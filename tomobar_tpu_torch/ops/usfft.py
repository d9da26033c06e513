"""Fourier direct inversion on unequally-spaced grids (USFFT), on PyTorch
tensors.

Counterpart of ``tomobar_tpu/ops/usfft.py`` (reference ``FOURIER_INV``,
Nikitin's method adapted from TomoCuPy): FBP-filter the sinogram on an
oversampled grid (the Ff kernel, F's filter variant), pack two real
z-slices into one (re, im) pair, 1-D FFT along detX, spread each polar
frequency sample onto a 2n x 2n Cartesian grid with a Gaussian kernel (the
G kernel), 2-D inverse FFT (Fc, F's centred variant), then crop and
multiply by the deconvolution factor phi.  The pipeline keeps the JAX
package's split (re, im) pairs, its sign-flip fftshifts and its
half-pixel shift, so every stage lines up with the JAX one.  What runs
where follows the tensor's device: a CUDA tensor runs the kernels, a CPU
tensor their plain versions.  ``set_usfft_backend``
and the ``TOMOBAR_TPU_USFFT`` environment variable take the JAX package's
names ("auto", "pallas", "xla") so that user code switches packages
unchanged, but the port grids the same way under each: with the G kernel
on a CUDA tensor at any n, with its plain version (``grid_plain``, the
scatter that the JAX package's "xla" runs) on a CPU tensor.

As in the JAX package, the output is a factor 8/pi hotter than the
calibrated inverse Radon transform (the reference's ``calc_filter``
amplitudes), and within the inscribed circle it correlates > 0.99 with a
Ram-Lak FBP; the corners outside the measured frequency disc are not
reconstructed.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tomobar_tpu_torch.ops.fft_kernels import filter_rows, ifft2_centred
from tomobar_tpu_torch.ops.fft_real import (
    _fft_axis2,
    apply_freq_filter_real,
    fft_pairs,
    runs_f,
    use_fused_axis2,
)
from tomobar_tpu_torch.ops.filters import calc_filter_np
from tomobar_tpu_torch.ops.usfft_kernels import grid
from tomobar_tpu_torch.trace import span
from tomobar_tpu_torch.utils.tools import (
    check_kwargs,
    data_dims_swapper,
    free_device_bytes,
)

__all__ = ["fourier_inv", "usfft_grid", "set_usfft_backend"]

_USFFT_BACKEND = os.environ.get("TOMOBAR_TPU_USFFT", "auto")


def set_usfft_backend(name: str) -> None:
    """Accept the JAX package's gridding backend names ("auto", "pallas",
    "xla"); the port's gridding follows the tensor's device under each."""
    global _USFFT_BACKEND
    if name not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown usfft backend {name!r}")
    _USFFT_BACKEND = name


def _edge_pad_last(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Edge-pad the last axis of a 3D tensor by (lo, hi)."""
    if lo == 0 and hi == 0:
        return x
    return torch.nn.functional.pad(x, (lo, hi), mode="replicate")


@lru_cache(maxsize=16)
def _filter_spectrum(ow: int, filter_type: str, cutoff: float, rotation_axis: float):
    """Full-length (ow,) Hermitian spectrum of ``calc_filter`` x the CoR
    phase ramp, float32 (re, im).  Host math that depends on the geometry
    only (the JAX package builds it once per trace), so it is cached."""
    half = calc_filter_np(ow, filter_type, cutoff)
    t = np.fft.fftfreq(ow)
    w_full = np.empty(ow, dtype=np.complex128)
    w_full[: ow // 2 + 1] = half
    w_full[ow // 2 + 1 :] = half[1 : (ow + 1) // 2][::-1]
    w_full = w_full * np.exp(-2j * np.pi * t * rotation_axis)
    # exact Hermitian symmetry: the DC and Nyquist bins must be real
    w_full[0] = w_full[0].real
    w_full[ow // 2] = w_full[ow // 2].real
    return w_full.real.astype(np.float32), w_full.imag.astype(np.float32)


def _oversampled_width(
    raw_width: int, width: int, power_of_2_oversampling: bool, oversampling_level: int
) -> int:
    """Width of the grid the filter stage transforms on."""
    if power_of_2_oversampling:
        ow = 2 ** math.ceil(math.log2(raw_width * 3))
        if width > ow:
            ow = 2 ** math.ceil(math.log2(width))
        return ow
    return max(int(oversampling_level * raw_width), width)


def _filter_window(ow: int, raw_width: int, width: int) -> Tuple[int, int, int]:
    """The edge pad's left width and the crop [unpad_m, unpad_p) of the
    filter stage on its oversampled grid."""
    return ow // 2 - raw_width // 2, ow // 2 - width // 2, ow // 2 + width // 2


@lru_cache(maxsize=16)
def _device_filter(ow: int, filter_type: str, cutoff: float, rotation_axis: float, device):
    """Ff's filter table on ``device``: :func:`_filter_spectrum` times the
    1/ow scale of the inverse transform, float32 (re, im) pairs."""
    w_re, w_im = _filter_spectrum(ow, filter_type, cutoff, rotation_axis)
    pairs = np.stack([w_re, w_im], axis=1).astype(np.float64) / ow
    return torch.as_tensor(pairs.astype(np.float32).ravel(), device=device)


def _fbp_filter_stage(
    data: torch.Tensor,
    raw_width: int,
    width: int,
    filter_type: str,
    cutoff: float,
    rotation_axis: float,
    power_of_2_oversampling: bool = True,
    oversampling_level: int = 4,
) -> torch.Tensor:
    """STEP0: filter rows on an oversampled grid, return width ``width``
    (``_fbp_filtering``, ``methodsDIR_CuPy.py:449-545``): edge-pad to the
    oversampled width, multiply the spectrum by ``calc_filter`` x the CoR
    phase ramp, inverse transform and crop the centred ``width`` window.
    On a CUDA tensor, where the oversampled width splits as F's transforms
    do (``use_fused_axis2``), the whole stage is one launch of Ff
    (``fft_kernels.filter_rows``); elsewhere it is :func:`_fbp_filter_plain`."""
    ow = _oversampled_width(raw_width, width, power_of_2_oversampling, oversampling_level)
    if data.device.type in ("cuda", "meta") and use_fused_axis2(ow):
        pad_m, unpad_m, unpad_p = _filter_window(ow, raw_width, width)
        table = None if data.is_meta else _device_filter(
            ow, filter_type, cutoff, rotation_axis, data.device)
        return filter_rows(data, table, ow, pad_m, unpad_m, unpad_p - unpad_m)
    return _fbp_filter_plain(data, ow, raw_width, width, filter_type, cutoff, rotation_axis)


def _fbp_filter_plain(
    data: torch.Tensor,
    ow: int,
    raw_width: int,
    width: int,
    filter_type: str,
    cutoff: float,
    rotation_axis: float,
) -> torch.Tensor:
    """:func:`_fbp_filter_stage` on a width-``ow`` grid as a chain of
    passes, Ff's plain version: the edge pad, ``apply_freq_filter_real``
    (F twice on a CUDA tensor where ``use_fused_axis2(ow)``), the crop."""
    pad_m, unpad_m, unpad_p = _filter_window(ow, raw_width, width)
    w_re, w_im = (
        torch.as_tensor(w, device=data.device)
        for w in _filter_spectrum(ow, filter_type, cutoff, rotation_axis)
    )
    tmp = _edge_pad_last(data, pad_m, ow - raw_width - pad_m)
    tmp = apply_freq_filter_real(tmp, w_re, w_im)
    return tmp[:, :, unpad_m:unpad_p].float()


def _sign_vector(n: int, device) -> torch.Tensor:
    """(-1)^(x+1): +1 at odd x, -1 at even x (the 1-D fftshift sign)."""
    i = torch.arange(n, device=device)
    return torch.where(i % 2 == 1, 1.0, -1.0).to(torch.float32)


def _pack_pairs(filtered: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack slice pairs (2z, 2z+1) -> (re, im), with the (-1)^x 1-D fftshift
    sign folded in (``r2c_c1dfftshift``)."""
    sign = _sign_vector(filtered.shape[-1], filtered.device)
    return filtered[0::2] * sign, filtered[1::2] * sign


def _spectra(data_re: torch.Tensor, data_im: torch.Tensor, n: int):
    """STEP1: centred 1-D FFT along detX (``torch.fft``) and the
    ``c1dfftshift`` sign x (4/n) scale.  Returns the gridding's input and
    what stays alive beside it until the gridding returns (the unscaled
    spectra and the scale, as the memory model of ``utils/memest.py`` has
    it)."""
    sre, sim = fft_pairs(data_re, data_im)
    scale = _sign_vector(n, data_re.device) * (4.0 / n)
    return (sre * scale, sim * scale), (sre, sim, scale)


def usfft_grid(
    data_re: torch.Tensor,
    data_im: torch.Tensor,
    n: int,
    theta: np.ndarray,
    eps: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """STEP1/2: centred 1-D FFT along detX (``torch.fft``), the
    ``c1dfftshift`` sign x (4/n) scale, then the Gaussian gridding onto
    (2n, 2n) (the G kernel).  data (nz2, nproj, n) -> grids (nz2, 2n, 2n)."""
    (gre, gim), held = _spectra(data_re, data_im, n)  # held until G returns
    return grid(gre, gim, n, theta, eps)


def _ifft2_centered(
    fre: torch.Tensor, fim: torch.Tensor, n: int, half_pixel_shift: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """STEP3: checkerboard-sign 2-D inverse FFT (``c2dfftshift`` pair).

    ``half_pixel_shift`` applies an exact Fourier-domain shift of
    (-0.5, -0.5) pixels, aligning the output with FBP on the same grid (the
    JAX package's deliberate departure from the reference).  The result is
    the inverse image TRANSPOSED in its last two axes; every later factor
    is symmetric, and ``_unpad_mul_phi`` restores the orientation on the
    small cropped volume.  On a CUDA tensor, where the passes run the F
    kernel, the whole stage is its centred variant Fc (two launches,
    ``fft_kernels.ifft2_centred``); elsewhere it is :func:`_ifft2_chain`.
    """
    if fre.device.type in ("cuda", "meta") and runs_f(2 * n):
        return ifft2_centred(fre, fim, half_pixel_shift)
    return _ifft2_chain(fre, fim, n, half_pixel_shift)


def _ifft2_chain(
    fre: torch.Tensor, fim: torch.Tensor, n: int, half_pixel_shift: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_ifft2_centered` as a chain of passes, Fc's plain version:
    the checkerboard and the ramp, both 1-D passes along axis -2 (F, or
    ``torch.fft``) with one transpose between, the signed scale."""
    two_n = 2 * n
    dev = fre.device
    i = torch.arange(two_n, device=dev)
    checker = torch.where((i[:, None] + i[None, :]) % 2 == 1, -1.0, 1.0).to(
        torch.float32
    )
    fre = fre * checker
    fim = fim * checker
    if half_pixel_shift:
        # stored index k <-> centred frequency (k - n); shifting the image
        # by s pixels multiplies F[k] by exp(-2i*pi*(k-n)*s/(2n)), s = -0.5
        ang = 2.0 * np.pi * (np.arange(two_n) - n) * 0.5 / two_n
        r1 = torch.as_tensor(np.cos(ang), dtype=torch.float32, device=dev)
        r2 = torch.as_tensor(np.sin(ang), dtype=torch.float32, device=dev)
        ramp_re = r1[:, None] * r1[None, :] - r2[:, None] * r2[None, :]
        ramp_im = r1[:, None] * r2[None, :] + r2[:, None] * r1[None, :]
        fre, fim = (
            fre * ramp_re - fim * ramp_im,
            fre * ramp_im + fim * ramp_re,
        )
    fre, fim = _fft_axis2(fre, fim, +1)
    fre = fre.transpose(-1, -2).contiguous()
    fim = fim.transpose(-1, -2).contiguous()
    fre, fim = _fft_axis2(fre, fim, +1)
    s = checker * (1.0 / (two_n * two_n))
    return fre * s, fim * s


@lru_cache(maxsize=4)
def _phi(n: int, nproj: int, m0: int, p0: int, mu: float, device) -> torch.Tensor:
    """The deconvolution factor on the cropped window, float32 on
    ``device``; geometry-only host math, cached (one recon-sized slice)."""
    r = np.arange(m0, p0, dtype=np.float32)
    d = -0.5 + r / n
    phi2d = np.exp(mu * n * n * (d[:, None] ** 2 + d[None, :] ** 2)) * (
        float(1 - n % 4) / nproj
    )
    return torch.as_tensor(phi2d, dtype=torch.float32, device=device)


def _unpad_mul_phi(
    fre: torch.Tensor,
    fim: torch.Tensor,
    n: int,
    nproj: int,
    nz: int,
    odd_horiz: bool,
    odd_vert: bool,
    recon_size: int,
    mu: float,
) -> torch.Tensor:
    """STEP4: crop to recon size, multiply by phi, unpack (re, im) -> 2 real
    slices (``unpadding_mul_phi``).  The incoming grids are transposed in
    their last two axes (see ``_ifft2_centered``); the crop window and phi
    are symmetric, so the orientation is restored here."""
    odd_recon = bool(recon_size % 2)
    unpad_z = nz - int(odd_vert)
    m0 = (n - int(odd_horiz)) // 2 - recon_size // 2
    p0 = (n - int(odd_horiz)) // 2 + (recon_size + odd_recon) // 2
    size = p0 - m0

    sl_re = fre[:, n // 2 + m0 : n // 2 + p0, n // 2 + m0 : n // 2 + p0]
    sl_im = fim[:, n // 2 + m0 : n // 2 + p0, n // 2 + m0 : n // 2 + p0]
    phi = _phi(n, nproj, m0, p0, mu, fre.device)
    out = torch.stack([sl_re * phi, sl_im * phi], dim=1).reshape(-1, size, size)
    out = out.transpose(-1, -2)
    return out[:unpad_z].contiguous()


def fourier_inv_pair_bytes(n: int) -> int:
    """Bytes that the chunk count plans for per z-pair: 4 grid-sized
    float32 (re, im) buffer pairs of (2n)^2.  On a CUDA tensor the ifft2
    stage (the centred F) holds 3 such pairs at its peak, and it peaks at
    every shape since the filter stage (Ff) holds only its output;
    ``utils/memest.py`` replays both and its tests hold the plan to them."""
    return 4 * 2 * (2 * n) * (2 * n) * 4


def _fourier_inv_memory_chunks(nz: int, n: int, kwargs: dict, device=None) -> int:
    """Number of z-slice chunks for memory-bounded execution
    (``methodsDIR_CuPy.py:179-237``): an explicit ``chunk_count`` wins;
    otherwise the chunk count keeps :func:`fourier_inv_pair_bytes` per
    z-pair under a budget.  On the CPU that is ``mem_budget_gb`` (default 8)
    and applies only when ``min_mem_usage_filter``/``min_mem_usage_ifft2``
    ask for it, as in the JAX package, so both packages chunk alike.  On a
    CUDA device every call is bounded: ``mem_budget_gb`` if given, else a
    third of the device's free memory, which leaves room for the
    temporaries beyond the model and for the output."""
    chunk_count = kwargs.get("chunk_count")
    if chunk_count is not None:
        if not isinstance(chunk_count, int) or chunk_count < 1:
            print(f"Invalid chunk count: {chunk_count}. Set to 1")
            return 1
        return min(chunk_count, max(nz // 2, 1))
    on_cuda = device is not None and torch.device(device).type == "cuda"
    asked = kwargs.get("min_mem_usage_filter") or kwargs.get("min_mem_usage_ifft2")
    if not (asked or on_cuda):
        return 1
    if kwargs.get("mem_budget_gb") is not None or not on_cuda:
        budget = float(kwargs.get("mem_budget_gb") or 8.0) * 1e9
    else:
        budget = free_device_bytes(device) / 3
    pairs_per_chunk = max(int(budget // fourier_inv_pair_bytes(n)), 1)
    return max(-(-(nz // 2) // pairs_per_chunk), 1)


class _Pipeline(NamedTuple):
    """What the pipeline makes of a (detY, angles, detX) input shape and the
    kwargs; :func:`fourier_inv` and the memory model of ``utils/memest.py``
    share it."""

    filter_type: str
    cutoff_freq: float
    power_of_2_oversampling: bool
    oversampling_level: int
    nz: int  # detY, made even
    nproj: int
    data_n: int  # detX, made even
    odd_vert: bool
    odd_horiz: bool
    n: int  # the transform size: data_n + the detector and the kwargs' padding
    ow: int  # the filter stage's oversampled width


def _pipeline(model, shape: Tuple[int, int, int], kwargs: dict) -> _Pipeline:
    cutoff_freq = kwargs.get("cutoff_freq")
    if cutoff_freq is None:
        cutoff_freq = 1.0
    filter_type = kwargs.get("filter_type")
    if filter_type is None:
        filter_type = "shepp"
    if filter_type not in (
        "none", "ramp", "shepp", "cosine", "cosine2", "hamming", "hann", "parzen",
    ):
        print(
            "Unknown filter name, please use: none, ramp, shepp, cosine, "
            "cosine2, hamming, hann or parzen. Set to shepp filter"
        )
        filter_type = "shepp"
    padding = kwargs.get("padding", 0)
    if not isinstance(padding, int) or padding < 0:
        print(f"Invalid padding: {padding}. Set to 0")
        padding = 0

    nz, nproj, data_n = shape
    if model.recon_size > data_n:
        raise ValueError(
            f"The reconstruction size {model.recon_size} should not be larger than "
            f"the size of the horizontal detector {data_n}"
        )
    odd_horiz = bool(data_n % 2)
    odd_vert = bool(nz % 2)
    nz += int(odd_vert)
    data_n += int(odd_horiz)

    n = data_n + model.detectors_x_pad * 2 + padding * 2
    if kwargs.get("power_of_2_cropping", False):
        n_pow2 = 2 ** math.ceil(math.log2(n))
        if 0.9 < n / n_pow2:
            n = n_pow2
    p2 = kwargs.get("power_of_2_oversampling", True)
    level = kwargs.get("oversampling_level", 4)
    return _Pipeline(
        filter_type, cutoff_freq, p2, level, nz, nproj, data_n, odd_vert,
        odd_horiz, n, _oversampled_width(data_n, n, p2, level),
    )


def fourier_inv(model, data: torch.Tensor, **kwargs) -> torch.Tensor:
    """Full FOURIER_INV pipeline on a (detY, angles, detX) tensor (2D
    (angles, detX) data is promoted to detY = 1 and returned as 2D).

    Accepts the reference's kwargs (``methodsDIR_CuPy.py:160-237``):
    ``filter_type``, ``cutoff_freq``, ``padding``, ``power_of_2_cropping``,
    ``power_of_2_oversampling``, ``oversampling_level``, ``chunk_count``,
    ``min_mem_usage_filter``/``min_mem_usage_ifft2``/``mem_budget_gb``,
    ``data_axes_labels_order`` and ``recon_mask_radius``; kwargs that only
    set CUDA launch shapes in the reference are accepted and ignored.
    """
    order = kwargs.get("data_axes_labels_order")
    data = data.float()
    squeeze_2d = data.dim() == 2
    if squeeze_2d:
        if order is not None:
            data = data_dims_swapper(data, order, ["angles", "detX"])
        data = data[None]
    elif order is not None:
        data = data_dims_swapper(data, order, ["detY", "angles", "detX"])

    p = _pipeline(model, tuple(data.shape), kwargs)
    if p.odd_vert:
        data = torch.cat([data, data[-1:]], dim=0)
    if p.odd_horiz:
        data = _edge_pad_last(data, 0, 1)
    nz, nproj, data_n, n = p.nz, p.nproj, p.data_n, p.n
    odd_horiz, odd_vert, recon_size = p.odd_horiz, p.odd_vert, model.recon_size
    eps = 1e-4
    mu = -np.log(eps) / (2 * n * n)
    theta = -np.asarray(model.geom.angles, dtype=np.float64)
    rotation_axis = float(np.mean(model.geom.cor_horizontal)) + 0.5

    def run_block(block, block_nz, trailing_odd):
        at = {"nz": block_nz, "nproj": nproj, "n": n, "ow": p.ow}
        with span("tomobar::usfft.filter", **at):
            filtered = _fbp_filter_stage(
                block,
                data_n,
                n,
                p.filter_type,
                p.cutoff_freq,
                rotation_axis,
                p.power_of_2_oversampling,
                p.oversampling_level,
            )
        with span("tomobar::usfft.fft1d", **at):
            dre, dim = _pack_pairs(filtered)
            (gre, gim), held = _spectra(dre, dim, n)
        with span("tomobar::usfft.grid", **at):
            fre, fim = grid(gre, gim, n, theta, eps)
        del gre, gim, held
        with span("tomobar::usfft.ifft2", **at):
            fre, fim = _ifft2_centered(fre, fim, n)
        with span("tomobar::usfft.unpad", **at):
            return _unpad_mul_phi(
                fre, fim, n, nproj, block_nz, odd_horiz, trailing_odd,
                recon_size, mu,
            )

    n_chunks = _fourier_inv_memory_chunks(nz, n, kwargs, data.device)
    if n_chunks <= 1:
        recon = run_block(data, nz, odd_vert)
    else:
        # pair-aligned z blocks; exact by blockwise consistency
        pairs = nz // 2
        per = -(-pairs // n_chunks)
        recon = None
        for q0 in range(0, pairs, per):
            z0, z1 = 2 * q0, min(2 * (q0 + per), nz)
            part = run_block(data[z0:z1], z1 - z0, odd_vert and z1 == nz)
            if recon is None:
                recon = torch.empty(
                    (nz - int(odd_vert), *part.shape[1:]), dtype=part.dtype, device=part.device
                )
            recon[z0 : z0 + part.shape[0]] = part
    if squeeze_2d:
        recon = recon[0]
    return check_kwargs(recon, recon_mask_radius=kwargs.get("recon_mask_radius"))
