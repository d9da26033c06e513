"""Fourier direct inversion on unequally-spaced grids (USFFT), on PyTorch
tensors.

Counterpart of ``tomobar_tpu/ops/usfft.py`` (reference ``FOURIER_INV``,
Nikitin's method adapted from TomoCuPy): FBP-filter the sinogram on an
oversampled grid, pack two real z-slices into one (re, im) pair, 1-D FFT
along detX, spread each polar frequency sample onto a 2n x 2n Cartesian
grid with a Gaussian kernel (the G kernel), 2-D inverse FFT (the F kernel
along axis -2, twice), then crop and multiply by the deconvolution factor
phi.  The pipeline keeps the JAX package's split (re, im) pairs, its
sign-flip fftshifts and its half-pixel shift, so every stage lines up with
the JAX one.  What runs where follows the tensor's device: a CUDA tensor
runs the kernels, a CPU tensor their plain versions.

As in the JAX package, the output is a factor 8/pi hotter than the
calibrated inverse Radon transform (the reference's ``calc_filter``
amplitudes), and within the inscribed circle it correlates > 0.99 with a
Ram-Lak FBP; the corners outside the measured frequency disc are not
reconstructed.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from tomobar_tpu_torch.ops.fft_real import _fft_axis2, apply_freq_filter_real, fft_pairs
from tomobar_tpu_torch.ops.filters import calc_filter_np
from tomobar_tpu_torch.ops.usfft_kernels import grid
from tomobar_tpu_torch.utils.tools import (
    check_kwargs,
    data_dims_swapper,
    free_device_bytes,
)

__all__ = ["fourier_inv", "usfft_grid"]


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
    phase ramp, inverse transform and crop the centred ``width`` window."""
    if power_of_2_oversampling:
        ow = 2 ** math.ceil(math.log2(raw_width * 3))
        if width > ow:
            ow = 2 ** math.ceil(math.log2(width))
    else:
        ow = max(int(oversampling_level * raw_width), width)

    pad_m = ow // 2 - raw_width // 2
    unpad_m = ow // 2 - width // 2
    unpad_p = ow // 2 + width // 2

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
    sre, sim = fft_pairs(data_re, data_im)
    scale = _sign_vector(n, data_re.device) * (4.0 / n)
    return grid(sre * scale, sim * scale, n, theta, eps)


def _ifft2_centered(
    fre: torch.Tensor, fim: torch.Tensor, n: int, half_pixel_shift: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """STEP3: checkerboard-sign 2-D inverse FFT (``c2dfftshift`` pair).

    ``half_pixel_shift`` applies an exact Fourier-domain shift of
    (-0.5, -0.5) pixels, aligning the output with FBP on the same grid (the
    JAX package's deliberate departure from the reference).  Both 1-D
    passes run along axis -2 (the F kernel) with one transpose between, so
    the result is the inverse image TRANSPOSED in its last two axes; every
    later factor is symmetric, and ``_unpad_mul_phi`` restores the
    orientation on the small cropped volume.
    """
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


def _fourier_inv_memory_chunks(nz: int, n: int, kwargs: dict, device=None) -> int:
    """Number of z-slice chunks for memory-bounded execution
    (``methodsDIR_CuPy.py:179-237``): an explicit ``chunk_count`` wins;
    otherwise the chunk count keeps 4 grid-sized float32 buffer pairs per
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
    per_pair = 4 * 2 * (2 * n) * (2 * n) * 4.0
    pairs_per_chunk = max(int(budget // per_pair), 1)
    return max(-(-(nz // 2) // pairs_per_chunk), 1)


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

    order = kwargs.get("data_axes_labels_order")
    data = data.float()
    squeeze_2d = data.dim() == 2
    if squeeze_2d:
        if order is not None:
            data = data_dims_swapper(data, order, ["angles", "detX"])
        data = data[None]
    elif order is not None:
        data = data_dims_swapper(data, order, ["detY", "angles", "detX"])

    nz, nproj, data_n = data.shape
    recon_size = model.recon_size
    if recon_size > data_n:
        raise ValueError(
            f"The reconstruction size {recon_size} should not be larger than "
            f"the size of the horizontal detector {data_n}"
        )

    odd_horiz = bool(data_n % 2)
    odd_vert = bool(nz % 2)
    if odd_vert:
        data = torch.cat([data, data[-1:]], dim=0)
        nz += 1
    if odd_horiz:
        data = _edge_pad_last(data, 0, 1)
        data_n += 1

    n = data_n + model.detectors_x_pad * 2 + padding * 2
    if kwargs.get("power_of_2_cropping", False):
        n_pow2 = 2 ** math.ceil(math.log2(n))
        if 0.9 < n / n_pow2:
            n = n_pow2

    eps = 1e-4
    mu = -np.log(eps) / (2 * n * n)
    theta = -np.asarray(model.geom.angles, dtype=np.float64)
    rotation_axis = float(np.mean(model.geom.cor_horizontal)) + 0.5

    def run_block(block, block_nz, trailing_odd):
        filtered = _fbp_filter_stage(
            block,
            data_n,
            n,
            filter_type,
            cutoff_freq,
            rotation_axis,
            kwargs.get("power_of_2_oversampling", True),
            kwargs.get("oversampling_level", 4),
        )
        dre, dim = _pack_pairs(filtered)
        fre, fim = usfft_grid(dre, dim, n, theta, eps)
        fre, fim = _ifft2_centered(fre, fim, n)
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
