"""Host side of the G kernel (USFFT Gaussian gridding), its plain PyTorch
version and the wrapper that launches ``csrc/usfft_grid.cu``.

Counterpart of the gridding step of ``tomobar_tpu/ops/usfft.py``
(``usfft_grid``, the XLA scatter oracle) and of the Pallas kernels that
replace it on the TPU (``usfft_pallas.py``: G1 ``_grid_kernel_astack``, G0
``_grid_kernel``), which compute the same sum.  Each polar sample (a, r) of
the already transformed and scaled spectra ``g`` (nz2, nproj, n) is spread
onto the (2n, 2n) grid over the (2m+1)^2 footprint around
``floor(2n*x0), floor(2n*y0)`` with weights
``coeff0 * exp(coeff1 * (w0^2 + w1^2))``, grid indices wrapped as
``mod(l + n, 2n)``.

:func:`grid_plain` is the plain version (the oracle's scatter, as one
``index_add_`` per footprint offset); :func:`grid` runs it for a tensor on
the CPU, and for a CUDA tensor launches the kernel or raises (for a meta
tensor it makes the grids and launches nothing: a memory plan).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tomobar_tpu_torch import _build

__all__ = ["GridParams", "grid_params", "grid", "grid_plain", "tile_order"]

# half-width of the centre square of the grid whose tiles G sums with
# compensation (see csrc/usfft_grid.cu): all angles overlap there
CENTRE_HALF_WIDTH = 128


class GridParams(NamedTuple):
    """Scalars of the Gaussian gridding for a size-n transform (the
    Gaussian's width is mu = -log(eps) / (2 n^2))."""

    m: int  # footprint half-width in grid cells
    coeff0: np.float32  # pi / mu
    coeff1: np.float32  # -pi^2 / mu
    clamp: np.float32  # sample positions are clamped to 0.5 - 1e-5


def grid_params(n: int, eps: float = 1e-4) -> GridParams:
    """``usfft.py:153-178``: the oracle's scalars, float32 where the oracle
    casts them."""
    mu = -np.log(eps) / (2 * n * n)
    m = int(
        np.ceil(
            2 * n / np.pi * np.sqrt(-mu * np.log(eps) + (mu * n) * (mu * n) / 4)
        )
    )
    return GridParams(
        m, np.float32(np.pi / mu), np.float32(-np.pi * np.pi / mu),
        np.float32(0.5 - 1e-5),
    )


def _sample_positions(n: int, theta: np.ndarray, clamp: np.float32):
    """Polar sample coordinates (nproj, n), float32 host math exactly as the
    oracle: x0, y0 and the footprint origins floor(2n x0), floor(2n y0)."""
    cos_t = np.cos(theta).astype(np.float32)
    sin_t = np.sin(theta).astype(np.float32)
    c = (np.arange(n, dtype=np.float32) - n / 2) / n
    x0 = np.minimum(c[None, :] * cos_t[:, None], clamp)
    y0 = np.minimum(-c[None, :] * sin_t[:, None], clamp)
    ell0 = np.floor(2 * n * x0).astype(np.int64)
    ell1 = np.floor(2 * n * y0).astype(np.int64)
    return x0, y0, ell0, ell1


def grid_plain(
    g_re: torch.Tensor, g_im: torch.Tensor, n: int, theta: np.ndarray,
    eps: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of G: g (nz2, nproj, n) -> grids (nz2, 2n, 2n).  The
    weights are float32 as the oracle's; the grids take g's dtype, so a
    float64 g gives float64 sums (a reference free of fp32 sum order)."""
    prm = grid_params(n, eps)
    nz2 = g_re.shape[0]
    dev = g_re.device
    two_n = 2 * n
    x0, y0, ell0, ell1 = (
        torch.as_tensor(a.reshape(-1), device=dev)
        for a in _sample_positions(n, theta, prm.clamp)
    )
    gre = g_re.reshape(nz2, -1)
    gim = g_im.reshape(nz2, -1)
    fre = torch.zeros((nz2, two_n * two_n), dtype=g_re.dtype, device=dev)
    fim = torch.zeros_like(fre)
    coeff0, coeff1 = float(prm.coeff0), float(prm.coeff1)
    # a tensor divisor: a true float32 division as the oracle's (PyTorch
    # multiplies by the rounded reciprocal of a Python scalar on CUDA)
    two_n_f = torch.tensor(float(two_n), dtype=torch.float32, device=dev)
    for i1 in range(2 * prm.m + 1):
        l1 = ell1 - prm.m + i1
        w1 = l1.to(torch.float32) / two_n_f - y0
        row = torch.remainder(l1 + n, two_n) * two_n
        for i0 in range(2 * prm.m + 1):
            l0 = ell0 - prm.m + i0
            w0 = l0.to(torch.float32) / two_n_f - x0
            w = coeff0 * torch.exp(coeff1 * (w0 * w0 + w1 * w1))
            idx = row + torch.remainder(l0 + n, two_n)
            fre.index_add_(1, idx, gre * w)
            fim.index_add_(1, idx, gim * w)
    return fre.view(nz2, two_n, two_n), fim.view(nz2, two_n, two_n)


@lru_cache(maxsize=16)
def _device_angles(theta_bytes: bytes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin of the float64 polar angles ``theta_bytes`` on
    ``device``, uploaded once per geometry."""
    theta = np.frombuffer(theta_bytes, dtype=np.float64)
    return tuple(
        torch.as_tensor(f(theta).astype(np.float32), device=device)
        for f in (np.cos, np.sin)
    )


def tile_order(n: int, tile_y: int, tile_x: int) -> np.ndarray:
    """The tiles of the (2n, 2n) grid (row-major numbers) by the distance of
    their centres from the grid's centre, nearest first: a tile near the
    centre holds the samples of every angle, so the kernel's blocks take
    the heavy tiles first."""
    ny, nx = -(-2 * n // tile_y), -(-2 * n // tile_x)
    cy = (np.arange(ny) + 0.5) * tile_y - n
    cx = (np.arange(nx) + 0.5) * tile_x - n
    d2 = cy[:, None] ** 2 + cx[None, :] ** 2
    return np.argsort(d2.ravel(), kind="stable").astype(np.int32)


@lru_cache(maxsize=16)
def _device_tile_order(n: int, tile_y: int, tile_x: int, device) -> torch.Tensor:
    return torch.as_tensor(tile_order(n, tile_y, tile_x), device=device)


def grid(
    g_re: torch.Tensor, g_im: torch.Tensor, n: int, theta: np.ndarray,
    eps: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """G (see :func:`grid_plain`).  g_re/g_im (nz2, nproj, n) float32.  The
    kernel stores every grid cell once, in a fixed order of the sum: two
    calls on the same input give the same grids bit for bit."""
    theta = np.asarray(theta, dtype=np.float64)
    if g_re.device.type == "cpu":
        return grid_plain(g_re, g_im, n, theta, eps)
    if g_re.device.type not in ("cuda", "meta") or g_im.device != g_re.device:
        raise ValueError(f"G: tensors on {g_re.device} and {g_im.device}; the kernel takes CUDA tensors")
    if g_re.dtype != torch.float32 or g_im.dtype != torch.float32:
        raise TypeError(f"G: expected float32, got {g_re.dtype} and {g_im.dtype}")
    nz2, nproj = g_re.shape[0], theta.shape[0]
    if g_re.shape != (nz2, nproj, n) or g_im.shape != g_re.shape:
        raise ValueError(f"G: spectra must be ({nz2}, {nproj}, {n}), got {tuple(g_re.shape)} and {tuple(g_im.shape)}")
    prm = grid_params(n, eps)
    if prm.m >= n:
        raise ValueError(f"G: n = {n} is smaller than the footprint (m = {prm.m})")
    g_re = g_re.contiguous()
    g_im = g_im.contiguous()
    fre = torch.empty((nz2, 2 * n, 2 * n), dtype=torch.float32, device=g_re.device)
    fim = torch.empty_like(fre)
    if fre.is_meta:  # a memory plan: the grids, no launch
        return fre, fim
    cos_t, sin_t = _device_angles(theta.tobytes(), g_re.device)
    lib = _build.library()
    order = _device_tile_order(
        n, lib.tt_usfft_grid_tile(0), lib.tt_usfft_grid_tile(1), g_re.device
    )
    with torch.cuda.device(g_re.device):
        err = lib.tt_usfft_grid(
            g_re.data_ptr(), g_im.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
            fre.data_ptr(), fim.data_ptr(), order.data_ptr(),
            nz2, nproj, n, prm.m, CENTRE_HALF_WIDTH,
            float(prm.coeff0), float(prm.coeff1), float(prm.clamp),
            torch.cuda.current_stream(g_re.device).cuda_stream,
        )
    _build.check("G", err)
    _build.launch_counts["G"] += 1
    return fre, fim
