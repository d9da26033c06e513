"""Host side of the F kernel (the fused axis-(-2) FFT pass), its plain
PyTorch version and the wrapper that launches ``csrc/fft_axis2.cu``.

Counterpart of ``_fft_axis2_fused`` in ``tomobar_tpu/ops/fft_real.py``:
the length-n DFT along axis -2 of a split-complex (re, im) float32 pair of
shape (..., n, L), unnormalised in both directions, by the Bailey
factorisation n = B*C:

    X[k1 + B*k2] = DFT_C[n2 -> k2]( T[k1, n2] * DFT_B[n1 -> k1]( x[n1*C + n2] ) )

with ``T[k1, n2] = exp(sign*2i*pi*k1*n2/n)``.  The tables are built in
float64 on the host and cast to float32, as the JAX package builds them.
The kernel is the forward transform; the unnormalised inverse is the same
launch on swapped re/im pointers, since conj(DFT(conj x)) equals
swap(DFT(swap x)) with swap(a + ib) = b + ia.  Its C-point transform runs
as in-place stages whose radices :func:`stage_plan` picks.

:func:`fft_axis2_plain` is the plain version (``torch.fft`` along dim -2).
:func:`fft_axis2` runs it for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from tomobar_tpu_torch import _build

__all__ = [
    "MAX_C",
    "MAX_B",
    "best_split",
    "stage_plan",
    "dft_mats",
    "twiddle",
    "fft_axis2",
    "fft_axis2_plain",
]

MAX_C = 1024  # largest C-point transform (the JAX package's _MAX_MATMUL_N)
MAX_B = 8  # largest B of the fused pass (JAX's _use_fused_axis2)


@lru_cache(maxsize=None)
def dft_mats(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag parts of the DFT matrix W[j, k] = exp(sign*2i*pi*j*k/n),
    built in float64 then cast: twiddle accuracy dominates FFT error."""
    j = np.arange(n, dtype=np.float64)
    ang = (sign * 2.0 * np.pi / n) * np.outer(j, j)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=None)
def twiddle(n: int, B: int, C: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """T[k1, n2] = exp(sign*2i*pi*k1*n2/n), shape (B, C)."""
    k1 = np.arange(B, dtype=np.float64)[:, None]
    n2 = np.arange(C, dtype=np.float64)[None, :]
    ang = (sign * 2.0 * np.pi / n) * (k1 * n2)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def best_split(n: int) -> Tuple[int, int]:
    """Factor n = B*C with C as large as possible but <= MAX_C, preferring
    multiples of 128 (the JAX package's ``_best_split``).  Returns (0, 0)
    when no nontrivial factorisation exists (prime n)."""
    fallback = (0, 0)
    for c in range(min(n - 1, MAX_C), 1, -1):
        if n % c == 0:
            if c % 128 == 0:
                return (n // c, c)
            if fallback == (0, 0):
                fallback = (n // c, c)
    return fallback


def fft_axis2_plain(re: torch.Tensor, im: torch.Tensor, sign: int):
    """Plain version of F: ``torch.fft`` along dim -2 of ``re + 1j*im``,
    unnormalised for both signs (as the JAX pass), split back to re/im."""
    x = torch.complex(re.float(), im.float())
    if sign < 0:
        y = torch.fft.fft(x, dim=-2)
    else:
        y = torch.fft.ifft(x, dim=-2, norm="forward")
    return y.real.contiguous(), y.imag.contiguous()


# stages of a 2**k-point transform, k <= 10: the fewest, of radix <= 16
_POW2_STAGES = (
    (), (2,), (4,), (8,), (16,), (8, 4), (8, 8), (16, 8), (16, 16), (8, 8, 8),
    (16, 8, 8),
)


@lru_cache(maxsize=None)
def stage_plan(C: int) -> Tuple[int, ...]:
    """Radices of the kernel's C-point stages, in order (their product is
    C): the odd prime factors first, ascending (3 and 5 have register
    butterflies; a larger prime runs one output per thread item), then the
    power of two in radices up to 16."""
    plan = []
    p = 3
    while C & (C - 1):  # not yet a power of two: an odd factor is left
        if C % p == 0:
            plan.append(p)
            C //= p
        else:
            p += 2
    return tuple(plan) + _POW2_STAGES[C.bit_length() - 1]


@lru_cache(maxsize=16)
def _device_tables(n: int, B: int, C: int, device) -> torch.Tensor:
    """The kernel's constant tables of the forward transform on ``device``,
    in one float32 buffer of (re, im) pairs: DFT_B (B*B), T (B*C) and the
    C-stage roots w_C[j] = exp(-2i*pi*j/C) (C)."""
    bre, bim = dft_mats(B, -1)
    tre, tim = twiddle(n, B, C, -1)
    ang = (-2.0 * np.pi / C) * np.arange(C, dtype=np.float64)
    pairs = np.concatenate([
        np.stack([bre.ravel(), bim.ravel()], axis=1),
        np.stack([tre.ravel(), tim.ravel()], axis=1),
        np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32),
    ])
    return torch.as_tensor(pairs.ravel(), dtype=torch.float32, device=device)


def fft_axis2(re: torch.Tensor, im: torch.Tensor, sign: int):
    """F: length-n DFT along axis -2 of (..., n, L), n = B*C from
    :func:`best_split` with 1 < B <= 8 and C <= 1024.  ``sign`` -1 is the
    forward transform, +1 the unnormalised inverse."""
    if re.device.type == "cpu":
        return fft_axis2_plain(re, im, sign)
    if re.device.type not in ("cuda", "meta") or im.device != re.device:
        raise ValueError(f"F: tensors on {re.device} and {im.device}; the kernel takes CUDA tensors")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"F: expected float32, got {re.dtype} and {im.dtype}")
    if re.shape != im.shape or re.dim() < 2:
        raise ValueError(f"F: re {tuple(re.shape)} and im {tuple(im.shape)} must be one (..., n, L) shape")
    if sign not in (-1, 1):
        raise ValueError(f"F: sign must be -1 or +1, got {sign}")
    n, L = re.shape[-2], re.shape[-1]
    B, C = best_split(n)
    if not (1 < B <= MAX_B and C <= MAX_C):
        raise ValueError(f"F: n = {n} splits as B={B}, C={C}; the kernel takes 1 < B <= {MAX_B}, C <= {MAX_C}")
    Z = re.numel() // max(n * L, 1)
    re = re.contiguous()
    im = im.contiguous()
    ore = torch.empty_like(re)
    oim = torch.empty_like(im)
    if ore.is_meta:  # a memory plan: the outputs, no launch
        return ore, oim
    tables = _device_tables(n, B, C, re.device)
    plan = stage_plan(C)
    radices = (ctypes.c_int * len(plan))(*plan)
    # the inverse: the forward kernel on swapped re/im, in and out
    ptrs = (re, im, ore, oim) if sign < 0 else (im, re, oim, ore)
    lib = _build.library()
    with torch.cuda.device(re.device):
        err = lib.tt_fft_axis2(
            *(t.data_ptr() for t in ptrs), tables.data_ptr(), Z, B, C, L,
            radices, len(plan), torch.cuda.current_stream(re.device).cuda_stream,
        )
    _build.check("F", err)
    _build.launch_counts["F"] += 1
    return ore, oim
