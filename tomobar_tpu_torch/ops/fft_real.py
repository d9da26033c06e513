"""Split-complex FFT helpers on PyTorch tensors.

Counterpart of ``tomobar_tpu/ops/fft_real.py``.  The JAX package carries
(re, im) float32 pairs because its TPU runtime has no complex dtype; the
port keeps the same pair interface so the USFFT pipeline lines up stage by
stage.  Last-axis transforms (:func:`fft_pairs`, :func:`ifft_pairs`) are
``torch.fft``.  Axis-(-2) transforms go through the F kernel
(:mod:`tomobar_tpu_torch.ops.fft_kernels`) at exactly the sizes where the
JAX package runs its fused Pallas pass (1 < B <= 8, C <= 1024 from
``fft_kernels.best_split``), and through ``torch.fft`` otherwise; the
TPU-only conditions of that choice (lane-strip divisibility, native
complex support) have no counterpart.  The host tables of the Bailey
factorisation (``_best_split``, ``_dft_mats``, ``_twiddle`` in the JAX
module) live beside the kernel, in :mod:`tomobar_tpu_torch.ops.fft_kernels`.
"""

from __future__ import annotations

import torch

from tomobar_tpu_torch.ops.fft_kernels import (
    MAX_B,
    MAX_C,
    best_split,
    fft_axis2,
    fft_axis2_plain,
)

__all__ = [
    "fft_pairs",
    "ifft_pairs",
    "fft2_pairs",
    "ifft2_pairs",
    "apply_freq_filter_real",
    "use_fused_axis2",
]


def use_fused_axis2(n: int) -> bool:
    """True where the JAX package would run its fused axis-(-2) Pallas pass
    for a length-n transform: the sizes the F kernel takes."""
    B, C = best_split(n)
    return B != 0 and 1 < B <= MAX_B and C <= MAX_C


def _fft_axis2(re: torch.Tensor, im: torch.Tensor, sign: int):
    """Length-n transform along axis -2 of (..., n, L), unnormalised."""
    n = re.shape[-2]
    if n > MAX_C and use_fused_axis2(n):
        return fft_axis2(re, im, sign)
    return fft_axis2_plain(re, im, sign)


def fft_pairs(re: torch.Tensor, im=None):
    """Forward FFT along the last axis on an (re, im) float32 pair.
    ``im=None`` treats the input as real."""
    x = re.float() if im is None else torch.complex(re.float(), im.float())
    y = torch.fft.fft(x, dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


def ifft_pairs(re: torch.Tensor, im: torch.Tensor):
    """Inverse FFT along the last axis (includes the 1/n scale)."""
    y = torch.fft.ifft(torch.complex(re.float(), im.float()), dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


def fft2_pairs(re: torch.Tensor, im=None):
    """Forward 2-D FFT over the last two axes (rows by ``torch.fft``, columns
    by the axis-(-2) transform)."""
    re1, im1 = fft_pairs(re, im)
    return _fft_axis2(re1, im1, -1)


def ifft2_pairs(re: torch.Tensor, im: torch.Tensor):
    """Inverse 2-D FFT over the last two axes (includes 1/(n1*n2))."""
    re1, im1 = ifft_pairs(re, im)  # includes 1/n2
    re2, im2 = _fft_axis2(re1, im1, +1)
    s = 1.0 / re.shape[-2]
    return re2 * s, im2 * s


def apply_freq_filter_real(
    x: torch.Tensor, w_re: torch.Tensor, w_im=None
) -> torch.Tensor:
    """Filter real rows in the frequency domain: ifft(fft(x) * w).real.

    ``x`` is (..., R, n) real; ``w_re``/``w_im`` is the FULL-length (n,)
    spectrum of a Hermitian-symmetric filter.  Rows are packed in pairs
    into the (re, im) slots (two real transforms per complex one), which is
    exact because a Hermitian w maps real rows to real rows.  ``w`` must be
    exactly Hermitian: the DC and Nyquist bins real.

    Where :func:`use_fused_axis2` holds, both transforms run along axis -2
    of the transposed (n, rows) pair, through the F kernel on CUDA, as the
    JAX package routes them on the TPU; otherwise along the last axis.
    """
    *lead, R, n = x.shape
    x2 = x.reshape(-1, R, n)
    odd = R % 2
    if odd:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, 1))
    re = x2[:, 0::2, :]
    im = x2[:, 1::2, :]
    npairs = re.shape[1]
    if use_fused_axis2(n):
        re_t = re.reshape(-1, n).transpose(0, 1).contiguous()  # (n, rows)
        im_t = im.reshape(-1, n).transpose(0, 1).contiguous()
        fre, fim = fft_axis2(re_t, im_t, -1)
        wr = w_re[:, None]
        if w_im is None:
            gre = fre * wr
            gim = fim * wr
        else:
            wi = w_im[:, None]
            gre = fre * wr - fim * wi
            gim = fre * wi + fim * wr
        yre, yim = fft_axis2(gre, gim, +1)
        s = 1.0 / n
        yre = yre.transpose(0, 1).reshape(-1, npairs, n) * s
        yim = yim.transpose(0, 1).reshape(-1, npairs, n) * s
    else:
        fre, fim = fft_pairs(re, im)
        if w_im is None:
            gre = fre * w_re
            gim = fim * w_re
        else:
            gre = fre * w_re - fim * w_im
            gim = fre * w_im + fim * w_re
        yre, yim = ifft_pairs(gre, gim)
    y = torch.stack([yre, yim], dim=2).reshape(x2.shape[0], R + odd, n)
    if odd:
        y = y[:, :R, :]
    return y.reshape(*lead, R, n).to(x.dtype)
