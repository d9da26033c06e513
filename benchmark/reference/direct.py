"""Plain references of ``RecToolsDIRCuPy(...).FBP`` (the sinc filter) and ``.FOURIER_INV`` (default keywords), from their definitions.

FBP: each row along detX is filtered by the sinc filter of cutoff ``a``
(ToMoBAR's ``generate_filtersync.cu``: r(w) = |2/a sin(a w/2)| dot^2 on w =
-pi + 2 pi k/n, ifftshifted, times 1/n_angles), then back-projected by
the reference operator.

FOURIER_INV (Nikitin's USFFT as TomoCuPy runs it, with the half-pixel
shift that aligns it with FBP): the rows edge-padded to ow = 2^ceil(log2
3n), filtered by the LPRec "shepp" bank times the centre's phase ramp,
cropped to n; slices packed in pairs (2q + i (2q + 1)) with the (-1)^x
sign; a 1D FFT along detX times the sign and 4/n; each polar sample
spread onto the (2n)^2 grid by the Gaussian kernel (footprint m, width mu
= -log(1e-4)/(2 n^2)); the checkerboard-signed inverse 2D FFT with the
(-1/2, -1/2) pixel shift; the centre n x n window times the deconvolution
factor phi; the real part is slice 2q, the imaginary part slice 2q + 1.
The gridding sums in float64.

The filter tables (``sinc_filter_half``, ``_wint``, ``shepp_filter_half``)
and the gridding's scalars and sample positions are frozen copies of
``tomobar_tpu_torch/ops/filters.py`` and ``ops/usfft_kernels.py`` at commit
4cba618f362617c7, themselves ToMoBAR's host code.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.common import rounder
from benchmark.reference.projector import Operator


# ----------------------------------------------------------------- FBP

def sinc_filter_half(n: int, a: float, multiplier: float) -> np.ndarray:
    w = -np.pi + np.arange(n) * (2 * np.pi / n)
    rd = a * w / 2.0
    rn2 = np.sin(rd)
    dot = float(np.dot(rn2, rd) / np.dot(rd, rd))
    r = np.abs(2.0 / a * rn2) * dot * dot
    return (np.fft.ifftshift(r)[: n // 2 + 1] * multiplier).astype(np.float32)


def fbp(sino: torch.Tensor, theta: np.ndarray, cor: float, n: int, cutoff: float,
        prec: str = "fp32") -> torch.Tensor:
    """FBP of ``sino`` [angles, detX] (2D) or [detY, angles, detX]."""
    q = rounder(prec)
    det_x = sino.shape[-1]
    half = torch.as_tensor(sinc_filter_half(det_x, cutoff, 1.0 / sino.shape[-2]), device=sino.device)
    filtered = q(torch.fft.irfft(torch.fft.rfft(q(sino), dim=-1) * half, det_x, dim=-1))
    return Operator(theta, cor, det_x, n, sino.device, prec).bp(filtered)


# -------------------------------------------------------- FOURIER_INV

def _wint(n: int, t: np.ndarray) -> np.ndarray:
    """Quadrature weights of the LPRec filters (ToMoBAR ``fourier.py``)."""
    N = len(t)
    s = np.linspace(1e-40, 1, n)
    iv = np.linalg.inv(np.exp(np.outer(np.arange(n), np.log(s))))
    powers = np.arange(1, n + 2)
    u = np.diff(np.exp(np.outer(powers, np.log(s))) / powers[:, None], axis=1)
    W1 = iv @ u[1 : n + 1, :]
    W2 = iv @ u[0:n, :]
    p = 1.0 / np.concatenate((np.arange(1, n), (n - 1) * np.ones(N - 2 * (n - 1) - 1),
                              np.arange(n - 1, 0, -1)))
    w = np.zeros(N)
    for j in range(N - n + 1):
        W = ((t[j + n - 1] - t[j]) ** 2) * W1 + (t[j + n - 1] - t[j]) * t[j] * W2
        w[j : j + n] += W @ p[j : j + n - 1]
    if N > 40:
        w[-40:] = w[-40] / (N - 40) * np.arange(N - 40, N)
    return w


def shepp_filter_half(n: int, cutoff: float = 1.0) -> np.ndarray:
    """The LPRec "shepp" filter on the rfft half-grid, float32."""
    d = 0.5
    t = np.arange(0, n // 2 + 1) / n
    wfa = n * cutoff * _wint(12, t) * np.sinc(t / (2 * d)) * (t / d <= 2)
    wfa = 2 * wfa * (wfa >= 0)
    wfa[0] *= 2
    return wfa.astype(np.float32)


def _filter_spectrum(ow: int, rotation_axis: float) -> np.ndarray:
    """The rfft half of the filter times the centre's phase ramp, with its
    DC and Nyquist bins real, complex64."""
    half = shepp_filter_half(ow).astype(np.float64)
    t = np.fft.rfftfreq(ow)
    w = half * np.exp(-2j * np.pi * t * rotation_axis)
    w[0], w[-1] = w[0].real, w[-1].real
    w = w.real.astype(np.float32) + 1j * w.imag.astype(np.float32)
    return w.astype(np.complex64)


def _grid(g: torch.Tensor, n: int, theta: np.ndarray, eps: float) -> torch.Tensor:
    """Gaussian gridding of the polar spectra g (pairs, nproj, n) complex
    onto (pairs, 2n, 2n), summed in float64."""
    mu = -np.log(eps) / (2 * n * n)
    m = int(np.ceil(2 * n / np.pi * np.sqrt(-mu * np.log(eps) + (mu * n) * (mu * n) / 4)))
    coeff0, coeff1 = np.float32(np.pi / mu), np.float32(-np.pi * np.pi / mu)
    clamp = np.float32(0.5 - 1e-5)
    cos_t = np.cos(theta).astype(np.float32)
    sin_t = np.sin(theta).astype(np.float32)
    c = (np.arange(n, dtype=np.float32) - n / 2) / n
    x0 = np.minimum(c[None, :] * cos_t[:, None], clamp)
    y0 = np.minimum(-c[None, :] * sin_t[:, None], clamp)
    dev = g.device
    ell0 = torch.as_tensor(np.floor(2 * n * x0).astype(np.int64).reshape(-1), device=dev)
    ell1 = torch.as_tensor(np.floor(2 * n * y0).astype(np.int64).reshape(-1), device=dev)
    x0 = torch.as_tensor(x0.reshape(-1), device=dev)
    y0 = torch.as_tensor(y0.reshape(-1), device=dev)
    two_n = 2 * n
    src = g.reshape(g.shape[0], -1).to(torch.complex128)
    grid = torch.zeros((g.shape[0], two_n * two_n), dtype=torch.complex128, device=dev)
    two_n_f = torch.tensor(float(two_n), dtype=torch.float32, device=dev)
    for i1 in range(2 * m + 1):
        l1 = ell1 - m + i1
        w1 = l1.to(torch.float32) / two_n_f - y0
        row = torch.remainder(l1 + n, two_n) * two_n
        for i0 in range(2 * m + 1):
            l0 = ell0 - m + i0
            w0 = l0.to(torch.float32) / two_n_f - x0
            w = float(coeff0) * torch.exp(float(coeff1) * (w0 * w0 + w1 * w1))
            grid.index_add_(1, row + torch.remainder(l0 + n, two_n), src * w.double())
    return grid.view(g.shape[0], two_n, two_n)


def fourier_inv(sino: torch.Tensor, theta: np.ndarray, cor: float, n: int,
                prec: str = "fp32") -> torch.Tensor:
    """FOURIER_INV of ``sino`` [detY (even), angles, detX = n (even)]."""
    q = rounder(prec)
    nz, nproj, data_n = sino.shape
    if nz % 2 or data_n % 2 or data_n != n:
        raise ValueError("the reference takes an even stack of even, unpadded rows")
    dev = sino.device
    eps = 1e-4
    mu = -np.log(eps) / (2 * n * n)
    ow = 2 ** math.ceil(math.log2(data_n * 3))
    pad_m = ow // 2 - data_n // 2
    x = torch.nn.functional.pad(q(sino), (pad_m, ow - data_n - pad_m), mode="replicate")
    w = torch.as_tensor(_filter_spectrum(ow, cor + 0.5), device=dev)
    x = torch.fft.irfft(torch.fft.rfft(x, dim=-1) * w, ow, dim=-1)
    filtered = q(x[:, :, ow // 2 - n // 2 : ow // 2 + n // 2])
    sign = torch.where(torch.arange(n, device=dev) % 2 == 1, 1.0, -1.0)
    packed = torch.complex(filtered[0::2] * sign, filtered[1::2] * sign)
    spectra = q(torch.fft.fft(packed, dim=-1) * (sign * (4.0 / n)))
    grid = _grid(spectra, n, -np.asarray(theta, np.float64), eps)
    i = torch.arange(2 * n, device=dev)
    checker = torch.where((i[:, None] + i[None, :]) % 2 == 1, -1.0, 1.0).double()
    ang = 2.0 * np.pi * (np.arange(2 * n) - n) * 0.5 / (2 * n)
    r = torch.as_tensor(np.exp(1j * ang), device=dev)
    grid = q(grid.to(torch.complex64)) * (checker * (r[:, None] * r[None, :])).to(torch.complex64)
    img = torch.fft.ifft2(grid) * checker.to(torch.float32)
    m0, p0 = n // 2 - n // 2, n // 2 + n // 2
    d = (-0.5 + np.arange(m0, p0, dtype=np.float32) / n)
    phi = np.exp(mu * n * n * (d[:, None] ** 2 + d[None, :] ** 2)) * (float(1 - n % 4) / nproj)
    win = img[:, n // 2 + m0 : n // 2 + p0, n // 2 + m0 : n // 2 + p0]
    win = win * torch.as_tensor(phi.astype(np.float32), device=dev)
    return q(torch.stack([win.real, win.imag], dim=1).reshape(nz, n, n).contiguous())
