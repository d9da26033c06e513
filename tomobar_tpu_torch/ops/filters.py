"""FBP filters on PyTorch tensors: the custom sinc filter, the classic
filter bank and the LPRec filter bank of FOURIER_INV.

Counterpart of ``tomobar_tpu/ops/filters.py``.  The filter synthesis is
host numpy (float64, cast to float32), copied from the JAX package so both
build identical tables.  ``filter_sino_sinc``/``filter_sino_classic`` apply
a filter along detX: on a CUDA tensor through
:func:`tomobar_tpu_torch.ops.fft_real.apply_freq_filter_real` (the fused
axis-(-2) F kernel where the size allows, as on the TPU), on a CPU tensor
through ``torch.fft.rfft``/``irfft`` (as the JAX package on a CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from tomobar_tpu_torch.ops.fft_real import apply_freq_filter_real

__all__ = [
    "sinc_filter_half",
    "filter_sino_sinc",
    "filter_sino_classic",
    "classic_filter_half",
    "hermitian_extend_real",
    "calc_filter_np",
    "calc_filter",
    "FILTER_TYPES",
    "CLASSIC_FILTER_TYPES",
]

# input bytes of one pass of the CUDA filter route (its temporaries are a few
# times that)
FILTER_CHUNK_BYTES = 2**30

FILTER_TYPES = (
    "none",
    "ramp",
    "shepp",
    "cosine",
    "cosine2",
    "hamming",
    "hann",
    "parzen",
)


def sinc_filter_half(n: int, a: float, multiplier: float = 1.0) -> np.ndarray:
    """rfft-half sinc filter of length n//2+1 (static numpy, float32).

    Matches ``generate_filtersync.cu``: the full filter is evaluated on
    ``w = -pi + k*2*pi/n`` and written to ifftshifted positions, of which the
    rfft half ``[0, n//2]`` is kept.  ``multiplier`` folds FFT scaling.
    """
    w = -np.pi + np.arange(n) * (2 * np.pi / n)
    rd = a * w / 2.0
    rn2 = np.sin(rd)
    dot = float(np.dot(rn2, rd) / np.dot(rd, rd))
    r = np.abs(2.0 / a * rn2) * dot * dot
    full = np.fft.ifftshift(r)
    return (full[: n // 2 + 1] * multiplier).astype(np.float32)


def hermitian_extend_real(half: np.ndarray, n: int) -> np.ndarray:
    """Full-length (n,) spectrum of a REAL half filter (length n//2+1):
    mirror the positive frequencies onto the negative half."""
    full = np.empty(n, dtype=np.float32)
    full[: n // 2 + 1] = half
    full[n // 2 + 1 :] = half[1 : (n + 1) // 2][::-1]
    return full


def _apply_half_filter(sino: torch.Tensor, half: np.ndarray) -> torch.Tensor:
    """Filter the rows of ``sino`` along detX by the real rfft-half filter
    ``half``: rfft/irfft on the CPU, the split pair-packed route on CUDA."""
    det_x = sino.shape[-1]
    if sino.device.type == "cpu":
        spec = torch.fft.rfft(sino, dim=-1) * torch.from_numpy(half)
        return torch.fft.irfft(spec, det_x, dim=-1).to(sino.dtype)
    full = torch.as_tensor(hermitian_extend_real(half, det_x), device=sino.device)
    squeeze = sino.dim() == 2
    x = sino[None] if squeeze else sino
    # slices are filtered independently: a deep stack goes by in runs of
    # slices of at most FILTER_CHUNK_BYTES, which bounds the temporaries
    step = max(FILTER_CHUNK_BYTES // max(4 * x.shape[1] * x.shape[2], 1), 1)
    if step >= x.shape[0]:
        out = apply_freq_filter_real(x, full)
    else:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        for z0 in range(0, x.shape[0], step):
            out[z0 : z0 + step] = apply_freq_filter_real(x[z0 : z0 + step], full)
    return (out[0] if squeeze else out).to(sino.dtype)


def filter_sino_sinc(sino: torch.Tensor, cutoff: float = 0.35) -> torch.Tensor:
    """Apply the sinc FBP filter along the last (detX) axis, with the
    1/n_angles scaling folded in.  Operates on the canonical
    ``(detY, angles, detX)`` or ``(angles, detX)`` layout."""
    half = sinc_filter_half(sino.shape[-1], cutoff, 1.0 / sino.shape[-2])
    return _apply_half_filter(sino, half)


CLASSIC_FILTER_TYPES = (
    "ram-lak",
    "shepp-logan",
    "cosine",
    "hamming",
    "hann",
    "tukey",
    "lanczos",
    "triangular",
    "gaussian",
    "blackman",
    "nuttall",
    "blackman-harris",
    "blackman-nuttall",
    "flat-top",
    "kaiser",
    "parzen",
    "none",
)

# cosine-sum window coefficients a_k, window(nu) = sum_k a_k cos(k*pi*nu)
_COSINE_SUM = {
    "blackman": (0.42, 0.5, 0.08),
    "nuttall": (0.355768, 0.487396, 0.144232, 0.012604),
    "blackman-harris": (0.35875, 0.48829, 0.14128, 0.01168),
    "blackman-nuttall": (0.3635819, 0.4891775, 0.1365995, 0.0106411),
    "flat-top": (0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368),
}


def classic_filter_half(
    n: int,
    filter_type: str = "ram-lak",
    filter_parameter: float | None = None,
    filter_d: float = 1.0,
    multiplier: float = 1.0,
) -> np.ndarray:
    """Classic FBP filter bank on the rfft half-grid (length n//2+1).

    The filter is ``ramp(nu) * window(nu)`` with ``nu = k/(n/2)`` the
    Nyquist-normalised frequency and ``ramp = pi * rfft(h)`` the discrete
    Ram-Lak ramp (reaching pi/2 at Nyquist), cut off at ``nu > filter_d``.
    ``multiplier`` folds the 1/n_angles back-projection scaling.
    """
    if filter_type not in CLASSIC_FILTER_TYPES:
        raise ValueError(
            f"Unknown filter '{filter_type}', choose one of {CLASSIC_FILTER_TYPES}"
        )
    nu = np.arange(n // 2 + 1) / max(n // 2, 1)
    # discrete ramp: DFT of the band-limited spatial Ram-Lak kernel
    # h[0]=1/4, h[odd]=-1/(pi k)^2 (Kak & Slaney eq. 61), scaled by pi
    h = np.zeros(n)
    k = np.arange(1, n // 2 + 1)
    h[0] = 0.25
    h[k[::2]] = -1.0 / (np.pi * k[::2]) ** 2
    h[-k[::2]] = -1.0 / (np.pi * k[::2]) ** 2
    ramp = np.pi * np.real(np.fft.rfft(h))
    if filter_type == "none":
        win = np.ones_like(nu)
    elif filter_type == "ram-lak":
        win = np.ones_like(nu)
    elif filter_type == "shepp-logan":
        win = np.sinc(nu / 2.0)
    elif filter_type == "cosine":
        win = np.cos(np.pi * nu / 2.0)
    elif filter_type == "hamming":
        alpha = 0.54 if filter_parameter is None else float(filter_parameter)
        win = alpha + (1.0 - alpha) * np.cos(np.pi * nu)
    elif filter_type == "hann":
        win = 0.5 * (1.0 + np.cos(np.pi * nu))
    elif filter_type == "tukey":
        alpha = 0.5 if filter_parameter is None else float(filter_parameter)
        alpha = min(max(alpha, 1e-6), 1.0)
        win = np.where(
            nu <= 1.0 - alpha,
            1.0,
            0.5 * (1.0 + np.cos(np.pi * (nu - (1.0 - alpha)) / alpha)),
        )
    elif filter_type == "lanczos":
        win = np.sinc(nu)
    elif filter_type == "triangular":
        win = 1.0 - nu
    elif filter_type == "gaussian":
        sigma = 0.4 if filter_parameter is None else float(filter_parameter)
        win = np.exp(-(nu**2) / (2.0 * sigma**2))
    elif filter_type == "kaiser":
        beta = 3.0 if filter_parameter is None else float(filter_parameter)
        win = np.i0(beta * np.sqrt(np.clip(1.0 - nu**2, 0.0, None))) / np.i0(beta)
    elif filter_type == "parzen":
        win = np.where(
            nu <= 0.5,
            1.0 - 6.0 * nu**2 * (1.0 - nu),
            2.0 * (1.0 - np.clip(nu, None, 1.0)) ** 3,
        )
    else:
        # centred cosine-sum form: the (-1)^k of centring cancels the
        # alternating signs of the published a_k
        a = _COSINE_SUM[filter_type]
        win = sum(ak * np.cos(k * np.pi * nu) for k, ak in enumerate(a))
    half = ramp * win * (nu <= filter_d)
    return (half * multiplier).astype(np.float32)


def filter_sino_classic(
    sino: torch.Tensor,
    filter_type: str = "ram-lak",
    filter_parameter: float | None = None,
    filter_d: float = 1.0,
) -> torch.Tensor:
    """Apply a classic-bank FBP filter along the last (detX) axis, with the
    1/n_angles scaling folded in (same convention as ``filter_sino_sinc``)."""
    half = classic_filter_half(
        sino.shape[-1], filter_type, filter_parameter, filter_d,
        1.0 / sino.shape[-2],
    )
    return _apply_half_filter(sino, half)


def _wint(n: int, t: np.ndarray) -> np.ndarray:
    """Quadrature weights for higher-order integral discretisation
    (``tomobar/fourier.py:81-108``): degree-(n-1) polynomials through
    sliding windows of n frequency samples, integrated exactly, overlapping
    windows weighted by 1/overlap-count; the last 40 samples become a
    linear ramp to suppress endpoint ringing."""
    N = len(t)
    s = np.linspace(1e-40, 1, n)
    # inverse Vandermonde on the log grid
    iv = np.linalg.inv(np.exp(np.outer(np.arange(n), np.log(s))))
    # integrals of x^k over short intervals, k = 1..n+1 (for x*p) and 0..n (p)
    powers = np.arange(1, n + 2)
    u = np.diff(
        np.exp(np.outer(powers, np.log(s))) / powers[:, None], axis=1
    )
    W1 = iv @ u[1 : n + 1, :]  # x*p_n(x) term
    W2 = iv @ u[0:n, :]  # const*p_n(x) term

    # overlap compensation: interior windows overlap (n-1)-fold
    ramp_up = np.arange(1, n)
    flat = (n - 1) * np.ones(N - 2 * (n - 1) - 1)
    ramp_down = np.arange(n - 1, 0, -1)
    p = 1.0 / np.concatenate((ramp_up, flat, ramp_down))
    w = np.zeros(N)
    for j in range(N - n + 1):
        W = ((t[j + n - 1] - t[j]) ** 2) * W1 + (t[j + n - 1] - t[j]) * t[j] * W2
        w[j : j + n] += W @ p[j : j + n - 1]

    if N > 40:
        w[-40:] = w[-40] / (N - 40) * np.arange(N - 40, N)
    return w


def calc_filter_np(
    n: int, filter_type: str = "shepp", cutoff_freq: float = 1.0
) -> np.ndarray:
    """LPRec filter bank on the rfft half-grid (length n//2+1), float32,
    with the apodisation windows and the doubled DC term of
    ``tomobar/fourier.py:111-159``."""
    if filter_type not in FILTER_TYPES:
        raise ValueError(
            f"Unknown filter '{filter_type}', choose one of {FILTER_TYPES}"
        )
    d = 0.5
    t = np.arange(0, n // 2 + 1) / n

    if filter_type == "none":
        wfa = n * cutoff_freq + t * 0
        return np.asarray(wfa, dtype=np.float32)
    base = n * cutoff_freq * _wint(12, t)
    if filter_type == "ramp":
        wfa = base
    elif filter_type == "shepp":
        wfa = base * np.sinc(t / (2 * d)) * (t / d <= 2)
    elif filter_type == "cosine":
        wfa = base * np.cos(np.pi * t / (2 * d)) * (t / d <= 1)
    elif filter_type == "cosine2":
        wfa = base * (np.cos(np.pi * t / (2 * d))) ** 2 * (t / d <= 1)
    elif filter_type == "hamming":
        wfa = base * (0.54 + 0.46 * np.cos(np.pi * t / d)) * (t / d <= 1)
    elif filter_type == "hann":
        wfa = base * (1 + np.cos(np.pi * t / d)) / 2.0 * (t / d <= 1)
    elif filter_type == "parzen":
        wfa = base * pow(1 - t / d, 3) * (t / d <= 1)
    else:
        raise ValueError(
            f"Unknown filter '{filter_type}', choose one of {FILTER_TYPES}"
        )

    wfa = 2 * wfa * (wfa >= 0)
    wfa[0] *= 2
    return np.asarray(wfa, dtype=np.float32)


def calc_filter(
    n: int, filter_type: str = "shepp", cutoff_freq: float = 1.0, device=None
) -> torch.Tensor:
    """:func:`calc_filter_np` as a float32 tensor (on ``device``)."""
    return torch.as_tensor(calc_filter_np(n, filter_type, cutoff_freq), device=device)
