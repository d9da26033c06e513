"""Dynamic flat-field correction (PCA eigen-flat-fields), on the host.

A copy of ``tomobar_tpu/utils/dffc.py`` (numpy and scipy; the card takes no
part: one BFGS fit per projection).  Equivalent of the reference's ``_DFFC`` (``tomobar/supp/suppTools.py:44-184``,
after V. Van Nieuwenhove et al., "Dynamic intensity normalization using
eigen flat fields in X-ray imaging"): parallel-analysis selection of the
number of principal components of the flat-field stack, per-projection
weight fitting by minimising the total variation of the corrected
projection.

Differences from the reference (documented):
* eigen-flat-field denoising uses a separable Gaussian blur instead of BM3D
  (the bm3d package is an optional dependency the reference also only
  soft-imports); pass ``denoise_fn`` to plug in anything better.
* the BFGS weight fit uses scipy (same as the reference).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["dynamic_flatfield_correction"]


def _downscale_local_mean(img: np.ndarray, factor: int) -> np.ndarray:
    """Block-mean downscale (replaces skimage.transform.downscale_local_mean)."""
    if factor <= 1:
        return img
    h, w = img.shape
    hp, wp = -(-h // factor) * factor, -(-w // factor) * factor
    padded = np.zeros((hp, wp), dtype=np.float64)
    padded[:h, :w] = img
    return padded.reshape(hp // factor, factor, wp // factor, factor).mean(
        axis=(1, 3)
    )


def _gaussian_blur(img: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, sigma)


def wavelet_denoise(img: np.ndarray, levels: int = 4) -> np.ndarray:
    """Haar wavelet soft-threshold denoiser for eigen-flat-fields.

    A stronger edge-preserving built-in alternative to the separable
    Gaussian (the reference uses BM3D when installed,
    ``suppTools.py:44-184``; BM3D is unavailable here).  Reuses the
    framework's multi-level Haar shrinkage
    (:func:`tomobar_tpu_torch.regularisers_legacy.WAVELET_SHRINK`, run on
    the CPU); the noise sigma comes from the robust MAD of first differences (finest-scale
    detail), so the threshold adapts to each eigen-flat-field's scale.
    The 1.25*sigma multiplier is calibrated for WAVELET_SHRINK's
    averaging (non-orthonormal) Haar normalisation, where detail
    coefficients carry sigma/sqrt(2) noise per level — the orthonormal
    VisuShrink ``sqrt(2 log n)`` factor over-thresholds it ~3x (measured
    error minimum at 1.0-1.5*sigma on noisy smooth fields).
    """
    import torch

    from tomobar_tpu_torch.regularisers_legacy import WAVELET_SHRINK

    x = np.asarray(img, np.float32)
    d = np.diff(x, axis=-1).ravel()
    sigma = np.median(np.abs(d - np.median(d))) / 0.6745 / np.sqrt(2.0)
    thr = float(1.25 * sigma)
    if thr <= 0.0 or not np.isfinite(thr):
        return x
    return WAVELET_SHRINK(torch.from_numpy(x), thr, levels).numpy()


def _parallel_analysis(flat_fields: np.ndarray, repetitions: int, rng):
    """Select the number of significant principal components by comparing
    eigenvalues of the data covariance to those of matched random noise."""
    std_eff = np.std(flat_fields, axis=0, ddof=1, dtype=np.float64)
    H, W = flat_fields.shape
    keep = np.zeros((H, repetitions), dtype=np.float64)
    for i in range(repetitions):
        sample = std_eff * rng.standard_normal((H, W))
        keep[:, i] = np.linalg.eigvals(np.cov(sample)).real
    centred = flat_fields - np.mean(flat_fields, axis=0)
    d, v = np.linalg.eig(np.cov(centred))
    d = d.real
    v = v.real
    threshold = keep.mean(axis=1) + 2 * keep.std(axis=1, ddof=1)
    return v, d, int(np.sum(d > threshold))


def dynamic_flatfield_correction(
    data: np.ndarray,
    flats: np.ndarray,
    darks: np.ndarray,
    downsample: int = 2,
    n_pa_repetitions: int = 10,
    denoise_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    seed: int = 0,
):
    """Returns [corrected_data, eigen_flat_fields, denoised_EFFs].

    data/flats layout: [detY, angles/frames, detX] (reference convention).
    """
    import scipy.optimize

    rng = np.random.default_rng(seed)
    if denoise_fn is None:
        denoise_fn = _gaussian_blur

    mean_dark = np.mean(darks, axis=1, dtype=np.float64)
    H, n_flats, W = flats.shape
    white = np.zeros((n_flats, H * W), dtype=np.float64)
    for i in range(n_flats):
        white[i] = flats[:, i, :].ravel() - mean_dark.ravel()
    mn = white.mean(axis=0)
    centred = white - mn

    # The reference retries parallel analysis until a component passes
    # (``suppTools.py:94-97`` — an unbounded loop that can spin forever
    # on noise-dominated flat stacks where the threshold, built from the
    # per-pixel std that already CONTAINS the structured variation, never
    # admits a component).  Consciously fixed: bounded retries, then fall
    # back to the single largest principal component.
    n_eff = 0
    for _ in range(20):
        v, d, n_eff = _parallel_analysis(centred, n_pa_repetitions, rng)
        if n_eff > 0:
            break
    if n_eff <= 0:
        print(
            "Parallel analysis selected no components after 20 tries; "
            "falling back to the largest principal component."
        )
        n_eff = 1
    order = d.argsort()[::-1]
    v = v[:, order]

    eff = np.zeros((n_eff + 1, H, W))
    eff[0] = mn.reshape(H, W)
    for i in range(n_eff):
        eff[i + 1] = (centred.T @ v[:, i]).reshape(H, W)

    eff_denoised = eff.copy()
    for i in range(1, n_eff + 1):
        lo, hi = eff_denoised[i].min(), eff_denoised[i].max()
        scale = hi - lo if hi > lo else 1.0
        normed = (eff_denoised[i] - lo) / scale
        eff_denoised[i] = denoise_fn(normed) * scale + lo

    def cost(x, projection, mean_ff, ffs, dark):
        ff_eff = np.tensordot(x, ffs, axes=1)
        log_corr = (projection - dark) / (mean_ff + ff_eff) * np.mean(
            mean_ff + ff_eff
        )
        gx, gy = np.gradient(log_corr)
        return np.sum(np.sqrt(gx**2 + gy**2))

    H2, n_proj, W2 = data.shape
    corrected = np.zeros((H2, n_proj, W2), dtype=np.float64)
    mean_ff = eff_denoised[0]
    ffs = eff_denoised[1:]
    mean_ff_ds = _downscale_local_mean(mean_ff, downsample)
    ffs_ds = np.stack([_downscale_local_mean(f, downsample) for f in ffs])
    dark_ds = _downscale_local_mean(mean_dark, downsample)
    for i in range(n_proj):
        proj = data[:, i, :]
        proj_ds = _downscale_local_mean(proj, downsample)
        res = scipy.optimize.minimize(
            cost,
            np.zeros(n_eff),
            args=(proj_ds, mean_ff_ds, ffs_ds, dark_ds),
            method="BFGS",
            tol=1e-8,
        )
        ff_eff = np.tensordot(res.x, ffs, axes=1)
        corrected[:, i, :] = (proj - mean_dark) / (mean_ff + ff_eff)

    return [corrected, eff, eff_denoised]
