"""Automatic centre-of-rotation estimation, on the host.

A copy of ``tomobar_tpu/utils/center.py``; a tensor input (on any device)
gives up only the rows the estimate needs, which go to the host.  Its
default is the JAX package's estimator; ``stack=True`` removes that
estimator's bias toward zero on wide objects and averages the noise over a
stack's slices.

The reference leaves CoR as a user input (``CenterRotOffset``) and its
demos find it by manual sweeps; production pipelines around it (HTTomo)
bolt on external finders.  This module provides a built-in estimator so
the framework is self-sufficient:

* :func:`find_center_correlation` — parallel-beam identity
  ``p(theta + pi, t) = p(theta, -t)``: a projection and the mirrored
  opposite projection are displaced by exactly ``2 * cor``; the shift is
  recovered by FFT cross-correlation with sub-pixel parabolic
  refinement.  Fast (two rows), accurate to ~0.1 px on clean data.
Reconstruction-quality sweep scoring (entropy / negativity /
reprojection-residual variants) was prototyped and REJECTED: on shifted
phantoms every tested image metric turned out monotonic in the offset
rather than peaked at the true CoR (the circular mask's interaction
with the shifted object dominates the score), so a sweep would
confidently return garbage.  The correlation estimator needs no sweep:
it is exact up to interpolation for any [0, pi) parallel scan.

Returns the CoR in the framework's convention (the detector-shift
offset fed to ``CenterRotOffset`` / ``Geometry.center_rot_offset``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["find_center_correlation"]


def _subpixel_peak(c: np.ndarray) -> float:
    """Index of the parabola vertex through the max and its neighbours."""
    k = int(np.argmax(c))
    if k == 0 or k == len(c) - 1:
        return float(k)
    y0, y1, y2 = c[k - 1], c[k], c[k + 1]
    denom = y0 - 2.0 * y1 + y2
    if denom == 0.0:
        return float(k)
    return k + 0.5 * (y0 - y2) / denom


def _host_row(sino, i: int) -> np.ndarray:
    """Row ``i`` of a numpy or tensor sinogram as float64 numpy."""
    row = sino[i]
    if isinstance(row, torch.Tensor):
        row = row.detach().cpu().numpy()
    return np.asarray(row, dtype=np.float64)


def find_center_correlation(
    sino: np.ndarray,
    angles: Optional[np.ndarray] = None,
    search_radius: Optional[float] = None,
    stack: bool = False,
) -> float:
    """CoR from the 180-degree mirror identity.

    Args:
        sino: (angles, detX) sinogram, or (detY, angles, detX); a numpy
            array or a tensor.
        angles: projection angles in radians; when given, the pair of
            rows closest to a pi separation is used (otherwise first vs
            last row, correct for a [0, pi) endpoint=False scan).
        search_radius: optional clamp on |cor| in pixels (rejects false
            correlation peaks from periodic textures).
        stack: False (the default) is the JAX package's estimator: the
            middle detY slice, each row less its mean.  The mean is a
            pedestal that the zero padding turns into a triangle in the
            correlation, which pulls the peak toward lag 0, the more the
            wider the object (a 4.25 px offset of a 2560 px Shepp-Logan
            sinogram comes out as 2.93).  True correlates the rows as they
            are, which is right for flat-field-normalised data (zero
            background), and sums the correlations of every detY slice
            (one axis for the whole stack; the noise averages).

    Returns:
        The centre-of-rotation offset in pixels (detector-shift
        convention, may be fractional and negative).
    """
    if not isinstance(sino, torch.Tensor):
        sino = np.asarray(sino)
    if sino.ndim == 3 and not stack:
        sino = sino[sino.shape[0] // 2]
    if sino.ndim == 2:
        sino = sino[None]
    if sino.ndim != 3:
        raise ValueError("sino must be (angles, detX) or (detY, angles, detX)")
    _, n_ang, n = sino.shape

    if angles is not None and len(angles) == n_ang:
        a = np.asarray(angles, dtype=np.float64)
        # row pair whose separation is closest to pi
        j = int(np.argmin(np.abs((a - a[0]) - np.pi)))
        if j == 0:
            j = n_ang - 1
    else:
        j = n_ang - 1

    # FFT cross-correlation, zero-padded to avoid circular wrap
    m = 2 * n
    corr = 0.0
    for rows in sino:
        row0, row1 = (_host_row(rows, i) for i in (0, j))
        p0, p1 = row0, row1[::-1]
        if not stack:
            p0 = row0 - row0.mean()
            p1 = row1[::-1] - row1.mean()
        f0 = np.fft.rfft(p0, m)
        f1 = np.fft.rfft(p1, m)
        corr = corr + np.fft.irfft(f0 * np.conj(f1), m)
    corr = np.concatenate([corr[-(n - 1):], corr[:n]])  # lags -(n-1)..n-1
    lags = np.arange(-(n - 1), n, dtype=np.float64)
    if search_radius is not None:
        mask = np.abs(lags) <= 2.0 * search_radius + 1.0
        corr = np.where(mask, corr, -np.inf)
    shift = _subpixel_peak(corr) - (n - 1)
    # p1 is p0 displaced by 2*cor along the detector: mirror of
    # x cos + y sin = t - (n-1)/2 + cor about the rotation axis
    return float(-shift / 2.0)
