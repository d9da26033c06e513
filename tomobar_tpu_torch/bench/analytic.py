"""The closed-form Radon transform of ellipses: a check of the projector,
FBP and FOURIER_INV against exact mathematics rather than against another
implementation.

An ellipse of value ``v``, semi-axes ``(a, b)``, centre ``(x0, y0)`` and
tilt ``phi`` projects at angle ``theta`` onto detector coordinate ``s`` as

    p(s) = 2 v a b / w^2 * sqrt(w^2 - (s - s0)^2),
    w^2  = a^2 cos^2(theta - phi) + b^2 sin^2(theta - phi),
    s0   = x0 cos(theta) + y0 sin(theta),

with the package's line convention ``x cos(theta) + y sin(theta) = s`` and
``s = it - (det_x - 1)/2 + cor`` (:mod:`tomobar_tpu_torch.geometry`).  A
negated angle, a mirrored detector or a centre offset of the wrong sign
moves the discrete projection away from this by an order of magnitude more
than the rasterised edges do, so the match pins those conventions; the
flat interior of the unit ellipse pins FBP's and FOURIER_INV's absolute
amplitude, and the reconstruction beating its own 1-pixel shifts pins their
registration on the grid.

The ellipses and masks are given at n = 256 (:data:`ELLIPSES`) and scaled
to any n by :func:`scaled`.  Numpy only: the tests and ``chip_smoke.py``
both use it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "BASE_N",
    "ELLIPSES",
    "FOURIER_INV_SCALE",
    "scaled",
    "ellipse_phantom",
    "ellipse_sinogram",
    "flat_interior_mask",
    "incircle_mask",
    "rel_l2",
    "rel_rmse",
    "shift_rmse",
]

Ellipse = Tuple[float, float, float, float, float, float]

#: the size at which :data:`ELLIPSES` and the masks are given
BASE_N = 256
#: (value, semi_a, semi_b, x0, y0, phi) in pixels at n = 256: a unit
#: ellipse with a positive and a negative insert
ELLIPSES: Tuple[Ellipse, ...] = (
    (1.0, 80.0, 110.0, 0.0, 0.0, 0.0),
    (0.5, 30.0, 50.0, 40.0, -20.0, float(np.deg2rad(30.0))),
    (-0.3, 20.0, 20.0, -50.0, 35.0, 0.0),
)
#: FOURIER_INV's documented amplitude: 8/pi times the object's
FOURIER_INV_SCALE = 8.0 / np.pi


def scaled(ellipses: Sequence[Ellipse], n: int, value: float = 1.0) -> Tuple[Ellipse, ...]:
    """``ellipses``, given at n = 256, at size ``n``: semi-axes and centres
    times n / 256, each value times ``value``, tilts kept."""
    f = n / BASE_N
    return tuple((v * value, a * f, b * f, x0 * f, y0 * f, phi)
                 for v, a, b, x0, y0, phi in ellipses)


def _grid(n: int):
    """World coordinates ``(x, y)`` of the voxel centres of an n x n slice."""
    c = (n - 1) / 2.0
    iy, ix = np.mgrid[0:n, 0:n]
    return ix - c, iy - c


def ellipse_phantom(n: int, ellipses: Sequence[Ellipse]) -> np.ndarray:
    """The ellipses rasterised on an n x n slice (a voxel takes an ellipse's
    value when its centre lies inside), float32 ``[n, n]``."""
    x, y = _grid(n)
    ph = np.zeros((n, n), np.float64)
    for v, a, b, x0, y0, phi in ellipses:
        xr = (x - x0) * np.cos(phi) + (y - y0) * np.sin(phi)
        yr = -(x - x0) * np.sin(phi) + (y - y0) * np.cos(phi)
        ph[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += v
    return ph.astype(np.float32)


def ellipse_sinogram(angles, n: int, ellipses: Sequence[Ellipse],
                     cor: float = 0.0) -> np.ndarray:
    """The continuous Radon transform of ``ellipses`` sampled at ``n``
    detector cells per angle, offset by ``cor``: float32 ``[angles, n]``,
    computed in float64."""
    th = np.asarray(angles, np.float64)[:, None]
    s = np.arange(n) - (n - 1) / 2.0 + cor
    out = np.zeros((th.shape[0], n))
    for v, a, b, x0, y0, phi in ellipses:
        s0 = x0 * np.cos(th) + y0 * np.sin(th)
        w2 = a**2 * np.cos(th - phi) ** 2 + b**2 * np.sin(th - phi) ** 2
        d2 = np.maximum(w2 - (s - s0) ** 2, 0.0)
        out += 2.0 * v * a * b / w2 * np.sqrt(d2)
    return out.astype(np.float32)


def flat_interior_mask(n: int) -> np.ndarray:
    """The interior of the big ellipse away from its edge and from both
    inserts (the 256-pixel masks scaled to ``n``): the phantom equals the
    big ellipse's value there."""
    x, y = _grid(n)
    x, y = x * (BASE_N / n), y * (BASE_N / n)
    m = (x**2 / 40.0**2 + y**2 / 60.0**2) <= 1.0
    m &= ~(((x - 40.0) ** 2 / 35.0**2 + (y + 20.0) ** 2 / 55.0**2) <= 1.0)
    m &= ~(((x + 50.0) ** 2 / 25.0**2 + (y - 35.0) ** 2 / 25.0**2) <= 1.0)
    return m


def incircle_mask(n: int) -> np.ndarray:
    """Voxels within 0.45 n of the centre of an n x n slice."""
    x, y = _grid(n)
    return np.hypot(x, y) < 0.45 * n


def rel_l2(got, ref) -> float:
    """``||got - ref|| / ||ref||`` in float64."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def rel_rmse(rec, truth, mask) -> float:
    """RMSE of ``rec`` against ``truth`` inside ``mask``, over the RMS of
    ``truth`` there, in float64."""
    rec, truth = np.asarray(rec, np.float64)[mask], np.asarray(truth, np.float64)[mask]
    return float(np.sqrt(np.mean((rec - truth) ** 2)) / np.sqrt(np.mean(truth**2)))


def shift_rmse(rec, truth, mask) -> Tuple[float, dict]:
    """The RMSE of ``rec`` against ``truth`` inside ``mask``, and of each of
    its four 1-pixel shifts ``{(dy, dx): rmse}``: a reconstruction on the
    right grid beats every shift."""
    rec, truth = np.asarray(rec, np.float64), np.asarray(truth, np.float64)

    def rmse(r):
        return float(np.sqrt(np.mean((r[mask] - truth[mask]) ** 2)))

    shifts = {d: rmse(np.roll(rec, d, axis=(0, 1))) for d in ((1, 0), (-1, 0), (0, 1), (0, -1))}
    return rmse(rec), shifts
