"""Parallel-beam acquisition geometry for the TPU-native framework.

This replaces the reference's ASTRA vector-geometry plumbing
(``tomobar/astra_wrappers/astra_base.py`` and ``tomobar/supp/funcs.py:22-65``)
with a single static dataclass.  All geometry quantities (angles, centre of
rotation, detector sizes) are host-side numpy values: they are *static* with
respect to jit tracing, so the projector code can specialise on them (e.g.
partition angles into x-driven / y-driven sets at trace time).

Conventions (documented here once, used everywhere):

* Volume array ``vol[iz, iy, ix]`` with a square slice of size ``n``;
  world coordinates ``x = ix - (n - 1) / 2``, ``y = iy - (n - 1) / 2``
  (voxel centres, pixel size 1.0).
* Sinogram array ``sino[iz, iangle, it]`` (canonical axis order
  ``["detY", "angles", "detX"]`` exactly as the reference,
  ``tomobar/supp/dicts.py:50``).
* A detector cell ``it`` at angle ``theta`` integrates the volume along the
  line ``x*cos(theta) + y*sin(theta) = s`` with
  ``s = it - (det_x - 1)/2 + cor``, where ``cor`` is the centre-of-rotation
  offset (scalar or per-angle), mirroring the reference's detector-shift
  implementation of CoR correction (``supp/funcs.py:22-41``: the detector
  centre is displaced by ``+cor`` along the detector axis).

Ordered subsets use the same interleave as the reference
(``astra_base.py:195-209``): subset ``s`` takes angle indices
``s, s + OS, s + 2*OS, ...`` with the ragged tail dropped when the final
bin index stays at its zero initialisation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np

__all__ = ["Geometry", "os_subset_indices"]


def os_subset_indices(n_angles: int, os_number: int) -> List[np.ndarray]:
    """Interleaved ordered-subset angle indices.

    Replicates the reference's ``_setOS_indices`` (``astra_base.py:195-209``)
    including the "shrink last bin" behaviour used by the solvers
    (``methodsIR_CuPy.py:455-457``).
    """
    if os_number is None or os_number < 1:
        os_number = 1
    os_number = min(os_number, n_angles)
    # arange already produces the exact valid (shrunk-tail) set per subset,
    # matching the reference's "drop ragged last bin" bookkeeping.
    return [
        np.arange(s, n_angles, os_number, dtype=np.int64)
        for s in range(os_number)
    ]


@dataclass(frozen=True)
class Geometry:
    """Static parallel-beam geometry.

    Args:
        detectors_x: horizontal detector size (before padding).
        detectors_y: vertical detector size; 0 or None for 2D.
        angles: projection angles in radians, shape (n_angles,).
        center_rot_offset: CoR offset; scalar, (n_angles,) vector, or
            (n_angles, 2) array of [horizontal, vertical] per-angle offsets
            (mirrors ``_vec_geom_init3D``, ``supp/funcs.py:45-65``).
        recon_size: reconstructed slice size (recon is recon_size^2).
        detectors_x_pad: symmetric edge-padding amount for detX; when > 0 the
            reconstruction grid is enlarged to ``detectors_x + 2*pad`` and the
            result cropped back (reference ``methodsIR_CuPy.py:72-79``).
        os_number: number of ordered subsets (1 = no OS).
    """

    detectors_x: int
    detectors_y: Optional[int]
    angles: np.ndarray
    center_rot_offset: Union[float, np.ndarray] = 0.0
    recon_size: int = 0
    detectors_x_pad: int = 0
    os_number: int = 1

    def __post_init__(self):
        angles = np.asarray(self.angles, dtype=np.float64)
        object.__setattr__(self, "angles", angles)
        if self.detectors_y is None or self.detectors_y == 0:
            object.__setattr__(self, "detectors_y", 1)
        cor = self.center_rot_offset
        if cor is None:
            cor = 0.0
        cor = np.asarray(cor, dtype=np.float64)
        object.__setattr__(self, "center_rot_offset", cor)
        if self.recon_size == 0:
            object.__setattr__(self, "recon_size", self.detectors_x)
        os_n = self.os_number if self.os_number else 1
        object.__setattr__(self, "os_number", int(os_n))

    # ---- derived quantities -------------------------------------------------

    @property
    def n_angles(self) -> int:
        return int(self.angles.size)

    @property
    def detectors_x_total(self) -> int:
        """Horizontal detector size including the symmetric padding."""
        return self.detectors_x + 2 * self.detectors_x_pad

    @property
    def is_2d(self) -> bool:
        return self.detectors_y == 1

    @property
    def cor_horizontal(self) -> np.ndarray:
        """Per-angle horizontal CoR offset, shape (n_angles,)."""
        cor = self.center_rot_offset
        if cor.ndim == 0:
            return np.full(self.n_angles, float(cor))
        if cor.ndim == 1:
            return cor.astype(np.float64)
        return cor[:, 0].astype(np.float64)

    @property
    def cor_vertical(self) -> Optional[np.ndarray]:
        """Per-angle vertical CoR offset (or None if not provided)."""
        cor = self.center_rot_offset
        if cor.ndim == 2:
            return cor[:, 1].astype(np.float64)
        return None

    def os_indices(self) -> List[np.ndarray]:
        """The angle indices of each ordered subset (:func:`os_subset_indices`)."""
        return os_subset_indices(self.n_angles, self.os_number)

    def subset(self, indices: np.ndarray) -> "Geometry":
        """A new Geometry restricted to an angle subset (for OS solvers)."""
        cor = self.center_rot_offset
        if cor.ndim > 0:
            cor = cor[indices]
        return Geometry(
            detectors_x=self.detectors_x,
            detectors_y=self.detectors_y,
            angles=self.angles[indices],
            center_rot_offset=cor,
            recon_size=self.recon_size,
            detectors_x_pad=self.detectors_x_pad,
            os_number=1,
        )

    def with_recon_size(self, recon_size: int) -> "Geometry":
        """The same geometry with another reconstruction size."""
        return Geometry(
            detectors_x=self.detectors_x,
            detectors_y=self.detectors_y,
            angles=self.angles,
            center_rot_offset=self.center_rot_offset,
            recon_size=recon_size,
            detectors_x_pad=self.detectors_x_pad,
            os_number=self.os_number,
        )
