"""Carry problems across from the JAX package ``tomobar_tpu``.

Both functions are duck-typed on what the JAX package produces (its
``Geometry`` and numpy copies of its arrays), so this module imports
neither jax nor ``tomobar_tpu``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from tomobar_tpu_torch.geometry import Geometry

__all__ = ["geometry_from_reference", "tensor_from_reference"]

_LAYOUTS = {
    "sinogram": ("detY", "angles", "detX"),
    "volume": ("nz", "ny", "nx"),
}


def geometry_from_reference(obj) -> Geometry:
    """The port's :class:`Geometry` for any object with the fields of the
    JAX package's ``Geometry``."""
    return Geometry(
        detectors_x=int(obj.detectors_x),
        detectors_y=int(obj.detectors_y),
        angles=np.asarray(obj.angles, dtype=np.float64),
        center_rot_offset=np.asarray(obj.center_rot_offset, dtype=np.float64),
        recon_size=int(obj.recon_size),
        detectors_x_pad=int(obj.detectors_x_pad),
        os_number=int(obj.os_number),
    )


def tensor_from_reference(
    array, layout: str, device: Union[str, torch.device] = "cpu"
) -> torch.Tensor:
    """A float32 tensor on ``device`` from a numpy array in one of the JAX
    package's canonical layouts: ``"sinogram"`` ``[detY, angles, detX]`` or
    ``"volume"`` ``[nz, ny, nx]`` (also for warm starts passed as
    ``_algorithm_["initialise"]``)."""
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(_LAYOUTS)}, got {layout!r}")
    arr = np.asarray(array)
    if arr.ndim != 3:
        raise ValueError(
            f"{layout} must be 3D {list(_LAYOUTS[layout])}, got shape {arr.shape}"
        )
    if not np.issubdtype(arr.dtype, np.floating):
        raise TypeError(f"{layout} must be floating point, got {arr.dtype}")
    if layout == "volume" and arr.shape[1] != arr.shape[2]:
        raise ValueError(f"volume slices must be square, got shape {arr.shape}")
    # torch.tensor copies, so a read-only numpy view is never aliased
    return torch.tensor(arr.astype(np.float32), device=torch.device(device))
