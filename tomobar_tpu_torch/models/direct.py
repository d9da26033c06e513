"""Direct reconstruction classes (FBP, Fourier methods) on PyTorch tensors.

Counterpart of ``tomobar_tpu/models/direct.py`` (reference ``RecToolsDIR``,
``tomobar/methodsDIR.py:18``, and ``RecToolsDIRCuPy``,
``tomobar/methodsDIR_CuPy.py:26``).  Both classes run on one torch device;
``RecToolsDIR`` returns numpy arrays and ``RecToolsDIRTPU`` (alias
``RecToolsDIRCuPy``) returns tensors on its device.

Ported: 2D and 3D ``FBP``, ``FORWPROJ`` and ``BACKPROJ`` (2D runs the
packed nz = 1 projector kernels K1p/K4p), 2D ``FOURIER`` and
``FOURIER_INV`` (3D, and 2D promoted to detY = 1).  The shape-only memory
estimate of ``FOURIER_INV`` waits for the memory estimator (ROADMAP.md).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.models.iterative import _to_device
from tomobar_tpu_torch.ops.filters import filter_sino_classic, filter_sino_sinc
from tomobar_tpu_torch.ops.projector import Projector
from tomobar_tpu_torch.ops.usfft import fourier_inv
from tomobar_tpu_torch.utils.tools import (
    apply_horiz_detector_padding,
    check_kwargs,
    data_dims_swapper,
)

__all__ = ["RecToolsDIR", "RecToolsDIRTPU"]


def _labels(ndim: int):
    return ["angles", "detX"] if ndim == 2 else ["detY", "angles", "detX"]


class RecToolsDIR:
    """Direct reconstruction: forward/back projection, FBP, Fourier recon.

    Args mirror the reference constructor (``methodsDIR.py:32-69``):
        DetectorsDimH: horizontal detector dimension.
        DetectorsDimH_pad: symmetric horizontal detector padding.
        DetectorsDimV: vertical detector dimension (0/None for 2D).
        CenterRotOffset: CoR offset scalar or per-angle vector.
        AnglesVec: projection angles in radians.
        ObjSize: reconstructed slice size.
        projector: accepted for API compatibility and ignored.
        device_projector: index of the CUDA device used by default (the
            reference's "gpu" string means device 0).
        device: the torch device to run on; defaults to
            ``torch.device("cuda", device_projector)``.  The CPU is used
            only when asked for (``device="cpu"``); asking for CUDA on a
            machine without it raises.
    """

    #: whether public methods return numpy arrays (host) or tensors (device)
    _return_numpy = True

    def __init__(
        self,
        DetectorsDimH,
        DetectorsDimH_pad,
        DetectorsDimV,
        CenterRotOffset,
        AnglesVec,
        ObjSize,
        projector: str = "astra",
        device_projector: Union[int, str] = "gpu",
        device: Union[str, torch.device, None] = None,
    ):
        del projector
        if device is None:
            index = device_projector if isinstance(device_projector, int) else 0
            device = torch.device("cuda", index)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: device {self.device} requested but "
                "CUDA is not available (pass device='cpu' to run on the CPU)"
            )
        if CenterRotOffset is None:
            CenterRotOffset = 0.0
        self.geom = Geometry(
            detectors_x=int(DetectorsDimH),
            detectors_y=None if not DetectorsDimV else int(DetectorsDimV),
            angles=np.asarray(AnglesVec),
            center_rot_offset=CenterRotOffset,
            recon_size=int(ObjSize),
            detectors_x_pad=int(DetectorsDimH_pad),
        )
        self.geom_detY = self.geom.is_2d is False  # 3D: a vertical detector
        self.detectors_x_pad = self.geom.detectors_x_pad
        self.angles_vec = self.geom.angles
        self.centre_of_rotation = CenterRotOffset
        self.recon_size = self.geom.recon_size
        self.Atools = Projector(self.geom)
        self.geom_label = "2D" if self.geom.is_2d else "3D"

    # -- helpers -------------------------------------------------------------

    def _out(self, x: torch.Tensor):
        return x.cpu().numpy() if self._return_numpy else x

    # -- public API ----------------------------------------------------------

    def FORWPROJ(self, data, **kwargs):
        """Forward projection of a 2D ``[ny, nx]`` or 3D ``[nz, ny, nx]``
        object.  Output canonical order ``["angles", "detX"]`` (2D) or
        ``["detY", "angles", "detX"]`` (3D), reorderable via
        ``data_axes_labels_order``."""
        projected = self.Atools.fp(_to_device(data, self.device))
        order = kwargs.get("data_axes_labels_order")
        if order is not None:
            projected = data_dims_swapper(projected, order, _labels(projected.dim()))
        return self._out(projected)

    def BACKPROJ(self, data, **kwargs):
        """Back-projection of 2D ``[angles, detX]`` or 3D
        ``[detY, angles, detX]`` projection data."""
        data = _to_device(data, self.device)
        order = kwargs.get("data_axes_labels_order")
        if order is not None:
            data = data_dims_swapper(data, order, _labels(data.dim()))
        data = apply_horiz_detector_padding(data, self.detectors_x_pad)
        return self._out(self.Atools.bp(data))

    def FBP(self, data, **kwargs):
        """Filtered back-projection of 2D data ``["angles", "detX"]`` or of
        3D data, canonical order ``["angles", "detY", "detX"]``
        (``methodsDIR_CuPy.py:123``), with the custom sinc filter
        (``cutoff_freq``, default 1.1 in 2D as the reference's host 2D path,
        ``methodsDIR.py:297``, and 0.35 in 3D) or, when ``filter_type`` is
        given, a classic filter with optional ``filter_parameter``/
        ``filter_d``."""
        data = _to_device(data, self.device)
        cutoff = kwargs.get("cutoff_freq", None)
        filter_type = kwargs.get("filter_type", None)
        order = kwargs.get("data_axes_labels_order")
        if data.dim() == 2:
            if order is not None:
                data = data_dims_swapper(data, order, ["angles", "detX"])
            default_cutoff = 1.1
        else:
            if order is not None:
                data = data_dims_swapper(data, order, ["angles", "detY", "detX"])
            data = data.transpose(0, 1)  # to canonical (detY, angles, detX)
            if data.shape[1] != self.geom.n_angles:
                raise ValueError(
                    f"FBP expects 3D data as [angles, detY, detX] (got "
                    f"{tuple(data.transpose(0, 1).shape)} for "
                    f"{self.geom.n_angles} angles; pass "
                    f"data_axes_labels_order to reorder)"
                )
            default_cutoff = 0.35
        data = apply_horiz_detector_padding(data, self.detectors_x_pad)
        if filter_type is not None:
            data = filter_sino_classic(
                data, filter_type, kwargs.get("filter_parameter", None),
                kwargs.get("filter_d", 1.0),
            )
        else:
            data = filter_sino_sinc(data, default_cutoff if cutoff is None else cutoff)
        rec = self.Atools.bp(data)
        rec = check_kwargs(rec, recon_mask_radius=kwargs.get("recon_mask_radius"))
        return self._out(rec)

    def FOURIER(self, data, **kwargs):
        """2D Fourier-slice-theorem reconstruction: the USFFT pipeline of
        :meth:`FOURIER_INV` run without a filter (the unfiltered,
        low-frequency-weighted Fourier-slice image).  ``method`` (the
        reference's scipy interpolant name) is checked and ignored."""
        if np.ndim(data) == 3:
            raise ValueError(
                "Fourier method is currently for 2D data only, use FBP if 3D "
                "reconstruction needed"
            )
        method = kwargs.pop("method", "linear")
        if method not in ["linear", "nearest", "cubic"]:
            raise ValueError(
                "For griddata interpolation module choose nearest, linear or cubic"
            )
        order = kwargs.pop("data_axes_labels_order", None)
        data = _to_device(data, self.device)
        if order is not None:
            data = data_dims_swapper(data, order, ["angles", "detX"])
        kwargs["filter_type"] = "none"
        return self._out(fourier_inv(self, data[None], **kwargs)[0])


class RecToolsDIRTPU(RecToolsDIR):
    """Device-resident direct reconstruction (returns tensors on its
    device); adds ``FOURIER_INV``.  Equivalent of the reference's
    ``RecToolsDIRCuPy``; ``device_projector`` defaults to 0."""

    _return_numpy = False

    def __init__(
        self,
        DetectorsDimH,
        DetectorsDimH_pad,
        DetectorsDimV,
        CenterRotOffset,
        AnglesVec,
        ObjSize,
        projector: str = "astra",
        device_projector: Union[int, str] = 0,
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__(
            DetectorsDimH,
            DetectorsDimH_pad,
            DetectorsDimV,
            CenterRotOffset,
            AnglesVec,
            ObjSize,
            projector,
            device_projector,
            device,
        )

    def FOURIER_INV(self, data, **kwargs):
        """Fourier direct inversion on unequally-spaced grids (USFFT); see
        :mod:`tomobar_tpu_torch.ops.usfft`.  ``data`` is
        ``[detY, angles, detX]`` (or 2D ``[angles, detX]``)."""
        if isinstance(data, (tuple, list)):
            raise NotImplementedError(
                "FOURIER_INV on a shape tuple (the DeviceMemStack memory "
                "estimate) is not ported yet: ROADMAP.md queue 1, item 11 "
                "(utils/memest.py)"
            )
        return fourier_inv(self, _to_device(data, self.device), **kwargs)
