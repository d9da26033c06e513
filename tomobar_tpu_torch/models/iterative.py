"""Iterative reconstruction class with the three-dictionary API, on
PyTorch tensors.

Counterpart of ``tomobar_tpu/models/iterative.py`` (reference
``tomobar/methodsIR_CuPy.py:36``): power method, Landweber, SIRT, CGLS,
FISTA and ADMM with LS / PWLS / SWLS / KL fidelities, OSEM, ordered subsets,
every prox that ``prox_regul`` serves, warm start, detector padding (with
recon-grid enlargement and final crop) and circular masking.  2D data run
as one slice (detY = 1) and return ``(1, N, N)``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops.projector import Projector
from tomobar_tpu_torch.regularisers import prox_regul
from tomobar_tpu_torch.solvers import core as solvers
from tomobar_tpu_torch.utils.dicts import dicts_check
from tomobar_tpu_torch.utils.tools import (
    apply_horiz_detector_padding,
    check_kwargs,
    perform_recon_crop,
)

__all__ = ["RecToolsIRTPU"]


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


class RecToolsIRTPU:
    """Iterative reconstruction tools on one torch device.

    Args mirror the reference constructor (``methodsIR_CuPy.py:53-95``):
        DetectorsDimH: horizontal detector dimension.
        DetectorsDimH_pad: symmetric horizontal detector padding; when > 0,
            the reconstruction grid is enlarged to DetectorsDimH + 2*pad and
            the result cropped back to ObjSize.
        DetectorsDimV: vertical detector dimension ('None'/0 for 2D).
        CenterRotOffset: CoR offset scalar, per-angle vector, or
            (n_angles, 2) [horizontal, vertical] array.
        AnglesVec: projection angles in radians.
        ObjSize: reconstructed slice size.
        device_projector: index of the CUDA device used by default.
        OS_number: number of ordered subsets (None for non-OS).
        device: the torch device to run on; defaults to
            ``torch.device("cuda", device_projector)``.  The CPU is used
            only when asked for (``device="cpu"``); asking for CUDA on a
            machine without it raises.
    """

    def __init__(
        self,
        DetectorsDimH: int,
        DetectorsDimH_pad: int,
        DetectorsDimV: Union[int, None],
        CenterRotOffset: Union[float, np.ndarray],
        AnglesVec: np.ndarray,
        ObjSize: int,
        device_projector: int = 0,
        OS_number: Optional[int] = None,
        device: Union[str, torch.device, None] = None,
    ):
        if device is None:
            device = torch.device("cuda", device_projector)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"RecToolsIRTPU: device {self.device} requested but CUDA is "
                "not available (pass device='cpu' to run on the CPU)"
            )
        self.OS_number = OS_number if OS_number is not None else 1

        if DetectorsDimH_pad == 0:
            self.objsize_user_given = None
        else:
            self.objsize_user_given = ObjSize
        if DetectorsDimH_pad > 0:
            ObjSize = DetectorsDimH + 2 * DetectorsDimH_pad
        if DetectorsDimV == 0 or DetectorsDimV is None:
            DetectorsDimV = 1
        if CenterRotOffset is None:
            CenterRotOffset = 0.0

        self.geom = "3D"
        self._geometry = Geometry(
            detectors_x=int(DetectorsDimH),
            detectors_y=int(DetectorsDimV),
            angles=np.asarray(AnglesVec),
            center_rot_offset=CenterRotOffset,
            recon_size=int(ObjSize),
            detectors_x_pad=int(DetectorsDimH_pad),
            os_number=self.OS_number,
        )
        self.Atools = Projector(self._geometry)
        self.data_fidelity = "LS"
        self.nonneg_regul = 0
        # L = ||A^T A|| depends only on the operator (geometry + OS; the
        # power method's PWLS weights are ones), so it is computed once per
        # instance and reused by every solver call without lipschitz_const
        self._lipschitz_cache: Optional[float] = None

    # ------------------------------------------------------------------ API

    @property
    def vol_shape(self):
        g = self._geometry
        return (g.detectors_y, g.recon_size, g.recon_size)

    # -------------------------------------------------------------- helpers

    def _Ax(self, x, sub_ind: int = 1, os: bool = False):
        return self.Atools.fp_sub(x, sub_ind) if os else self.Atools.fp(x)

    def _Atb(self, b, sub_ind: int = 1, os: bool = False):
        return self.Atools.bp_sub(b, sub_ind) if os else self.Atools.bp(b)

    def _prep_data(self, _data_, _algorithm_, _regularisation_, method_run):
        d, a, r = dicts_check(self, _data_, _algorithm_, _regularisation_, method_run)
        d["projection_data"] = apply_horiz_detector_padding(
            _to_device(d["projection_data"], self.device),
            self._geometry.detectors_x_pad,
        )
        return d, a, r

    def _finalise(self, x, _algorithm_):
        if self.objsize_user_given is not None:
            return perform_recon_crop(x, self.objsize_user_given)
        return check_kwargs(x, recon_mask_radius=_algorithm_["recon_mask_radius"])

    def _common_init(self, _data_, _algorithm_, _regularisation_, method_run):
        """Shared init: dicts check, padding, Lipschitz constant, warm start
        (``methodsIR_CuPy.py:356-399``)."""
        d, a, r = self._prep_data(_data_, _algorithm_, _regularisation_, method_run)
        if a.get("lipschitz_const") is None:
            if self._lipschitz_cache is None:
                self._lipschitz_cache = self.powermethod(d)
            a["lipschitz_const"] = self._lipschitz_cache
        rec_dim = self.vol_shape
        if a["initialise"] is not None:
            if tuple(a["initialise"].shape) == rec_dim:
                x0 = _to_device(a["initialise"], self.device)
            else:
                print(
                    f"Provided initialisation (array) has incorrect dimensions, "
                    f"the correct dims are {rec_dim}. Zero initialisation is used."
                )
                x0 = torch.zeros(rec_dim, dtype=torch.float32, device=self.device)
        elif method_run == "OSEM":
            x0 = torch.ones(rec_dim, dtype=torch.float32, device=self.device)
        else:
            x0 = torch.zeros(rec_dim, dtype=torch.float32, device=self.device)
        return d, a, r, x0

    @staticmethod
    def _fid_kwargs(d: dict) -> dict:
        """Robust-fidelity parameters from the data dict."""
        return {
            k: d[k]
            for k in ("beta_SWLS", "huber_threshold", "studentst_threshold")
            if d.get(k) is not None
        }

    def _regul_fn(self, _regularisation_):
        if _regularisation_.get("method") is None:
            return None
        return lambda x: prox_regul(self, x, _regularisation_)

    # -------------------------------------------------------------- solvers

    def powermethod(self, _data_: dict) -> float:
        """Lipschitz constant via power iterations
        (``methodsIR_CuPy.py:311-354``).  A direct call always recomputes and
        refreshes the per-instance cache used by the solvers."""
        if _data_.get("data_fidelity") is None:
            _data_["data_fidelity"] = "LS"
        val = solvers.power_method(
            self.Atools,
            self.vol_shape,
            iterations=15,
            use_pwls=_data_["data_fidelity"] == "PWLS",
            device=self.device,
        )
        self._lipschitz_cache = val
        return val

    def Landweber(self, _data_: dict, _algorithm_: Union[dict, None] = None) -> torch.Tensor:
        """Landweber iterations (``iterations``, step ``tau_step_lanweber``,
        ``nonnegativity``) on ``projection_data``; keys as in
        ``docs/parameters.md``.  Returns the reconstruction on the device."""
        d, a, _ = self._prep_data(_data_, _algorithm_, None, "Landweber")
        x = solvers.landweber(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            tau_step=a["tau_step_lanweber"],
            nonnegativity=a["nonnegativity"],
        )
        return self._finalise(x, a)

    def SIRT(self, _data_: dict, _algorithm_: Union[dict, None] = None) -> torch.Tensor:
        """SIRT (``iterations``, ``nonnegativity``) on ``projection_data``;
        keys as in ``docs/parameters.md``.  Returns the reconstruction on the
        device."""
        d, a, _ = self._prep_data(_data_, _algorithm_, None, "SIRT")
        x = solvers.sirt(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            nonnegativity=a["nonnegativity"],
        )
        return self._finalise(x, a)

    def CGLS(self, _data_: dict, _algorithm_: Union[dict, None] = None) -> torch.Tensor:
        """Conjugate gradients on the least-squares problem (``iterations``,
        ``nonnegativity``) on ``projection_data``; keys as in
        ``docs/parameters.md``.  Returns the reconstruction on the device."""
        d, a, _ = self._prep_data(_data_, _algorithm_, None, "CGLS")
        x = solvers.cgls(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            nonnegativity=a["nonnegativity"],
        )
        return self._finalise(x, a)

    def FISTA(
        self,
        _data_: dict,
        _algorithm_: Union[dict, None] = None,
        _regularisation_: Union[dict, None] = None,
    ) -> torch.Tensor:
        """FISTA, with ordered subsets when the instance has ``OS_number``:
        the data fidelity of ``_data_`` (LS, PWLS, SWLS, KL; Huber and
        Student's t thresholds), ``_algorithm_``'s iterations, Lipschitz
        constant (the power method's when absent), nonnegativity, warm start
        (``initialise``) and tolerance, and the prox of ``_regularisation_``
        (:func:`tomobar_tpu_torch.regularisers.prox_regul`).  Keys as in
        ``docs/parameters.md``.  Returns the reconstruction on the device."""
        d, a, r, x0 = self._common_init(_data_, _algorithm_, _regularisation_, "FISTA")
        x = solvers.fista(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            lipschitz_const=a["lipschitz_const"],
            nonnegativity=a["nonnegativity"],
            fidelity=d["data_fidelity"],
            regul_fn=self._regul_fn(r),
            x0=x0,
            fid_kwargs=self._fid_kwargs(d),
            tolerance=a.get("tolerance", 0.0),
            verbose=bool(a.get("verbose", False)),
        )
        return self._finalise(x, a)

    def ADMM(
        self,
        _data_: dict,
        _algorithm_: Union[dict, None] = None,
        _regularisation_: Union[dict, None] = None,
    ) -> torch.Tensor:
        """ADMM (``ADMM_rho_const``, ``ADMM_relax_par``), with ordered subsets
        when the instance has ``OS_number``; the dictionaries as
        :meth:`FISTA`'s, the regularisation parameter divided by rho as the
        reference does.  Returns the reconstruction on the device."""
        d, a, r, x0 = self._common_init(_data_, _algorithm_, _regularisation_, "ADMM")
        # regul_param scaled by 1/rho (methodsIR_CuPy.py:526-528)
        r = dict(r)
        if r.get("regul_param") is not None:
            r["regul_param"] = r["regul_param"] / a["ADMM_rho_const"]
        x = solvers.admm(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            lipschitz_const=a["lipschitz_const"],
            rho_const=a["ADMM_rho_const"],
            relax_par=a["ADMM_relax_par"],
            nonnegativity=a["nonnegativity"],
            fidelity=d["data_fidelity"],
            regul_fn=self._regul_fn(r),
            x0=x0,
            fid_kwargs=self._fid_kwargs(d),
            tolerance=a.get("tolerance", 0.0),
            verbose=bool(a.get("verbose", False)),
        )
        return self._finalise(x, a)

    def OSEM(
        self,
        _data_: dict,
        _algorithm_: Union[dict, None] = None,
        _regularisation_: Union[dict, None] = None,
    ) -> torch.Tensor:
        """OSEM (MLEM without subsets) on count-like ``projection_data``,
        started from ones or ``initialise``, with an optional prox of
        ``_regularisation_`` after each subset and ``osem_normalisation``
        ("reference" or "divide").  Returns the reconstruction on the
        device."""
        d, a, r, x0 = self._common_init(_data_, _algorithm_, _regularisation_, "OSEM")
        x = solvers.osem(
            self.Atools,
            d["projection_data"],
            iterations=a["iterations"],
            regul_fn=self._regul_fn(r),
            x0=x0,
            normalisation_mode=a.get("osem_normalisation", "reference"),
        )
        return self._finalise(x, a)
