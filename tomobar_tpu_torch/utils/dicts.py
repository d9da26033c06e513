"""The three-dictionary parameter system for iterative methods.

Counterpart of ``tomobar_tpu/utils/dicts.py`` (reference
``tomobar/supp/dicts.py:6-184``): validates and defaults the ``_data_``,
``_algorithm_`` and ``_regularisation_`` dictionaries per solver, with the
same defaults and messages.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from tomobar_tpu_torch.utils.tools import data_dims_swapper

__all__ = ["dicts_check"]


def dicts_check(
    self,
    _data_: dict,
    _algorithm_: Union[dict, None] = None,
    _regularisation_: Union[dict, None] = None,
    method_run: str = "FISTA",
) -> tuple:
    """Validate/default the three parameter dictionaries (see reference
    ``supp/dicts.py`` for the parameter catalogue; semantics preserved)."""
    correct_labels_order = ["detY", "angles", "detX"]
    correct_labels_order2d = ["angles", "detX"]
    data2dinput = False

    if _data_ is None:
        raise NameError("The data dictionary must be always provided")
    if _data_.get("projection_data") is None:
        raise NameError("'projection_data' needs to be provided")
    if _data_["projection_data"].ndim == 2:
        data2dinput = True

    if "data_axes_labels_order" not in _data_:
        _data_["data_axes_labels_order"] = None

    if _data_["data_axes_labels_order"] is not None:
        labels = correct_labels_order2d if data2dinput else correct_labels_order
        _data_["projection_data"] = data_dims_swapper(
            _data_["projection_data"], _data_["data_axes_labels_order"], labels
        )
        _data_["data_axes_labels_order"] = None

    if data2dinput:
        proj = _data_["projection_data"]
        _data_["projection_data"] = (
            proj[None] if isinstance(proj, torch.Tensor) else np.expand_dims(proj, 0)
        )

    if _data_.get("data_fidelity") is None:
        _data_["data_fidelity"] = "LS"
    if _data_["data_fidelity"] not in {"LS", "PWLS", "SWLS", "KL"}:
        raise ValueError(
            "_data_['data_fidelity'] should be provided as 'LS', 'PWLS', "
            "'SWLS' or 'KL'."
        )
    self.data_fidelity = _data_["data_fidelity"]
    if _data_["data_fidelity"] == "SWLS":
        if "beta_SWLS" not in _data_:
            _data_["beta_SWLS"] = 0.1

    if self.OS_number > 1 and method_run in {"SIRT", "CGLS", "Landweber"}:
        raise NameError(
            "There is no ordered-subsets implementation for this "
            "reconstruction method, please set OS_number=None"
        )

    # ----------  _algorithm_  --------------
    if _algorithm_ is None:
        _algorithm_ = {}
    if method_run in {"SIRT", "CGLS", "power", "Landweber", "OSEM"}:
        _algorithm_["lipschitz_const"] = 0
        if _algorithm_.get("iterations") is None:
            defaults = {"SIRT": 200, "CGLS": 30, "power": 15, "Landweber": 1500}
            if method_run in defaults:
                _algorithm_["iterations"] = defaults[method_run]
        if _algorithm_.get("tau_step_lanweber") is None:
            _algorithm_["tau_step_lanweber"] = 1e-05
    if method_run == "OSEM" and _algorithm_.get("iterations") is None:
        _algorithm_["iterations"] = 15 if self.OS_number > 1 else 300
    if method_run == "OSEM" and "osem_normalisation" not in _algorithm_:
        _algorithm_["osem_normalisation"] = "reference"
    if method_run == "FISTA" and _algorithm_.get("iterations") is None:
        _algorithm_["iterations"] = 20 if self.OS_number > 1 else 400
    if method_run == "ADMM":
        if _algorithm_.get("iterations") is None:
            _algorithm_["iterations"] = 10 if self.OS_number > 1 else 400
        if "ADMM_rho_const" not in _algorithm_:
            _algorithm_["ADMM_rho_const"] = 1.0
        if "ADMM_relax_par" not in _algorithm_:
            _algorithm_["ADMM_relax_par"] = 1.6
    if "initialise" not in _algorithm_:
        _algorithm_["initialise"] = None
    if "nonnegativity" not in _algorithm_:
        _algorithm_["nonnegativity"] = False
    if _algorithm_["nonnegativity"] not in [True, False]:
        raise ValueError("_algorithm_['nonnegativity'] should be set to True or False.")
    self.nonneg_regul = 1 if _algorithm_["nonnegativity"] else 0
    if "recon_mask_radius" not in _algorithm_:
        _algorithm_["recon_mask_radius"] = 1.0
    if "tolerance" not in _algorithm_:
        _algorithm_["tolerance"] = 0.0
    if "verbose" not in _algorithm_:
        _algorithm_["verbose"] = False

    # ----------  _regularisation_  --------------
    if _regularisation_ is None:
        _regularisation_ = {}
    if bool(_regularisation_) is False:
        _regularisation_["method"] = None
    if method_run in {"FISTA", "ADMM", "OSEM"}:
        if "regul_param" not in _regularisation_:
            _regularisation_["regul_param"] = 0.001
        if "iterations" not in _regularisation_:
            _regularisation_["iterations"] = 150
        if "tolerance" not in _regularisation_:
            _regularisation_["tolerance"] = 0.0
        if "time_marching_step" not in _regularisation_:
            _regularisation_["time_marching_step"] = 0.005
        # the reference dict default is 12.0 while its function default is
        # 8.0 (dicts.py:177 vs regularisersCuPy.py:176); the dict default
        # is kept for parity
        if "PD_LipschitzConstant" not in _regularisation_:
            _regularisation_["PD_LipschitzConstant"] = 12.0
        if "methodTV" not in _regularisation_:
            _regularisation_["methodTV"] = 0
        if "device_regulariser" not in _regularisation_:
            _regularisation_["device_regulariser"] = 0
    return (_data_, _algorithm_, _regularisation_)
