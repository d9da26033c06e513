"""Proximal regularisers on PyTorch tensors: PD-TV (Chambolle-Pock).

Counterpart of ``tomobar_tpu/regularisers.py``.  ``PD_TV`` runs the CUDA
kernel of :mod:`tomobar_tpu_torch.ops.pd_tv` for CUDA tensors and its plain
PyTorch version for CPU tensors.  The other methods of the JAX package's
``prox_regul`` are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from tomobar_tpu_torch.ops.pd_tv import pd_tv

__all__ = ["PD_TV", "prox_regul"]

# ROADMAP.md queue 1 item that ports each method not yet available
_NOT_PORTED = {
    "ROF_TV": "ROADMAP.md queue 1, item 4 (ROF_TV)",
    "FGP_TV": "ROADMAP.md queue 1, item 10 (legacy regularisers)",
    "SB_TV": "ROADMAP.md queue 1, item 10 (legacy regularisers)",
    "LLT_ROF": "ROADMAP.md queue 1, item 10 (legacy regularisers)",
    "TGV": "ROADMAP.md queue 1, item 10 (legacy regularisers)",
    "NDF": "ROADMAP.md queue 1, item 10 (legacy regularisers)",
    "Diff4th": "ROADMAP.md queue 1, item 10 (legacy regularisers)",
    "NLTV": "ROADMAP.md queue 1, item 10 (legacy regularisers)",
    "WAVELET": "ROADMAP.md queue 1, item 10 (legacy regularisers)",
}


def _squeeze_2d(data: torch.Tensor):
    """Squeeze a singleton axis of 3D input (reference
    ``regularisersCuPy.py:299-315``)."""
    if data.dim() == 2:
        return data, True, 0
    if data.dim() == 3:
        for i in range(3):
            if data.shape[i] == 1:
                return data.squeeze(i), True, i
        return data, False, 0
    raise ValueError("2D or 3D arrays must be provided only")


def PD_TV(
    data: torch.Tensor,
    regularisation_parameter: float = 1e-05,
    iterations: int = 1000,
    methodTV: int = 0,
    nonneg: int = 0,
    lipschitz_const: float = 8.0,
    half_precision: bool = False,
) -> torch.Tensor:
    """Primal-dual (Chambolle-Pock) TV denoising, iso (``methodTV=0``) or
    aniso, optional non-negativity; ``half_precision`` keeps the duals in
    bfloat16.  A 2D input (or a 3D one with a singleton axis) is denoised
    in 2D, and a 2D input returns a ``(1, H, W)`` result."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    vol = data[None] if data.dim() == 2 else data
    out = pd_tv(
        vol.to(torch.float32).contiguous(),
        regularisation_parameter,
        iterations,
        methodTV,
        nonneg,
        lipschitz_const,
        half_precision,
    )
    if input_is_2d:
        out = out[0].unsqueeze(ind_axis)
    return out


def prox_regul(self, X: torch.Tensor, _regularisation_: dict) -> torch.Tensor:
    """Apply the proximal operator named by ``_regularisation_["method"]``
    (substring match, as the reference's ``regularisersCuPy.py:6-38``)."""
    method = _regularisation_["method"]
    if method is None:
        raise ValueError(f"Unknown regularisation method: {method}")
    for name, item in _NOT_PORTED.items():
        if name in method:
            raise NotImplementedError(
                f"regulariser {name} is not ported to tomobar_tpu_torch yet: {item}"
            )
    if "PD_TV" not in method:
        raise ValueError(f"Unknown regularisation method: {method}")
    return PD_TV(
        X,
        _regularisation_["regul_param"],
        _regularisation_["iterations"],
        _regularisation_["methodTV"],
        getattr(self, "nonneg_regul", 0),
        _regularisation_["PD_LipschitzConstant"],
        _regularisation_.get("half_precision", False),
    )
