"""Proximal regularisers on PyTorch tensors: ROF-TV and PD-TV
(Chambolle-Pock).

Counterpart of ``tomobar_tpu/regularisers.py``.  ``PD_TV`` runs the CUDA
kernel of :mod:`tomobar_tpu_torch.ops.pd_tv` for CUDA tensors and its plain
PyTorch version for CPU tensors.  ``ROF_TV`` is plain PyTorch on either
device, as the JAX package's is plain XLA.  The legacy methods of the JAX
package's ``prox_regul`` are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from tomobar_tpu_torch.ops.pd_tv import pd_tv

__all__ = ["ROF_TV", "PD_TV", "prox_regul"]

_EPS_ROF = 1.0e-8

# the legacy methods of the JAX package's prox_regul, not ported yet
# (ROADMAP.md queue 1, item 10)
_NOT_PORTED = ("FGP_TV", "SB_TV", "LLT_ROF", "TGV", "NDF", "Diff4th", "NLTV", "WAVELET")


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


def _fwd_diff(u: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference with reflect-at-end boundary: d[-1]=u[-2]-u[-1]."""
    n = u.shape[dim]
    nxt = torch.cat([u.narrow(dim, 1, n - 1), u.narrow(dim, n - 2, 1)], dim)
    return nxt - u


def _prev_reflect(u: torch.Tensor, dim: int) -> torch.Tensor:
    """u[i-1] with reflect boundary at 0: prev[0]=u[1]."""
    return torch.cat([u.narrow(dim, 1, 1), u.narrow(dim, 0, u.shape[dim] - 1)], dim)


def ROF_TV(
    data: torch.Tensor,
    regularisation_parameter: float = 1e-05,
    iterations: int = 3000,
    time_marching_parameter: float = 0.001,
    half_precision: bool = False,
) -> torch.Tensor:
    """Rudin-Osher-Fatemi explicit time-marching TV denoising: normalised
    forward differences with minmod denominators, Neumann boundaries
    (reference ``rudin_osher_fatemi_total_variation.cu``).
    ``half_precision`` keeps the normalised differences in bfloat16.  A 2D
    input (or a 3D one with a singleton axis) is denoised in 2D and
    returned with the singleton axis restored."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    ndim = data.dim()
    grad_dtype = torch.bfloat16 if half_precision else torch.float32
    data = data.to(torch.float32)
    lam = float(regularisation_parameter)
    tau = float(time_marching_parameter)
    # the CUDA kernels' axis roles: D1 <-> axis -2, D2 <-> axis -1, D3 <->
    # axis -3 (3D only)
    d_axes = [ndim - 2, ndim - 1] + ([ndim - 3] if ndim == 3 else [])

    def normalised_diffs(u):
        fdiffs = [_fwd_diff(u, ax) for ax in d_axes]
        bdiffs = [u - _prev_reflect(u, ax) for ax in d_axes]
        sq = [f * f for f in fdiffs]
        mm = []
        for b, f in zip(bdiffs, fdiffs):
            den = 0.5 * (torch.sign(f) + torch.sign(b)) * torch.minimum(
                torch.abs(f), torch.abs(b)
            )
            mm.append(den * den)
        Ds = []
        for k in range(len(d_axes)):
            terms = [sq[k] if j == k else mm[j] for j in range(len(d_axes))]
            denom = torch.sqrt(sum(terms) + _EPS_ROF)
            Ds.append((fdiffs[k] / denom).to(grad_dtype))
        return Ds

    u = data
    for _ in range(iterations):
        Ds = normalised_diffs(u)
        dv = sum(
            D.to(torch.float32) - _prev_reflect(D, ax).to(torch.float32)
            for D, ax in zip(Ds, d_axes)
        )
        u = u + tau * (lam * dv - (u - data))
    if input_is_2d:
        u = u.unsqueeze(ind_axis)
    return u


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
    (substring match, as the reference's ``regularisersCuPy.py:6-38``):
    ROF_TV or PD_TV."""
    method = _regularisation_["method"]
    if method is None:
        raise ValueError(f"Unknown regularisation method: {method}")
    for name in _NOT_PORTED:
        if name in method:
            raise NotImplementedError(
                f"regulariser {name} is not ported to tomobar_tpu_torch yet: "
                "ROADMAP.md queue 1, item 10 (legacy regularisers)"
            )
    if "ROF_TV" in method:
        return ROF_TV(
            X,
            _regularisation_["regul_param"],
            _regularisation_["iterations"],
            _regularisation_["time_marching_step"],
            _regularisation_.get("half_precision", False),
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
