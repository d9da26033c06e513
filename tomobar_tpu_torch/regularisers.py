"""Proximal regularisers on PyTorch tensors: ROF-TV and PD-TV
(Chambolle-Pock).

Counterpart of ``tomobar_tpu/regularisers.py``.  ``PD_TV`` runs the CUDA
kernel of :mod:`tomobar_tpu_torch.ops.pd_tv` for CUDA tensors and its plain
PyTorch version for CPU tensors.  ``ROF_TV`` is plain PyTorch on either
device, as the JAX package's is plain XLA, and so are the legacy methods
that ``prox_regul`` reaches in :mod:`tomobar_tpu_torch.regularisers_legacy`.
"""

from __future__ import annotations

import torch

from tomobar_tpu_torch.ops.pd_tv import pd_tv

__all__ = ["ROF_TV", "PD_TV", "prox_regul"]

_EPS_ROF = 1.0e-8


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


def _bwd_diff_zero(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Backward difference with zero boundary at 0: d[0]=p[0]."""
    prev = torch.cat([torch.zeros_like(p.narrow(dim, 0, 1)), p.narrow(dim, 0, p.shape[dim] - 1)], dim)
    return p - prev


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
    (substring match, as the reference's ``regularisersCuPy.py:6-38``, so
    combined strings such as ``"PD_TV_WAVELETS"`` work), tried in the JAX
    package's order: ROF_TV, PD_TV, FGP_TV, SB_TV, LLT_ROF, TGV, NDF,
    Diff4th, NLTV, then a name that starts with ``WAVELET`` (shrinkage
    alone).  A name holding ``WAVELET`` shrinks the result by
    :func:`~tomobar_tpu_torch.regularisers_legacy.WAVELET_SHRINK` with
    ``wavelet_threshold``, else ``regul_param`` for a pure ``WAVELETS`` and
    ``regul_param2`` for a combination, over ``wavelet_levels`` (3)."""
    from tomobar_tpu_torch import regularisers_legacy as legacy

    r = _regularisation_
    method = r["method"]
    if method is None:
        raise ValueError(f"Unknown regularisation method: {method}")
    if "ROF_TV" in method:
        out = ROF_TV(X, r["regul_param"], r["iterations"], r["time_marching_step"],
                     r.get("half_precision", False))
    elif "PD_TV" in method:
        out = PD_TV(X, r["regul_param"], r["iterations"], r["methodTV"],
                    getattr(self, "nonneg_regul", 0), r["PD_LipschitzConstant"],
                    r.get("half_precision", False))
    elif "FGP_TV" in method:
        out = legacy.FGP_TV(X, r["regul_param"], r["iterations"], r["methodTV"],
                            getattr(self, "nonneg_regul", 0))
    elif "SB_TV" in method:
        out = legacy.SB_TV(X, r["regul_param"], r["iterations"], r["methodTV"])
    elif "LLT_ROF" in method:
        out = legacy.LLT_ROF(X, r["regul_param"], r.get("regul_param2", 1e-05),
                             r["iterations"], r["time_marching_step"])
    elif "TGV" in method:
        out = legacy.TGV(X, r["regul_param"], r.get("alpha1", 1.0), r.get("alpha0", 2.0),
                         r["iterations"], r.get("TGV_LipschitzConstant", 12.0))
    elif "NDF" in method:
        out = legacy.NDF(X, r["regul_param"], r.get("edge_param", 0.01), r["iterations"],
                         r["time_marching_step"], r.get("NDF_penalty", 1))
    elif "Diff4th" in method:
        out = legacy.Diff4th(X, r["regul_param"], r.get("edge_param", 0.01),
                             r["iterations"], r["time_marching_step"])
    elif "NLTV" in method:
        # legacy demo dicts give IterNumb and may leave out "iterations",
        # so the fallback is read only when IterNumb is missing
        iters = r.get("IterNumb")
        if iters is None:
            iters = r.get("iterations", 5)
        out = legacy.NLTV(X, r["NLTV_H_i"], r["NLTV_H_j"], r["NLTV_Weights"],
                          r["regul_param"], iters)
    elif method.startswith("WAVELET"):
        out = X  # shrinkage alone, below
    else:
        raise ValueError(f"Unknown regularisation method: {method}")
    if "WAVELET" in method:
        out = legacy.WAVELET_SHRINK(out, wavelet_threshold(r), r.get("wavelet_levels", 3))
    return out


def wavelet_threshold(r: dict) -> float:
    """The Haar shrinkage threshold of a regularisation dict:
    ``wavelet_threshold``, else ``regul_param`` for a pure ``WAVELETS`` and
    the legacy demos' ``regul_param2`` for a combination."""
    thr = r.get("wavelet_threshold")
    if thr is None:
        thr = r["regul_param"] if r["method"].startswith("WAVELET") else r.get("regul_param2", 1e-05)
    return thr
