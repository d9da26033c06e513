"""The legacy regulariser family on PyTorch tensors: FGP-TV, SB-TV,
LLT-ROF, TGV, NDF, Diff4th, NLTV (with its ``patch_select`` neighbour
search) and multi-level Haar wavelet shrinkage.

Counterpart of ``tomobar_tpu/regularisers_legacy.py``, whose operators are
plain XLA (no TPU kernel stands behind them): each ``lax.fori_loop`` is a
Python loop over tensor expressions here, in the JAX package's order of
operations and with its float32 constants, on whatever device the input
lies.  Every operator takes 2D or 3D input with the conventions of
:func:`tomobar_tpu_torch.regularisers._squeeze_2d` (a 2D input, or a 3D one
with a singleton axis, is denoised in 2D and returned with that axis).

Algorithm sources (public literature):

* FGP-TV: Beck & Teboulle, "Fast gradient-based algorithms for constrained
  total variation image denoising and deblurring" (2009).
* SB-TV: Goldstein & Osher, "The split Bregman method for L1-regularized
  problems" (2009).
* LLT-ROF: ROF + Lysaker-Lundervold-Tai higher-order model (Kazantsev et
  al., 2017).
* TGV: Bredies, Kunisch & Pock, "Total generalized variation" (2010),
  second order, Chambolle-Pock primal-dual.
* NDF: Perona & Malik anisotropic diffusion (1990) and its Huber variant.
* Diff4th: Hajiaboli's fourth-order nonlinear PDE (2011).
* NLTV: nonlocal TV by a lagged-diffusivity fixed point on precomputed
  patch-similarity weights.
* WAVELETS: multi-level Haar soft thresholding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tomobar_tpu_torch.regularisers import (
    _bwd_diff_zero,
    _fwd_diff,
    _prev_reflect,
    _squeeze_2d,
)

__all__ = [
    "FGP_TV",
    "SB_TV",
    "LLT_ROF",
    "TGV",
    "NDF",
    "Diff4th",
    "NLTV",
    "WAVELET_SHRINK",
    "patch_select",
]

# patch_select's intermediates per run of rows: each (offsets, rows, W)
# array stays under this many elements
PATCH_BLOCK_ELEMENTS = 2**27


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x`` (the JAX
    package's ``jnp.float32`` scalars)."""
    return float(np.float32(x))


def _restore(out: torch.Tensor, input_is_2d: bool, ind_axis: int) -> torch.Tensor:
    return out.unsqueeze(ind_axis) if input_is_2d else out


def _axes(ndim: int) -> list:
    """Difference axes in the PD_TV convention: x, y, then z (3D)."""
    return [ndim - 1, ndim - 2] + ([ndim - 3] if ndim == 3 else [])


def _project_ball(ps, radius: float, iso: bool):
    """Project a list of dual fields onto the (an)isotropic ball."""
    if iso:
        norm2 = sum(p * p for p in ps)
        scale = torch.where(
            norm2 > radius * radius,
            radius * torch.rsqrt(torch.clamp(norm2, min=1e-30)),
            1.0,
        )
        return [p * scale for p in ps]
    return [torch.clamp(p, -radius, radius) for p in ps]


def _fwd_diff_zero(u: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference with zero-at-end boundary, the exact negative
    adjoint of ``_bwd_diff_zero`` when the dual's last lane is zero."""
    n = u.shape[dim]
    nxt = torch.cat([u.narrow(dim, 1, n - 1), u.narrow(dim, n - 1, 1)], dim)
    return nxt - u


def _second_diff(u: torch.Tensor, dim: int) -> torch.Tensor:
    """Symmetric second difference with reflect boundaries."""
    nxt = _fwd_diff(u, dim)
    prv = u - _prev_reflect(u, dim)
    return nxt - prv


# ---------------------------------------------------------------------------
# FGP-TV, SB-TV, LLT-ROF, TGV, NDF, Diff4th
# ---------------------------------------------------------------------------


def FGP_TV(
    data: torch.Tensor,
    regularisation_parameter: float = 1e-05,
    iterations: int = 100,
    methodTV: int = 0,
    nonneg: int = 0,
) -> torch.Tensor:
    """Fast Gradient Projection TV denoising (Beck-Teboulle dual method with
    FISTA momentum) of ``min_u 0.5||u - data||^2 + lam * TV(u)``."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    d_axes = _axes(data.dim())
    data = data.to(torch.float32)
    lam = np.float32(regularisation_parameter)
    L = np.float32(8.0 if data.dim() == 2 else 12.0)
    step = float(np.float32(1.0) / (L * lam))

    def primal(ps):
        u = data + float(lam) * sum(_bwd_diff_zero(p, ax) for p, ax in zip(ps, d_axes))
        return torch.clamp(u, min=0.0) if nonneg else u

    zeros = [torch.zeros_like(data) for _ in d_axes]
    ps, rs, t = zeros, zeros, np.float32(1.0)
    for _ in range(iterations):
        u = primal(rs)
        qs = [r + step * _fwd_diff(u, ax) for r, ax in zip(rs, d_axes)]
        qs = _project_ball(qs, 1.0, methodTV == 0)
        t_new = (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t)) * np.float32(0.5)
        mom = float((t - np.float32(1.0)) / t_new)
        rs = [q + mom * (q - p) for q, p in zip(qs, ps)]
        ps, t = qs, t_new
    return _restore(primal(ps), input_is_2d, ind_axis)


def SB_TV(
    data: torch.Tensor,
    regularisation_parameter: float = 1e-05,
    iterations: int = 50,
    methodTV: int = 0,
) -> torch.Tensor:
    """Split-Bregman TV denoising (Goldstein-Osher): the objective of
    :func:`FGP_TV` with the zero-at-end gradient; the u-subproblem takes one
    residual-form Jacobi sweep per outer iteration, whose fixed point solves
    the linear system exactly."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    d_axes = _axes(data.dim())
    data = data.to(torch.float32)
    # penalty weight of the d = grad(u) constraint: twice the fidelity weight
    pen = np.float32(2.0)
    thresh = float(np.float32(regularisation_parameter) / pen)
    diag = float(np.float32(1.0) + np.float32(2 * len(d_axes)) * pen)
    pen = float(pen)

    zeros = [torch.zeros_like(data) for _ in d_axes]
    u, ds, bs = data, zeros, zeros
    for _ in range(iterations):
        # u-step: (1 - pen*Lap) u = data + pen*div(b - d), div = -grad^T
        rhs = data + pen * sum(_bwd_diff_zero(b - d, ax) for d, b, ax in zip(ds, bs, d_axes))
        lap = sum(_bwd_diff_zero(_fwd_diff_zero(u, ax), ax) for ax in d_axes)
        resid = rhs - (u - pen * lap)
        u = u + resid / diag
        # d-step: shrink(grad u + b)
        gs = [_fwd_diff_zero(u, ax) + b for ax, b in zip(d_axes, bs)]
        if methodTV == 0:  # isotropic joint shrinkage
            s = torch.sqrt(sum(g * g for g in gs) + 1e-12)
            factor = torch.clamp(s - thresh, min=0.0) / s
            ds = [factor * g for g in gs]
        else:  # anisotropic soft threshold per component
            ds = [torch.sign(g) * torch.clamp(torch.abs(g) - thresh, min=0.0) for g in gs]
        # Bregman update b <- b + (grad u - d); g already carries b
        bs = [g - d for g, d in zip(gs, ds)]
    return _restore(u, input_is_2d, ind_axis)


def LLT_ROF(
    data: torch.Tensor,
    regularisation_parameter: float = 1e-05,
    regularisation_parameter2: float = 1e-05,
    iterations: int = 300,
    time_marching_parameter: float = 0.0025,
) -> torch.Tensor:
    """Combined ROF + Lysaker-Lundervold-Tai explicit scheme:
    ``regularisation_parameter`` weights the first-order TV term,
    ``regularisation_parameter2`` the second-order LLT term."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    d_axes = _axes(data.dim())
    data = data.to(torch.float32)
    lam_rof = _f32(regularisation_parameter)
    lam_llt = _f32(regularisation_parameter2)
    tau = _f32(time_marching_parameter)
    eps = 1e-8

    u = data
    for _ in range(iterations):
        # first-order curvature: div(grad u / |grad u|)
        gs = [_fwd_diff(u, ax) for ax in d_axes]
        mag1 = torch.sqrt(sum(g * g for g in gs) + eps)
        rof = sum(_bwd_diff_zero(g / mag1, ax) for g, ax in zip(gs, d_axes))
        # second-order term: sum_i (u_ii / |D2 u|)_ii
        d2s = [_second_diff(u, ax) for ax in d_axes]
        mag2 = torch.sqrt(sum(d * d for d in d2s) + eps)
        llt = sum(_second_diff(d / mag2, ax) for d, ax in zip(d2s, d_axes))
        u = u + tau * (lam_rof * rof - lam_llt * llt - (u - data))
    return _restore(u, input_is_2d, ind_axis)


def TGV(
    data: torch.Tensor,
    regularisation_parameter: float = 1e-05,
    alpha1: float = 1.0,
    alpha0: float = 2.0,
    iterations: int = 300,
    lipschitz_const: float = 12.0,
) -> torch.Tensor:
    """Second-order Total Generalized Variation denoising of
    ``min_u 0.5||u-data||^2 + lam*TGV^2_{alpha0,alpha1}(u)`` by
    Chambolle-Pock; ``lipschitz_const`` bounds ||K||^2 for the step sizes
    tau = sigma = 1/sqrt(L)."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    d_axes = _axes(data.dim())
    nd = len(d_axes)
    data = data.to(torch.float32)
    lam = np.float32(regularisation_parameter)
    r1 = float(lam * np.float32(alpha1))
    r0 = float(lam * np.float32(alpha0))
    tau = sigma = _f32(1.0 / np.sqrt(lipschitz_const))
    one_tau = _f32(np.float32(1.0) + np.float32(tau))

    # symmetric-gradient components: nd diagonals, then the i<j off-diagonals
    offd = [(i, j) for i in range(nd) for j in range(i + 1, nd)]

    def sym_grad(vs):
        diag = [_fwd_diff(vs[i], d_axes[i]) for i in range(nd)]
        off = [
            0.5 * (_fwd_diff(vs[i], d_axes[j]) + _fwd_diff(vs[j], d_axes[i]))
            for i, j in offd
        ]
        return diag, off

    def sym_div(diag, off):
        out = []
        for i in range(nd):
            t = _bwd_diff_zero(diag[i], d_axes[i])
            for k, (a, b) in enumerate(offd):
                if a == i:
                    t = t + _bwd_diff_zero(off[k], d_axes[b])
                elif b == i:
                    t = t + _bwd_diff_zero(off[k], d_axes[a])
            out.append(t)
        return out

    def ball(norm2, r):
        return torch.where(norm2 > r * r, r * torch.rsqrt(torch.clamp(norm2, min=1e-30)), 1.0)

    z = torch.zeros_like(data)
    u, ub = data, data
    vs = vbs = ps = qd = [z] * nd
    qo = [z] * len(offd)
    for _ in range(iterations):
        # dual p: ascent on grad(ub) - vb, projected onto the ball r1
        ps = [p + sigma * (_fwd_diff(ub, ax) - vb) for p, ax, vb in zip(ps, d_axes, vbs)]
        scale = ball(sum(p * p for p in ps), r1)
        ps = [p * scale for p in ps]
        # dual q: ascent on E(vb), projected onto the ball r0 (Frobenius
        # norm with the off-diagonals counted twice)
        gd, go = sym_grad(vbs)
        qd = [q + sigma * g for q, g in zip(qd, gd)]
        qo = [q + sigma * g for q, g in zip(qo, go)]
        qs = ball(sum(q * q for q in qd) + 2.0 * sum(q * q for q in qo), r0)
        qd = [q * qs for q in qd]
        qo = [q * qs for q in qo]
        # primal u: gradient step, then the prox of the fidelity
        u_old = u
        u = (u + tau * sum(_bwd_diff_zero(p, ax) for p, ax in zip(ps, d_axes))
             + tau * data) / one_tau
        ub = 2.0 * u - u_old
        # primal v
        dv = sym_div(qd, qo)
        vs_old = vs
        vs = [v + tau * (p + d) for v, p, d in zip(vs, ps, dv)]
        vbs = [2.0 * v - vo for v, vo in zip(vs, vs_old)]
    return _restore(u, input_is_2d, ind_axis)


def NDF(
    data: torch.Tensor,
    regularisation_parameter: float = 1e-05,
    edge_parameter: float = 0.01,
    iterations: int = 300,
    time_marching_parameter: float = 0.025,
    penalty_type: int = 1,
) -> torch.Tensor:
    """Nonlinear (anisotropic) diffusion with data fidelity.
    ``penalty_type``: 1 Huber, 2 Perona-Malik rational ``1/(1+(s/eps)^2)``,
    3 Perona-Malik exponential ``exp(-(s/eps)^2)``."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    d_axes = _axes(data.dim())
    data = data.to(torch.float32)
    lam = _f32(regularisation_parameter)
    eps = _f32(edge_parameter)
    tau = _f32(time_marching_parameter)

    def g(s):
        if penalty_type == 1:  # Huber: linear inside eps, 1/|s| outside
            return torch.where(torch.abs(s) > eps, eps / torch.abs(s), 1.0)
        if penalty_type == 2:
            return 1.0 / (1.0 + (s / eps) ** 2)
        return torch.exp(-((s / eps) ** 2))

    u = data
    for _ in range(iterations):
        dv = torch.zeros_like(u)
        for ax in d_axes:
            d = _fwd_diff(u, ax)
            dv = dv + _bwd_diff_zero(g(d) * d, ax)
        u = u + tau * (lam * dv - (u - data))
    return _restore(u, input_is_2d, ind_axis)


def Diff4th(
    data: torch.Tensor,
    regularisation_parameter: float = 1e-05,
    edge_parameter: float = 0.01,
    iterations: int = 500,
    time_marching_parameter: float = 0.001,
) -> torch.Tensor:
    """Fourth-order nonlinear diffusion (edge function on the Laplacian)."""
    data, input_is_2d, ind_axis = _squeeze_2d(data)
    d_axes = _axes(data.dim())
    data = data.to(torch.float32)
    lam = _f32(regularisation_parameter)
    eps = _f32(edge_parameter)
    tau = _f32(time_marching_parameter)

    def laplacian(u):
        return sum(_second_diff(u, ax) for ax in d_axes)

    u = data
    for _ in range(iterations):
        lap = laplacian(u)
        w = lap / (1.0 + (lap / eps) ** 2)
        u = u + tau * (-lam * laplacian(w) - (u - data))
    return _restore(u, input_is_2d, ind_axis)


# ---------------------------------------------------------------------------
# NLTV (nonlocal TV on precomputed neighbour weights)
# ---------------------------------------------------------------------------


def _patch_kernel(pw: int) -> np.ndarray:
    """The normalised (2pw+1)^2 Gaussian patch kernel, float32."""
    t = np.arange(-pw, pw + 1, dtype=np.float32)
    k1 = np.exp(-(t**2) / (2.0 * max(pw / 2.0, 0.5) ** 2))
    k1 /= k1.sum()
    return np.outer(k1, k1)


def _correlate(padded: torch.Tensor, kern: np.ndarray, rows: int, cols: int) -> torch.Tensor:
    """sum_ab kern[a, b] * padded[:, a:a+rows, b:b+cols], taps in row-major
    order: the same order of sums for any run of rows."""
    out = None
    for a in range(kern.shape[0]):
        for b in range(kern.shape[1]):
            term = float(kern[a, b]) * padded[:, a : a + rows, b : b + cols]
            out = term if out is None else out + term
    return out


def patch_select(
    data,
    search_window: int = 9,
    similarity_window: int = 2,
    neighbours: int = 15,
    edge_parameter: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nonlocal neighbour search for 2D images (PatchSelect analogue).

    For every pixel, ranks the offsets of the ``(2*search_window+1)^2``
    search region by Gaussian-weighted patch distance and keeps the
    ``neighbours`` nearest; equal distances keep the lower offset first, as
    ``jax.lax.top_k`` does (a stable sort).  Returns ``(H_i, H_j, Weights)``,
    each ``(neighbours, H, W)``: the row and column of each neighbour and its
    weight ``exp(-d2 / edge_parameter^2)``.  ``H_i``/``H_j`` are int32
    (the JAX package returns uint16, which PyTorch cannot index with; the
    values are equal).  The rows go by in runs whose (offsets, rows, W)
    arrays stay under ``PATCH_BLOCK_ELEMENTS`` each; a run reads the rows of
    its patches' halo, so the result does not depend on the runs."""
    u = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.array(data, dtype=np.float32))
    u = u.to(torch.float32)
    if u.dim() != 2:
        raise ValueError("patch_select currently supports 2D images")
    H, W = u.shape
    dev = u.device
    sw, pw, K = int(search_window), int(similarity_window), int(neighbours)
    kern = _patch_kernel(pw)
    offsets = [
        (di, dj)
        for di in range(-sw, sw + 1)
        for dj in range(-sw, sw + 1)
        if not (di == 0 and dj == 0)
    ]
    M = len(offsets)
    off_i = torch.as_tensor([o[0] for o in offsets], device=dev)
    off_j = torch.as_tensor([o[1] for o in offsets], device=dev)
    cols = torch.arange(W, device=dev)
    edge2 = _f32(np.float32(edge_parameter) ** 2)
    rows_per_run = max(PATCH_BLOCK_ELEMENTS // (M * W), 1)
    h_i = torch.empty((K, H, W), dtype=torch.int32, device=dev)
    h_j = torch.empty_like(h_i)
    wts = torch.empty((K, H, W), dtype=torch.float32, device=dev)
    for r0 in range(0, H, rows_per_run):
        r1 = min(r0 + rows_per_run, H)
        # the run's rows with the patch halo, clipped to the image
        h0, h1 = max(r0 - pw, 0), min(r1 + pw, H)
        halo_rows = torch.arange(h0, h1, device=dev)
        centre = u[h0:h1]
        d2 = torch.empty((M, h1 - h0, W), dtype=torch.float32, device=dev)
        for m, (di, dj) in enumerate(offsets):
            # jnp.roll(u, (-di, -dj)): the neighbour at (r + di, c + dj) mod size
            shifted = u.index_select(0, (halo_rows + di) % H).roll(-dj, 1)
            d2[m] = (centre - shifted) ** 2
        # Gaussian-weighted SSD: convolve2d(mode="same") with zero fill (the
        # kernel is symmetric); zero rows stand for those beyond the image
        d2 = torch.nn.functional.pad(d2, (pw, pw, pw - (r0 - h0), pw - (h1 - r1)))
        d2 = _correlate(d2, kern, r1 - r0, W)
        rr = torch.arange(r0, r1, device=dev)
        ri = rr[None, :, None] + off_i[:, None, None]
        rj = cols[None, None, :] + off_j[:, None, None]
        valid = (ri >= 0) & (ri < H) & (rj >= 0) & (rj < W)
        d2 = torch.where(valid, d2, torch.inf)
        # the K smallest per pixel, equal values in offset order
        _, idx = torch.sort(d2.permute(1, 2, 0), dim=-1, stable=True)
        idx = idx[..., :K].permute(2, 0, 1)  # (K, rows, W)
        d2_sel = torch.gather(d2, 0, idx)
        h_i[:, r0:r1] = torch.clamp(rr[None, :, None] + off_i[idx], 0, H - 1).to(torch.int32)
        h_j[:, r0:r1] = torch.clamp(cols[None, None, :] + off_j[idx], 0, W - 1).to(torch.int32)
        w = torch.exp(-d2_sel / edge2)
        wts[:, r0:r1] = torch.where(torch.isfinite(d2_sel), w, 0.0)
        del d2, idx, d2_sel, w
    return h_i, h_j, wts


def _index_tensor(h, device) -> torch.Tensor:
    """A neighbour table (numpy uint16 as the legacy demos pass it, or any
    integer tensor) as int64 on ``device``."""
    if isinstance(h, torch.Tensor):
        return h.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.array(h, dtype=np.int64), device=device)


def NLTV(
    data: torch.Tensor,
    H_i,
    H_j,
    weights,
    regularisation_parameter: float = 0.0025,
    iterations: int = 5,
) -> torch.Tensor:
    """Nonlocal TV denoising on precomputed neighbour tables (2D, or 3D with
    one slice): a lagged-diffusivity fixed point on
    ``sum_k w_k |u - u(N_k)|_eps + 1/(2*lam) ||u - data||^2``, each
    iteration re-linearising the nonlocal term and solving the weighted
    average in closed form.  ``H_i``/``H_j``/``weights`` are
    :func:`patch_select`'s tables, as tensors or numpy arrays."""
    u0 = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.array(data, dtype=np.float32))
    u0 = u0.to(torch.float32)
    squeeze = False
    if u0.dim() == 3 and u0.shape[0] == 1:
        u0, squeeze = u0[0], True
    if u0.dim() != 2:
        raise ValueError("NLTV supports 2D images (reference parity)")
    hi = _index_tensor(H_i, u0.device)
    hj = _index_tensor(H_j, u0.device)
    w = weights if isinstance(weights, torch.Tensor) else torch.as_tensor(np.array(weights, dtype=np.float32))
    w = w.to(device=u0.device, dtype=torch.float32)
    lam = _f32(regularisation_parameter)
    eps = 1e-5

    u = u0
    for _ in range(iterations):
        nb = u[hi, hj]  # (K, H, W) gather of the neighbours' values
        r = w / torch.sqrt((u[None] - nb) ** 2 + eps * eps)
        denom = 1.0 + lam * torch.sum(r, dim=0)
        u = (u0 + lam * torch.sum(r * nb, dim=0)) / denom
    return u[None] if squeeze else u


# ---------------------------------------------------------------------------
# WAVELETS (multi-level Haar soft threshold)
# ---------------------------------------------------------------------------

_SQRT2 = float(np.sqrt(2.0))


def _haar_fwd_axis(x: torch.Tensor, dim: int):
    """Haar analysis along ``dim``: approximation, detail and the odd
    leftover element, which passes through."""
    n = x.shape[dim]
    ne = n - (n % 2)
    head = x.narrow(dim, 0, ne)
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(0, ne, 2)
    ev = head[tuple(idx)]
    idx[dim] = slice(1, ne, 2)
    od = head[tuple(idx)]
    a = (ev + od) / _SQRT2
    d = (ev - od) / _SQRT2
    return a, d, x.narrow(dim, ne, n - ne)


def _haar_inv_axis(a, d, tail, dim: int) -> torch.Tensor:
    ev = (a + d) / _SQRT2
    od = (a - d) / _SQRT2
    shp = list(ev.shape)
    shp[dim] *= 2
    x = torch.stack([ev, od], dim=dim + 1).reshape(shp)
    if tail.shape[dim]:
        x = torch.cat([x, tail], dim=dim)
    return x


def _soft(x: torch.Tensor, thr: float) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - thr, min=0.0)


def _haar_level(x, axes, thr: float):
    """One Haar level over ``axes``; thresholds every detail band.  Bands
    are (tensor, mask) with a mask entry per axis: 0 approximation, 1
    detail, 2 leftover."""
    bands = [(x, ())]
    for ax in axes:
        new = []
        for arr, mask in bands:
            a, d, tail = _haar_fwd_axis(arr, ax)
            new.append((a, mask + (0,)))
            new.append((d, mask + (1,)))
            new.append((tail, mask + (2,)))
        bands = new
    out = []
    for arr, mask in bands:
        if any(m == 1 for m in mask):
            arr = _soft(arr, thr)
        out.append((arr, mask))
    return out


def _haar_rebuild(bands, axes) -> torch.Tensor:
    for ax in reversed(axes):
        grouped = {}
        for arr, mask in bands:
            grouped.setdefault(mask[:-1], {})[mask[-1]] = arr
        bands = [
            (_haar_inv_axis(g[0], g[1], g[2], ax), mask)
            for mask, g in grouped.items()
        ]
    (x, _), = bands
    return x


def WAVELET_SHRINK(data, threshold: float, levels: int = 3) -> torch.Tensor:
    """Multi-level Haar wavelet soft thresholding (2D or 3D): the shrinkage
    the legacy ``*_WAVELETS`` method strings apply after the primary prox.
    Only axes of size >= 2 are transformed, so a (1, H, W) volume shrinks
    over H and W."""
    x = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.array(data, dtype=np.float32))
    x = x.to(torch.float32)
    thr = _f32(threshold)

    def shrink(x, level):
        axes = [ax for ax in range(x.dim()) if x.shape[ax] >= 2]
        if level == 0 or not axes:
            return x
        out = []
        for arr, mask in _haar_level(x, axes, thr):
            if all(m == 0 for m in mask):  # recurse on the approximation
                arr = shrink(arr, level - 1)
            out.append((arr, mask))
        return _haar_rebuild(out, axes)

    return shrink(x, int(levels))
