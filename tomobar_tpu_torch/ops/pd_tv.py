"""PD-TV (Chambolle-Pock) iterations: the plain PyTorch version and the
wrapper of the CUDA kernel in ``csrc/pd_tv.cu``.

Counterpart of ``tomobar_tpu/ops/pd_tv_pallas.py`` with the semantics of
the XLA path of ``tomobar_tpu.regularisers.PD_TV``: forward differences
reflect at the far edge, the divergence takes the neighbour before index 0
as zero, and the constants are tau = 0.1 lambda, sigma = 1 / (L tau),
theta = 1, lt = tau / lambda, all in float32.  Volumes are ``(nz, ny, nx)``;
``nz == 1`` is the 2D case with no z-term.  ``half_precision`` stores the
duals as bfloat16 between iterations.

The kernel runs several iterations per launch on tiles that it keeps in
registers and shared memory (see ``csrc/pd_tv.cu``): a prox of n iterations
is ``ceil(n / K)`` launches, the last one shorter where K does not divide n.
"""

from __future__ import annotations

import numpy as np
import torch

from tomobar_tpu_torch import _build

__all__ = ["pd_tv", "pd_tv_plain", "pd_tv_constants", "launch_plan"]


def pd_tv_constants(regularisation_parameter: float, lipschitz_const: float):
    """(sigma, tau, lt, theta) as float32 values, computed as the JAX XLA
    path computes them (``regularisers.py`` PD_TV)."""
    tau = np.float32(regularisation_parameter * 0.1)
    sigma = np.float32(np.float32(1.0) / (np.float32(lipschitz_const) * tau))
    lt = np.float32(tau / np.float32(regularisation_parameter))
    return float(sigma), float(tau), float(lt), 1.0


def _fwd_diff(u: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference with reflect-at-end boundary: d[-1]=u[-2]-u[-1]."""
    n = u.shape[dim]
    nxt = torch.cat([u.narrow(dim, 1, n - 1), u.narrow(dim, n - 2, 1)], dim=dim)
    return nxt - u


def _bwd_diff_zero(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Backward difference with zero boundary at 0: d[0]=p[0]."""
    n = p.shape[dim]
    prev = torch.cat(
        [torch.zeros_like(p.narrow(dim, 0, 1)), p.narrow(dim, 0, n - 1)], dim=dim
    )
    return p - prev


def _check_shape(data: torch.Tensor) -> None:
    if data.dim() != 3:
        raise ValueError("PD-TV takes (nz, ny, nx) volumes")
    nz, ny, nx = data.shape
    if ny < 2 or nx < 2 or nz == 0:
        raise ValueError(f"PD-TV needs ny, nx >= 2, got {tuple(data.shape)}")


def pd_tv_plain(
    data: torch.Tensor,
    regularisation_parameter: float,
    iterations: int,
    methodTV: int = 0,
    nonneg: int = 0,
    lipschitz_const: float = 8.0,
    half_precision: bool = False,
) -> torch.Tensor:
    """Plain PyTorch PD-TV on a (nz, ny, nx) float32 volume."""
    _check_shape(data)
    sigma, tau, lt, theta = pd_tv_constants(regularisation_parameter, lipschitz_const)
    dual_dtype = torch.bfloat16 if half_precision else torch.float32
    # P1 <-> x (dim 2), P2 <-> y (dim 1), P3 <-> z (dim 0, 3D only)
    dims = [2, 1] + ([0] if data.shape[0] > 1 else [])
    u = data
    ps = [torch.zeros(data.shape, dtype=dual_dtype, device=data.device) for _ in dims]
    for _ in range(iterations):
        new_ps = [p.to(torch.float32) + sigma * _fwd_diff(u, d) for p, d in zip(ps, dims)]
        if methodTV == 0:
            denom = new_ps[0] * new_ps[0]
            for p in new_ps[1:]:
                denom = denom + p * p
            scale = torch.where(
                denom > 1.0, torch.rsqrt(torch.clamp(denom, min=1e-30)), 1.0
            )
            new_ps = [p * scale for p in new_ps]
        else:
            new_ps = [p / torch.clamp(torch.abs(p), min=1.0) for p in new_ps]
        div = _bwd_diff_zero(new_ps[0], dims[0])
        for p, d in zip(new_ps[1:], dims[1:]):
            div = div + _bwd_diff_zero(p, d)
        uc = torch.clamp(u, min=0.0) if nonneg else u
        u_new = (uc + tau * div + lt * data) / (1.0 + lt)
        u = u_new + theta * (u_new - uc)
        ps = [p.to(dual_dtype) for p in new_ps]
    return u


def launch_plan(iterations: int, fuse: int):
    """The launches of one prox: ``(iterations of the launch, first, last)``
    for each.  ``first`` starts from u = data and zero duals without reading
    either, ``last`` writes no duals."""
    counts = [fuse] * (iterations // fuse)
    if iterations % fuse:
        counts.append(iterations % fuse)
    return [(k, i == 0, i == len(counts) - 1) for i, k in enumerate(counts)]


def pd_tv(
    data: torch.Tensor,
    regularisation_parameter: float,
    iterations: int,
    methodTV: int = 0,
    nonneg: int = 0,
    lipschitz_const: float = 8.0,
    half_precision: bool = False,
) -> torch.Tensor:
    """PD-TV on a (nz, ny, nx) float32 volume: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor, several iterations per launch
    (:func:`launch_plan`)."""
    if data.device.type == "cpu":
        return pd_tv_plain(
            data, regularisation_parameter, iterations, methodTV, nonneg,
            lipschitz_const, half_precision,
        )
    _check_shape(data)
    if data.device.type != "cuda":
        raise ValueError(f"PD: data on {data.device}; the kernel takes CUDA tensors")
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("PD: data must be contiguous float32")
    if data.numel() > 2**31 - 1:
        raise ValueError("PD: volume exceeds int32 indexing")
    sigma, tau, lt, theta = pd_tv_constants(regularisation_parameter, lipschitz_const)
    nz, ny, nx = data.shape
    dual_dtype = torch.bfloat16 if half_precision else torch.float32
    lib = _build.library()
    plan = launch_plan(iterations, lib.tt_pd_tv_fuse(nz))
    if not plan:
        return data.clone()
    # launch i reads u[(i - 1) % 2] and the duals ps[(i - 1) % 2] and writes
    # u[i % 2] and ps[i % 2]; separate buffers, because a tile's halo is its
    # neighbours' output.  The first launch reads neither, the last writes
    # no duals, so short plans need fewer buffers.
    u = [torch.empty_like(data) for _ in range(min(len(plan), 2))]
    ps = [
        [torch.empty(data.shape, dtype=dual_dtype, device=data.device)
         for _ in range(3 if nz > 1 else 2)]
        for _ in range(min(len(plan) - 1, 2))
    ]
    stream = torch.cuda.current_stream(data.device).cuda_stream
    unused = data.data_ptr()  # stands in for a buffer the launch does not touch
    with torch.cuda.device(data.device):
        for i, (k, first, last) in enumerate(plan):
            src = [unused] * 3 if first else [p.data_ptr() for p in ps[(i - 1) % 2]]
            dst = [unused] * 3 if last else [p.data_ptr() for p in ps[i % 2]]
            # 2D: the third dual is never touched; the second stands in for it
            err = lib.tt_pd_tv(
                data.data_ptr(), unused if first else u[(i - 1) % 2].data_ptr(),
                src[0], src[1], src[-1], u[i % 2].data_ptr(), dst[0], dst[1], dst[-1],
                nz, ny, nx, sigma, tau, lt, theta, int(methodTV == 0),
                int(bool(nonneg)), int(half_precision), k, int(first), int(last),
                stream,
            )
            _build.check("PD", err)
            _build.launch_counts["PD"] += 1
    return u[(len(plan) - 1) % 2]
