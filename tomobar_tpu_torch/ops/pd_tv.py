"""PD-TV (Chambolle-Pock) iterations: the plain PyTorch version and the
wrapper of the CUDA kernel in ``csrc/pd_tv.cu``.

Counterpart of ``tomobar_tpu/ops/pd_tv_pallas.py`` with the semantics of
the XLA path of ``tomobar_tpu.regularisers.PD_TV``: forward differences
reflect at the far edge, the divergence takes the neighbour before index 0
as zero, and the constants are tau = 0.1 lambda, sigma = 1 / (L tau),
theta = 1, lt = tau / lambda, all in float32.  Volumes are ``(nz, ny, nx)``;
``nz == 1`` is the 2D case with no z-term.  ``half_precision`` stores the
duals as bfloat16 between iterations.

Up to 8 slices, the tile kernel runs several iterations per launch on
tiles that it keeps in registers and shared memory; deeper volumes go to
the y-streaming wavefront kernel (``PDw``), whose sweep carries several
iterations through the volume as levels (see ``csrc/pd_tv.cu``).  Either
way a prox of n iterations is ``ceil(n / K)`` launches, the last one
shorter where K does not divide n.
"""

from __future__ import annotations

import numpy as np
import torch

from tomobar_tpu_torch import _build
from tomobar_tpu_torch.utils.tools import free_device_bytes

__all__ = ["pd_tv", "pd_tv_plain", "pd_tv_constants", "launch_plan", "z_chunks", "fuse",
           "CHUNK_BYTES", "MAX_ELEMENTS"]

# A prox holds eight volumes beside its input and output (u and three duals,
# twice), so a deep stack goes through in z-chunks.  n iterations widen a
# voxel's dependence cone by n slices, so a chunk is run with a halo of n
# slices on each inner side and only its own slices are kept: every kept
# voxel sees exactly the values it would see in the whole volume, and the
# result does not depend on the chunks.  A chunk with its halo keeps those
# eight volumes under the byte budget (CHUNK_BYTES; on a CUDA device a
# volume that needs more gets half of the free memory) and each of them
# under MAX_ELEMENTS.
CHUNK_BYTES = 8 * 2**30
MAX_ELEMENTS = 2**31 - 1
# csrc/pd_tv.cu's kPDZMax, the most slices the tile kernel takes (the
# wavefront takes the deeper volumes), and its kPDK and kPDWK, the
# iterations a launch of either fuses: tt_pd_tv_fuse's values, for a memory
# plan on meta tensors, which reaches no library
FUSE, FUSE_Z_MAX = 4, 8


def fuse(nz: int) -> int:
    """Iterations one launch takes on nz slices (``tt_pd_tv_fuse``)."""
    return FUSE


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
    """Plain PyTorch PD-TV on a (nz, ny, nx) float32 volume (a deep one in
    z-chunks, see :func:`z_chunks`)."""
    _check_shape(data)
    return _chunked(
        lambda v: _pd_tv_plain(v, regularisation_parameter, iterations, methodTV,
                               nonneg, lipschitz_const, half_precision),
        data, iterations,
    )


def _pd_tv_plain(data, regularisation_parameter, iterations, methodTV, nonneg,
                 lipschitz_const, half_precision):
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


def z_chunks(nz: int, ny: int, nx: int, iterations: int, budget_bytes: int):
    """``(z0, z1, h0, h1)`` per chunk: the slices [z0, z1) it keeps and the
    slices [h0, h1) it is run on (a halo of ``iterations`` slices on each
    side, cut at the volume's ends)."""
    per_slice = max(ny * nx, 1)
    deep = min(budget_bytes // (8 * 4 * per_slice), MAX_ELEMENTS // per_slice)
    if deep >= nz:
        return [(0, nz, 0, nz)]
    keep = max(deep - 2 * iterations, 1)
    return [
        (z0, min(z0 + keep, nz), max(z0 - iterations, 0), min(z0 + keep + iterations, nz))
        for z0 in range(0, nz, keep)
    ]


def _chunked(fn, data: torch.Tensor, iterations: int) -> torch.Tensor:
    """``fn(volume)`` (one prox) over the z-chunks of ``data``."""
    nz, ny, nx = data.shape
    budget = CHUNK_BYTES
    if data.device.type == "cuda" and 32 * data.numel() > budget:
        budget = free_device_bytes(data.device) // 2
    chunks = z_chunks(nz, ny, nx, iterations, budget)
    if len(chunks) == 1:
        return fn(data)
    out = torch.empty_like(data)
    for z0, z1, h0, h1 in chunks:
        out[z0:z1] = fn(data[h0:h1])[z0 - h0 : z1 - h0]
    return out


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
    tensor, the CUDA kernels for a CUDA tensor (the tile kernel up to
    ``FUSE_Z_MAX`` slices, the wavefront above), several iterations per
    launch (:func:`launch_plan`)."""
    if data.device.type == "cpu":
        return pd_tv_plain(
            data, regularisation_parameter, iterations, methodTV, nonneg,
            lipschitz_const, half_precision,
        )
    _check_shape(data)
    if data.device.type not in ("cuda", "meta"):
        raise ValueError(f"PD: data on {data.device}; the kernel takes CUDA tensors")
    if data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("PD: data must be contiguous float32")
    return _chunked(
        lambda v: _pd_tv_cuda(v, regularisation_parameter, iterations, methodTV,
                              nonneg, lipschitz_const, half_precision),
        data, iterations,
    )


def _pd_tv_cuda(data, regularisation_parameter, iterations, methodTV, nonneg,
                lipschitz_const, half_precision):
    """One prox on a contiguous float32 CUDA volume, :func:`launch_plan`'s
    launches of the tile kernel (``PD``) or, above ``FUSE_Z_MAX`` slices, of
    the wavefront kernel (``PDw``); on a meta volume their buffers and no
    launch."""
    assert data.numel() <= MAX_ELEMENTS  # z_chunks keeps a chunk below the cap
    sigma, tau, lt, theta = pd_tv_constants(regularisation_parameter, lipschitz_const)
    nz, ny, nx = data.shape
    dual_dtype = torch.bfloat16 if half_precision else torch.float32
    lib = None if data.is_meta else _build.library()
    k = fuse(nz) if lib is None else lib.tt_pd_tv_fuse(nz)
    plan = launch_plan(iterations, k)
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
    if lib is None:
        return u[(len(plan) - 1) % 2]
    kernel, name = (lib.tt_pd_tv_wave, "PDw") if nz > FUSE_Z_MAX else (lib.tt_pd_tv, "PD")
    stream = torch.cuda.current_stream(data.device).cuda_stream
    unused = data.data_ptr()  # stands in for a buffer the launch does not touch
    with torch.cuda.device(data.device):
        for i, (k, first, last) in enumerate(plan):
            src = [unused] * 3 if first else [p.data_ptr() for p in ps[(i - 1) % 2]]
            dst = [unused] * 3 if last else [p.data_ptr() for p in ps[i % 2]]
            # 2D: the third dual is never touched; the second stands in for it
            err = kernel(
                data.data_ptr(), unused if first else u[(i - 1) % 2].data_ptr(),
                src[0], src[1], src[-1], u[i % 2].data_ptr(), dst[0], dst[1], dst[-1],
                nz, ny, nx, sigma, tau, lt, theta, int(methodTV == 0),
                int(bool(nonneg)), int(half_precision), k, int(first), int(last),
                stream,
            )
            _build.check(name, err)
            _build.launch_counts[name] += 1
    return u[(len(plan) - 1) % 2]
