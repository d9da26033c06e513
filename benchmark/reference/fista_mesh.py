"""Plain reference of ``RecToolsIRCuPy(..., mesh=...).FISTA`` on a world of
ranks: each rank computes its z-slab of what :func:`benchmark.reference.
fista.fista` computes on the whole volume, with the same arithmetic, and
rank 0 gathers the volume.

The ranks of the default ``torch.distributed`` group (none: a world of one)
hold equal slabs of the volume's slices in rank order.  A slice's
projections are its own, so the projector needs no exchange.  What couples
the slabs is written out here, independently of the port's halo:

* the power method: the whole volume's draw from :mod:`fista`'s generator
  (seeded with 0 on the device), of which each rank keeps its slab; the
  norm is the square root of the ranks' sums of squares (float64,
  all-reduced);
* the PWLS weights' maximum: all-reduced;
* PD-TV (:func:`pd_tv_slab`): every iteration exchanges one slice with
  each neighbour, u's first slice back (for the forward difference at the
  slab's last slice) and p_z's last slice forward (for the divergence at
  the slab's first slice).  The far edge's reflection, d[-1] = u[-2] -
  u[-1], is on the volume's last slice only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from benchmark.reference.common import rounder
from benchmark.reference.fista import circle_mask
from benchmark.reference.pd_tv import constants
from benchmark.reference.projector import Operator


def _world():
    """(rank, ranks) of the default group, (0, 1) where none runs."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _sum(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    t = t.reshape(1).clone()
    if _world()[1] > 1:
        dist.all_reduce(t, op=op)
    return t[0]


def _exchange(send_back, send_fwd):
    """Send ``send_back`` to the rank before and ``send_fwd`` to the rank
    after (either None: nothing), and return what the rank after sent back
    and what the rank before sent forward (None at the volume's ends)."""
    rank, ranks = _world()
    ops, got_next, got_prev = [], None, None
    if send_back is not None and rank > 0:
        ops.append(dist.P2POp(dist.isend, send_back.contiguous(), rank - 1))
    if send_back is not None and rank < ranks - 1:
        got_next = torch.empty_like(send_back)
        ops.append(dist.P2POp(dist.irecv, got_next, rank + 1))
    if send_fwd is not None and rank < ranks - 1:
        ops.append(dist.P2POp(dist.isend, send_fwd.contiguous(), rank + 1))
    if send_fwd is not None and rank > 0:
        got_prev = torch.empty_like(send_fwd)
        ops.append(dist.P2POp(dist.irecv, got_prev, rank - 1))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got_next, got_prev


def pd_tv_slab(data: torch.Tensor, lam: float, iterations: int, lipschitz: float = 12.0,
               nonneg: bool = True, prec: str = "fp32") -> torch.Tensor:
    """This rank's slab of iso PD-TV of the whole (nz, ny, nx) volume, from
    the slab ``data`` (at least 2 slices a rank where there are several),
    as :func:`benchmark.reference.pd_tv.pd_tv` computes the whole."""
    q = rounder(prec)
    rank, ranks = _world()
    last = rank == ranks - 1
    sigma, tau, lt = constants(lam, lipschitz)
    nz = data.shape[0]
    if ranks > 1 and nz < 2:
        raise ValueError("the slab reference needs 2 slices a rank or more")
    u = data.clone()
    ps = [torch.zeros_like(data) for _ in range(3)]  # x, y, z
    tmp = torch.empty_like(data)
    for _ in range(iterations):
        u_next, _ = _exchange(u[0], None)
        for p, d in zip(ps[:2], (2, 1)):
            n = u.shape[d]
            torch.sub(u.narrow(d, 1, n - 1), u.narrow(d, 0, n - 1), out=tmp.narrow(d, 0, n - 1))
            torch.sub(u.narrow(d, n - 2, 1), u.narrow(d, n - 1, 1), out=tmp.narrow(d, n - 1, 1))
            p.add_(tmp, alpha=sigma)
        torch.sub(u[1:], u[:-1], out=tmp[:-1])
        if last:
            torch.sub(u[-2], u[-1], out=tmp[-1])
        else:
            torch.sub(u_next, u[-1], out=tmp[-1])
        ps[2].add_(tmp, alpha=sigma)
        norm2 = ps[0] * ps[0]
        for p in ps[1:]:
            norm2.addcmul_(p, p)
        scale = torch.rsqrt_(norm2.clamp_(min=1.0))
        for i, p in enumerate(ps):
            ps[i] = q(p.mul_(scale))
        _, pz_prev = _exchange(None, ps[2][-1])
        div = ps[0].clone()
        for p, d in zip(ps[:2], (2, 1)):
            if p is not ps[0]:
                div.add_(p)
            n = p.shape[d]
            div.narrow(d, 1, n - 1).sub_(p.narrow(d, 0, n - 1))
        div.add_(ps[2])
        div[1:].sub_(ps[2][:-1])
        if pz_prev is not None:
            div[0].sub_(pz_prev)
        uc = torch.clamp(u, min=0.0) if nonneg else u
        u_new = torch.add(uc, div, alpha=tau).add_(data, alpha=lt).div_(1.0 + lt)
        u = q(u_new.mul_(2.0).sub_(uc))
    return u


def power_method(op: Operator, nz_all: int, z0: int, z1: int, device,
                 iterations: int = 15) -> float:
    """:func:`benchmark.reference.fista.power_method` on the slabs: the
    start is slices [z0, z1) of the whole volume's draw."""
    gen = torch.Generator(device=device).manual_seed(0)
    x0 = torch.randn((nz_all, op.n, op.n), generator=gen, dtype=torch.float32, device=device)
    x0 = x0[z0:z1].clone()
    y = op.fp(x0)
    del x0
    s = None
    for _ in range(iterations):
        x1 = op.bp(y)
        s = torch.sqrt(_sum(torch.sum(x1.double() ** 2))).float()
        y = op.fp(x1 / s)
    return float(s)


def fista_mesh(sino: torch.Tensor, theta: np.ndarray, cor: float, n: int, os_number: int,
               iterations: int, regul: dict, prec: str = "fp32"):
    """The reconstruction of the whole ``sino`` [detY, angles, detX] (every
    rank holds it) as :func:`benchmark.reference.fista.fista`, each rank
    computing its slab; rank 0 returns the whole volume, the others None."""
    q = rounder(prec)
    rank, ranks = _world()
    dev = sino.device
    nz_all, n_ang, det_x = sino.shape
    if nz_all % ranks:
        raise ValueError(f"{nz_all} slices do not split evenly over {ranks} ranks")
    step = nz_all // ranks
    z0, z1 = rank * step, (rank + 1) * step
    sino = sino[z0:z1]
    subsets = [np.arange(s, n_ang, os_number) for s in range(min(os_number, n_ang))]

    def op(s):
        return Operator(theta[subsets[s]], cor, det_x, n, dev, prec, cache_w=True)

    ops = {0: op(0)}
    L = power_method(ops[0], nz_all, z0, z1, dev)
    L_inv = float(np.float32(1.0 / L))
    w = torch.clamp(sino, min=1e-6)
    w = w / _sum(torch.max(w), dist.ReduceOp.MAX)
    b_sub = [sino[:, torch.as_tensor(ix, device=dev)] for ix in subsets]
    w_sub = [w[:, torch.as_tensor(ix, device=dev)] for ix in subsets]
    x = x_t = torch.zeros((step, n, n), dtype=torch.float32, device=dev)
    t = np.float32(1.0)
    one, four, half = np.float32(1.0), np.float32(4.0), np.float32(0.5)
    lam, tv_iters = float(regul["regul_param"]), int(regul["iterations"])
    for _ in range(iterations):
        for s in range(len(subsets)):
            A = ops.pop(s) if s in ops else op(s)
            x_old, t_old = x, t
            grad = A.bp(q((A.fp(x_t) - b_sub[s]) * w_sub[s]))
            del A
            x = q(torch.clamp(x_t - L_inv * grad, min=0.0))
            x = pd_tv_slab(x, lam, tv_iters, 12.0, True, prec)
            t = np.float32((one + np.sqrt(one + four * t * t)) * half)
            x_t = q(x + float(np.float32((t_old - one) / t)) * (x - x_old))
    x = (x * circle_mask(n, 1.0, dev)).contiguous()
    if ranks == 1:
        return x
    whole = torch.empty((nz_all, n, n), dtype=x.dtype, device=dev) if rank == 0 else None
    dist.gather(x, list(whole.chunk(ranks, 0)) if rank == 0 else None, dst=0)
    return whole
