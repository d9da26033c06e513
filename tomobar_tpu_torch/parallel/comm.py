"""The collectives of the sharded layer, each over a ``torch.distributed``
process group.

The JAX package gets its collectives from XLA (``shard_map``'s ``psum``
and the halo exchanges its partitioner inserts); with one process per
device the port writes them out:

* :func:`all_reduce` (sum or max) and :func:`all_gather` (equal-sized
  tensors along a dimension) over a group;
* :func:`z_halo`: a z-slab widened by its neighbours' slices, and
  :func:`z_window`: a z-slab widened to any window of slices around it.
  They move only the slices inside the window, from as many slabs as the
  window spans, by point-to-point sends and receives.

Gloo reduces and gathers only host tensors (its CUDA support is broadcast,
all_reduce and barrier), so where a group's backend is gloo and a tensor
lies on a CUDA device, the operation goes explicitly through pinned host
memory.  That is the backend's limit, not a fallback: with NCCL, CUDA
tensors go direct.  :data:`stats` counts, per operation, its calls, the
bytes it moved (the payload of an all_reduce; the bytes this rank received
in a gather or a halo), the bytes it staged through the host (device to
host plus host to device) and the host's seconds in it (staged operations
return when done; with NCCL the seconds are the enqueue only).  A group of
one rank moves nothing.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "z_halo", "z_window", "stats", "reset_stats"]

# op -> {"calls", "bytes", "staged", "seconds"} since the last reset
stats: Dict[str, Dict[str, float]] = {}


def reset_stats() -> None:
    stats.clear()


def _count(op: str, moved: int, staged: int, t0: float) -> None:
    entry = stats.setdefault(op, {"calls": 0, "bytes": 0, "staged": 0, "seconds": 0.0})
    entry["calls"] += 1
    entry["bytes"] += int(moved)
    entry["staged"] += int(staged)
    entry["seconds"] += time.perf_counter() - t0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staged(group, t: torch.Tensor) -> bool:
    """True where ``t`` goes through the host: a CUDA tensor on gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


# pinned host buffers by (tag, dtype, numel), reused from call to call:
# pinning is slow, and a solver moves the same shapes every iteration
_PINNED: Dict[Tuple[str, torch.dtype, int], torch.Tensor] = {}


def _host_empty(shape, dtype: torch.dtype, tag: str) -> torch.Tensor:
    """A pinned host buffer of ``shape``, reused for the same tag and size."""
    numel = 1
    for d in shape:
        numel *= int(d)
    key = (tag, dtype, numel)
    buf = _PINNED.get(key)
    if buf is None:
        buf = torch.empty(numel, dtype=dtype, pin_memory=True)
        _PINNED[key] = buf
    return buf.view(tuple(shape))


def _host(t: torch.Tensor, tag: str) -> torch.Tensor:
    """A pinned host copy of ``t`` (in the buffer of :func:`_host_empty`)."""
    return _host_empty(t.shape, t.dtype, tag).copy_(t)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (``op`` "sum" or "max") and
    return it."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if dist.get_world_size(group) == 1:
        return t
    t0 = time.perf_counter()
    if _staged(group, t):
        h = _host(t.contiguous(), "reduce")
        dist.all_reduce(h, op=red, group=group)
        t.copy_(h)
        _count("all_reduce", _nbytes(t), 2 * _nbytes(t), t0)
    else:
        dist.all_reduce(t, op=red, group=group)
        _count("all_reduce", _nbytes(t), 0, t0)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's equal-sized tensors ``t`` concatenated along ``dim`` in
    the group's rank order."""
    p = dist.get_world_size(group)
    if p == 1:
        return t
    t0 = time.perf_counter()
    t = t.contiguous()
    if _staged(group, t):
        h = _host(t, "gather_in")
        parts = [_host_empty(t.shape, t.dtype, f"gather_out{i}") for i in range(p)]
        dist.all_gather(parts, h, group=group)
        out = torch.cat(parts, dim).to(t.device)
        _count("all_gather", (p - 1) * _nbytes(t), (p + 1) * _nbytes(t), t0)
    else:
        parts = [torch.empty_like(t) for _ in range(p)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts, dim)
        _count("all_gather", (p - 1) * _nbytes(t), 0, t0)
    return out


def z_halo(x: torch.Tensor, mesh, before: int, after: int) -> Tuple[torch.Tensor, int]:
    """This rank's z-slab ``x`` (dim 0) widened by ``before`` slices of the
    slabs before it and ``after`` slices of the slabs after it, as far as
    the volume reaches (nothing is filled beyond its ends), and the number
    of slices it added before the slab.  Every rank of the z group calls it
    with the same halo."""
    nz, n_all = x.shape[0], x.shape[0] * mesh.shape["z"]
    if before <= 0 and after <= 0:
        return x, 0
    return z_window(x, mesh, lambda j: (max(j * nz - before, 0),
                                        min((j + 1) * nz + after, n_all)))


def z_window(x: torch.Tensor, mesh, window: Callable[[int], Tuple[int, int]]
             ) -> Tuple[torch.Tensor, int]:
    """This rank's z-slab ``x`` (dim 0) widened to the slices
    ``window(z_index)`` of the whole volume, ``[w0, w1)``, which must hold
    the slab, and the number of slices it added before the slab.  Every
    rank of the z group calls it with the same ``window``; each sends every
    other slab the part of its own slab that lies in that slab's window
    (counted as ``z_halo``)."""
    n_z = mesh.shape["z"]
    nz = x.shape[0]
    z = mesh.z_index
    if n_z == 1 or all(window(j) == (j * nz, (j + 1) * nz) for j in range(n_z)):
        return x, 0
    w0, w1 = window(z)
    t0 = time.perf_counter()
    x = x.contiguous()
    group = mesh.z_group
    staged = _staged(group, x)
    ops: List = []
    recvs: List[Tuple[int, torch.Tensor]] = []
    moved = staged_bytes = 0
    for j in range(n_z):
        if j == z:
            continue
        peer = mesh.z_ranks[j]
        # what this rank sends to slab j: its own slices in j's window
        a0, a1 = window(j)
        s0, s1 = max(a0, z * nz), min(a1, (z + 1) * nz)
        if s0 < s1:
            part = x[s0 - z * nz:s1 - z * nz]
            if staged:
                part = _host(part, f"halo_send{j}")
                staged_bytes += _nbytes(part)
            ops.append(dist.P2POp(dist.isend, part, peer, group))
        # what it receives from slab j: j's slices in its own window
        r0, r1 = max(w0, j * nz), min(w1, (j + 1) * nz)
        if r0 < r1:
            shape = (r1 - r0, *x.shape[1:])
            buf = (_host_empty(shape, x.dtype, f"halo_recv{j}") if staged
                   else torch.empty(shape, dtype=x.dtype, device=x.device))
            ops.append(dist.P2POp(dist.irecv, buf, peer, group))
            recvs.append((j, buf))
            moved += _nbytes(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    parts = [buf for j, buf in recvs if j < z] + [None] + [buf for j, buf in recvs if j > z]
    if staged:
        staged_bytes += moved
        parts = [p if p is None else p.to(x.device) for p in parts]
    parts[parts.index(None)] = x
    _count("z_halo", moved, staged_bytes, t0)
    return (torch.cat(parts, 0) if len(parts) > 1 else x), z * nz - w0
