"""Parallel-beam Radon transform pair (FP / BP) on PyTorch tensors.

Counterpart of ``tomobar_tpu/ops/projector.py``, with its two backends,
each an exact numerical adjoint pair:

* ``"pallas"``: the two-pass shear/resample pair of
  :mod:`tomobar_tpu_torch.ops.projector_kernels` (K1-K4, and K1p/K4p in
  place of K1/K4 for one slice whose driven rows come in groups of 8, under
  the JAX package's conditions): the CUDA kernels for CUDA tensors, their
  plain versions for CPU tensors.
* ``"xla"``: the one-pass Joseph pair (``_fp_driven`` / ``_bp_driven``),
  plain PyTorch gathers on either device, as the JAX package's XLA path.
  It differs from the two-pass pair by ~1-2%, and ``GOLDEN_CPU`` of the
  JAX package's tests was frozen on it.

``set_projector_backend`` (or the ``TOMOBAR_TPU_PROJECTOR`` environment
variable) picks one, with the JAX package's names.  ``"auto"`` is an alias
of ``"pallas"``: the two-pass pair on every device, which is deliberately
not the JAX package's choice (there "auto" is XLA on anything but a TPU):
the port's operator is the counterpart of the TPU path, its CPU path is
what every port test holds against the interpret-mode Pallas kernels, and
the smoke run compares the GPU with the CPU on it.

Public layouts are the JAX package's canonical ones: volumes
``(nz, ny, nx)`` and sinograms ``(detY, angles, detX)``; 2D inputs
``(ny, nx)`` / ``(angles, detX)`` are accepted and returned as 2D.

A detector cell ``t`` at angle ``theta`` sees the line
``x cos(theta) + y sin(theta) = t - (det_x-1)/2 + cor``
(conventions in :mod:`tomobar_tpu_torch.geometry`).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops.projector_kernels import (
    DrivenParams,
    _partition,
    driven_params,
    packed_splits,
    resample_bp,
    resample_fp,
    shear_fp,
    shear_fp_packed,
    unshear_bp,
    unshear_bp_packed,
)

__all__ = [
    "CHUNK_BYTES",
    "MAX_ELEMENTS",
    "radon_fp",
    "radon_bp",
    "forward_project",
    "back_project",
    "Projector",
    "set_projector_backend",
]

_BACKEND = os.environ.get("TOMOBAR_TPU_PROJECTOR", "auto")


def set_projector_backend(name: str) -> None:
    """Select the projector implementation by the JAX package's names
    (see the module docstring)."""
    global _BACKEND
    if name not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown projector backend {name!r}")
    _BACKEND = name


# A stack of any depth goes through the kernels in z-chunks (slices are
# independent in FP and BP, so the chunks change no bit of the result).  A
# chunk keeps a group's u-lines ``s``/``q`` (A x chunk x LU floats, the
# largest intermediate) under CHUNK_BYTES, which bounds the memory of a call
# beside its input and output, and every tensor a kernel sees under
# MAX_ELEMENTS, the kernels' element cap.
CHUNK_BYTES = 2 * 2**30
MAX_ELEMENTS = 2**31 - 1


def _angle_partition(angles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x-driven (|cos| >= |sin|, ties included) and y-driven angle indices."""
    cos_v = np.cos(angles)
    sin_v = np.sin(angles)
    xdrive = np.abs(cos_v) >= np.abs(sin_v)
    return np.where(xdrive)[0], np.where(~xdrive)[0]


# ---------------------------------------------------------------------------
# vertical per-angle CoR: detector-centre z shift, applied as a per-angle
# linear-interp shift along detY around the kernels; zero fill outside keeps
# the FP/BP pair an exact adjoint (shift by +dz transposes to shift by -dz)
# ---------------------------------------------------------------------------


def _vshift_sino(sino: torch.Tensor, dz: np.ndarray) -> torch.Tensor:
    """out[v, a, t] = lin-interp of sino at (v + dz[a], a, t), zero outside.
    Angles are independent, so they go by in runs that keep the gather and
    its temporaries under ``CHUNK_BYTES`` and ``MAX_ELEMENTS`` each; the
    result does not depend on the runs."""
    nz, A, det_x = sino.shape
    dzt = torch.as_tensor(np.asarray(dz), dtype=sino.dtype, device=sino.device)
    kf = torch.floor(dzt)
    f = (dzt - kf)[None, :, None]
    i0 = torch.arange(nz, device=sino.device)[:, None] + kf.to(torch.int64)[None, :]
    per_angle = max(nz * det_x, 1)
    step = max(min(CHUNK_BYTES // (4 * per_angle), MAX_ELEMENTS // per_angle), 1)
    out = torch.empty_like(sino)
    for a0 in range(0, A, step):
        a1 = min(a0 + step, A)
        part = sino[:, a0:a1]
        acc = None
        for i, w in ((i0[:, a0:a1], 1.0 - f[:, a0:a1]), (i0[:, a0:a1] + 1, f[:, a0:a1])):
            valid = ((i >= 0) & (i < nz))[:, :, None]
            g = torch.gather(
                part, 0, torch.clamp(i, 0, nz - 1)[:, :, None].expand(nz, a1 - a0, det_x)
            )
            term = w * torch.where(valid, g, 0.0)
            acc = term if acc is None else acc + term
        out[:, a0:a1] = acc
    return out


# ---------------------------------------------------------------------------
# the one-pass Joseph pair (x-driven shown; the y-driven group swaps the
# volume's y and x): the JAX package's float32 arithmetic in its order, in
# blocks of rows (FP) or angles (BP) whose gathers stay under the budget
# ---------------------------------------------------------------------------

# elements of a block's gather intermediates
_BLOCK_BUDGET_ELEMS = 16 * 1024 * 1024


def _pick_block(total: int, other_elems: int) -> int:
    """A block length that keeps other_elems * block under the budget."""
    if total <= 0:
        return 1
    return int(min(total, max(1, _BLOCK_BUDGET_ELEMS // max(1, other_elems))))


def _pad_to_multiple(x: torch.Tensor, dim: int, multiple: int, value: float = 0.0) -> torch.Tensor:
    rem = (-x.shape[dim]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[dim] = rem
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim)


def _as_f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def _fp_driven(vol: torch.Tensor, cos_v, sin_v, cor_v, det_x: int) -> torch.Tensor:
    """Joseph x-driven FP for angles with |cos| >= |sin|: one linear
    interpolation per crossed row.  vol (nz, ny, nx) float32 -> (nz, A,
    det_x)."""
    nz, ny, nx = vol.shape
    dev = vol.device
    n_ang = int(np.size(cos_v))
    cos_t, sin_t, cor_t = (_as_f32(a, dev) for a in (cos_v, sin_v, cor_v))
    inv_c = 1.0 / cos_t
    t = torch.arange(det_x, dtype=torch.float32, device=dev)
    # detector coordinate s_t = t - (det_x-1)/2 + cor, (A, T)
    s_t = t[None, :] - (det_x - 1) / 2.0 + cor_t[:, None]
    cx = (nx - 1) / 2.0
    y_block = _pick_block(ny, nz * n_ang * det_x)
    volp = _pad_to_multiple(torch.nn.functional.pad(vol, (1, 1)), 1, y_block)
    y_base = torch.arange(y_block, dtype=torch.float32, device=dev)
    acc = torch.zeros((nz, n_ang, det_x), dtype=torch.float32, device=dev)
    shape = (nz, n_ang, y_block, det_x)
    for yb in range(volp.shape[1] // y_block):
        rows = volp[:, yb * y_block:(yb + 1) * y_block]  # (nz, B, nx+2)
        yv = (yb * y_block + y_base) - (ny - 1) / 2.0
        # sample position along x of each (angle, row, detector cell)
        pos = (s_t[:, None, :] - yv[None, :, None] * sin_t[:, None, None]) * inv_c[:, None, None] + cx
        i0 = torch.floor(pos)
        frac = pos - i0
        i0 = i0.to(torch.int64)
        # the gather index is int64, 8 B per (angle, row, cell) of the block,
        # expanded over the slices without a copy; rows likewise over angles
        src = rows[:, None].expand(nz, n_ang, y_block, nx + 2)
        g0 = torch.gather(src, 3, torch.clamp(i0 + 1, 0, nx + 1)[None].expand(shape))
        g1 = torch.gather(src, 3, torch.clamp(i0 + 2, 0, nx + 1)[None].expand(shape))
        contrib = (1.0 - frac)[None] * g0 + frac[None] * g1
        acc = acc + torch.sum(contrib, dim=2)
    return acc * torch.abs(inv_c)[None, :, None]


def _bp_driven(sino: torch.Tensor, cos_v, sin_v, cor_v, ny: int, nx: int) -> torch.Tensor:
    """Exact adjoint of :func:`_fp_driven`: the same hat weights, gathered
    from the sinogram side.  sino (nz, A, det_x) float32 -> (nz, ny, nx)."""
    nz, n_ang, det_x = sino.shape
    dev = sino.device
    ang_block = _pick_block(n_ang, nz * ny * nx)
    sinop = _pad_to_multiple(torch.nn.functional.pad(sino, (2, 2)), 1, ang_block)
    # padded angles get cos 1.0, so 1/cos stays finite
    cosp = _pad_to_multiple(_as_f32(cos_v, dev), 0, ang_block, 1.0)
    sinp = _pad_to_multiple(_as_f32(sin_v, dev), 0, ang_block)
    corp = _pad_to_multiple(_as_f32(cor_v, dev), 0, ang_block)
    xs = torch.arange(nx, dtype=torch.float32, device=dev) - (nx - 1) / 2.0
    ys = torch.arange(ny, dtype=torch.float32, device=dev) - (ny - 1) / 2.0
    acc = torch.zeros((nz, ny, nx), dtype=torch.float32, device=dev)
    for ab in range(sinop.shape[1] // ang_block):
        blk = slice(ab * ang_block, (ab + 1) * ang_block)
        rows = sinop[:, blk]  # (nz, Ab, det_x+4)
        c, s, r = cosp[blk], sinp[blk], corp[blk]
        a_abs = torch.abs(1.0 / c)[:, None, None]
        # detector coordinate of each voxel centre, (Ab, ny, nx)
        t_c = (xs[None, None, :] * c[:, None, None] + ys[None, :, None] * s[:, None, None]
               + (det_x - 1) / 2.0 - r[:, None, None])
        tf = torch.floor(t_c)
        part = None
        for d in (-1, 0, 1):
            tau = tf + d
            w = torch.clamp(1.0 - a_abs * torch.abs(tau - t_c), min=0.0) * a_abs
            # int64 index, 8 B per (angle, voxel) of the block, expanded
            # over the slices without a copy
            idx = torch.clamp(tau.to(torch.int64) + 2, 0, det_x + 3).reshape(1, ang_block, ny * nx)
            g = torch.gather(rows, 2, idx.expand(nz, ang_block, ny * nx)).reshape(nz, ang_block, ny, nx)
            term = torch.sum(w[None] * g, dim=1)
            part = term if part is None else part + term
        acc = acc + part
    return acc


class _Group(NamedTuple):
    """One driven-angle group with its parameters on the device."""

    idx: torch.Tensor  # where BP (K3) reads the group's angles in the sinogram
    pos: torch.Tensor  # where FP writes them in its output
    prm: DrivenParams
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    swap: bool  # y-driven: the kernels see the volume's y and x swapped
    splits: Optional[int]  # K1p's runs of rows (None: not packed)


class _DrivenPlan:
    """One driven group given by per-angle data: the counterpart of
    ``fp_driven_pallas_from_data`` / ``bp_driven_pallas_from_data``
    (``tomobar_tpu/ops/projector_pallas.py``).  A geometry's :class:`_Plan`
    is its x- and y-driven groups; a shard of
    :class:`~tomobar_tpu_torch.parallel.sharding.ShardedProjector` runs its
    deal of each group as one, with the U0 and LU of its own shapes.

    ``idx`` are the angles' positions in the sinogram that BP reads, ``pos``
    those that FP writes (default ``idx``); ``c``, ``s``, ``cor`` their
    kernel-side (cos, sin, cor) in float64 (the y-driven group, ``swap``,
    passes (sin, cos)).  K1p cuts the rows as for a group of
    ``split_angles`` angles, so that a shard of a group sums as the whole
    group does."""

    def __init__(self, idx, c, s, cor, det_x: int, swap: bool, split_angles: int,
                 pos=None):
        self.idx = np.asarray(idx, dtype=np.int64)
        self.pos = self.idx if pos is None else np.asarray(pos, dtype=np.int64)
        self.c, self.s, self.cor = (np.asarray(a, dtype=np.float64) for a in (c, s, cor))
        self.det_x = int(det_x)
        self.swap = bool(swap)
        self.split_angles = int(split_angles)
        self._groups = {}
        self._index = {}

    def index(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(idx, pos) on ``device``."""
        if device not in self._index:
            idx = torch.as_tensor(self.idx, device=device)
            pos = idx if self.pos is self.idx else torch.as_tensor(self.pos, device=device)
            self._index[device] = (idx, pos)
        return self._index[device]

    def group(self, ny: int, nx: int, device: torch.device, single_slice: bool) -> _Group:
        """The group's kernel parameters on a (ny, nx) slice (x-driven rows
        are image rows, y-driven rows columns); with ``single_slice`` (nz ==
        1) packed where the driven rows number a multiple of 8
        (``radon_fp_pallas``/``radon_bp_pallas``' conditions)."""
        key = (ny, nx, device, single_slice)
        if key not in self._groups:
            shape = (nx, ny) if self.swap else (ny, nx)
            packed = single_slice and shape[0] % 8 == 0
            prm = driven_params(self.c, self.s, self.cor, self.det_x, *shape, packed=packed)

            def put(a):
                return torch.as_tensor(a, dtype=torch.float32, device=device)

            splits = packed_splits(shape[0], self.split_angles) if packed else None
            self._groups[key] = _Group(*self.index(device), prm, put(prm.alpha),
                                       put(prm.beta), put(prm.gamma), self.swap, splits)
        return self._groups[key]


def _fp_group(part: torch.Tensor, g: _Group, det_x: int) -> torch.Tensor:
    """K1 (or K1p) then K2 of one group on a chunk of slices: (nz, A, det_x)."""
    if g.prm.packed:
        # the y-driven group reads one explicit transpose of the slice
        rows = part.transpose(1, 2).contiguous() if g.swap else part
        s = shear_fp_packed(rows, g.beta, g.prm.U0, g.prm.LU, g.splits)
    else:
        s = shear_fp(part, g.beta, g.prm.U0, g.prm.LU, g.swap)
    return resample_fp(s, g.alpha, g.gamma, g.prm.U0, det_x)


def _bp_group(part: torch.Tensor, g: _Group, n: int, out: torch.Tensor,
              accumulate: bool, index: Optional[torch.Tensor]) -> None:
    """K3 then K4 (or K4p) of one group on a chunk of sinogram slices,
    written into (or, with ``accumulate``, added to) ``out``; K3 reads the
    group's angles at ``index`` of ``part`` (None: ``part`` holds exactly
    the group's angles in order)."""
    q = resample_bp(part, g.alpha, g.gamma, g.prm.U0, g.prm.LU, index=index)
    if g.prm.packed:
        unshear_bp_packed(q, g.beta, g.prm.U0, n, g.swap, out=out, accumulate=accumulate)
    else:
        unshear_bp(q, g.beta, g.prm.U0, n, n, g.swap, out=out, accumulate=accumulate)


class _Plan:
    """Driven groups with their kernel parameters, uploaded once per (slice
    shape, device): a geometry's two, or (:meth:`from_driven`) any given by
    per-angle data, as a shard's deal.  FP writes ``n_out`` angles of
    ``det_x`` cells (zeros where no group writes); BP reads any sinogram
    that holds every group's ``idx``."""

    def __init__(self, geom: Geometry):
        cos_v, sin_v, idx_x, idx_y = _partition(geom.angles)
        cor = geom.cor_horizontal
        det_x = geom.detectors_x_total
        # the y-driven group: the kernels run with (sin, cos) swapped
        driven = [_DrivenPlan(idx, c[idx], s[idx], cor[idx], det_x, swap, idx.size)
                  for idx, c, s, swap in ((idx_x, cos_v, sin_v, False),
                                          (idx_y, sin_v, cos_v, True)) if idx.size]
        self._init(driven, geom.n_angles, det_x, geom.recon_size)
        dzv = geom.cor_vertical
        self.cor_vertical = dzv if dzv is not None and np.any(dzv) else None

    @classmethod
    def from_driven(cls, driven: List[_DrivenPlan], n_out: int, det_x: int,
                    recon_size: int) -> "_Plan":
        plan = cls.__new__(cls)
        plan._init(driven, n_out, det_x, recon_size)
        plan.cor_vertical = None
        return plan

    def _init(self, driven, n_out: int, det_x: int, recon_size: int) -> None:
        self.driven = driven
        self.n_out, self.det_x, self.recon_size = int(n_out), int(det_x), int(recon_size)
        # FP's output needs no zeros where the groups write every angle
        self._dense = sum(dp.pos.size for dp in driven) == self.n_out

    def groups(self, ny: int, nx: int, device: torch.device,
               single_slice: bool = False) -> List[_Group]:
        """The driven groups on a (ny, nx) slice (:meth:`_DrivenPlan.group`;
        BP's slice is n x n, where ny == nx)."""
        return [dp.group(ny, nx, device, single_slice) for dp in self.driven]

    def fp(self, vol: torch.Tensor) -> torch.Tensor:
        if self.cor_vertical is not None and vol.dim() == 3:
            return _vshift_sino(self._fp_core(vol), self.cor_vertical)
        return self._fp_core(vol)

    def bp(self, sino: torch.Tensor) -> torch.Tensor:
        if self.cor_vertical is not None and sino.dim() == 3:
            sino = _vshift_sino(sino, -np.asarray(self.cor_vertical))
        return self._bp_core(sino)

    def _z_chunks(self, nz: int, groups: List[_Group], *per_slice: int):
        """(z0, z1) runs of slices: each keeps the largest group's u-lines
        under CHUNK_BYTES and these, and the other per-slice element counts
        of the caller, under MAX_ELEMENTS.  Runs of more than one slice are
        even where nz allows it (K4 takes two slices per block)."""
        lines = max((g.prm.A * g.prm.LU for g in groups), default=1)
        widest = max(lines, *per_slice, 1)
        zc = max(min(CHUNK_BYTES // (4 * lines), MAX_ELEMENTS // widest, nz), 1)
        if 1 < zc < nz:
            zc -= zc % 2
        return [(z0, min(z0 + zc, nz)) for z0 in range(0, nz, zc)]

    def _fp_core(self, vol: torch.Tensor) -> torch.Tensor:
        squeeze = vol.dim() == 2
        if squeeze:
            vol = vol[None]
        vol = vol.to(torch.float32).contiguous()
        nz, ny, nx = vol.shape
        det_x, dev = self.det_x, vol.device
        shape = (nz, self.n_out, det_x)
        if _BACKEND == "xla":
            out = torch.zeros(shape, dtype=torch.float32, device=dev)
            for dp in self.driven:
                # y-driven: x and y swap roles on the line y sin + x cos = s
                out[:, dp.index(dev)[1]] = _fp_driven(
                    vol.transpose(1, 2) if dp.swap else vol, dp.c, dp.s, dp.cor, det_x)
            return out[0] if squeeze else out
        groups = self.groups(ny, nx, dev, nz == 1)
        # one group that writes every angle in order needs no scatter
        whole = len(groups) == 1 and self._dense
        chunks = self._z_chunks(nz, groups, ny * nx, self.n_out * det_x)
        if whole and len(chunks) == 1:
            out = _fp_group(vol, groups[0], det_x)
            return out[0] if squeeze else out
        out = (torch.empty if self._dense else torch.zeros)(shape, dtype=torch.float32,
                                                            device=dev)
        for z0, z1 in chunks:
            part = vol[z0:z1]
            for g in groups:
                p = _fp_group(part, g, det_x)
                if whole:
                    out[z0:z1] = p
                else:
                    out[z0:z1, g.pos] = p
        return out[0] if squeeze else out

    def _bp_core(self, sino: torch.Tensor) -> torch.Tensor:
        squeeze = sino.dim() == 2
        if squeeze:
            sino = sino[None]
        sino = sino.to(torch.float32).contiguous()
        nz, n_in, det_x = sino.shape
        n, dev = self.recon_size, sino.device
        if _BACKEND == "xla":
            vol = torch.zeros((nz, n, n), dtype=torch.float32, device=dev)
            for dp in self.driven:
                part = _bp_driven(sino[:, dp.index(dev)[0]], dp.c, dp.s, dp.cor, n, n)
                vol = vol + (part.transpose(1, 2) if dp.swap else part)
            return vol[0] if squeeze else vol
        groups = self.groups(n, n, dev, nz == 1)
        if not groups:
            vol = torch.zeros((nz, n, n), dtype=torch.float32, device=dev)
            return vol[0] if squeeze else vol
        # K3 reads each group's angles where they lie in the sinogram, unless
        # one group holds all of them in order
        whole = len(groups) == 1 and groups[0].prm.A == n_in
        vol = torch.empty((nz, n, n), dtype=torch.float32, device=dev)
        for z0, z1 in self._z_chunks(nz, groups, n * n, n_in * det_x):
            part = sino[z0:z1]
            for k, g in enumerate(groups):
                # the first group writes the chunk's slices, the others add
                _bp_group(part, g, n, vol[z0:z1], k > 0, None if whole else g.idx)
        return vol[0] if squeeze else vol


def radon_fp(vol: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Forward-project a volume.  vol (nz, n, n) or (n, n) -> sino
    (nz, n_angles, det_x_total) or (n_angles, det_x_total)."""
    return _Plan(geom).fp(vol)


def radon_bp(sino: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Back-project a sinogram (exact adjoint of :func:`radon_fp`); the
    output slice size is ``geom.recon_size``."""
    return _Plan(geom).bp(sino)


# ---------------------------------------------------------------------------
# differentiable pair: FP and BP are each other's backward
# ---------------------------------------------------------------------------


class _ForwardProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vol, plan):
        ctx.plan = plan
        return plan.fp(vol)

    @staticmethod
    def backward(ctx, ct):
        return ctx.plan.bp(ct), None


class _BackProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sino, plan):
        ctx.plan = plan
        return plan.bp(sino)

    @staticmethod
    def backward(ctx, ct):
        return ctx.plan.fp(ct), None


def forward_project(vol: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """:func:`radon_fp` with :func:`radon_bp` as its backward."""
    return _ForwardProject.apply(vol, _Plan(geom))


def back_project(sino: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """:func:`radon_bp` with :func:`radon_fp` as its backward."""
    return _BackProject.apply(sino, _Plan(geom))


# ---------------------------------------------------------------------------
# Projector: per-geometry operator pair with OS subset support
# ---------------------------------------------------------------------------


class Projector:
    """Operator pair A / A^T for a fixed geometry, with OS subsets.  Kernel
    parameters are uploaded once per subset and device."""

    def __init__(self, geom: Geometry):
        self.geom = geom
        self.subset_indices = geom.os_indices()
        self._sub_geoms = [geom.subset(ind) for ind in self.subset_indices]
        self._plan = _Plan(geom)
        self._sub_plans = [_Plan(g) for g in self._sub_geoms]
        self._subset_index = {}

    def fp(self, vol: torch.Tensor) -> torch.Tensor:
        """Forward projection of ``[nz, ny, nx]`` (or ``[ny, nx]``) to
        ``[nz, angles, detX]`` (or ``[angles, detX]``), differentiable."""
        return _ForwardProject.apply(vol, self._plan)

    def bp(self, sino: torch.Tensor) -> torch.Tensor:
        """Back-projection, the exact transpose of :meth:`fp`."""
        return _BackProject.apply(sino, self._plan)

    def fp_sub(self, vol: torch.Tensor, sub: int) -> torch.Tensor:
        """Forward projection onto the angles of ordered subset ``sub``."""
        return _ForwardProject.apply(vol, self._sub_plans[sub])

    def bp_sub(self, sino: torch.Tensor, sub: int) -> torch.Tensor:
        """Back-projection of ordered subset ``sub``'s sinogram."""
        return _BackProject.apply(sino, self._sub_plans[sub])

    # reductions over the whole volume or sinogram: the identity on one
    # device; the sharded projector reduces them over its z-slabs
    @staticmethod
    def global_sum(t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the devices holding the volume: ``t`` itself here."""
        return t

    @staticmethod
    def global_max(t: torch.Tensor) -> torch.Tensor:
        """The largest ``t`` over the devices holding the volume: ``t`` itself here."""
        return t

    @staticmethod
    def global_norm(t: torch.Tensor) -> torch.Tensor:
        """The L2 norm of ``t`` (a whole volume or sinogram)."""
        return torch.linalg.vector_norm(t)

    def sino_subset(self, sino: torch.Tensor, sub: int) -> torch.Tensor:
        """The angles of ordered subset ``sub`` of ``[nz, angles, detX]``."""
        key = (sub, sino.device)
        if key not in self._subset_index:  # uploaded once, not at every call
            self._subset_index[key] = torch.as_tensor(
                self.subset_indices[sub], device=sino.device)
        ind = self._subset_index[key]
        if sino.dim() == 2:
            return sino[ind, :]
        return sino[:, ind, :]
