"""Sharding over a ("z", "angles") mesh of ``torch.distributed`` ranks:
detY slabs x angle deals, one process per device.

Counterpart of ``tomobar_tpu/parallel/sharding.py``.  A rank holds the
z-slab of the volume and of the canonical ``(detY, angles, detX)``
sinogram that its mesh coordinate owns; ranks are laid out z-major,
``rank = z * n_angles + a``, so over several hosts the z axis splits
across hosts and each angle group stays within one.  Ranks on one z
coordinate form an *angle group*, ranks on one angle coordinate a *z
group*.

What XLA inserts by itself in the JAX package is written out here
(:mod:`tomobar_tpu_torch.parallel.comm`):

* ``fp``: each rank runs its round-robin deal of both driven groups
  through the projector's kernels (a :class:`~tomobar_tpu_torch.ops.projector.
  _Plan` of its deal), pads each group's block to the deal's ``B`` angles, and
  one ``all_gather`` over the angle group (both groups' blocks side by
  side) gives every rank its canonical slab;
* ``bp``: each rank back-projects its deal of both groups from its
  canonical slab into one volume, then one ``all_reduce`` over the angle
  group sums the partial volumes (the JAX package psums once per group);
* the per-angle vertical CoR shift runs on the slab widened by a
  ``z_halo`` of ``ceil(max|dz|) + 1`` slices;
* the solvers' global sums, norms and maxima are reduced over the z group
  (``global_sum``, ``global_norm``, ``global_max``): volumes, and
  sinograms after ``fp``, are replicated across the angle group;
* a 3D prox runs on the slab widened by a ``z_halo`` of its reach
  (:func:`sharded_prox`, :func:`sharded_regul_fn`), the Haar shrinkage on
  the slab widened to its blocks (:func:`sharded_wavelet`).

Use :func:`distributed_init`, :func:`make_mesh` and
:class:`ShardedProjector` in place of
:class:`~tomobar_tpu_torch.ops.projector.Projector` to run the solvers of
:mod:`tomobar_tpu_torch.solvers.core` unchanged on a rank's slab.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops.projector import _DrivenPlan, _Plan, _vshift_sino
from tomobar_tpu_torch.ops.projector_kernels import _partition
from tomobar_tpu_torch.parallel import comm

__all__ = [
    "Mesh",
    "distributed_init",
    "make_mesh",
    "ShardedProjector",
    "sharded_prox",
    "sharded_regul_fn",
    "sharded_wavelet",
]

_STATE = {"device": None}


def _rank_device(device=None) -> torch.device:
    """``device``, or else this rank's card: ``cuda:LOCAL_RANK`` (modulo the
    card count) where the environment names the local rank, else the
    current card.  Without CUDA it raises: the entry points run on the card
    unless the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise ValueError(
            "no device for this rank: CUDA is not available; start the group with "
            "distributed_init(backend=\"gloo\", device=\"cpu\") or pass "
            "make_mesh(..., device=\"cpu\") to run the ranks on the CPU")
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def distributed_init(
    backend: Optional[str] = None,
    init_method: str = "env://",
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> torch.device:
    """Initialise the default process group, once, and record this rank's
    device; returns it.  A second call returns the device of the first.  On
    a group started elsewhere (``dist.init_process_group``, as under
    ``torchrun``) it initialises nothing and records ``device``, by default
    ``cuda:LOCAL_RANK``.

    ``backend`` defaults to NCCL on ``cuda:LOCAL_RANK``.  NCCL refuses two
    ranks on one card, so it raises ``ValueError`` where the ranks of a
    host outnumber its cards: use ``backend="gloo"`` there, whose CUDA
    tensors go through pinned host memory (ranks ``LOCAL_RANK`` modulo the
    card count).  ``device="cpu"`` with gloo runs every rank on the CPU.
    ``world_size`` and ``rank`` default to the environment's, as
    ``env://`` reads them."""
    if dist.is_initialized():
        if _STATE["device"] is None:
            _STATE["device"] = _rank_device(device)
            if _STATE["device"].type == "cuda":
                torch.cuda.set_device(_STATE["device"])
        return _STATE["device"]
    backend = backend or "nccl"
    n_world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", n_world))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "distributed_init: CUDA is not available (pass device='cpu' "
                "with backend='gloo' to run the ranks on the CPU)")
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local_world > n_cards:
            raise ValueError(
                f"distributed_init: {local_world} ranks on a host with {n_cards} "
                "card(s): NCCL refuses two ranks on one card; pass backend=\"gloo\" "
                "to let ranks share a card")
        local_rank = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                        else os.environ.get("RANK", 0)))
        device = torch.device("cuda", local_rank % n_cards)
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("distributed_init: NCCL needs CUDA devices; use backend=\"gloo\"")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # -1: read from the environment, as env:// does
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank)
    _STATE["device"] = device
    return device


class Mesh:
    """A ("z", "angles") mesh of the default group's ranks, laid out
    z-major.  ``shape`` maps each axis to its size, ``z_index`` /
    ``angle_index`` are this rank's coordinates, ``z_group`` /
    ``angle_group`` its process groups (``z_ranks``: the z group's global
    ranks in z order) and ``device`` its device."""

    def __init__(self, n_z: int, n_angles: int, device: torch.device):
        rank = dist.get_rank()
        self.shape = {"z": n_z, "angles": n_angles}
        self.z_index, self.angle_index = divmod(rank, n_angles)
        self.device = device
        # every rank creates every group, in the same order
        for z in range(n_z):
            ranks = [z * n_angles + a for a in range(n_angles)]
            group = dist.new_group(ranks)
            if z == self.z_index:
                self.angle_group = group
        for a in range(n_angles):
            ranks = [z * n_angles + a for z in range(n_z)]
            group = dist.new_group(ranks)
            if a == self.angle_index:
                self.z_group, self.z_ranks = group, ranks

    def z_slab(self, nz: int) -> Tuple[int, int]:
        """The slices [z0, z1) of an nz-slice volume that this rank holds;
        nz must split evenly over the z axis (as the JAX package's
        ``P("z")`` needs)."""
        n_z = self.shape["z"]
        if nz % n_z:
            raise ValueError(
                f"{nz} slices do not split evenly over {n_z} z-shards; pad detY "
                "or change the mesh")
        step = nz // n_z
        return self.z_index * step, (self.z_index + 1) * step

    def __repr__(self) -> str:
        return (f"Mesh(z={self.shape['z']}, angles={self.shape['angles']}, "
                f"z_index={self.z_index}, angle_index={self.angle_index}, "
                f"device={self.device})")


def make_mesh(n_z: Optional[int] = None, n_angles: Optional[int] = None,
              device=None) -> Mesh:
    """A ("z", "angles") mesh over the default group's ranks, on ``device``
    (default: the one :func:`distributed_init` recorded, else this rank's
    card, ``cuda:LOCAL_RANK``; without CUDA it raises unless ``device`` is
    given).

    By default every rank goes to the z axis, which needs no collective in
    the projector.  ``n_angles > 1`` also deals the angles (an ``all_gather``
    per ``fp`` and a volume-sized ``all_reduce`` per ``bp``).  Over several
    hosts (``LOCAL_WORLD_SIZE`` ranks each) the z axis must be a multiple
    of the host count, so that slabs split across hosts and angle groups
    stay within one."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call distributed_init first")
    n_dev = dist.get_world_size()
    if n_z is None and n_angles is None:
        n_z, n_angles = n_dev, 1
    elif n_z is None:
        n_z = n_dev // n_angles
    elif n_angles is None:
        n_angles = n_dev // n_z
    if n_z * n_angles != n_dev:
        raise ValueError(f"mesh {n_z}x{n_angles} does not match {n_dev} devices")
    n_proc = max(n_dev // int(os.environ.get("LOCAL_WORLD_SIZE", n_dev)), 1)
    if n_proc > 1 and n_z % n_proc != 0:
        raise ValueError(
            f"multi-host mesh needs the z axis ({n_z}) divisible by the host "
            f"count ({n_proc}) so slabs split across hosts; got "
            f"{n_z} % {n_proc} != 0")
    if device is None and _STATE["device"] is not None:
        device = _STATE["device"]
    return Mesh(n_z, n_angles, _rank_device(device))


class _GroupPlan:
    """Host-side plan for one driven group dealt over S angle shards (a
    numpy copy of the JAX package's).

    ``cos/sin/cor`` are the padded, shard-contiguous parameter vectors
    (shard s owns positions [s*B, (s+1)*B)); ``ang_idx`` maps each kept
    padded position back to its canonical angle index and ``keep_pos`` are
    the padded positions that carry real angles.  Pad entries hold the
    x-driven-safe (cos=1, sin=0) line; no kernel runs them here (a shard
    runs its real angles only), so only the gathered block is padded."""

    def __init__(self, idx, cos_g, sin_g, cor_g, S):
        n = idx.size
        self.B = -(-n // S) if n else 0  # ceil
        total = S * self.B
        cos_p = np.ones(total, np.float64)
        sin_p = np.zeros(total, np.float64)
        cor_p = np.zeros(total, np.float64)
        keep = np.zeros(total, bool)
        ang_idx = []
        self.counts = []
        for s in range(S):
            blk = idx[np.arange(s, n, S)]  # round-robin deal (canonical ids)
            p0 = s * self.B
            cos_p[p0 : p0 + blk.size] = cos_g[blk]
            sin_p[p0 : p0 + blk.size] = sin_g[blk]
            cor_p[p0 : p0 + blk.size] = cor_g[blk]
            keep[p0 : p0 + blk.size] = True
            ang_idx.extend(blk)
            self.counts.append(blk.size)
        self.n = n
        self.cos = cos_p
        self.sin = sin_p
        self.cor = cor_p
        self.keep_pos = np.where(keep)[0]
        self.ang_idx = np.asarray(ang_idx, dtype=np.int64)
        # BP gather: canonical angle index per padded position (-1: a pad)
        self.gather_idx = np.full(total, -1, dtype=np.int64)
        self.gather_idx[self.keep_pos] = self.ang_idx

    def shard(self, s: int, det_x: int, swap: bool, offset: int) -> Optional[_DrivenPlan]:
        """The real angles of shard ``s`` as a driven plan (None if it has
        none): BP reads them at their canonical positions, FP writes them
        from ``offset`` on in the rank's block; K1p splits them as it
        splits the whole group."""
        k = self.counts[s]
        if k == 0:
            return None
        blk = slice(s * self.B, s * self.B + k)
        return _DrivenPlan(self.gather_idx[blk], self.cos[blk], self.sin[blk], self.cor[blk],
                           det_x, swap, self.n, pos=offset + np.arange(k))


class _ShardPlan:
    """Both driven groups of one angle set, planned for S angle shards."""

    def __init__(self, geom: Geometry, S: int):
        # y-driven group: kernels run with (sin, cos) swapped + transposed
        cos_v, sin_v, idx_x, idx_y = _partition(geom.angles)
        cor = geom.cor_horizontal
        self.gx = _GroupPlan(idx_x, cos_v, sin_v, cor, S)
        self.gy = _GroupPlan(idx_y, sin_v, cos_v, cor, S)
        self.n_angles = geom.n_angles
        self.det_x = geom.detectors_x_total
        self.recon_size = geom.recon_size
        # [n, 2] CoR: the per-angle vertical detector shift along the
        # (sharded) z axis, on the slab widened by a z_halo
        dzv = geom.cor_vertical
        self.cor_vertical = (
            np.asarray(dzv) if dzv is not None and np.any(dzv) else None
        )


class _RankPlan:
    """One rank's share of a :class:`_ShardPlan`: its deal of both groups as
    one projector plan whose FP fills the rank's block, both groups' padded
    blocks side by side, ``[B_x | B_y]``, and the positions that place the
    gathered blocks in canonical order."""

    def __init__(self, plan: _ShardPlan, s: int):
        self.plan = plan
        groups = [(grp, swap) for grp, swap in ((plan.gx, False), (plan.gy, True)) if grp.B]
        offsets = np.cumsum([0] + [grp.B for grp, _ in groups])
        width = int(offsets[-1])
        driven = [grp.shard(s, plan.det_x, swap, off)
                  for (grp, swap), off in zip(groups, offsets)]
        self.local = _Plan.from_driven([dp for dp in driven if dp is not None], width,
                                       plan.det_x, plan.recon_size)
        # each kept position of the gathered blocks, and its canonical angle
        pos = []
        for (grp, _), off in zip(groups, offsets):
            shard, j = np.divmod(grp.keep_pos, grp.B)
            pos.append(shard * width + off + j)
        none = [np.zeros(0, np.int64)]
        self.gather_pos = np.concatenate(pos or none)
        self.canon_idx = np.concatenate([grp.ang_idx for grp, _ in groups] or none)
        self._dev = {}

    def index(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        if device not in self._dev:
            self._dev[device] = (torch.as_tensor(self.gather_pos, device=device),
                                 torch.as_tensor(self.canon_idx, device=device))
        return self._dev[device]


class ShardedProjector:
    """Projector pair over a ("z", "angles") mesh of ranks.

    Drop-in for :class:`~tomobar_tpu_torch.ops.projector.Projector` inside
    the solver cores, on this rank's z-slabs: ``fp`` takes the volume's
    slab and returns the canonical sinogram's slab (equal to that slab of
    the single-device ``fp``), ``bp`` the reverse.  Volumes and sinograms
    are replicated across the angle group."""

    def __init__(self, geom: Geometry, mesh: Mesh):
        self.geom = geom
        self.mesh = mesh
        self.n_ang_shards = mesh.shape["angles"]
        self.subset_indices = geom.os_indices()
        s = mesh.angle_index
        self._plan = _RankPlan(_ShardPlan(geom, self.n_ang_shards), s)
        self._sub_plans = [
            _RankPlan(_ShardPlan(geom.subset(ind), self.n_ang_shards), s)
            for ind in self.subset_indices
        ]
        self._subset_index = {}

    @property
    def device(self) -> torch.device:
        """The mesh's device, where this rank's slabs lie."""
        return self.mesh.device

    # -- core sharded ops -----------------------------------------------------

    def _fp_plan(self, vol: torch.Tensor, rp: _RankPlan) -> torch.Tensor:
        """vol slab (nz, n, n) -> canonical sinogram slab (nz, A, det_x)."""
        plan = rp.plan
        out = torch.empty((vol.shape[0], plan.n_angles, plan.det_x), dtype=torch.float32,
                          device=vol.device)
        if not rp.local.n_out:
            return out
        gathered = comm.all_gather(rp.local._fp_core(vol), 1, self.mesh.angle_group)
        pos, canon = rp.index(vol.device)
        out[:, canon] = gathered[:, pos]
        return out

    def _bp_plan(self, sino: torch.Tensor, rp: _RankPlan) -> torch.Tensor:
        """canonical sinogram slab -> the volume slab, summed over the
        angle group."""
        return comm.all_reduce(rp.local._bp_core(sino), self.mesh.angle_group)

    def _vshift(self, sino: torch.Tensor, dz: np.ndarray) -> torch.Tensor:
        """The vertical-CoR shift of the whole sinogram, on this rank's slab
        widened by the shift's reach."""
        reach = int(math.ceil(float(np.max(np.abs(dz))))) + 1
        return sharded_prox(self.mesh, lambda wide: _vshift_sino(wide, dz), reach)(sino)

    def _post_fp(self, sino, plan: _ShardPlan):
        if plan.cor_vertical is None:
            return sino
        return self._vshift(sino, plan.cor_vertical)

    def _pre_bp(self, sino, plan: _ShardPlan):
        if plan.cor_vertical is None:
            return sino
        return self._vshift(sino, -plan.cor_vertical)

    # -- Projector interface --------------------------------------------------

    def fp(self, vol: torch.Tensor) -> torch.Tensor:
        """Forward projection of this rank's z-slab onto its angle group's
        angles, gathered to the whole sinogram slab (one ``all_gather``)."""
        return self._post_fp(self._fp_plan(vol, self._plan), self._plan.plan)

    def bp(self, sino: torch.Tensor) -> torch.Tensor:
        """Back-projection of this rank's sinogram slab over its dealt angles,
        summed over the angle group (one ``all_reduce``)."""
        return self._bp_plan(self._pre_bp(sino, self._plan.plan), self._plan)

    def fp_sub(self, vol: torch.Tensor, sub: int) -> torch.Tensor:
        """:meth:`fp` onto the angles of ordered subset ``sub``."""
        rp = self._sub_plans[sub]
        return self._post_fp(self._fp_plan(vol, rp), rp.plan)

    def bp_sub(self, sino: torch.Tensor, sub: int) -> torch.Tensor:
        """:meth:`bp` of ordered subset ``sub``'s sinogram."""
        rp = self._sub_plans[sub]
        return self._bp_plan(self._pre_bp(sino, rp.plan), rp)

    def sino_subset(self, sino: torch.Tensor, sub: int) -> torch.Tensor:
        """The angles of ordered subset ``sub`` of this rank's sinogram slab."""
        key = (sub, sino.device)
        if key not in self._subset_index:
            self._subset_index[key] = torch.as_tensor(
                self.subset_indices[sub], device=sino.device)
        return sino[:, self._subset_index[key], :]

    # reductions of a whole volume or sinogram from this rank's slab: slabs
    # are replicated across the angle group, so they reduce over z
    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the z-slabs (an ``all_reduce`` over z)."""
        return comm.all_reduce(t.clone(), self.mesh.z_group, "sum")

    def global_max(self, t: torch.Tensor) -> torch.Tensor:
        """The largest ``t`` over the z-slabs (an ``all_reduce`` over z)."""
        return comm.all_reduce(t.clone(), self.mesh.z_group, "max")

    def global_norm(self, t: torch.Tensor) -> torch.Tensor:
        """The L2 norm of the whole volume or sinogram of which ``t`` is this
        rank's slab (squares summed in float64 over z)."""
        sq = torch.linalg.vector_norm(t).double() ** 2
        return torch.sqrt(comm.all_reduce(sq, self.mesh.z_group, "sum")).to(t.dtype)

    # -- placement helpers ----------------------------------------------------

    def device_put_vol(self, vol) -> torch.Tensor:
        """This rank's z-slab of a whole (nz, n, n) volume (numpy or a
        tensor), on the mesh's device."""
        return _slab(vol, self.mesh)

    def device_put_sino(self, sino) -> torch.Tensor:
        """This rank's z-slab of a whole canonical (detY, angles, detX)
        sinogram, every angle, on the mesh's device."""
        return _slab(sino, self.mesh)

    def gather_vol(self, x: torch.Tensor) -> torch.Tensor:
        """The whole volume (or sinogram) from every rank's z-slab, on every
        rank of the z group (for tests and checks)."""
        return comm.all_gather(x, 0, self.mesh.z_group)


def _slab(a, mesh: Mesh) -> torch.Tensor:
    z0, z1 = mesh.z_slab(a.shape[0])
    part = a[z0:z1]
    if isinstance(part, torch.Tensor):
        return part.to(device=mesh.device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(part, dtype=np.float32), device=mesh.device)


# ---------------------------------------------------------------------------
# 3D proxes on z-slabs
# ---------------------------------------------------------------------------


def sharded_prox(mesh: Mesh, prox: Callable, halo: int) -> Callable:
    """``x`` (this rank's slab) -> the slab of ``prox`` of the whole volume:
    ``prox`` runs on the slab widened by ``halo`` slices of its neighbours
    on each side (fewer at the volume's ends) and the widening is cropped.
    Exact where ``halo`` covers the prox's reach: a prox whose one
    iteration reads one slice each way needs its iteration count.  A slab
    thinner than the halo takes slices from as many slabs as the window
    spans."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        wide, before = comm.z_halo(x, mesh, halo, halo)
        return prox(wide)[before : before + x.shape[0]]

    return fn


class _Owner:
    """What ``prox_regul`` reads of its owner."""

    OS_number = 1

    def __init__(self, nonneg: bool):
        self.nonneg_regul = 1 if nonneg else 0


# prox_regul's methods in its order of matching, and how many slices one
# iteration of each reads on either side along z (from the stencils of
# regularisers.py and regularisers_legacy.py; None: one slice only)
_Z_REACH = (
    ("ROF_TV", 1), ("PD_TV", 1), ("FGP_TV", 1), ("SB_TV", 1), ("LLT_ROF", 2),
    ("TGV", 1), ("NDF", 1), ("Diff4th", 2), ("NLTV", None),
)


def _haar_window(j: int, slab: int, nz: int, levels: int) -> Tuple[int, int]:
    """The slices [w0, w1) around slab j on which ``levels`` Haar levels
    along z give the whole volume's result for the slab: the blocks of
    2^levels slices that hold it, from 0 (where each level pairs the same
    slices as on the whole volume) to a multiple of 2^levels or to the
    volume's end, and then at least 2^levels slices long (so that z stays
    a transformed axis at every level, and the odd leftovers of the whole
    volume's levels are the window's)."""
    B = 2 ** levels
    w0 = j * slab // B * B
    w1 = min(-(-(j + 1) * slab // B) * B, nz)
    if w1 == nz and 0 < w0 and nz - w0 < B:
        w0 -= B
    return w0, w1


def sharded_wavelet(mesh: Mesh, threshold: float, levels: int = 3) -> Callable:
    """``x`` (this rank's slab) -> its slab of ``WAVELET_SHRINK`` of the
    whole volume: the shrinkage runs on the slab widened to its Haar blocks
    (:func:`_haar_window`) and the widening is cropped."""
    from tomobar_tpu_torch.regularisers_legacy import WAVELET_SHRINK

    def fn(x: torch.Tensor) -> torch.Tensor:
        slab, nz = x.shape[0], x.shape[0] * mesh.shape["z"]
        wide, before = comm.z_window(x, mesh, lambda j: _haar_window(j, slab, nz, levels))
        return WAVELET_SHRINK(wide, threshold, levels)[before : before + slab]

    return fn


def sharded_regul_fn(mesh: Mesh, regularisation: dict, nonneg: bool = False) -> Callable:
    """The solvers' ``regul_fn`` for ``prox_regul``'s method in
    ``regularisation`` (its defaults filled as ``dicts_check`` fills them;
    ``nonneg`` is the solver's nonnegativity, which PD-TV and FGP-TV read)
    on this rank's slab: equal, bit for bit, to that slab of the method on
    the whole volume.

    Under ``n_z > 1`` each method runs through :func:`sharded_prox` with a
    halo of its iteration count times its reach along z (``_Z_REACH``): one
    iteration of PD-TV, ROF-TV, FGP-TV, SB-TV, TGV or NDF reads u one slice
    each way (first differences and their divergence; SB-TV's u-step is one
    Jacobi sweep, whose Laplacian reads z-1..z+1, and the TGV duals' and
    v's differences likewise), one of LLT-ROF or Diff4th two (a second
    difference of a function of second differences), so a wrong value at
    the window's edge travels that far per iteration.  None of them reduces
    over the volume (FGP-TV's momentum is a scalar recurrence), so none
    needs ``global_*``.  NLTV takes one slice only, as on one device, and a
    volume split along z has more than one: it raises ``ValueError`` here,
    before any collective.  The Haar shrinkage of the ``*_WAVELETS`` methods
    runs after the method on the slab widened to its blocks
    (:func:`sharded_wavelet`).  Under ``n_z == 1`` every method runs on the
    whole volume."""
    from tomobar_tpu_torch.regularisers import prox_regul, wavelet_threshold
    from tomobar_tpu_torch.utils.dicts import dicts_check

    owner = _Owner(nonneg)
    _, _, r = dicts_check(owner, {"projection_data": np.zeros((1, 1, 1), np.float32)},
                          {"nonnegativity": bool(nonneg)}, dict(regularisation), "FISTA")
    method = r["method"]
    if method is None:
        return None
    if mesh.shape["z"] == 1:
        return lambda x: prox_regul(owner, x, r)
    primary = next(((name, reach) for name, reach in _Z_REACH if name in method), None)
    if primary is None and not method.startswith("WAVELET"):
        raise ValueError(f"Unknown regularisation method: {method}")
    if primary is not None and primary[1] is None:
        raise ValueError(f"{method} supports 2D images (reference parity): a volume split "
                         f"over {mesh.shape['z']} z-shards has more than one slice")
    steps = []
    if primary is not None:
        name, reach = primary
        alone = dict(r, method=name)

        def prox(x):
            return prox_regul(owner, x, alone)

        steps.append(sharded_prox(mesh, prox, reach * int(r["iterations"])))
    if "WAVELET" in method:
        steps.append(sharded_wavelet(mesh, wavelet_threshold(r), r.get("wavelet_levels", 3)))

    def fn(x: torch.Tensor) -> torch.Tensor:
        for step in steps:
            x = step(x)
        return x

    return fn
