"""The sharded layer's collectives, modelled and counted, and its weak
scaling over z.

Counterpart of ``tomobar_tpu/bench/scaling.py``.  There XLA partitions the
step and the angle axis psums once per driven group; here the collectives
are the ones ``tomobar_tpu_torch/parallel`` writes out, so
:func:`comm_model` counts, per rank and outer FISTA-OS iteration (PWLS,
non-negativity, the PD-TV prox with its halo; ``solvers.core.fista`` on a
``ShardedProjector``):

* ``all_reduce``: one per ``bp_sub`` over the angle group, of the rank's
  volume slab (both driven groups summed on the rank first), and one of a
  float32 scalar over the z group for the PWLS weights' maximum
  (``global_max``);
* ``all_gather``: one per ``fp_sub`` over the angle group, of the rank's
  padded block of both groups' deals: an OS subset's x-driven angles
  (|cos| >= |sin|) and its y-driven angles, each dealt round-robin to the
  n_angles ranks and padded to ceil(angles / n_angles), times the slab and
  the detector width (the model counts these from the angles itself, not
  from the sharded layer's plan);
* ``z_halo``: one per prox over the z group, of the prox's iteration count
  in slices each way, as far as the volume reaches.

The z axis carries collectives here (the halo and the global reductions),
unlike the JAX package's model, which priced the angle axis alone.
:func:`count_collectives_in_step` runs one such iteration on a mesh and
returns what :mod:`tomobar_tpu_torch.parallel.comm` counted, which the
model must equal call for call and byte for byte.

:func:`run` measures weak scaling over z (``nz_per_device`` slices a
z-shard): each mesh runs with NCCL, a card per rank, where the machine has
a card for every rank, and is timed; otherwise its ranks share card 0 over
gloo and are counted, not timed (their times would measure the host's
staging).  Run on a machine with the cards::

    python -m tomobar_tpu_torch.bench.scaling
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["comm_model", "count_collectives_in_step", "run", "NVLINK_BYTES"]

# NVLink 4 of an H100 SXM: 900 GB/s both ways together, 450 GB/s each way
NVLINK_BYTES = 450e9
F32 = 4


def comm_model(N: int, nz: int, os_number: int, t_outer_1card_s: float,
               mesh: Tuple[int, int] = (1, 1), tv_iters: int = 20, nproj: int = 1801,
               z_index: int = 0) -> dict:
    """Calls and bytes of each collective that the rank at ``z_index`` of
    ``mesh`` = (n_z, n_angles) makes in one outer FISTA-OS iteration of an
    nz x nproj x N problem (angles over [0, pi), CoR 0, ``os_number``
    subsets, a PD-TV prox of ``tv_iters`` iterations), in the shape of
    ``comm.stats`` (an operation appears only where it is called);
    ``seconds_at_nvlink`` is their bytes over :data:`NVLINK_BYTES`, beside
    ``t_outer_1card_s`` for scale."""
    n_z, n_a = mesh
    slab = nz // n_z
    stats: Dict[str, Dict[str, int]] = {}

    def add(op, calls, nbytes):
        if calls:
            entry = stats.setdefault(op, {"calls": 0, "bytes": 0})
            entry["calls"] += calls
            entry["bytes"] += int(nbytes)

    if n_z > 1:
        add("all_reduce", 1, F32)  # the PWLS weights' maximum over z
        w0 = max(z_index * slab - tv_iters, 0)
        w1 = min((z_index + 1) * slab + tv_iters, nz)
        add("z_halo", os_number, os_number * (w1 - w0 - slab) * N * N * F32)
    if n_a > 1:
        add("all_reduce", os_number, os_number * slab * N * N * F32)
        angles = np.linspace(0, np.pi, nproj, endpoint=False)
        gathered = 0
        for s in range(os_number):
            sub = angles[s::os_number]
            n_x = int(np.count_nonzero(np.abs(np.cos(sub)) >= np.abs(np.sin(sub))))
            width = -(-n_x // n_a) + -(-(sub.size - n_x) // n_a)
            gathered += (n_a - 1) * slab * width * N * F32
        add("all_gather", os_number, gathered)
    total = sum(v["bytes"] for v in stats.values())
    return {
        "mesh": [n_z, n_a], "z_index": z_index, "stats": stats,
        "bytes_per_outer": total,
        "seconds_at_nvlink": total / NVLINK_BYTES,
        "t_outer_1card_s": t_outer_1card_s,
        "derivation": (
            "per outer iteration and rank: all_reduce = OS x the volume slab "
            "(n_angles > 1) + one float32 (n_z > 1); all_gather = OS x (n_angles - 1) "
            "x the slab's padded block of both groups' deals (n_angles > 1); z_halo = "
            "OS x the slices within tv_iters of the slab (n_z > 1)"),
    }


def count_collectives_in_step(mesh, projector, sino: torch.Tensor, lipschitz_const: float,
                              regularisation: dict) -> Dict[str, Dict[str, int]]:
    """Reset ``comm.stats``, run one outer iteration of ``solvers.core.fista``
    (PWLS, non-negativity, ``regularisation``'s prox on z-slabs) on this
    rank's slab ``sino`` through ``projector`` (a ``ShardedProjector`` on
    ``mesh``), and return the calls and bytes it counted per collective."""
    from tomobar_tpu_torch.parallel import comm, sharded_regul_fn
    from tomobar_tpu_torch.solvers import core as solvers

    reg = sharded_regul_fn(mesh, regularisation, nonneg=True)
    comm.reset_stats()
    solvers.fista(projector, sino, 1, lipschitz_const, nonnegativity=True, fidelity="PWLS",
                  regul_fn=reg)
    return {op: {"calls": int(v["calls"]), "bytes": int(v["bytes"])}
            for op, v in comm.stats.items()}


def _outer_s(projector, sino, lipschitz_const, regul_fn) -> float:
    """Seconds of one outer FISTA iteration: the 3- less the 2-iteration
    call, after a warm-up call."""
    from tomobar_tpu_torch.bench.harness import Marks
    from tomobar_tpu_torch.solvers import core as solvers

    def call(k):
        return solvers.fista(projector, sino, k, lipschitz_const, nonnegativity=True,
                             fidelity="PWLS", regul_fn=regul_fn)

    call(1)
    times = []
    for k in (2, 3):
        marks = Marks(sino.device)
        marks.mark()
        call(k)
        marks.mark()
        times.append(marks.elapsed_ms()[0] / 1e3)
    return times[1] - times[0]


def _rank(rank: int, world: int, port: int, backend: str, mesh, cfg: dict, out_dir: str):
    """One rank of :func:`run`: its slab of random data on its card (or on
    card 0 where the ranks share it), the counts of one outer iteration
    and, with NCCL, the outer iteration's seconds."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.parallel import ShardedProjector, distributed_init, make_mesh
    from tomobar_tpu_torch.parallel import sharded_regul_fn

    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    distributed_init(backend=backend, init_method=f"tcp://127.0.0.1:{port}",
                     world_size=world, rank=rank)
    m = make_mesh(*mesh)
    N, nz, nproj, os_number = cfg["N"], cfg["nz"], cfg["nproj"], cfg["os"]
    sp = ShardedProjector(Geometry(N, nz, np.linspace(0, np.pi, nproj, endpoint=False), 0.0,
                                   N, os_number=os_number), m)
    gen = torch.Generator(device=m.device).manual_seed(rank)
    slab = torch.rand((nz // mesh[0], nproj, N), generator=gen, device=m.device)
    reg = {"method": "PD_TV", "regul_param": 5e-4, "iterations": cfg["tv"]}
    counts = count_collectives_in_step(m, sp, slab, cfg["L"], reg)
    t = _outer_s(sp, slab, cfg["L"], sharded_regul_fn(m, reg, nonneg=True)) \
        if backend == "nccl" else None
    with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
        json.dump({"z_index": m.z_index, "counts": counts, "outer_s": t}, f)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(N=None, nz_per_device=None, nproj=None, os_number=None, tv_iters=None,
        meshes=((2, 1), (1, 2), (2, 2))) -> dict:
    """Weak scaling over z with ``nz_per_device`` slices a z-shard: the
    single card's outer iteration at ``nz_per_device`` slices, and for each
    mesh (n_z, n_angles) the model and the counts of each rank, and, where
    the machine has a card per rank (NCCL), each rank's outer iteration and
    t(1 card) / t(mesh): the weak-scaling efficiency over z, the speedup
    over the angles (whose problem does not grow)."""
    import torch.multiprocessing as mp

    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector
    from tomobar_tpu_torch.regularisers import PD_TV
    from tomobar_tpu_torch.solvers import core as solvers

    N = N or int(os.environ.get("TOMOBAR_BENCH_N", 2560))
    nz1 = nz_per_device or int(os.environ.get("TOMOBAR_BENCH_NZ", 8))
    nproj = nproj or int(os.environ.get("TOMOBAR_BENCH_NPROJ", 1801))
    os_number = os_number or int(os.environ.get("TOMOBAR_BENCH_OS", 10))
    tv = tv_iters or int(os.environ.get("TOMOBAR_BENCH_TV_ITERS", 20))
    n_cards = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    P = Projector(Geometry(N, nz1, angles, 0.0, N, os_number=os_number))
    L = solvers.power_method(P, (nz1, N, N), device=dev)
    sino = torch.rand((nz1, nproj, N), generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    t1 = _outer_s(P, sino, L, lambda x: PD_TV(x, 5e-4, tv, 0, 1, 12.0))
    del sino
    torch.cuda.empty_cache()
    out = {"metric": f"weak scaling over z ({nproj} x {nz1}/z-shard x {N}, FISTA-OS{os_number}"
                     f"-PWLS-PD-TV{tv})", "cards": n_cards, "t_outer_1card_s": round(t1, 6),
           "meshes": {}}
    for n_z, n_a in meshes:
        world = n_z * n_a
        backend = "nccl" if n_cards >= world else "gloo"
        cfg = {"N": N, "nz": nz1 * n_z, "nproj": nproj, "os": os_number, "tv": tv, "L": L}
        with tempfile.TemporaryDirectory() as d:
            mp.spawn(_rank, args=(world, _free_port(), backend, (n_z, n_a), cfg, d),
                     nprocs=world, join=True)
            ranks = []
            for r in range(world):
                with open(os.path.join(d, f"rank_{r}.json")) as f:
                    ranks.append(json.load(f))
        entry = {"backend": backend, "nz": nz1 * n_z, "ranks": []}
        for rep in ranks:
            model = comm_model(N, nz1 * n_z, os_number, t1, (n_z, n_a), tv, nproj, rep["z_index"])
            entry["ranks"].append({"z_index": rep["z_index"], "counted": rep["counts"],
                                   "model": model["stats"],
                                   "equal": rep["counts"] == model["stats"],
                                   "outer_s": rep["outer_s"]})
        if backend == "nccl":
            t = max(rep["outer_s"] for rep in ranks)
            entry["outer_s"] = round(t, 6)
            entry["efficiency"] = round(t1 / t, 4)
        out["meshes"][f"{n_z}x{n_a}"] = entry
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    run()
