#!/usr/bin/env python3
"""Reconstruction on a mesh of ranks: sharded FBP and sharded FISTA.

The port's counterpart of ``examples/multichip_sharded_recon.py``.  A
``("z", "angles")`` mesh of ``torch.distributed`` ranks, one process each,
shards detY slabs (independent slices) and deals the angles of each
subset (the back-projections summed over the angle group), and the same
step code runs on one rank or many: the projector is a
``ShardedProjector``, the TV prox runs on each slab widened by a halo of
its neighbours' slices (``sharded_prox``), and FBP is ``ShardedDirect``.

Run it with one rank per card (NCCL)::

    torchrun --nproc-per-node 4 examples/torch/multichip_sharded_recon.py

or with ranks sharing one card (``--backend gloo``), or on the CPU
(``--device cpu``, gloo)::

    torchrun --nproc-per-node 4 examples/torch/multichip_sharded_recon.py --device cpu

Started without ``torchrun`` it runs a world of one rank.  NCCL refuses two
ranks on one card: with more ranks than cards it raises, naming
``--backend gloo``; it never falls back by itself.
"""

import os
import socket
import sys
import timeit

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import (  # noqa: E402
    arguments, ellipsoid_phantom, example_device, example_size, rel_rmse)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tomobar_tpu_torch.geometry import Geometry  # noqa: E402
from tomobar_tpu_torch.models.direct import RecToolsDIRTPU  # noqa: E402
from tomobar_tpu_torch.parallel import (  # noqa: E402
    ShardedDirect, ShardedProjector, distributed_init, make_mesh, sharded_prox)
from tomobar_tpu_torch.regularisers import PD_TV  # noqa: E402

TV_ITERATIONS = 20  # the prox's iterations, and its halo: one slice each


def start_ranks(device=None, backend=None) -> torch.device:
    """This rank's device, starting the process group where none runs: the
    world of ``torchrun`` (its environment), else a world of one rank on a
    local port.  ``device`` None: ``cuda:LOCAL_RANK`` and NCCL (raises
    without CUDA); ``"cpu"``: gloo on the CPU; ``backend`` overrides the
    backend (``"gloo"`` lets ranks share a card)."""
    if device is not None:
        device = example_device(device)
    else:
        example_device(None)  # raises without CUDA
    if backend is None:
        backend = "gloo" if device is not None and device.type == "cpu" else "nccl"
    if dist.is_initialized() or "RANK" in os.environ:
        return distributed_init(backend=backend, device=device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return distributed_init(backend=backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, device=device)


def main(N=None, nz=None, device=None, volumes=False, backend=None, mesh=None,
         save=None) -> dict:
    """Runs the example on this rank at ``N`` (default ``TOMOBAR_EXAMPLE_N``,
    else 128) on ``nz`` slices (default two per rank, at least 4), on ``mesh`` (n_z,
    n_angles) (default: two angle shards where the rank count is even);
    every rank returns the rel-RMSEs rank 0 prints, with the gathered
    volumes under ``"volumes"`` when asked.  ``save``: rank 0 writes the
    rel-RMSEs and the volumes to that ``.npz`` file."""
    dev = start_ranks(device, backend)
    n_dev = dist.get_world_size()
    rank0 = dist.get_rank() == 0
    if mesh is None:
        n_ang_shards = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
        mesh = (n_dev // n_ang_shards, n_ang_shards)
    m = make_mesh(*mesh, device=dev)
    if rank0:
        print(f"mesh: {m.shape} over {n_dev} x {dev.type}")

    N = example_size(N, "TOMOBAR_EXAMPLE_N", 128)
    # an even slab per z shard (FOURIER_INV packs slice pairs); at least 4:
    # the 2 slices of one rank would lie on the stack's poles, where no
    # ellipsoid reaches
    nz = max(2 * n_dev, 4) if nz is None else nz
    angles = np.linspace(0, np.pi, 180, endpoint=False).astype(np.float32)
    phantom = ellipsoid_phantom(N, nz)

    geom = Geometry(detectors_x=N, detectors_y=nz, angles=angles, recon_size=N, os_number=4)
    SP = ShardedProjector(geom, m)
    sino = SP.fp(SP.device_put_vol(phantom))  # this rank's slab, every angle

    # sharded direct reconstruction (z-slab FBP)
    rt = RecToolsDIRTPU(N, 0, nz, 0.0, angles, N, device=dev)
    SD = ShardedDirect(rt, m)
    fbp = SP.gather_vol(SD.fbp(sino, cutoff_freq=1.1)).cpu().numpy()
    out = {"fbp": rel_rmse(fbp, phantom)}
    if rank0:
        print(f"sharded FBP     rel-RMSE {out['fbp']:.4f}")

    # sharded FISTA-OS-TV: the single-device solvers' step on slabs
    n_sub = len(SP.subset_indices)
    L_inv = np.float32(1.0 / (2.0 * N * len(angles) / n_sub))
    prox = sharded_prox(m, lambda v: PD_TV(v, 1e-4, TV_ITERATIONS, 0, 1, 12.0), TV_ITERATIONS)

    def fista_step(x, x_t, t, b):
        for s in range(n_sub):
            x_old, t_old = x, t
            grad = SP.bp_sub(SP.fp_sub(x_t, s) - SP.sino_subset(b, s), s)
            x = prox(torch.clamp(x_t - L_inv * grad, min=0.0))
            t = np.float32((1.0 + np.sqrt(np.float32(1.0) + 4.0 * t * t)) * 0.5)
            x_t = x + float((t_old - 1.0) / t) * (x - x_old)
        return x, x_t, t

    x = x_t = SP.device_put_vol(np.zeros((nz, N, N), np.float32))
    t = np.float32(1.0)
    t0 = timeit.default_timer()
    for _ in range(10):
        x, x_t, t = fista_step(x, x_t, t, sino)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = timeit.default_timer() - t0
    z0, z1 = m.z_slab(nz)
    fista = SP.gather_vol(x).cpu().numpy()
    out["fista"] = rel_rmse(fista, phantom)
    if rank0:
        print(
            f"sharded FISTA   rel-RMSE {out['fista']:.4f} "
            f"(10 outer iters, {dt:.2f} s, rank 0 holds slices {z0}:{z1} of {nz})"
        )
    if rank0 and save:
        np.savez(save, fbp=fbp, fista=fista, **{f"rel_rmse_{k}": v for k, v in out.items()})
    if volumes:
        out["volumes"] = {"fbp": fbp, "fista": fista}
    return out


def _mesh(text: str):
    n_z, n_a = (int(v) for v in text.split(","))
    return n_z, n_a


if __name__ == "__main__":
    main(**arguments(
        __doc__,
        (("--backend",), {"default": None, "help": "nccl (default on cards) or gloo"}),
        (("--mesh",), {"type": _mesh, "default": None, "help": "n_z,n_angles"}),
        (("--save",), {"default": None, "help": "rank 0 writes the volumes to this .npz"}),
    ))
    dist.destroy_process_group()
