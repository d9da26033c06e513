"""``RecToolsIRCuPy(..., mesh=...).FISTA`` on one volume spread over the
world's ranks as z-slabs, one card a rank: every rank makes the same
reconstructor for each call (the power method runs in every call, as a
pipeline calls it chunk by chunk) on its slab of the chunk's rows
(:func:`local`), and rank 0 gathers the reconstructed volume, the answer
(the prox couples every slice of it).

The mesh is made once, in the first call: a z axis of every rank of the
world and the configuration's ``mesh["angles"]`` (1: a z-only mesh).  A
run with no world (one process, ``run.run``) starts a world of one gloo
rank on a local port, whose slab is the whole chunk.  A program whose
``RecToolsIRCuPy`` takes no ``mesh`` fails the call before any collective."""

from __future__ import annotations

import copy
import inspect
import socket

import torch.distributed as dist

from benchmark.inputs import angles

_MESH = []


def _program():
    from tomobar_tpu_torch import RecToolsIRCuPy

    if "mesh" not in inspect.signature(RecToolsIRCuPy).parameters:
        raise RuntimeError("this program's RecToolsIRCuPy takes no mesh")
    return RecToolsIRCuPy


def _mesh(config: dict, device):
    if not _MESH:
        from tomobar_tpu_torch.parallel import distributed_init, make_mesh

        if not dist.is_initialized():
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                    world_size=1, rank=0)
        ranks, n_angles = dist.get_world_size(), int(config["mesh"]["angles"])
        if ranks > 1 and ranks != int(config["mesh"]["z"]) * n_angles:
            raise ValueError(f"the configuration's mesh {config['mesh']} is not a world of "
                             f"{ranks} ranks")
        distributed_init(device=device)
        _MESH.append(make_mesh(ranks // n_angles, n_angles, device=device))
    return _MESH[0]


def local(config: dict, traffic: dict, chunk):
    """This rank's slab of the chunk's rows (rank r holds the r-th of as
    many equal slabs as the world has ranks), a copy."""
    ranks, rank = dist.get_world_size(), dist.get_rank()
    step = chunk.shape[0] // ranks
    return chunk[rank * step:(rank + 1) * step].clone()


def call(config: dict, traffic: dict, part, device):
    RecToolsIRCuPy = _program()
    mesh = _mesh(config, device)
    g, r, m = config["geometry"], config["reconstructor"], config["FISTA"]
    rows = int(part.shape[0]) * mesh.shape["z"]
    rt = RecToolsIRCuPy(int(g["detector_x"]), 0, rows, float(g["centre_offset"]), angles(g),
                        int(g["recon_size"]), OS_number=int(r["OS_number"]), device=device,
                        mesh=mesh)
    data = dict(copy.deepcopy(m["data"]), projection_data=part)
    x = rt.FISTA(data, copy.deepcopy(m["algorithm"]), copy.deepcopy(m["regularisation"]))
    return rt.Atools.gather_vol(x, dst=0)


def warmup(config: dict, traffic: dict, part, device):
    """The call with one outer iteration, as ``FISTA.py`` warms up: every
    kernel, shape, plan and exchange of the timed call."""
    cfg = copy.deepcopy(config)
    cfg["FISTA"]["algorithm"]["iterations"] = 1
    return call(cfg, traffic, part, device)


def answer_count(out) -> int:
    return 1


def answer(out, j: int):
    return out


def reference(config: dict, traffic: dict, chunk, ids, prec: str = "fp32") -> dict:
    """The reference's reconstruction of the whole ``chunk`` (answer 0),
    each rank computing its slab (``benchmark/reference/fista_mesh.py``);
    rank 0's is the whole volume, the other ranks' None."""
    from benchmark.reference.fista_mesh import fista_mesh

    g, r, m = config["geometry"], config["reconstructor"], config["FISTA"]
    a, reg = m["algorithm"], m["regularisation"]
    supported = (m["data"].get("data_fidelity") == "PWLS" and a.get("nonnegativity") is True
                 and reg.get("method") == "PD_TV" and set(a) <= {"iterations", "nonnegativity"}
                 and set(reg) <= {"method", "regul_param", "iterations"}
                 and int(config["mesh"]["angles"]) == 1)
    if not supported:
        raise ValueError("the mesh FISTA reference covers PWLS, non-negativity, iso PD-TV and "
                         "z-only meshes only")
    out = fista_mesh(chunk, angles(g), float(g["centre_offset"]), int(g["recon_size"]),
                     int(r["OS_number"]), int(a["iterations"]), reg, prec)
    return {0: out}
