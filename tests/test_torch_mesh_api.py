"""The public class on a mesh: ``RecToolsIRCuPy(..., mesh=...).FISTA`` on
z-slabs, on a world of 4 CPU ranks (gloo), at 32 slices x 64^2 x 60 angles
with OS 4 and 3 outer iterations, PWLS and PD-TV at 20 iterations (a halo
of 20 slices, wider than a rank's 8-slice slab) and at 4 (narrower).
Held:

* (a) against the one-device API on the whole volume: bit for bit with
  ``lipschitz_const`` given; with the power method within 1e-5 rel L2
  (``tests/test_torch_sharded_solvers.py``'s bound for it: the mesh's norm
  sums the slabs' squares in float64), the power method's start being
  each rank's slab of the whole volume's draw;
* (b) the plain reference on the same world
  (``benchmark/reference/fista_mesh.py``, an exchange of one slice a PD-TV
  iteration) against ``benchmark/reference/fista.py`` on the whole volume;
* (c) the mesh API against that reference within the cell's limit, which
  the same reference in bfloat16 exceeds, at the cell's 10 subsets (at 4,
  12 steps grow bfloat16's rounding to only ~0.02);
* (d) the spans ``tomobar::regul.sharded_prox``, ``comm.z_halo``,
  ``comm.gather`` and ``parallel.mesh`` with the attrs the readers read,
  and the counters ``halo.rows_computed`` / ``rows_kept`` /
  ``comm.halo_bytes`` against the slab arithmetic; the gather to rank 0
  alone; what the mesh cannot serve raising ``ValueError`` naming the
  mesh before any collective;
* (e) the cell ``fista_pdtv.mesh4`` cut to the tiny size
  (``benchmark/tests/tiny_mesh.py``) through ``run.run_world`` on 4 gloo
  ranks, traced and not: ``correct``, both new readers reporting;
* (f) the same world with the prox run on the bare slab (no halo):
  ``correct`` false.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import inputs, program
from benchmark.reference import fista as ref_fista
from benchmark.reference.common import rel_l2
from benchmark.tests.tiny_mesh import tiny_root
from test_torch_sharding import REPO, WORLD_TIMEOUT, finish_world, start_world
from tomobar_tpu_torch import RecToolsIRCuPy

N, NZ, NA, OS, ITERS, LAM = 64, 32, 60, 4, 3, 8e-3
OS_CELL = 10  # the cell's OS_number
RANKS, SLAB = 4, 32 // 4
TV_ITERS = (20, 4)
TOL_POWER = 1e-5  # rel L2: tests/test_torch_sharded_solvers.py's bound for the power method
# the mesh reference against the whole-volume one: its L differs in the last
# bits (float64 sum of the slabs' squares against one float32 norm) and a
# slab's projector batches fewer slices (other float32 rounding in the FFT
# and matrix products); 12 OS-FISTA steps grow that to ~1e-6 here
TOL_REF = 1e-5
CELL = "fista_pdtv.mesh4"
SEED = 2**31 + 57


def _limit() -> float:
    own = json.loads((Path(REPO) / "benchmark" / "workloads" / f"{CELL}.json").read_text())
    return own["limits"]["rel_l2"]


def _inputs() -> dict:
    theta = np.linspace(0.0, np.pi, NA, endpoint=False)
    clean = inputs.clean_sinogram(theta, N, N, 64, np.arange(16, 16 + NZ), 0.0, "cpu")
    sino = inputs.noisy(clean, 8000.0, N, torch.Generator().manual_seed(9))
    rt = RecToolsIRCuPy(N, 0, NZ, 0.0, theta, N, OS_number=OS, device="cpu")
    return {"angles": theta, "sino": sino.numpy(),
            "L": np.float64(rt.powermethod({"projection_data": sino, "data_fidelity": "PWLS"}))}


def _regul(its: int) -> dict:
    return {"method": "PD_TV", "regul_param": LAM, "iterations": its}


_WORLD = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from benchmark.reference.fista_mesh import fista_mesh
from tomobar_tpu_torch import RecToolsIRCuPy, trace
from tomobar_tpu_torch.parallel import comm, distributed_init, make_mesh

d = sys.argv[1]
N, NZ, OS, ITERS, OS_CELL = (int(a) for a in sys.argv[2:7])
LAM, TV_ITERS = float(sys.argv[7]), json.loads(sys.argv[8])
inp = dict(np.load(d + "/inputs.npz"))
dev = distributed_init(backend="gloo", device="cpu")
rank = dist.get_rank()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    trace.reset()
    mesh = make_mesh(4, 1)
    made = [s["attrs"] for s in trace.snapshot()["spans"] if s["name"] == "tomobar::parallel.mesh"]
z0, z1 = mesh.z_slab(NZ)
sino, angles, L = torch.as_tensor(inp["sino"]), inp["angles"], float(inp["L"])
out, mine = {}, {"mesh_spans": made}


def rt(rows=NZ, os_number=OS):
    return RecToolsIRCuPy(N, 0, rows, 0.0, angles, N, OS_number=os_number, mesh=mesh)


def data(part=None):
    return {"projection_data": (sino[z0:z1] if part is None else part).clone(),
            "data_fidelity": "PWLS"}


def alg(**kw):
    return dict({"iterations": ITERS, "nonnegativity": True}, **kw)


def put(key, vol):
    if rank == 0:
        out[key] = vol.numpy()
    else:
        mine[f"none/{key}"] = vol is None


def refused(fn):
    comm.reset_stats()
    try:
        fn()
    except ValueError as e:
        return {"refused": "Mesh(z=4" in str(e), "collectives": len(comm.stats), "text": str(e)}
    return {"refused": False}


for its in TV_ITERS:
    reg = {"method": "PD_TV", "regul_param": LAM, "iterations": its}
    r = rt()
    put(f"given/{its}", r.Atools.gather_vol(r.FISTA(data(), alg(lipschitz_const=L), dict(reg)), dst=0))
    r = rt()
    put(f"power/{its}", r.Atools.gather_vol(r.FISTA(data(), alg(), dict(reg)), dst=0))
    mine[f"L/{its}"] = r._lipschitz_cache
    put(f"ref/{its}", fista_mesh(sino, angles, 0.0, N, OS, ITERS, reg))
    r = rt(os_number=OS_CELL)
    put(f"cell/{its}", r.Atools.gather_vol(r.FISTA(data(), alg(), dict(reg)), dst=0))
    for prec in ("fp32", "bf16"):
        put(f"cell_ref_{prec}/{its}", fista_mesh(sino, angles, 0.0, N, OS_CELL, ITERS, reg, prec))
    # one traced call: the spans and counters of the halo prox
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.reset()
        r = rt()
        r.Atools.gather_vol(r.FISTA(data(), alg(lipschitz_const=L), dict(reg)), dst=0)
        snap = trace.snapshot()
    mine[f"trace/{its}"] = {
        "prox": [s["attrs"] for s in snap["spans"] if s["name"] == "tomobar::regul.sharded_prox"],
        "halo": [s["attrs"] for s in snap["spans"] if s["name"] == "tomobar::comm.z_halo"],
        "gather": [s["attrs"] for s in snap["spans"] if s["name"] == "tomobar::comm.gather"],
        "counters": snap["counters"]}

nltv = {"method": "NLTV", "regul_param": 0.03, "NLTV_H_i": 0, "NLTV_H_j": 0, "NLTV_Weights": 0}
mine["err/nltv"] = refused(lambda: rt().FISTA(data(), alg(), nltv))
mine["err/whole_data"] = refused(lambda: rt().FISTA(data(sino), alg(), dict(reg)))
mine["err/rows"] = refused(lambda: rt(NZ - 2))
mine["err/device"] = refused(lambda: RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N, device="meta",
                                                    mesh=mesh))
with open(f"{d}/rank_{rank}.json", "w") as f:
    json.dump(mine, f)
if rank == 0:
    np.savez(d + "/mesh.npz", **out)
dist.barrier()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_api")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    procs = start_world(_WORLD, (str(d), N, NZ, OS, ITERS, OS_CELL, LAM, json.dumps(TV_ITERS)),
                        RANKS)
    finish_world(procs)
    ranks = [json.loads((d / f"rank_{r}.json").read_text()) for r in range(RANKS)]
    return dict(np.load(d / "mesh.npz")), ranks, inp


@pytest.fixture(scope="module")
def whole(world):
    """The one-device API and the whole-volume reference on the same data."""
    inp = world[2]
    sino = torch.as_tensor(inp["sino"])
    out = {}
    for its in TV_ITERS:
        for key, a in (("given", {"lipschitz_const": float(inp["L"])}), ("power", {})):
            rt = RecToolsIRCuPy(N, 0, NZ, 0.0, inp["angles"], N, OS_number=OS, device="cpu")
            out[f"{key}/{its}"] = rt.FISTA(
                {"projection_data": sino.clone(), "data_fidelity": "PWLS"},
                dict({"iterations": ITERS, "nonnegativity": True}, **a), _regul(its)).numpy()
        out[f"ref/{its}"] = ref_fista.fista(sino, inp["angles"], 0.0, N, OS, ITERS,
                                            _regul(its)).numpy()
    return out


def _rel(got, want) -> float:
    return rel_l2(torch.as_tensor(got), torch.as_tensor(want))


@pytest.mark.parametrize("its", TV_ITERS)
def test_mesh_fista_given_l_equals_one_device(world, whole, its):
    got, want = world[0][f"given/{its}"], whole[f"given/{its}"]
    assert got.shape == want.shape == (NZ, N, N)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("its", TV_ITERS)
def test_mesh_fista_with_the_power_method(world, whole, its):
    assert _rel(world[0][f"power/{its}"], whole[f"power/{its}"]) <= TOL_POWER
    L = world[1][0][f"L/{its}"]
    assert all(r[f"L/{its}"] == L for r in world[1])  # one L on every rank
    assert abs(L / float(world[2]["L"]) - 1.0) <= TOL_POWER


@pytest.mark.parametrize("its", TV_ITERS)
def test_mesh_reference_equals_the_whole_volume_reference(world, whole, its):
    assert _rel(world[0][f"ref/{its}"], whole[f"ref/{its}"]) <= TOL_REF


@pytest.mark.parametrize("its", TV_ITERS)
def test_mesh_api_against_mesh_reference_and_bf16_fails(world, its):
    ref = world[0][f"cell_ref_fp32/{its}"]
    assert _rel(world[0][f"cell/{its}"], ref) < _limit() / 10
    assert _rel(world[0][f"cell_ref_bf16/{its}"], ref) > _limit()


def test_the_gather_leaves_the_other_ranks_empty(world):
    for rank in world[1][1:]:
        flags = {k: v for k, v in rank.items() if k.startswith("none/")}
        assert flags and all(flags.values()), flags


@pytest.mark.parametrize("its", TV_ITERS)
def test_halo_spans_and_counters_follow_the_slab(world, its):
    proxes = ITERS * OS
    for r, rank in enumerate(world[1]):
        t = rank[f"trace/{its}"]
        before, after = min(its, r * SLAB), min(its, (RANKS - 1 - r) * SLAB)
        wide = before + SLAB + after
        assert len(t["prox"]) == proxes
        for a in t["prox"]:
            assert a == {"nz": SLAB, "n": N, "before": before, "after": after, "wide_nz": wide,
                         "method": "PD_TV", "iterations": its}
        assert len(t["halo"]) == proxes
        assert all(a["bytes"] == (before + after) * N * N * 4 for a in t["halo"])
        assert all(a["peers"] >= 1 for a in t["halo"])
        c = t["counters"]
        assert c["halo.rows_computed"] == proxes * wide * its
        assert c["halo.rows_kept"] == proxes * SLAB * its
        assert c["comm.halo_bytes"] == proxes * (before + after) * N * N * 4
        got = (RANKS - 1) * SLAB * N * N * 4 if r == 0 else 0
        assert [g["bytes"] for g in t["gather"]] == [got]
        assert c["comm.gather_bytes"] == got


def test_make_mesh_is_a_span(world):
    for rank in world[1]:
        assert rank["mesh_spans"] == [{"n_z": 4, "n_angles": 1}]


@pytest.mark.parametrize("case", ["nltv", "whole_data", "rows", "device"])
def test_what_the_mesh_cannot_serve_raises_first(world, case):
    for rank in world[1]:
        err = rank[f"err/{case}"]
        assert err["refused"] and err["collectives"] == 0, err


def _world_run(root, trace: int) -> tuple:
    code = ("import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import run;"
            "sys.exit(run.run_world(sys.argv[2:], 4, Path(sys.argv[1]), 'cpu'))")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code, str(root), "--workload", CELL, "--seed",
                          str(SEED), "--seconds", "0.01", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=WORLD_TIMEOUT, env=env, cwd=root)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), res.stderr


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("mesh_cell"))


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_a_world_of_four(tiny, trace):
    res, err = _world_run(tiny, trace)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == RANKS and res["failed"] == 0
    if trace:
        for name in ("halo_prox_roofline_pct", "halo_link_pct"):
            assert math.isfinite(res["metrics"][name]["value"]), name
            assert f"{name} by rank: [" in err
    else:
        assert {"slices_per_s", "setup_s"} <= set(res["metrics"])


def test_the_prox_on_the_bare_slab_is_not_correct(tmp_path):
    root = tiny_root(tmp_path)
    entry = root / "benchmark" / "entries" / "FISTA_MESH.py"
    entry.write_text(entry.read_text() + (
        "\n\nfrom tomobar_tpu_torch.parallel import sharding as _sharding\n"
        "_prox = _sharding.sharded_prox\n"
        "_sharding.sharded_prox = lambda mesh, prox, halo, *a: _prox(mesh, prox, 0, *a)\n"))
    res, _ = _world_run(root, 0)
    assert res["failed"] == 0 and not res["correct"], res["checks"]


def test_the_readers_read_nothing_without_the_spans(monkeypatch):
    from benchmark import registry

    for name in ("halo_prox_roofline_pct", "halo_link_pct"):
        mod = registry.metric(Path(REPO), name)
        for snap in (None, {"spans": [], "counters": {}, "dropped": 0}):
            monkeypatch.setattr(program, "snapshot", lambda snap=snap: snap)
            assert mod.read(None) is None
