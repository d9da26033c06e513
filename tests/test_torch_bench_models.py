"""The port's bench models (``tomobar_tpu_torch/bench``): the roofline
report's bounds (every case of ``tests/test_bench_models.py``, on the H100
bounds), the work models, and the collective model against what the
sharded layer counts on worlds of CPU ranks (gloo).

Tolerances: the utilisations to 1e-6 (rounded to 3 places by the report);
the work and collective counts exactly.
"""

import json

import numpy as np
import pytest

from test_torch_sharding import finish_world, start_world
from tomobar_tpu.bench import breakdown as JB
from tomobar_tpu_torch.bench import breakdown as B
from tomobar_tpu_torch.bench import fourier_breakdown as FB
from tomobar_tpu_torch.bench.scaling import comm_model

FLOPS, HBM = B.H100_SXM_FP32_FLOPS, B.H100_SXM_HBM_BYTES


def _check_bounds(rec):
    for k, v in rec.items():
        if k.endswith("_util"):
            assert 0.0 < v <= 1.0, (k, v)


def test_normal_stage_within_bounds(capsys):
    # 10 ms doing half the peak's worth of operations: utilisation 0.5
    rec = B.stage_report("half-peak", 1e-2, flops=0.5 * FLOPS * 1e-2)
    _check_bounds(rec)
    assert abs(rec["fp32_util"] - 0.5) < 1e-6
    capsys.readouterr()


def test_impossible_model_is_clamped_and_flagged(capsys):
    # a model claiming 3x the peak: the utilisation clamps to 1, the raw
    # value stays visible
    rec = B.stage_report("broken-model", 1e-2, flops=3.0 * FLOPS * 1e-2)
    _check_bounds(rec)
    assert rec["fp32_util"] == 1.0
    assert rec["fp32_util_raw"] == 3.0
    capsys.readouterr()


def test_zero_ms_stage_reports_no_rates(capsys):
    rec = B.stage_report("instant", 1e-7, flops=1e9, bytes_moved=1e9)
    assert "gflops" not in rec and "hbm_gbs" not in rec
    assert "fp32_util" not in rec and "hbm_util" not in rec
    assert rec["below_timer_resolution"] is True
    assert rec["ms"] < B._MIN_RATE_DT * 1e3
    capsys.readouterr()


def test_hbm_util_bounded(capsys):
    rec = B.stage_report("membound", 1e-3, bytes_moved=10.0 * HBM * 1e-3)
    _check_bounds(rec)
    assert rec["hbm_util"] == 1.0 and rec["hbm_util_raw"] == 10.0
    capsys.readouterr()


def test_bounds_are_the_h100_sxm_data_sheet():
    """67 TFLOP/s float32 and 3.35 TB/s, the bounds ``chip_smoke.py`` holds
    every kernel against; no TPU peak is left."""
    assert (FLOPS, HBM) == (67e12, 3.35e12)
    assert not any(k.startswith(("_VPU", "_MXU")) for k in vars(B))


# FOURIER_INV's stage times at 1801 x 8 x 2560 on an NVIDIA H100 80GB HBM3 at
# 700 W (chip_smoke.py phase 7): the filter stage 6.434 ms, ifft2 10.061 ms
@pytest.mark.parametrize("stage, ms", [("filter", 6.434), ("ifft2", 10.061), ("grid", 6.878)])
def test_fourier_models_cannot_exceed_peak(stage, ms):
    """At the stage times measured on the card, the work models imply
    utilisations within (0, 1] of both bounds."""
    ow = 8192
    ops, moved = FB.stage_work(2560, 8, 1801, ow)[stage]
    for util in (ops / (ms * 1e-3) / FLOPS, moved / (ms * 1e-3) / HBM):
        assert 0.0 < util <= 1.0, (stage, util)


@pytest.mark.parametrize("shape", [(8, 180, 2560, 2560), (1, 91, 2560, 2560), (20, 181, 64, 64)])
def test_projector_flops_equal_the_jax_count(shape):
    assert B.projector_flops(*shape) == JB.projector_flops(*shape) == 4.0 * np.prod(shape)


@pytest.mark.parametrize("nz, per_voxel", [(8, 36), (20, 36), (1, 28)])
def test_work_pd_counts_36_operations(nz, per_voxel):
    """PD: 36 operations per voxel and iteration, 28 for one slice (the
    JAX package's 42 overcounted); the data read and u written once."""
    ops, moved = B.work_pd(nz, 64, 20)
    assert ops == per_voxel * 20 * nz * 64 * 64
    assert moved == 8 * nz * 64 * 64
    assert JB.pd_tv_flops(nz, 64, 64, 20) == 42 * 20 * nz * 64 * 64


def test_work_models_of_the_kernels():
    """The kernels' (operations, bytes), each input read and each output
    written once (the counts ``chip_smoke.py`` holds the kernels to)."""
    assert B.work_unshear(90, 8, 64, 256) == (4 * 90 * 8 * 64 * 64,
                                               4 * (90 * 8 * 256 + 90 + 8 * 64 * 64))
    assert B.work_shear(90, 8, 64, 64, 256)[0] == 4 * 90 * 8 * 64 * 65
    assert B.work_resample(90, 8, 256, 64, 13)[0] == 13 * 8 * 90 * 64
    assert B.work_resample(90, 8, 256, 64, 26)[0] == 26 * 90 * 8 * 256
    assert B.work_fft((4, 1024, 100)) == (5 * 4 * 1024 * 100 * 10, 16 * 4 * 1024 * 100)
    assert B.work_grid(2, 10, 32, m=2) == (10 * 32 * 25 * (8 + 8),
                                           8 * 2 * 10 * 32 + 8 * 2 * 4 * 32 * 32 + 80)


# -- the collective model against the counts of one outer iteration ---------

N, NZ, NA, OS, TV = 32, 8, 20, 2, 3
MESHES = [(2, 1), (1, 2), (2, 2)]

_WORLD = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from tomobar_tpu_torch.bench.scaling import count_collectives_in_step
from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.parallel import ShardedProjector, distributed_init, make_mesh

d, N, NZ, NA, OS, TV = sys.argv[1], *map(int, sys.argv[2:7])
meshes = json.loads(sys.argv[7])
distributed_init(backend="gloo", device="cpu")
rank = torch.distributed.get_rank()
geom = Geometry(N, NZ, np.linspace(0, np.pi, NA, endpoint=False), 0.0, N, os_number=OS)
sino = np.random.default_rng(7).uniform(0.1, 1.0, (NZ, NA, N)).astype(np.float32)
out = {}
for n_z, n_a in meshes:
    mesh = make_mesh(n_z, n_a)
    sp = ShardedProjector(geom, mesh)
    counts = count_collectives_in_step(
        mesh, sp, sp.device_put_sino(sino), 500.0,
        {"method": "PD_TV", "regul_param": 5e-4, "iterations": TV})
    out[f"{n_z}x{n_a}"] = {"z_index": mesh.z_index, "counts": counts}
with open(f"{d}/counts_{len(meshes)}_{rank}.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """Each rank's counts: a world of 2 ranks on meshes (2, 1) and (1, 2),
    beside a world of 4 on mesh (2, 2)."""
    d = tmp_path_factory.mktemp("bench_comm")
    worlds = [(2, [(2, 1), (1, 2)]), (4, [(2, 2)])]
    procs = [start_world(_WORLD, (d, N, NZ, NA, OS, TV, json.dumps(m)), world=w)
             for w, m in worlds]
    for p in procs:
        finish_world(p)
    out = {}
    for w, meshes in worlds:
        for r in range(w):
            with open(d / f"counts_{len(meshes)}_{r}.json") as f:
                for key, v in json.load(f).items():
                    out[(key, r)] = v
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_comm_model_equals_the_counted_stats(counted, mesh):
    """Every rank's calls and bytes per collective in one outer iteration
    equal the model's for its z coordinate, exactly."""
    key = f"{mesh[0]}x{mesh[1]}"
    ranks = [r for (k, r) in counted if k == key]
    assert len(ranks) == mesh[0] * mesh[1]
    for r in ranks:
        got = counted[(key, r)]
        model = comm_model(N, NZ, OS, 1.0, mesh, TV, NA, got["z_index"])
        assert got["counts"] == model["stats"], (r, got, model["stats"])
        assert got["counts"], "the mesh moved nothing"


@pytest.mark.parametrize("n_a, width", [(2, 4), (3, 2), (4, 2)])
def test_comm_model_all_gather_by_hand(n_a, width):
    """Six angles 30 degrees apart, one subset: 0, 30 and 150 drive x
    (|cos| >= |sin|), 60, 90 and 120 drive y; each group of 3 dealt to n_a
    ranks pads to ceil(3 / n_a) angles a rank, so a rank's block is
    ``width`` angles wide and it receives (n_a - 1) blocks of 4 slices x 8
    detectors in float32."""
    stats = comm_model(8, 4, 1, 1.0, (1, n_a), 2, 6)["stats"]
    assert stats["all_gather"] == {"calls": 1, "bytes": (n_a - 1) * 4 * width * 8 * 4}
    assert stats["all_reduce"] == {"calls": 1, "bytes": 4 * 8 * 8 * 4}
    assert "z_halo" not in stats


def test_bench_imports_no_jax():
    """A fresh interpreter imports every bench module without jax or the
    JAX package."""
    import os
    import subprocess
    import sys

    from test_torch_sharding import REPO

    code = ("import sys\n"
            "import tomobar_tpu_torch.bench.harness, tomobar_tpu_torch.bench.breakdown\n"
            "import tomobar_tpu_torch.bench.fourier_breakdown, tomobar_tpu_torch.bench.northstar\n"
            "import tomobar_tpu_torch.bench.scaling\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tomobar_tpu.'))"
            " or m == 'tomobar_tpu']; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
