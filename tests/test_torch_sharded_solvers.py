"""The port's solvers on z-slabs: ``solvers.core`` with a
``ShardedProjector`` and the halo prox, on a world of 4 CPU ranks (gloo).

One world runs every case (meshes (4, 1), (2, 2) and (1, 4)); one JAX
subprocess (8 virtual CPU devices) runs the JAX package's sharded FISTA
step as ``__graft_entry__.dryrun_multichip`` writes it, on mesh (2, 2).
Held:

* against the port's single device: FISTA (OS 2, PWLS or SWLS, PD-TV of
  5 iterations, 2 outer iterations, L given), Landweber, SIRT, ADMM and
  OSEM bit for bit on z-only meshes; the power method's L, CGLS (whose
  global dot products are sums of the slabs' partial sums) and every
  result on meshes that deal angles within 1e-5 rel;
* against the JAX package's sharded step, on the Joseph pair on both
  sides, at 2e-4 rel L2 (``tests/test_torch_solvers.py``);
* the halo prox of every ``prox_regul`` method against the unsharded
  prox, bit for bit, with halos below and above the slab's depth (the Haar
  shrinkage on blocks of 2, 4 and 8 slices; NLTV gathers the volume and
  refuses its slices as one device does); under ``n_z == 1`` a method runs
  on the whole volume;
* the ``ValueError`` of ``make_mesh``, ``Mesh.z_slab`` and
  ``ShardedDirect``, ``distributed_init`` called twice, the device of a
  group started outside it, and a package that imports neither jax nor
  ``tomobar_tpu``.
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_sharding import (
    REPO, WORLD_TIMEOUT, finish_world, run_in_cpu_mesh_subprocess, start_world)
from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops import projector as P
from tomobar_tpu_torch.regularisers import PD_TV, ROF_TV, prox_regul
from tomobar_tpu_torch.regularisers_legacy import FGP_TV
from tomobar_tpu_torch.solvers import core as S
from tomobar_tpu_torch.utils.dicts import dicts_check

MESHES = [(4, 1), (2, 2), (1, 4)]
TOL_REL = 2e-4  # rel L2 against the JAX package (tests/test_torch_solvers.py)
TOL_SHARD = 1e-5  # rel: global reductions summed slab by slab
N, NZ, NA, OS = 32, 8, 16, 2
PROX_CASES = [("PD_TV", 1), ("PD_TV", 5), ("ROF_TV", 1), ("ROF_TV", 5)]
# the other methods of prox_regul on z-slabs: (label, regularisation dict),
# each at 1 and 5 iterations (halos of 1-2 and 5-10 slices against slabs of
# 2 and 4)
LEGACY_CASES = [
    (f"{label}_{its}", dict(reg, iterations=its))
    for its in (1, 5)
    for label, reg in (
        ("FGP_TV", {"method": "FGP_TV", "regul_param": 0.05}),
        ("FGP_TV_aniso", {"method": "FGP_TV", "regul_param": 0.05, "methodTV": 1}),
        ("SB_TV", {"method": "SB_TV", "regul_param": 0.05}),
        ("LLT_ROF", {"method": "LLT_ROF", "regul_param": 0.05, "regul_param2": 0.02}),
        ("TGV", {"method": "TGV", "regul_param": 0.05}),
        ("NDF_1", {"method": "NDF", "regul_param": 0.05, "edge_param": 0.1, "NDF_penalty": 1}),
        ("NDF_3", {"method": "NDF", "regul_param": 0.05, "edge_param": 0.1, "NDF_penalty": 3}),
        ("Diff4th", {"method": "Diff4th", "regul_param": 0.05, "edge_param": 0.1}),
        ("PD_TV_WAVELETS", {"method": "PD_TV_WAVELETS", "regul_param": 0.05,
                            "regul_param2": 0.02}),
    )
] + [(f"WAVELETS_levels{lv}", {"method": "WAVELETS", "regul_param": 0.3, "wavelet_levels": lv})
     for lv in (1, 2, 3)]


def _inputs() -> dict:
    rng = np.random.default_rng(30)
    angles = np.linspace(0.0, np.pi, NA, endpoint=False)
    yy, xx = np.mgrid[-1:1:N * 1j, -1:1:N * 1j]
    disk = (xx ** 2 + yy ** 2 < 0.5).astype(np.float32)
    phantom = np.stack([disk * (1.0 + 0.1 * z) for z in range(NZ)])
    clean = P.radon_fp(torch.as_tensor(phantom), Geometry(N, NZ, angles, 0.0, N)).numpy()
    sino = (clean + 0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    return {
        "angles": angles,
        "sino": np.maximum(sino, 0.0).astype(np.float32),
        "x0": rng.standard_normal((NZ, N, N)).astype(np.float32),
        "noisy": (phantom + 0.1 * rng.standard_normal(phantom.shape)).astype(np.float32),
        "L": np.float64(S.power_method(P.Projector(Geometry(N, NZ, angles, 0.0, N, os_number=OS)),
                                       (NZ, N, N), device="cpu")),
    }


_TORCH_WORLD = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from tomobar_tpu_torch import RecToolsDIRCuPy
from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops.projector import set_projector_backend
from tomobar_tpu_torch.parallel import (
    ShardedDirect, ShardedProjector, comm, distributed_init, make_mesh, sharded_regul_fn)
from tomobar_tpu_torch.solvers import core as S

d = sys.argv[1]
N, NZ, NA, OS = (int(a) for a in sys.argv[2:6])
inp = dict(np.load(d + "/inputs.npz"))


def raises(exc, fn, text=""):
    try:
        fn()
    except exc as e:
        return np.asarray(text in str(e))
    return np.asarray(False)


# a group started outside distributed_init, as torchrun scripts start it: no
# CPU mesh unless asked for, cuda:LOCAL_RANK where cards are visible
dist.init_process_group("gloo")
out = {"outside/no_cuda": raises(ValueError, lambda: make_mesh(4, 1), "CUDA is not available")}
cuda = torch.cuda.is_available, torch.cuda.device_count
torch.cuda.is_available, torch.cuda.device_count = (lambda: True), (lambda: 4)
out["outside/card"] = np.asarray(str(make_mesh(4, 1).device) == f"cuda:{dist.get_rank()}")
torch.cuda.is_available, torch.cuda.device_count = cuda
out["outside/cpu_asked"] = np.asarray(make_mesh(4, 1, device="cpu").device.type == "cpu")
dev = distributed_init(backend="gloo", device="cpu")
out["outside/recorded"] = np.asarray(dev.type == "cpu" and make_mesh(4, 1).device == dev)
out["init_twice"] = np.asarray(distributed_init(backend="gloo", device="cpu") == dev)
meshes = {m: make_mesh(*m) for m in ((4, 1), (2, 2), (1, 4))}
g = Geometry(N, NZ, inp["angles"], 0.0, N, os_number=OS)
g1 = Geometry(N, NZ, inp["angles"], 0.0, N)
L = float(inp["L"])
pd = {"method": "PD_TV", "regul_param": 5e-4, "iterations": 5}

for (zm, am), mesh in meshes.items():
    tag = f"{zm}x{am}"
    sp, sp1 = ShardedProjector(g, mesh), ShardedProjector(g1, mesh)
    b, b1 = sp.device_put_sino(inp["sino"]), sp1.device_put_sino(inp["sino"])
    for fid in ("PWLS", "SWLS"):
        x = S.fista(sp, b, 2, L, nonnegativity=True, fidelity=fid,
                    regul_fn=sharded_regul_fn(mesh, pd, nonneg=True))
        out[f"{tag}/fista_{fid}"] = sp.gather_vol(x)
    out[f"{tag}/power"] = np.asarray(S.power_method(sp, None, x0=sp.device_put_vol(inp["x0"])))
    out[f"{tag}/cgls"] = sp1.gather_vol(S.cgls(sp1, b1, 10))
    out[f"{tag}/landweber"] = sp1.gather_vol(S.landweber(sp1, b1, 3, 1e-3, True))
    out[f"{tag}/sirt"] = sp1.gather_vol(S.sirt(sp1, b1, 3, True))
    out[f"{tag}/admm"] = sp.gather_vol(S.admm(sp, b, 3, L, nonnegativity=True, tolerance=1e-12,
                                              regul_fn=sharded_regul_fn(mesh, pd, nonneg=True)))
    out[f"{tag}/osem"] = sp.gather_vol(S.osem(sp, b, 2))
    noisy = sp.device_put_vol(inp["noisy"])
    for method, its in ((m, i) for m in ("PD_TV", "ROF_TV") for i in (1, 5)):
        fn = sharded_regul_fn(mesh, {"method": method, "regul_param": 0.05, "iterations": its},
                              nonneg=True)
        out[f"{tag}/prox_{method}_{its}"] = sp.gather_vol(fn(noisy))
    fgp = {"method": "FGP_TV", "regul_param": 0.05, "iterations": 5}
    out[f"{tag}/prox_FGP_TV_5"] = sp.gather_vol(sharded_regul_fn(mesh, fgp)(noisy))
    if zm > 1:
        for label, reg in json.loads(sys.argv[6]):
            out[f"{tag}/legacy_{label}"] = sp.gather_vol(
                sharded_regul_fn(mesh, reg, nonneg=True)(noisy))
        nltv = {"method": "NLTV", "regul_param": 0.03, "NLTV_H_i": 0, "NLTV_H_j": 0,
                "NLTV_Weights": 0}
        comm.reset_stats()
        out[f"{tag}/nltv_refused"] = raises(
            ValueError, lambda: sharded_regul_fn(mesh, nltv)(noisy), "2D")
        out[f"{tag}/nltv_collectives"] = len(comm.stats)

# the JAX package's step on the Joseph pair: LS, L = 200, PD-TV (1e-4, 5)
set_projector_backend("xla")
graft = {"method": "PD_TV", "regul_param": 1e-4, "iterations": 5}
for (zm, am), mesh in meshes.items():
    sp = ShardedProjector(g, mesh)
    x = S.fista(sp, sp.device_put_sino(inp["sino"]), 2, 200.0, nonnegativity=True,
                regul_fn=sharded_regul_fn(mesh, graft, nonneg=True))
    out[f"{zm}x{am}/graft"] = sp.gather_vol(x)
set_projector_backend("pallas")

# the errors
m41 = meshes[(4, 1)]
out["err/mesh_size"] = raises(ValueError, lambda: make_mesh(3, 1), "does not match")
os.environ["LOCAL_WORLD_SIZE"] = "2"  # two hosts of two ranks
out["err/mesh_hosts"] = raises(ValueError, lambda: make_mesh(1, 4), "divisible by the host")
os.environ["LOCAL_WORLD_SIZE"] = "4"
out["err/z_slab"] = raises(ValueError, lambda: m41.z_slab(7), "split evenly")
rd = RecToolsDIRCuPy(N, 0, 12, 0.0, inp["angles"], N, device="cpu")
sd = ShardedDirect(rd, m41)
slab3 = sd.device_put_sino(np.zeros((12, NA, N), np.float32))
out["err/fourier_inv_pairs"] = raises(ValueError, lambda: sd.fourier_inv(slab3), "2 * z-shards")
out["err/fbp_angles"] = raises(ValueError, lambda: sd.fbp(slab3[:, :5]), f"with {NA} angles")
order = ["angles", "detY", "detX"]
for name in ("fbp", "fourier_inv"):
    out[f"err/{name}_axes"] = raises(
        ValueError, lambda: getattr(sd, name)(slab3, data_axes_labels_order=order), "canonical")
if dist.get_rank() == 0:
    np.savez(d + "/torch.npz", **{k: np.asarray(v) for k, v in out.items()})
dist.barrier()
"""

# __graft_entry__.py's sharded FISTA step, two outer iterations
_JAX_STEP = """
import numpy as np, jax, jax.numpy as jnp
from tomobar_tpu.geometry import Geometry
from tomobar_tpu.ops.projector import set_projector_backend
from tomobar_tpu.parallel import ShardedProjector, make_mesh
from tomobar_tpu.regularisers import PD_TV

d, N, NZ, NA, OS = ARGS
inp = dict(np.load(d + "/inputs.npz"))
set_projector_backend("xla")
mesh = make_mesh(2, 2, devices=jax.devices()[:4])
geom = Geometry(detectors_x=N, detectors_y=NZ, angles=inp["angles"], recon_size=N,
                os_number=OS)
SP = ShardedProjector(geom, mesh)
n_sub = len(SP.subset_indices)
L_inv = jnp.float32(1.0 / 200.0)


def train_step(x, x_t, t, sino):
    for s in range(n_sub):
        x_old, t_old = x, t
        res = SP.fp_sub(x_t, s) - SP.sino_subset(sino, s)
        grad = SP.bp_sub(res, s)
        x = jnp.maximum(x_t - L_inv * grad, 0.0)
        x = PD_TV(x, 1e-4, 5, 0, 1, 12.0)
        t = (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)) * 0.5
        x_t = x + ((t_old - 1.0) / t) * (x - x_old)
    return x, x_t, t


x = x_t = SP.device_put_vol(jnp.zeros((NZ, N, N), dtype=jnp.float32))
sino = SP.device_put_sino(jnp.asarray(inp["sino"]))
step = jax.jit(train_step)
t = jnp.float32(1.0)
for _ in range(2):
    x, x_t, t = step(x, x_t, t, sino)
np.savez(d + "/jax.npz", graft=np.asarray(x))
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_solvers")
    np.savez(d / "inputs.npz", **_inputs())
    args = (str(d), N, NZ, NA, OS)
    # the ranks run beside the JAX side
    procs = start_world(_TORCH_WORLD, args + (json.dumps(LEGACY_CASES),))
    try:
        run_in_cpu_mesh_subprocess(f"ARGS = {args!r}\n" + textwrap.dedent(_JAX_STEP),
                                   timeout=WORLD_TIMEOUT)
    finally:
        finish_world(procs)
    inp = dict(np.load(d / "inputs.npz"))
    return dict(np.load(d / "torch.npz")), dict(np.load(d / "jax.npz")), inp


def _pd(x, its=5, lam=5e-4):
    return PD_TV(x, lam, its, 0, 1, 12.0)


@pytest.fixture(scope="module")
def single(worlds):
    """The port's single-device results on the same inputs."""
    inp = worlds[2]
    g = Geometry(N, NZ, inp["angles"], 0.0, N, os_number=OS)
    pr, pr1 = P.Projector(g), P.Projector(Geometry(N, NZ, inp["angles"], 0.0, N))
    b = torch.as_tensor(inp["sino"])
    L = float(inp["L"])
    out = {}
    for fid in ("PWLS", "SWLS"):
        out[f"fista_{fid}"] = S.fista(pr, b, 2, L, nonnegativity=True, fidelity=fid, regul_fn=_pd)
    out["power"] = torch.tensor(S.power_method(pr, None, x0=torch.as_tensor(inp["x0"])))
    out["cgls"] = S.cgls(pr1, b, 10)
    out["landweber"] = S.landweber(pr1, b, 3, 1e-3, True)
    out["sirt"] = S.sirt(pr1, b, 3, True)
    out["admm"] = S.admm(pr, b, 3, L, nonnegativity=True, tolerance=1e-12, regul_fn=_pd)
    out["osem"] = S.osem(pr, b, 2)
    noisy = torch.as_tensor(inp["noisy"])
    for its in (1, 5):
        out[f"prox_PD_TV_{its}"] = _pd(noisy, its, 0.05)
        out[f"prox_ROF_TV_{its}"] = ROF_TV(noisy, 0.05, its, 0.005)
    out["prox_FGP_TV_5"] = FGP_TV(noisy, 0.05, 5, 0, 0)
    owner = SimpleNamespace(nonneg_regul=1, OS_number=1)
    for label, reg in LEGACY_CASES:
        _, _, r = dicts_check(owner, {"projection_data": np.zeros((1, 1, 1), np.float32)},
                              {"nonnegativity": True}, dict(reg), "FISTA")
        out[f"legacy_{label}"] = prox_regul(owner, noisy, r)
    return {k: v.numpy() for k, v in out.items()}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


EXACT_ON_Z = ["fista_PWLS", "fista_SWLS", "landweber", "sirt", "admm", "osem"]


@pytest.mark.parametrize("case", EXACT_ON_Z)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_solver_matches_single_device(worlds, single, mesh, case):
    got, want = worlds[0][f"{mesh[0]}x{mesh[1]}/{case}"], single[case]
    assert got.shape == want.shape
    if mesh[1] == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= TOL_SHARD


@pytest.mark.parametrize("case", ["power", "cgls"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_global_reductions_match_single_device(worlds, single, mesh, case):
    """The power method's norm and CGLS's dot products, reduced over the
    z group from each slab's partial sum."""
    got, want = worlds[0][f"{mesh[0]}x{mesh[1]}/{case}"], single[case]
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL_SHARD


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_fista_step_matches_jax_sharded(worlds, mesh):
    """``__graft_entry__``'s step (LS, L 200, nonneg, PD-TV 1e-4 of 5
    iterations, OS 2) for two outer iterations, on the Joseph pair."""
    got, want = worlds[0][f"{mesh[0]}x{mesh[1]}/graft"], worlds[1]["graft"]
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= TOL_REL


@pytest.mark.parametrize("method, its", PROX_CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_halo_prox_matches_unsharded(worlds, single, mesh, method, its):
    """A halo of the iteration count makes the slab's prox the whole
    volume's, also where the halo (5) is deeper than the slab (2 or 4
    slices) and the window spans several slabs."""
    got = worlds[0][f"{mesh[0]}x{mesh[1]}/prox_{method}_{its}"]
    np.testing.assert_array_equal(got, single[f"prox_{method}_{its}"])


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_other_prox_raises_on_z_slabs(worlds, single, mesh):
    """FGP-TV no longer raises on z-slabs: with a halo of its 5 iterations
    its slab equals the whole volume's prox bit for bit."""
    got = worlds[0][f"{mesh[0]}x{mesh[1]}/prox_FGP_TV_5"]
    np.testing.assert_array_equal(got, single["prox_FGP_TV_5"])


@pytest.mark.parametrize("label", [label for label, _ in LEGACY_CASES])
@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_legacy_prox_matches_unsharded(worlds, single, mesh, label):
    """Every other ``prox_regul`` method with a halo of its iterations
    times its reach along z (the Haar shrinkage on its blocks), on slabs of
    2 and 4 slices, against the prox of the whole volume, bit for bit."""
    got = worlds[0][f"{mesh[0]}x{mesh[1]}/legacy_{label}"]
    np.testing.assert_array_equal(got, single[f"legacy_{label}"])


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_nltv_on_z_slabs_refuses_as_one_device(worlds, mesh):
    """A volume split along z has more than one slice, which NLTV refuses
    on one device too; the refusal comes before any collective."""
    assert worlds[0][f"{mesh[0]}x{mesh[1]}/nltv_refused"]
    assert worlds[0][f"{mesh[0]}x{mesh[1]}/nltv_collectives"] == 0


def test_other_prox_runs_whole_under_one_z_shard(worlds, single):
    np.testing.assert_array_equal(worlds[0]["1x4/prox_FGP_TV_5"], single["prox_FGP_TV_5"])


@pytest.mark.parametrize("case", ["mesh_size", "mesh_hosts", "z_slab", "fourier_inv_pairs",
                                  "fbp_axes", "fourier_inv_axes", "fbp_angles"])
def test_value_errors(worlds, case):
    assert worlds[0][f"err/{case}"]


def test_distributed_init_twice(worlds):
    assert worlds[0]["init_twice"]


@pytest.mark.parametrize("case", ["no_cuda", "card", "cpu_asked", "recorded"])
def test_group_started_outside_distributed_init(worlds, case):
    """On a group that ``dist.init_process_group`` started, ``make_mesh``
    gives no CPU mesh by default: it raises without CUDA, takes
    ``cuda:LOCAL_RANK`` where cards are visible, the CPU where asked, and
    the device that ``distributed_init`` then records."""
    assert worlds[0][f"outside/{case}"]


def test_parallel_imports_no_jax():
    """A fresh interpreter imports the sharded layer without jax or the
    JAX package."""
    code = ("import sys, tomobar_tpu_torch.parallel; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tomobar_tpu.'))"
            " or m == 'tomobar_tpu']; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
