"""The port's sharded projector and direct methods
(``tomobar_tpu_torch.parallel``) on a world of 4 CPU ranks (gloo).

One world runs every case of this file on the meshes (4, 1), (2, 2) and
(1, 4), and one subprocess with 8 virtual CPU devices runs the JAX
package's ``ShardedProjector`` / ``ShardedDirect`` on mesh (2, 2) (the
two-pass pair as Pallas in interpret mode, as ``tests/test_sharding.py``
runs it, the Joseph pair and the direct methods on XLA).  Both start
together (the ``worlds`` fixture); the tests compare what they wrote:

* against the port's single-device ``Projector`` and direct methods: bit
  for bit on z-only meshes (each slice's arithmetic does not depend on its
  neighbours), ``fp`` bit for bit and ``bp`` within 1e-6 rel L2 (the
  partial volumes are summed over the angle group in another order) on
  meshes that deal angles;
* against the JAX package's sharded counterparts: the two-pass pair at
  5e-5 of max (``tests/test_torch_projector.py``), the Joseph pair and
  the direct methods at 2e-5 of max (``tests/test_torch_direct.py``).
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tomobar_tpu_torch import RecToolsDIRCuPy
from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops import projector as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = [(4, 1), (2, 2), (1, 4)]
TOL = 5e-5  # of max: the Pallas bf16x3 products (tests/test_torch_projector.py)
TOL_PIPE = 2e-5  # of max (tests/test_torch_direct.py)
TOL_BP = 1e-6  # rel L2 where the angle group sums partial volumes
N, NZ, NA, OS = 32, 8, 40, 4
WORLD_TIMEOUT = 240  # seconds, each rank


def run_in_cpu_mesh_subprocess(code: str, timeout=900) -> str:
    """A copy of ``tests/test_sharding.py``'s helper: the JAX package on 8
    virtual CPU devices in a fresh interpreter."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    assert out.returncode == 0, f"subprocess failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(code: str, args, world: int = 4):
    """Start ``world`` ranks of ``code`` (gloo, env rendezvous on a free
    local port), one process each; returns the processes."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def finish_world(procs, timeout: float = WORLD_TIMEOUT) -> None:
    """Wait for every rank (``timeout`` seconds each); kill the world and
    fail with each rank's output if one fails or hangs."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append((None, *p.communicate()))
            continue
        outs.append((p.returncode, out, err))
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed (rc {rc}):\n{out}\n{err[-4000:]}"


def _geoms():
    angles = np.linspace(0.0, np.pi, NA, endpoint=False)
    cor = np.linspace(-1.5, 1.5, NA)
    vcor = np.stack([cor, np.linspace(-2.0, 2.0, NA)], axis=1)  # [n, 2]
    return angles, cor, vcor


def _inputs() -> dict:
    rng = np.random.default_rng(20)
    angles, cor, vcor = _geoms()
    vol = rng.standard_normal((NZ, N, N)).astype(np.float32)
    sino = rng.standard_normal((NZ, NA, N)).astype(np.float32)
    return {
        "angles": angles, "cor": cor, "vcor": vcor, "vol": vol, "sino": sino,
        "vol1": vol[:4], "sino1": sino[:4],
    }


# every case on the port's side; rank 0 writes the assembled results
_TORCH_WORLD = """
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from tomobar_tpu_torch import RecToolsDIRCuPy
from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops.projector import set_projector_backend
from tomobar_tpu_torch.parallel import ShardedDirect, ShardedProjector, comm
from tomobar_tpu_torch.parallel import distributed_init, make_mesh

d = sys.argv[1]
N, NZ, NA, OS = (int(a) for a in sys.argv[2:6])
inp = dict(np.load(d + "/inputs.npz"))
distributed_init(backend="gloo", device="cpu")
meshes = {m: make_mesh(*m) for m in ((4, 1), (2, 2), (1, 4))}
out = {}
g_os = Geometry(N, NZ, inp["angles"], inp["cor"], N, os_number=OS)
g_v = Geometry(N, NZ, inp["angles"], inp["vcor"], N)
for backend in ("pallas", "xla"):
    set_projector_backend(backend)
    for (zm, am), mesh in meshes.items():
        tag = f"{backend}/{zm}x{am}"
        sp = ShardedProjector(g_os, mesh)
        v, s = sp.device_put_vol(inp["vol"]), sp.device_put_sino(inp["sino"])
        out[f"{tag}/fp"] = sp.gather_vol(sp.fp(v))
        out[f"{tag}/bp"] = sp.gather_vol(sp.bp(s))
        for k in range(OS):
            out[f"{tag}/fp_sub{k}"] = sp.gather_vol(sp.fp_sub(v, k))
            out[f"{tag}/bp_sub{k}"] = sp.gather_vol(sp.bp_sub(sp.sino_subset(s, k), k))
        sv = ShardedProjector(g_v, mesh)
        comm.reset_stats()
        out[f"{tag}/vcor_fp"] = sv.gather_vol(sv.fp(sv.device_put_vol(inp["vol"])))
        halo_stats = dict(comm.stats.get("z_halo", {}))
        out[f"{tag}/vcor_bp"] = sv.gather_vol(sv.bp(sv.device_put_sino(inp["sino"])))
        out[f"{tag}/vcor_halo_bytes"] = np.asarray(halo_stats.get("bytes", 0))
        rd = RecToolsDIRCuPy(N, 0, NZ, 0.0, inp["angles"], N, device="cpu")
        sd = ShardedDirect(rd, mesh)
        data = sd.device_put_sino(inp["sino"])
        out[f"{tag}/fbp"] = sd.sp.gather_vol(sd.fbp(data))
        if backend == "pallas":
            out[f"{zm}x{am}/fourier_inv"] = sd.sp.gather_vol(sd.fourier_inv(data))
    # one slice a slab: nz = 4 over 4 z-shards (K1p/K4p)
    mesh = meshes[(4, 1)]
    g1 = Geometry(N, 4, inp["angles"], inp["cor"], N)
    sp = ShardedProjector(g1, mesh)
    out[f"{backend}/slice1/fp"] = sp.gather_vol(sp.fp(sp.device_put_vol(inp["vol1"])))
    out[f"{backend}/slice1/bp"] = sp.gather_vol(sp.bp(sp.device_put_sino(inp["sino1"])))

# the collectives' byte counts of one fp and one bp per mesh
set_projector_backend("pallas")
for (zm, am), mesh in meshes.items():
    sp = ShardedProjector(g_os, mesh)
    v, s = sp.device_put_vol(inp["vol"]), sp.device_put_sino(inp["sino"])
    comm.reset_stats()
    sp.fp(v)
    sp.bp(s)
    for op in ("all_gather", "all_reduce"):
        out[f"stats/{zm}x{am}/{op}"] = np.asarray(
            [comm.stats.get(op, {}).get(k, 0) for k in ("calls", "bytes", "staged")])
# z_halo: the window of each slab, against the whole volume's slices
vol = torch.as_tensor(inp["vol"])
mesh = meshes[(4, 1)]
for before, after in ((1, 3), (5, 0), (0, 7)):
    z0, z1 = mesh.z_slab(NZ)
    wide, added = comm.z_halo(vol[z0:z1].clone(), mesh, before, after)
    w0, w1 = max(z0 - before, 0), min(z1 + after, NZ)
    ok = (tuple(wide.shape) == (w1 - w0, N, N) and torch.equal(wide, vol[w0:w1])
          and added == z0 - w0)
    flags = torch.tensor([float(ok)])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    out[f"halo/{before}_{after}"] = flags.numpy()
if dist.get_rank() == 0:
    np.savez(d + "/torch.npz", **{k: np.asarray(v) for k, v in out.items()})
dist.barrier()
"""

# the JAX package's sharded counterparts on mesh (2, 2)
_JAX_SHARDED = """
import numpy as np, jax, jax.numpy as jnp
from tomobar_tpu.geometry import Geometry
from tomobar_tpu.models.direct import RecToolsDIRTPU
from tomobar_tpu.ops import projector_pallas
from tomobar_tpu.ops.projector import set_projector_backend
from tomobar_tpu.parallel import ShardedDirect, ShardedProjector, make_mesh

d, N, NZ, NA, OS = ARGS
inp = dict(np.load(d + "/inputs.npz"))
mesh = make_mesh(2, 2, devices=jax.devices()[:4])
out = {}
g_os = Geometry(detectors_x=N, detectors_y=NZ, angles=inp["angles"],
                center_rot_offset=inp["cor"], recon_size=N, os_number=OS)
g_v = Geometry(detectors_x=N, detectors_y=NZ, angles=inp["angles"],
               center_rot_offset=inp["vcor"], recon_size=N)
vol, sino = jnp.asarray(inp["vol"]), jnp.asarray(inp["sino"])
projector_pallas._INTERPRET[0] = True
for backend, subs in (("pallas", (0,)), ("xla", range(OS))):
    set_projector_backend(backend)
    sp = ShardedProjector(g_os, mesh)
    v, s = sp.device_put_vol(vol), sp.device_put_sino(sino)
    out[f"{backend}/fp"] = jax.jit(sp.fp)(v)
    out[f"{backend}/bp"] = jax.jit(sp.bp)(s)
    for k in subs:
        out[f"{backend}/fp_sub{k}"] = jax.jit(lambda x, k=k: sp.fp_sub(x, k))(v)
        sk = sp.sino_subset(sino, k)
        out[f"{backend}/bp_sub{k}"] = jax.jit(lambda x, k=k: sp.bp_sub(x, k))(sk)
    sv = ShardedProjector(g_v, mesh)
    out[f"{backend}/vcor_fp"] = jax.jit(sv.fp)(sv.device_put_vol(vol))
    out[f"{backend}/vcor_bp"] = jax.jit(sv.bp)(sv.device_put_sino(sino))
set_projector_backend("xla")
rt = RecToolsDIRTPU(N, 0, NZ, 0.0, inp["angles"].astype(np.float32), N)
sd = ShardedDirect(rt, mesh)
data = sd.device_put_sino(sino)
out["fbp"] = jax.jit(sd.fbp)(data)
out["fourier_inv"] = jax.jit(sd.fourier_inv)(data)
np.savez(d + "/jax.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both sides' results, from one torch world and one JAX subprocess
    started together."""
    d = tmp_path_factory.mktemp("sharding")
    np.savez(d / "inputs.npz", **_inputs())
    args = (str(d), N, NZ, NA, OS)
    procs = start_world(_TORCH_WORLD, args)  # the ranks run beside the JAX side
    try:
        run_in_cpu_mesh_subprocess(f"ARGS = {args!r}\n" + textwrap.dedent(_JAX_SHARDED),
                                   timeout=WORLD_TIMEOUT)
    finally:
        finish_world(procs)
    return dict(np.load(d / "torch.npz")), dict(np.load(d / "jax.npz"))


@pytest.fixture(scope="module")
def single():
    """The port's single-device results on the same inputs."""
    inp = _inputs()
    angles, cor, vcor = inp["angles"], inp["cor"], inp["vcor"]
    vol, sino = torch.as_tensor(inp["vol"]), torch.as_tensor(inp["sino"])
    out = {}
    saved = P._BACKEND
    try:
        for backend in ("pallas", "xla"):
            P.set_projector_backend(backend)
            pr = P.Projector(Geometry(N, NZ, angles, cor, N, os_number=OS))
            out[f"{backend}/fp"] = pr.fp(vol)
            out[f"{backend}/bp"] = pr.bp(sino)
            for k in range(OS):
                out[f"{backend}/fp_sub{k}"] = pr.fp_sub(vol, k)
                out[f"{backend}/bp_sub{k}"] = pr.bp_sub(pr.sino_subset(sino, k), k)
            pv = P.Projector(Geometry(N, NZ, angles, vcor, N))
            out[f"{backend}/vcor_fp"] = pv.fp(vol)
            out[f"{backend}/vcor_bp"] = pv.bp(sino)
            rd = RecToolsDIRCuPy(N, 0, NZ, 0.0, angles, N, device="cpu")
            out[f"{backend}/fbp"] = rd.FBP(sino.transpose(0, 1))
            if backend == "pallas":
                out["fourier_inv"] = rd.FOURIER_INV(sino)
            p1 = P.Projector(Geometry(N, 4, angles, cor, N))
            out[f"{backend}/slice1/fp"] = p1.fp(vol[:4])
            out[f"{backend}/slice1/bp"] = p1.bp(sino[:4])
    finally:
        P._BACKEND = saved
    return {k: v.numpy() for k, v in out.items()}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _hold(got, want, zonly: bool, reduced: bool):
    """Bit for bit, except a result summed over an angle group (1e-6 rel)."""
    assert got.shape == want.shape
    if zonly or not reduced:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= TOL_BP


OPS = ["fp", "bp"] + [f"{op}_sub{k}" for k in range(OS) for op in ("fp", "bp")]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_projector_matches_single_device(worlds, single, mesh, op, backend):
    """OS 4 with a per-angle CoR, both the two-pass pair and the Joseph
    pair (``set_projector_backend("xla")``)."""
    got = worlds[0][f"{backend}/{mesh[0]}x{mesh[1]}/{op}"]
    _hold(got, single[f"{backend}/{op}"], mesh[1] == 1, op.startswith("bp"))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("op", ["vcor_fp", "vcor_bp"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_vertical_cor_matches_single_device(worlds, single, mesh, op, backend):
    """[n, 2] CoR: the vertical shift crosses the slabs' edges, on a slab
    widened by its z-halo."""
    got = worlds[0][f"{backend}/{mesh[0]}x{mesh[1]}/{op}"]
    _hold(got, single[f"{backend}/{op}"], mesh[1] == 1, op.endswith("bp"))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_vertical_cor_moves_only_its_halo(worlds, mesh):
    """The shift's reach is ceil(2.0) + 1 = 3 slices: rank 0, the first
    slab, receives the 3 slices after it (from one slab or two); a z axis
    of one moves nothing."""
    moved = int(worlds[0][f"pallas/{mesh[0]}x{mesh[1]}/vcor_halo_bytes"])
    slice_bytes = NA * N * 4
    if mesh[0] == 1:
        assert moved == 0
    else:
        assert moved == 3 * slice_bytes


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("op", ["fp", "bp"])
def test_one_slice_slabs_match_single_device(worlds, single, op, backend):
    """nz = 4 over 4 z-shards: each rank runs the packed one-slice pair
    (K1p/K4p) where the unsharded volume runs K1/K4."""
    _hold(worlds[0][f"{backend}/slice1/{op}"], single[f"{backend}/slice1/{op}"], True, False)


@pytest.mark.parametrize("op", ["fp", "bp", "fp_sub0", "bp_sub0", "vcor_fp", "vcor_bp"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_two_pass_matches_jax_pallas(worlds, mesh, op):
    """Against the JAX package's ShardedProjector on its interpret-mode
    Pallas pair (mesh 2 x 2)."""
    got = worlds[0][f"pallas/{mesh[0]}x{mesh[1]}/{op}"]
    want = worlds[1][f"pallas/{op}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("op", OPS + ["vcor_fp", "vcor_bp"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_joseph_matches_jax_xla(worlds, mesh, op):
    """Against the JAX package's ShardedProjector on its XLA (Joseph)
    pair (mesh 2 x 2)."""
    got = worlds[0][f"xla/{mesh[0]}x{mesh[1]}/{op}"]
    want = worlds[1][f"xla/{op}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PIPE * np.abs(want).max())


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_fbp_matches_single_device(worlds, single, mesh, backend):
    got = worlds[0][f"{backend}/{mesh[0]}x{mesh[1]}/fbp"]
    _hold(got, single[f"{backend}/fbp"], mesh[1] == 1, True)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_fourier_inv_matches_single_device(worlds, single, mesh):
    """Each slab runs the whole USFFT pipeline: no collective at all.  Bit
    for bit, except where a slab holds one slice pair (mesh 4 x 1): on the
    CPU, ``torch.fft`` along dim -2 rounds a batch of one otherwise than
    the same transform inside a larger batch (the plain version of the F
    pass in the 2D inverse FFT), so there 1e-6 rel L2."""
    got = worlds[0][f"{mesh[0]}x{mesh[1]}/fourier_inv"]
    if NZ // mesh[0] == 2:
        assert _rel(got, single["fourier_inv"]) <= TOL_BP
    else:
        np.testing.assert_array_equal(got, single["fourier_inv"])


def test_cpu_fft_rounds_a_batch_of_one_otherwise():
    """Why FOURIER_INV on one slice pair is not bit-equal on the CPU."""
    x = torch.complex(*torch.randn(2, 4, 128, 128, generator=torch.Generator().manual_seed(0)))
    one = torch.fft.ifft(x[:1], dim=-2, norm="forward")
    assert not torch.equal(one, torch.fft.ifft(x, dim=-2, norm="forward")[:1])
    assert torch.equal(torch.fft.ifft(x[:2], dim=-2, norm="forward"),
                       torch.fft.ifft(x, dim=-2, norm="forward")[:2])


@pytest.mark.parametrize("method", ["fbp", "fourier_inv"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_direct_matches_jax_sharded_direct(worlds, mesh, method):
    """Against the JAX package's ShardedDirect (XLA projector and
    gridding, mesh 2 x 2); the port's FBP on its Joseph pair to match."""
    key = f"xla/{mesh[0]}x{mesh[1]}/fbp" if method == "fbp" else f"{mesh[0]}x{mesh[1]}/fourier_inv"
    want = worlds[1][method]
    np.testing.assert_allclose(worlds[0][key], want, rtol=0,
                               atol=TOL_PIPE * np.abs(want).max())


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_collective_bytes(worlds, mesh):
    """One fp and one bp: a z-only mesh moves nothing; a mesh that deals
    angles gathers the padded group blocks once per fp and all-reduces the
    volume slab once per bp; on the CPU nothing is staged."""
    n_z, n_a = mesh
    gather = worlds[0][f"stats/{n_z}x{n_a}/all_gather"]
    reduce = worlds[0][f"stats/{n_z}x{n_a}/all_reduce"]
    if n_a == 1:
        assert gather.tolist() == [0, 0, 0] and reduce.tolist() == [0, 0, 0]
        return
    angles = _geoms()[0]
    idx_x, idx_y = P._angle_partition(angles)
    width = sum(-(-len(i) // n_a) for i in (idx_x, idx_y))  # B_x + B_y
    nz = NZ // n_z
    assert gather.tolist() == [1, (n_a - 1) * nz * width * N * 4, 0]
    assert reduce.tolist() == [1, nz * N * N * 4, 0]


@pytest.mark.parametrize("halo", ["1_3", "5_0", "0_7"])
def test_z_halo_window(worlds, halo):
    """z_halo returns each slab's window of the whole volume, cut at its
    ends, also where the window spans several slabs, and the slices it
    added before the slab."""
    assert worlds[0][f"halo/{halo}"].tolist() == [1.0]
