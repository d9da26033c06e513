"""Port parity: the PyTorch projector (tomobar_tpu_torch) against the JAX
package's interpret-mode Pallas projector, stage by stage and whole.

Inputs are made from a numpy seed and handed to both packages.  The Pallas
stages run in interpret mode (``projector_pallas._INTERPRET``), exactly as
``tests/test_pallas_kernels.py`` runs them.  The tolerance 5e-5 * max|ref|
covers the Pallas kernels' bf16x3 matmul products (~2^-17 relative,
``projector_pallas._dot_b3``) against the port's plain fp32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomobar_tpu.geometry import Geometry as JaxGeometry
from tomobar_tpu.ops import projector as jax_projector
from tomobar_tpu.ops import projector_pallas as PP

from tomobar_tpu_torch import _build
from tomobar_tpu_torch.convert import geometry_from_reference, tensor_from_reference
from tomobar_tpu_torch.ops import projector_kernels as K
from tomobar_tpu_torch.ops.projector import (
    Projector,
    _angle_partition,
    forward_project,
    radon_bp,
    radon_fp,
)

torch.set_num_threads(1)

N = 64
NZ = 2
N_ANG = 16
TOL = 5e-5


@pytest.fixture()
def pallas_interpret():
    PP._INTERPRET[0] = True
    yield
    PP._INTERPRET[0] = False


def _jax_geom(cor=0.0, n_ang=N_ANG, nz=NZ, os_number=1):
    angles = np.linspace(0.0, np.pi, n_ang, endpoint=False)
    return JaxGeometry(
        detectors_x=N, detectors_y=nz, angles=angles, center_rot_offset=cor,
        recon_size=N, os_number=os_number,
    )


def _close(port, ref, tol=TOL):
    port = np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _group(geom, driven: str):
    """Per-angle inputs of one driven group, as radon_fp_pallas builds them."""
    cos_v, sin_v, idx_x, idx_y = PP._partition(geom.angles)
    cor = geom.cor_horizontal
    if driven == "x":
        return cos_v[idx_x], sin_v[idx_x], cor[idx_x], False
    return sin_v[idx_y], cos_v[idx_y], cor[idx_y], True


# ---------------------------------------------------------------------------
# (a) each plain stage vs its interpret-mode Pallas stage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driven", ["x", "y"])
def test_stages_match_pallas(pallas_interpret, driven):
    geom = _jax_geom(cor=3.5)
    c, s, cor, swap = _group(geom, driven)
    jprm = PP._driven_params(c, s, cor, N, N, N, packed=False, ab=PP._AB_FP)
    prm = K.driven_params(c, s, cor, N, N, N)
    assert (prm.U0, prm.NXP, prm.LU) == (jprm.U0, jprm.NXP, jprm.LU)
    A = prm.A
    np.testing.assert_array_equal(prm.alpha, jprm.alpha[:A])
    np.testing.assert_array_equal(prm.beta, jprm.beta[:A])
    np.testing.assert_array_equal(prm.gamma, jprm.gamma[:A])
    alpha, beta, gamma = (torch.from_numpy(v) for v in (prm.alpha, prm.beta, prm.gamma))

    rng = np.random.default_rng(11)
    vol = rng.standard_normal((NZ, N, N)).astype(np.float32)
    NXR = 128
    # K1: the Pallas stage takes vol_t (rows, nz, NXR), rows along the
    # driven axis; the port takes the canonical volume and a swap flag
    vol_rows = np.swapaxes(vol, 1, 2) if swap else vol
    vol_t = np.pad(np.swapaxes(vol_rows, 0, 1), ((0, 0), (0, 0), (0, NXR - N)))
    s_ref = np.array(PP._fp_shear_stage(jnp.asarray(vol_t), jprm))[:A]
    s = K.shear_fp(torch.from_numpy(vol), beta, prm.U0, prm.LU, swap)
    _close(s, s_ref)

    # K2 on the same s
    p_ref = np.asarray(PP._fp_resample_stage(jnp.asarray(np.pad(
        s_ref, ((0, jprm.alpha.shape[0] - A), (0, 0), (0, 0))
    )), jprm))[:A, :, :N]
    p = K.resample_fp(torch.from_numpy(s_ref), alpha, gamma, prm.U0, N)
    _close(p, np.swapaxes(p_ref, 0, 1))

    # K3 on a random sinogram block
    sino = rng.standard_normal((NZ, A, N)).astype(np.float32)
    TP = 128 + PP._PW
    p_in = np.pad(
        np.swapaxes(sino, 0, 1),
        ((0, jprm.alpha.shape[0] - A), (0, 0), (0, TP - N)),
    )
    q_ref = np.array(PP._bp_resample_stage(jnp.asarray(p_in), jprm))[:A]
    q = K.resample_bp(torch.from_numpy(sino), alpha, gamma, prm.U0, prm.LU)
    _close(q, q_ref)

    # K4 on the same q
    q_pad = np.pad(q_ref, ((0, jprm.alpha.shape[0] - A), (0, 0), (0, 0)))
    v_t = np.asarray(PP._bp_unshear_stage(jnp.asarray(q_pad), jprm, N, N))[:, :, :N]
    v_ref = np.swapaxes(v_t, 0, 1)  # (nz, rows, cols)
    if swap:
        v_ref = np.swapaxes(v_ref, 1, 2)
    v = K.unshear_bp(torch.from_numpy(q_ref), beta, prm.U0, N, N, swap)
    _close(v, v_ref)


# ---------------------------------------------------------------------------
# (b) the full operator vs radon_fp_pallas / radon_bp_pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cor", [0.0, 3.5, "per_angle"])
def test_full_operator_matches_pallas(pallas_interpret, cor):
    if cor == "per_angle":
        cor = np.linspace(-2.0, 2.0, N_ANG)
    jg = _jax_geom(cor=cor)
    g = geometry_from_reference(jg)
    rng = np.random.default_rng(12)
    vol = rng.standard_normal((NZ, N, N)).astype(np.float32)
    sino = rng.standard_normal((NZ, N_ANG, N)).astype(np.float32)
    _close(
        radon_fp(tensor_from_reference(vol, "volume"), g),
        PP.radon_fp_pallas(jnp.asarray(vol), jg),
    )
    _close(
        radon_bp(tensor_from_reference(sino, "sinogram"), g),
        PP.radon_bp_pallas(jnp.asarray(sino), jg),
    )


def test_vertical_cor_matches_canonical_pallas(pallas_interpret, monkeypatch):
    """(n_angles, 2) CoR: the z-shift wraps the kernels on the canonical
    path, as JAX's radon_fp/radon_bp apply it on the Pallas backend."""
    monkeypatch.setattr(jax_projector, "_BACKEND", "pallas")
    cor = np.stack(
        [np.linspace(-1.5, 1.5, N_ANG), np.linspace(-0.7, 1.3, N_ANG)], axis=1
    )
    jg = _jax_geom(cor=cor, nz=3)
    g = geometry_from_reference(jg)
    rng = np.random.default_rng(13)
    vol = rng.standard_normal((3, N, N)).astype(np.float32)
    sino = rng.standard_normal((3, N_ANG, N)).astype(np.float32)
    _close(
        radon_fp(torch.from_numpy(vol), g),
        jax_projector.radon_fp(jnp.asarray(vol), jg),
    )
    _close(
        radon_bp(torch.from_numpy(sino), g),
        jax_projector.radon_bp(jnp.asarray(sino), jg),
    )


# ---------------------------------------------------------------------------
# (c)-(e) properties of the port's pair (plain versions, CPU)
# ---------------------------------------------------------------------------


def _port_geom(cor=0.0, n_ang=45, nz=NZ, os_number=1):
    return geometry_from_reference(_jax_geom(cor, n_ang, nz, os_number))


@pytest.mark.parametrize(
    "cor", [0.0, 3.5, "per_angle", "vertical"], ids=["0", "3.5", "vec", "2d"]
)
def test_adjointness(cor):
    n_ang = 45
    if cor == "per_angle":
        cor = np.linspace(-2.0, 2.0, n_ang)
    elif cor == "vertical":
        cor = np.stack([np.full(n_ang, 1.25), np.linspace(-1.0, 1.0, n_ang)], 1)
    g = _port_geom(cor=cor, n_ang=n_ang)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((NZ, N, N), generator=gen)
    y = torch.randn((NZ, n_ang, N), generator=gen)
    lhs = torch.sum(radon_fp(x, g).double() * y.double())
    rhs = torch.sum(x.double() * radon_bp(y, g).double())
    assert float(abs(lhs - rhs) / abs(lhs)) <= 1e-5


def test_os_subsets_tile_full_fp():
    g = _port_geom(n_ang=44, os_number=4)
    P = Projector(g)
    vol = torch.randn((NZ, N, N), generator=torch.Generator().manual_seed(4))
    full = P.fp(vol)
    for s, ind in enumerate(P.subset_indices):
        sub = P.fp_sub(vol, s)
        ref = full[:, torch.as_tensor(ind)]
        assert float(torch.linalg.vector_norm(sub - ref)) <= 1e-5 * float(
            torch.linalg.vector_norm(ref)
        )


def test_autograd_fp_backward_is_bp():
    g = _port_geom(cor=1.5, n_ang=20)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((NZ, N, N), generator=gen, requires_grad=True)
    y = torch.randn((NZ, 20, N), generator=gen)
    (forward_project(x, g) * y).sum().backward()
    ref = radon_bp(y, g)
    assert float(torch.linalg.vector_norm(x.grad - ref)) <= 1e-6 * float(
        torch.linalg.vector_norm(ref)
    )


def test_angle_partition_tie_is_x_driven():
    angles = np.array([0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4])
    idx_x, idx_y = _angle_partition(angles)
    ref_x, ref_y = jax_projector._angle_partition(angles)
    np.testing.assert_array_equal(idx_x, ref_x)
    np.testing.assert_array_equal(idx_y, ref_y)
    assert 1 in idx_x  # |cos| == |sin| at pi/4 (to rounding) goes x-driven


# ---------------------------------------------------------------------------
# (k) CPU tensors take the plain versions; no kernel launch, no build
# ---------------------------------------------------------------------------


def test_cpu_tensors_launch_no_kernel():
    _build.reset_launch_counts()
    g = _port_geom(cor=0.5, n_ang=12)
    vol = torch.randn((NZ, N, N), generator=torch.Generator().manual_seed(6))
    radon_bp(radon_fp(vol, g), g)
    assert all(v == 0 for v in _build.launch_counts.values())


# ---------------------------------------------------------------------------
# (f) z-chunks: any nz in bounded memory, bit for bit the unchunked result
# ---------------------------------------------------------------------------


def _vcor(n_ang):
    return np.stack(
        [np.linspace(-1.5, 1.5, n_ang), np.linspace(-0.7, 1.3, n_ang)], axis=1
    )


@pytest.mark.parametrize("limit", ["bytes", "elements"])
@pytest.mark.parametrize("vertical", [False, True], ids=["no-vcor", "vcor"])
@pytest.mark.parametrize("op", ["fp", "bp"])
def test_z_chunks_equal_unchunked(monkeypatch, op, vertical, limit):
    """FP and BP with the byte budget or the element cap lowered, so that a
    7-slice stack goes through in chunks of 2 (and a last one of 1), equal
    the single-chunk result bit for bit, with and without a vertical CoR
    (whose z shift runs on the whole sinogram, in runs of angles)."""
    from tomobar_tpu_torch.ops import projector as P

    nz, n_ang = 7, 18
    g = _port_geom(cor=_vcor(n_ang) if vertical else 1.5, n_ang=n_ang, nz=nz)
    rng = np.random.default_rng(40)
    x = torch.from_numpy(
        rng.standard_normal((nz, N, N) if op == "fp" else (nz, n_ang, N)).astype(np.float32)
    )
    run = radon_fp if op == "fp" else radon_bp
    whole = run(x, g)
    plan = P._Plan(g)
    groups = plan.groups(N, N, x.device)
    lines = max(gr.prm.A * gr.prm.LU for gr in groups)
    assert plan._z_chunks(nz, groups, N * N, n_ang * N) == [(0, nz)]
    if limit == "bytes":
        monkeypatch.setattr(P, "CHUNK_BYTES", 4 * lines * 2)
    else:
        monkeypatch.setattr(P, "MAX_ELEMENTS", 2 * lines + 1)
    assert plan._z_chunks(nz, groups, N * N, n_ang * N) == [(0, 2), (2, 4), (4, 6), (6, 7)]
    assert torch.equal(run(x, g), whole)


def test_z_chunks_match_pallas(pallas_interpret, monkeypatch):
    """The chunked port against the JAX package's interpret-mode Pallas
    projector (which cuts z into chunks of its own)."""
    from tomobar_tpu_torch.ops import projector as P

    nz = 5
    jg = _jax_geom(cor=2.0, nz=nz)
    g = geometry_from_reference(jg)
    monkeypatch.setattr(P, "CHUNK_BYTES", 1)  # one slice per chunk
    assert len(P._Plan(g)._z_chunks(nz, P._Plan(g).groups(N, N, torch.device("cpu")))) == nz
    rng = np.random.default_rng(41)
    vol = rng.standard_normal((nz, N, N)).astype(np.float32)
    sino = rng.standard_normal((nz, N_ANG, N)).astype(np.float32)
    _close(radon_fp(torch.from_numpy(vol), g), PP.radon_fp_pallas(jnp.asarray(vol), jg))
    _close(radon_bp(torch.from_numpy(sino), g), PP.radon_bp_pallas(jnp.asarray(sino), jg))


def test_no_element_cap_error_from_the_public_pair(monkeypatch):
    """With the element cap far below the stack's size the public pair still
    runs (one slice per chunk): the cap is never an error of an entry point."""
    from tomobar_tpu_torch.ops import projector as P

    g = _port_geom(nz=3, n_ang=8)
    monkeypatch.setattr(P, "MAX_ELEMENTS", 10)
    vol = torch.ones((3, N, N))
    assert radon_bp(radon_fp(vol, g), g).shape == (3, N, N)


def test_unshear_bp_overwrites_or_adds():
    """``accumulate=False`` writes over ``out`` (the first group of a
    chunk), the default adds into it (the second)."""
    from tomobar_tpu_torch.ops.projector import _Plan

    g = _Plan(_port_geom()).groups(N, N, torch.device("cpu"))[0]
    rng = np.random.default_rng(42)
    q = torch.from_numpy(rng.standard_normal((g.prm.A, NZ, g.prm.LU)).astype(np.float32))
    new = K.unshear_bp(q, g.beta, g.prm.U0, N, N)
    out = torch.full((NZ, N, N), 3.0)
    assert K.unshear_bp(q, g.beta, g.prm.U0, N, N, out=out, accumulate=False) is out
    assert torch.equal(out, new)
    K.unshear_bp(q, g.beta, g.prm.U0, N, N, out=out)
    assert torch.equal(out, new + new)


# ---------------------------------------------------------------------------
# K3 gathers the group's angles itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nz", [1, 3])
@pytest.mark.parametrize("driven", ["x", "y"])
def test_resample_bp_index_equals_the_copied_rows(driven, nz):
    """``resample_bp(p, ..., index=)`` on the whole sinogram equals
    ``resample_bp(p[:, index], ...)`` bit for bit, and so does the plain
    version; the group's angles lie scattered in the sinogram (a shuffled
    scan, so the index is not sorted)."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import _Plan

    rng = np.random.default_rng(50 + nz)
    angles = rng.permutation(np.linspace(0.0, np.pi, 30, endpoint=False))
    geom = Geometry(N, nz, angles, 1.5, N)
    g = [gr for gr in _Plan(geom).groups(N, N, torch.device("cpu")) if gr.swap == (driven == "y")][0]
    assert not bool((g.idx[1:] > g.idx[:-1]).all()) or g.idx.numel() < 30
    sino = torch.from_numpy(rng.standard_normal((nz, 30, N)).astype(np.float32))
    args = (g.alpha, g.gamma, g.prm.U0, g.prm.LU)
    ref = K.resample_bp(sino[:, g.idx].contiguous(), *args)
    assert ref.shape == (g.prm.A, nz, g.prm.LU)
    assert torch.equal(K.resample_bp(sino, *args, index=g.idx), ref)
    assert torch.equal(K.resample_bp_plain(sino, *args, index=g.idx), ref)
    assert torch.equal(K.resample_bp_plain(sino[:, g.idx], *args), ref)


@pytest.mark.parametrize("bad", [[0, 5, 30], [0, -1, 5], [-31, 2, 3]],
                         ids=["past-the-end", "minus-one", "far-below"])
def test_resample_bp_refuses_an_index_outside_the_sinogram(bad):
    """An ``index`` entry outside [0, n_angles) raises: the kernel reads
    row ``index[a]`` as it stands (no counting from the end), so neither the
    wrapper nor the plain version takes a negative entry for a valid row."""
    rng = np.random.default_rng(70)
    sino = torch.from_numpy(rng.standard_normal((2, 30, N)).astype(np.float32))
    alpha = torch.full((3,), 1.25)
    gamma = torch.zeros(3)
    index = torch.tensor(bad)
    for fn in (K.resample_bp, K.resample_bp_plain):
        with pytest.raises(IndexError, match=r"K3: index must lie in \[0, 30\)"):
            fn(sino, alpha, gamma, 0, 2 * N, index=index)
    ok = torch.tensor([0, 29, 5])
    assert torch.equal(K.resample_bp(sino, alpha, gamma, 0, 2 * N, index=ok),
                       K.resample_bp_plain(sino[:, ok], alpha, gamma, 0, 2 * N))


def test_resample_bp_kernel_traps_on_an_index_outside_the_sinogram():
    """The CUDA kernel checks the row it is about to read and fails its
    launch on one outside [0, n_rows), before the address is formed."""
    from pathlib import Path

    import tomobar_tpu_torch

    src = (Path(tomobar_tpu_torch.__file__).parent / "csrc" / "projector.cu").read_text()
    body = src[src.index("resample_bp_kernel(const float*"):src.index("// K4: vol[z, Y, X]")]
    guard = body.index("if (row < 0 || row >= n_rows) __trap();")
    assert body.index("index[a]") < guard < body.index("* n_rows + row)")


@pytest.mark.parametrize("nz", [1, 4], ids=["packed-one-slice", "four-slices"])
def test_bp_core_equals_the_copy_then_resample_path(nz):
    """``_bp_core`` hands K3 the whole sinogram and each group's ``idx``; the
    result equals, bit for bit, what it gave when it first copied each group's
    angles out (``part[:, g.idx]``) and resampled the copy."""
    from tomobar_tpu_torch.ops.projector import _Plan

    g = _port_geom(cor=2.5, n_ang=44, nz=nz)
    plan = _Plan(g)
    groups = plan.groups(N, N, torch.device("cpu"), nz == 1)
    assert len(groups) == 2 and all(gr.prm.packed == (nz == 1) for gr in groups)
    rng = np.random.default_rng(60 + nz)
    sino = torch.from_numpy(rng.standard_normal((nz, 44, N)).astype(np.float32))
    before = torch.empty((nz, N, N))
    for k, gr in enumerate(groups):
        q = K.resample_bp(sino[:, gr.idx], gr.alpha, gr.gamma, gr.prm.U0, gr.prm.LU)
        if gr.prm.packed:
            K.unshear_bp_packed(q, gr.beta, gr.prm.U0, N, gr.swap, out=before, accumulate=k > 0)
        else:
            K.unshear_bp(q, gr.beta, gr.prm.U0, N, N, gr.swap, out=before, accumulate=k > 0)
    assert torch.equal(plan._bp_core(sino), before)
    assert torch.equal(radon_bp(sino[0] if nz == 1 else sino, g),
                       before[0] if nz == 1 else before)
