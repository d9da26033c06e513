"""Port parity of the 2D path: the packed nz = 1 projector pair K1p/K4p,
2D ``FORWPROJ``/``BACKPROJ``/``FBP`` and 2D FISTA of tomobar_tpu_torch on
the CPU against the JAX package on its interpret-mode Pallas projector.

The Pallas side runs the packed kernels wherever the JAX package does (one
slice, driven rows a multiple of 8), and K1/K4 elsewhere.  Tolerances:
5e-5 of max for one operator application (the Pallas bf16x3 products, as
``tests/test_torch_projector.py``), rel L2 2e-4 for the direct methods
and FISTA (those errors compounded, as ``tests/test_torch_slice.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import shepp_logan_slice
from tomobar_tpu import RecToolsDIR as JaxDIR
from tomobar_tpu import RecToolsIRCuPy as JaxIR
from tomobar_tpu.geometry import Geometry as JaxGeometry
from tomobar_tpu.ops import projector as jax_projector
from tomobar_tpu.ops import projector_pallas as PP

from tomobar_tpu_torch import RecToolsDIR, RecToolsIRCuPy, _build
from tomobar_tpu_torch.convert import geometry_from_reference
from tomobar_tpu_torch.ops import projector_kernels as K
from tomobar_tpu_torch.ops.projector import Projector, radon_bp, radon_fp

torch.set_num_threads(1)

N, N_ANG = 64, 24
TOL = 5e-5
TOL_REL = 2e-4


@pytest.fixture()
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jax_projector, "_BACKEND", "pallas")
    PP._INTERPRET[0] = True
    yield
    PP._INTERPRET[0] = False


@pytest.fixture()
def pallas_interpret():
    PP._INTERPRET[0] = True
    yield
    PP._INTERPRET[0] = False


def _angles(n_ang=N_ANG):
    return np.linspace(0.0, np.pi, n_ang, endpoint=False)


def _cor(kind, n_ang=N_ANG):
    return 2.0 * np.sin(3.0 * _angles(n_ang)) if kind == "vec" else kind


def _jax_geom(n=N, cor=0.0, n_ang=N_ANG):
    return JaxGeometry(
        detectors_x=n, detectors_y=1, angles=_angles(n_ang),
        center_rot_offset=cor, recon_size=n,
    )


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _rel_l2(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# K1p / K4p plain versions against the interpret-mode Pallas stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cor", [3.5, "vec"])
@pytest.mark.parametrize("driven", ["x", "y"])
def test_packed_stages_match_pallas(pallas_interpret, driven, cor):
    geom = _jax_geom(cor=_cor(cor))
    cos_v, sin_v, idx_x, idx_y = PP._partition(geom.angles)
    idx, c, s, swap = (
        (idx_x, cos_v, sin_v, False) if driven == "x" else (idx_y, sin_v, cos_v, True)
    )
    corv = geom.cor_horizontal[idx]
    jprm = PP._driven_params(c[idx], s[idx], corv, N, N, N, packed=True, ab=PP._AB)
    prm = K.driven_params(c[idx], s[idx], corv, N, N, N, packed=True)
    assert prm.packed and jprm.packed
    assert (prm.U0, prm.NXP, prm.LU) == (jprm.U0, jprm.NXP, jprm.LU)
    assert prm.LU == K.driven_params(c[idx], s[idx], corv, N, N, N).LU + 128
    A = prm.A
    beta = torch.from_numpy(prm.beta)
    rng = np.random.default_rng(21)

    # K1p: the Pallas stage takes vol_t (rows, 1, NXR) with the driven rows
    # first; the port takes the (transposed, for y) slice as (1, rows, cols)
    vol = rng.standard_normal((N, N)).astype(np.float32)
    rows = vol.T.copy() if swap else vol
    vol_t = np.pad(rows[:, None, :], ((0, 0), (0, 0), (0, 128 - N)))
    s_ref = np.asarray(PP._fp_shear_stage(jnp.asarray(vol_t), jprm))[:A]
    _close(K.shear_fp_packed(torch.from_numpy(rows)[None], beta, prm.U0, prm.LU), s_ref)

    # K4p on a random q
    q = rng.standard_normal((A, 1, prm.LU)).astype(np.float32)
    q_pad = np.pad(q, ((0, jprm.alpha.shape[0] - A), (0, 0), (0, 0)))
    v_t = np.asarray(PP._bp_unshear_stage(jnp.asarray(q_pad), jprm, N, N))
    v_ref = v_t[:, 0, :N]
    if swap:
        v_ref = v_ref.T
    v = K.unshear_bp_packed(torch.from_numpy(q), beta, prm.U0, N, swap)
    _close(v, v_ref[None])


def test_packed_wrappers_are_the_plain_sums_on_the_cpu():
    """On CPU tensors the packed wrappers are K1/K4's sums at nz = 1, added
    into ``out`` where given (a slice this small takes K1p's rows in one
    run, which is K1's sum bit for bit)."""
    geom = geometry_from_reference(_jax_geom(cor=1.5))
    gen = torch.Generator().manual_seed(22)
    vol = torch.randn((1, N, N), generator=gen)
    for g in Projector(geom)._plan.groups(N, N, torch.device("cpu"), True):
        rows = vol.transpose(1, 2).contiguous() if g.swap else vol
        s = K.shear_fp_packed(rows, g.beta, g.prm.U0, g.prm.LU)
        assert torch.equal(s, K.shear_fp(vol, g.beta, g.prm.U0, g.prm.LU, g.swap))
        q = torch.randn((g.prm.A, 1, g.prm.LU), generator=gen)
        base = torch.randn((1, N, N), generator=gen)
        got = K.unshear_bp_packed(q, g.beta, g.prm.U0, N, g.swap, out=base.clone())
        want = K.unshear_bp(q, g.beta, g.prm.U0, N, N, g.swap) + base
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the 2D operator: routes, parity with radon_*_pallas, adjointness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,nz,packed", [(64, 1, True), (60, 1, False), (64, 2, False)]
)
def test_packed_route_follows_the_jax_conditions(n, nz, packed):
    """K1p/K4p run for one slice whose size is a multiple of 8, K1/K4
    otherwise (``radon_fp_pallas``/``radon_bp_pallas``)."""
    g = geometry_from_reference(_jax_geom(n=n))
    groups = Projector(g)._plan.groups(n, n, torch.device("cpu"), nz == 1)
    assert len(groups) == 2
    assert all(gr.prm.packed == packed for gr in groups)


@pytest.mark.parametrize("n,cor", [(64, 0.0), (64, "vec"), (60, 2.5)])
def test_2d_operator_matches_pallas(pallas_interpret, n, cor):
    jg = _jax_geom(n=n, cor=_cor(cor))
    g = geometry_from_reference(jg)
    rng = np.random.default_rng(23)
    vol = rng.standard_normal((n, n)).astype(np.float32)
    sino = rng.standard_normal((N_ANG, n)).astype(np.float32)
    _close(radon_fp(torch.from_numpy(vol), g), PP.radon_fp_pallas(jnp.asarray(vol), jg))
    _close(radon_bp(torch.from_numpy(sino), g), PP.radon_bp_pallas(jnp.asarray(sino), jg))


@pytest.mark.parametrize("n,cor", [(64, 3.5), (64, "vec"), (60, 0.0)])
def test_2d_adjointness(n, cor):
    n_ang = 45
    g = geometry_from_reference(_jax_geom(n=n, cor=_cor(cor, n_ang), n_ang=n_ang))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((n, n), generator=gen)
    y = torch.randn((n_ang, n), generator=gen)
    lhs = torch.sum(radon_fp(x, g).double() * y.double())
    rhs = torch.sum(x.double() * radon_bp(y, g).double())
    assert float(abs(lhs - rhs) / abs(lhs)) <= 1e-5


# ---------------------------------------------------------------------------
# 2D RecToolsDIR and 2D FISTA against the JAX package
# ---------------------------------------------------------------------------


def _phantom_sino(n=N, n_ang=N_ANG, cor=0.0):
    ph = shepp_logan_slice(n)
    g = geometry_from_reference(_jax_geom(n=n, cor=cor, n_ang=n_ang))
    return ph, radon_fp(torch.from_numpy(ph), g).numpy()


def test_forwproj_backproj_2d_match_jax(jax_pallas):
    ph, sino = _phantom_sino(cor=1.5)
    jrt = JaxDIR(N, 0, None, 1.5, _angles(), N)
    prt = RecToolsDIR(N, 0, None, 1.5, _angles(), N, device="cpu")
    got = prt.FORWPROJ(ph)
    assert isinstance(got, np.ndarray) and got.shape == (N_ANG, N)
    assert _rel_l2(got, jrt.FORWPROJ(jnp.asarray(ph))) <= TOL_REL
    order = ["detX", "angles"]
    assert _rel_l2(
        prt.FORWPROJ(ph, data_axes_labels_order=order),
        jrt.FORWPROJ(jnp.asarray(ph), data_axes_labels_order=order),
    ) <= TOL_REL
    assert _rel_l2(
        prt.BACKPROJ(sino.T, data_axes_labels_order=order),
        jrt.BACKPROJ(jnp.asarray(sino.T), data_axes_labels_order=order),
    ) <= TOL_REL


@pytest.mark.parametrize(
    "kwargs",
    [
        {},  # sinc filter, the 2D default cutoff 1.1
        {"filter_type": "shepp-logan", "data_axes_labels_order": ["detX", "angles"]},
    ],
    ids=["sinc", "shepp-logan"],
)
def test_fbp_2d_matches_jax(jax_pallas, kwargs):
    _, sino = _phantom_sino(cor=-1.0)
    data = sino.T.copy() if "data_axes_labels_order" in kwargs else sino
    want = JaxDIR(N, 0, None, -1.0, _angles(), N).FBP(jnp.asarray(data), **kwargs)
    got = RecToolsDIR(N, 0, None, -1.0, _angles(), N, device="cpu").FBP(data, **kwargs)
    assert got.shape == (N, N)
    assert _rel_l2(got, want) <= TOL_REL


def test_fbp_2d_default_cutoff_is_1_1():
    _, sino = _phantom_sino()
    rt = RecToolsDIR(N, 0, None, 0.0, _angles(), N, device="cpu")
    np.testing.assert_array_equal(rt.FBP(sino), rt.FBP(sino, cutoff_freq=1.1))
    assert not np.array_equal(rt.FBP(sino), rt.FBP(sino, cutoff_freq=0.35))


def test_fista_2d_matches_jax(jax_pallas):
    """BASELINE config 2's solver at a small size: 2D FISTA, OS, LS,
    non-negativity, PD-TV."""
    n_ang, os_n = 30, 3
    ph, sino = _phantom_sino(n_ang=n_ang)
    sino = (sino * np.random.default_rng(25).uniform(0.97, 1.03, sino.shape)).astype(
        np.float32
    )
    lc = 620.0  # the power method gives 613.5 here
    alg = {"iterations": 3, "nonnegativity": True, "lipschitz_const": lc}
    reg = {"method": "PD_TV", "regul_param": 2e-3, "iterations": 10}
    want = np.asarray(
        JaxIR(N, 0, None, 0.0, _angles(n_ang), N, OS_number=os_n).FISTA(
            {"projection_data": jnp.asarray(sino)}, dict(alg), dict(reg)
        )
    )
    _build.reset_launch_counts()
    got = RecToolsIRCuPy(
        N, 0, None, 0.0, _angles(n_ang), N, OS_number=os_n, device="cpu"
    ).FISTA({"projection_data": sino}, dict(alg), dict(reg))
    assert all(v == 0 for v in _build.launch_counts.values())
    assert got.shape == want.shape == (1, N, N)
    assert _rel_l2(got, want) <= TOL_REL
    # and it reconstructs: 3 iterations from zero get well inside the
    # zero start's distance to the phantom (0.587 of it here)
    assert np.linalg.norm(got.numpy()[0] - ph) < 0.7 * np.linalg.norm(ph)


def test_2d_cpu_tensors_launch_no_kernel():
    _build.reset_launch_counts()
    _, sino = _phantom_sino()
    rt = RecToolsDIR(N, 0, None, 0.0, _angles(), N, device="cpu")
    rt.BACKPROJ(rt.FORWPROJ(rt.FBP(sino)))
    assert all(v == 0 for v in _build.launch_counts.values())
    assert {"K1p", "K4p"} <= set(_build.launch_counts)
