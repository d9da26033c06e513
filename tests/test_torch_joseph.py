"""Port parity of the one-pass Joseph projector (``set_projector_backend
("xla")``) and of the gridding backend switch (``set_usfft_backend``):
tomobar_tpu_torch on the CPU against the JAX package's XLA path on the same
numpy inputs.

FP and BP within 1e-5 of max (float32 sums in another order); adjointness
within 1e-5 in float64 inner products of positive inputs (a random-signed
pair cancels in its inner product and measures the cancellation, not the
transpose); FOURIER_INV on the plain gridding within 2e-5 of max, as
``tests/test_torch_direct.py``.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomobar_tpu import RecToolsDIRCuPy as JaxDIR
from tomobar_tpu.geometry import Geometry as JaxGeometry
from tomobar_tpu.ops import projector as JP
from tomobar_tpu.ops import usfft as JU

from tomobar_tpu_torch import RecToolsDIRCuPy, _build
from tomobar_tpu_torch.convert import geometry_from_reference
from tomobar_tpu_torch.ops import projector as TP
from tomobar_tpu_torch.ops import usfft as TU
from tomobar_tpu_torch.ops import usfft_kernels as UK

torch.set_num_threads(1)

TOL = 1e-5
N, N_ANG = 32, 37


@pytest.fixture()
def joseph(monkeypatch):
    """Both packages on their Joseph pair; the backends come back after."""
    monkeypatch.setattr(JP, "_BACKEND", "auto")
    monkeypatch.setattr(TP, "_BACKEND", "auto")
    JP.set_projector_backend("xla")
    TP.set_projector_backend("xla")


def _geoms(nz=3, det=N, cor=0.0, n_ang=N_ANG, os_number=1):
    # angles over [0, 2 pi) with an offset: both driven groups, no tie
    angles = np.linspace(0.0, 2 * np.pi, n_ang, endpoint=False) + 0.123
    if cor == "vec":
        cor = 0.9 * np.sin(3.0 * angles)
    elif cor == "vertical":
        cor = np.stack([np.full(n_ang, 1.25), np.linspace(-1.0, 1.3, n_ang)], 1)
    jg = JaxGeometry(detectors_x=det, detectors_y=nz, angles=angles,
                     center_rot_offset=cor, recon_size=N, os_number=os_number)
    return jg, geometry_from_reference(jg)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


CASES = {
    "2d": dict(nz=None),
    "3d": dict(nz=3),
    "cor-3.5": dict(nz=3, cor=3.5),
    "cor-per-angle": dict(nz=2, cor="vec"),
    "det-40": dict(nz=3, det=40, cor=1.5),
    "det-27-2d": dict(nz=None, det=27, cor=-0.5),
    "vertical-cor": dict(nz=3, cor="vertical"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fp_bp_match_jax(joseph, case):
    jg, g = _geoms(**CASES[case])
    nz = CASES[case]["nz"]
    rng = np.random.default_rng(20)
    vol = rng.standard_normal((N, N) if nz is None else (nz, N, N)).astype(np.float32)
    want = JP.radon_fp(jnp.asarray(vol), jg)
    _build.reset_launch_counts()
    got = TP.radon_fp(torch.from_numpy(vol), g)
    _close(got, want)
    sino = rng.standard_normal(got.shape).astype(np.float32)
    _close(TP.radon_bp(torch.from_numpy(sino), g), JP.radon_bp(jnp.asarray(sino), jg))
    assert all(v == 0 for v in _build.launch_counts.values())


@pytest.mark.parametrize("driven", ["x", "y"])
def test_one_driven_group_matches_jax(joseph, driven):
    """Angles of one group only (|cos| >= |sin| or not)."""
    base = np.linspace(-0.6, 0.6, 15)
    angles = base if driven == "x" else base + np.pi / 2
    jg = JaxGeometry(detectors_x=N, detectors_y=2, angles=angles, center_rot_offset=0.7,
                     recon_size=N)
    g = geometry_from_reference(jg)
    rng = np.random.default_rng(21)
    vol = rng.standard_normal((2, N, N)).astype(np.float32)
    sino = rng.standard_normal((2, 15, N)).astype(np.float32)
    _close(TP.radon_fp(torch.from_numpy(vol), g), JP.radon_fp(jnp.asarray(vol), jg))
    _close(TP.radon_bp(torch.from_numpy(sino), g), JP.radon_bp(jnp.asarray(sino), jg))


def test_blocks_match_jax_and_one_block(joseph, monkeypatch):
    """The block budget lowered in both packages: FP in blocks of 3 rows
    (11 blocks, the last padded), BP in blocks of 2 angles (the last padded
    with cos 1.0); the port equals its one-block result to float rounding
    and the JAX package's blocked result."""
    jg, g = _geoms(nz=2, cor=1.5)
    rng = np.random.default_rng(22)
    vol = rng.standard_normal((2, N, N)).astype(np.float32)
    sino = rng.standard_normal((2, N_ANG, N)).astype(np.float32)
    one_fp = TP.radon_fp(torch.from_numpy(vol), g)
    one_bp = TP.radon_bp(torch.from_numpy(sino), g)
    n_x = int(np.sum(np.abs(np.cos(g.angles)) >= np.abs(np.sin(g.angles))))
    for mod in (JP, TP):
        monkeypatch.setattr(mod, "_BLOCK_BUDGET_ELEMS", 2 * n_x * N * 3)
    assert TP._pick_block(N, 2 * n_x * N) == 3
    got_fp = TP.radon_fp(torch.from_numpy(vol), g)
    _close(got_fp, JP.radon_fp(jnp.asarray(vol), jg))
    _close(got_fp, one_fp.numpy())
    for mod in (JP, TP):
        monkeypatch.setattr(mod, "_BLOCK_BUDGET_ELEMS", 2 * 2 * N * N)
    assert TP._pick_block(n_x, 2 * N * N) == 2
    got_bp = TP.radon_bp(torch.from_numpy(sino), g)
    _close(got_bp, JP.radon_bp(jnp.asarray(sino), jg))
    _close(got_bp, one_bp.numpy())


@pytest.mark.parametrize("case", ["2d", "3d", "cor-per-angle", "det-40", "vertical-cor"])
def test_adjointness(joseph, case):
    _, g = _geoms(**CASES[case])
    nz = CASES[case]["nz"]
    gen = torch.Generator().manual_seed(23)
    x = torch.rand((N, N) if nz is None else (nz, N, N), generator=gen)
    ax = TP.radon_fp(x, g)
    y = torch.rand(ax.shape, generator=gen)
    lhs = torch.sum(ax.double() * y.double())
    rhs = torch.sum(x.double() * TP.radon_bp(y, g).double())
    assert float(abs(lhs - rhs) / abs(lhs)) <= 1e-5


def test_os_subsets_and_projector_class(joseph):
    """``Projector.fp_sub``/``bp_sub`` on the Joseph pair against the JAX
    package's ``Projector``."""
    jg, g = _geoms(nz=2, os_number=4, n_ang=36)
    jp, tp = JP.Projector(jg), TP.Projector(g)
    rng = np.random.default_rng(24)
    vol = rng.standard_normal((2, N, N)).astype(np.float32)
    for sub in (0, 3):
        ax = tp.fp_sub(torch.from_numpy(vol), sub)
        _close(ax, jp.fp_sub(jnp.asarray(vol), sub))
        _close(tp.bp_sub(ax, sub), jp.bp_sub(jnp.asarray(ax.numpy()), sub))


def test_differs_from_two_pass_pair(monkeypatch):
    """The two pairs are different discrete operators, ~1-2% apart."""
    _, g = _geoms(nz=2)
    vol = torch.rand((2, N, N), generator=torch.Generator().manual_seed(25))
    monkeypatch.setattr(TP, "_BACKEND", "auto")
    two_pass = TP.radon_fp(vol, g)
    TP.set_projector_backend("xla")
    joseph_fp = TP.radon_fp(vol, g)
    rel = float(torch.linalg.vector_norm(joseph_fp - two_pass) / torch.linalg.vector_norm(two_pass))
    assert 1e-4 < rel < 0.05


def test_backend_names(monkeypatch):
    monkeypatch.setattr(TP, "_BACKEND", "auto")
    monkeypatch.setattr(TU, "_USFFT_BACKEND", "auto")
    for name in ("pallas", "xla", "auto"):
        TP.set_projector_backend(name)
        TU.set_usfft_backend(name)
        assert TP._BACKEND == TU._USFFT_BACKEND == name
    with pytest.raises(ValueError, match="unknown projector backend"):
        TP.set_projector_backend("astra")
    with pytest.raises(ValueError, match="unknown usfft backend"):
        TU.set_usfft_backend("cufft")
    assert TP._BACKEND == TU._USFFT_BACKEND == "auto"


def test_backends_read_the_environment():
    """``TOMOBAR_TPU_PROJECTOR`` and ``TOMOBAR_TPU_USFFT`` set the defaults,
    as in the JAX package."""
    env = dict(os.environ, TOMOBAR_TPU_PROJECTOR="xla", TOMOBAR_TPU_USFFT="pallas")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", "from tomobar_tpu_torch.ops import projector, usfft; "
         "print(projector._BACKEND, usfft._USFFT_BACKEND)"],
        env=env, cwd=root, capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    assert out == ["xla", "pallas"]


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_cpu_gridding_is_the_plain_scatter(monkeypatch, backend):
    """On the CPU every backend name grids with ``grid_plain``, once per
    call, and gives what the plain scatter gives."""
    monkeypatch.setattr(TU, "_USFFT_BACKEND", backend)
    rng = np.random.default_rng(26)
    n, theta = 128, -np.linspace(0.0, np.pi, 30, endpoint=False)
    re, im = (torch.from_numpy(rng.standard_normal((2, 30, n)).astype(np.float32)) for _ in range(2))
    plain = UK.grid_plain
    calls = []
    monkeypatch.setattr(UK, "grid_plain", lambda *a: calls.append(1) or plain(*a))
    got = TU.usfft_grid(re, im, n, theta)
    assert calls == [1]
    sre, sim = TU.fft_pairs(re, im)
    scale = TU._sign_vector(n, re.device) * (4.0 / n)
    for a, b in zip(got, plain(sre * scale, sim * scale, n, theta)):
        assert torch.equal(a, b)


def test_fourier_inv_on_the_plain_gridding_matches_jax(monkeypatch):
    """FOURIER_INV with ``set_usfft_backend("xla")`` in both packages."""
    monkeypatch.setattr(JU, "_USFFT_BACKEND", "auto")
    monkeypatch.setattr(TU, "_USFFT_BACKEND", "auto")
    JU.set_usfft_backend("xla")
    TU.set_usfft_backend("xla")
    n, nz, nproj = 128, 2, 45
    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    sino = np.random.default_rng(27).uniform(0, 1, (nz, nproj, n)).astype(np.float32)
    want = JaxDIR(n, 0, nz, 0.0, angles, n).FOURIER_INV(jnp.asarray(sino))
    _close(RecToolsDIRCuPy(n, 0, nz, 0.0, angles, n, device="cpu").FOURIER_INV(sino), want, 2e-5)
