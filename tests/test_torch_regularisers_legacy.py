"""Port parity of the legacy regulariser family: FGP_TV, SB_TV, LLT_ROF,
TGV, NDF, Diff4th, WAVELET_SHRINK, patch_select and NLTV of
tomobar_tpu_torch on the CPU against ``tomobar_tpu.regularisers_legacy``
on the same numpy inputs, and every method string of ``prox_regul``
against the direct call.

Tolerance max|port - JAX| <= 1e-5 max|JAX| (float32 sums in another
order).  ``patch_select``'s neighbour tables are held to exact equality
and its weights to 1e-6; see ``test_patch_select_matches_jax`` for the one
kind of entry where the tables may differ.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import shepp_logan_slice
import tomobar_tpu.regularisers_legacy as JL
from tomobar_tpu.regularisers import prox_regul as jax_prox_regul

import tomobar_tpu_torch.regularisers_legacy as TL
from tomobar_tpu_torch import _build
from tomobar_tpu_torch.regularisers import PD_TV, ROF_TV, prox_regul

torch.set_num_threads(1)

TOL = 1e-5
SHAPES = {"2d": (48, 40), "3d": (5, 32, 36), "squeezed": (1, 40, 36)}

# name -> (function name, args after the data)
CASES = {
    "FGP_TV-iso": ("FGP_TV", (0.05, 30, 0, 0)),
    "FGP_TV-iso-nonneg": ("FGP_TV", (0.05, 30, 0, 1)),
    "FGP_TV-aniso": ("FGP_TV", (0.05, 30, 1, 0)),
    "FGP_TV-aniso-nonneg": ("FGP_TV", (0.05, 30, 1, 1)),
    "SB_TV-iso": ("SB_TV", (0.05, 30, 0)),
    "SB_TV-aniso": ("SB_TV", (0.05, 30, 1)),
    "LLT_ROF": ("LLT_ROF", (0.05, 0.02, 40, 0.002)),
    "TGV": ("TGV", (0.05, 1.0, 2.0, 30, 12.0)),
    "NDF-huber": ("NDF", (0.05, 0.3, 30, 0.02, 1)),
    "NDF-rational": ("NDF", (0.05, 0.3, 30, 0.02, 2)),
    "NDF-exp": ("NDF", (0.05, 0.3, 30, 0.02, 3)),
    "Diff4th": ("Diff4th", (0.05, 0.3, 50, 0.001)),
}


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _noisy(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dims", list(SHAPES))
@pytest.mark.parametrize("case", list(CASES))
def test_legacy_operator_matches_jax(case, dims):
    name, args = CASES[case]
    x = _noisy(SHAPES[dims], 60)
    want = getattr(JL, name)(jnp.asarray(x), *args)
    _close(getattr(TL, name)(torch.from_numpy(x), *args), want)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize(
    "shape",
    [(48, 40), (47, 39), (5, 32, 36), (5, 33, 35), (1, 40, 36), (3, 1, 21)],
    ids=["even-2d", "odd-2d", "even-3d", "odd-3d", "singleton-first", "singleton-middle"],
)
def test_wavelet_shrink_matches_jax(shape, levels):
    x = _noisy(shape, 61)
    want = JL.WAVELET_SHRINK(jnp.asarray(x), 0.3, levels)
    _close(TL.WAVELET_SHRINK(torch.from_numpy(x), 0.3, levels), want)


def test_wavelet_shrink_zero_threshold_is_identity():
    x = torch.from_numpy(_noisy((5, 33, 35), 62))
    np.testing.assert_allclose(TL.WAVELET_SHRINK(x, 0.0, 3).numpy(), x.numpy(), atol=1e-5)


def _phantom(noise):
    ph = shepp_logan_slice(64)
    return (ph + noise * np.random.default_rng(63).standard_normal(ph.shape)).astype(np.float32)


def _exact_patch_distance(img, pw, r, c, rn, cn):
    """The Gaussian patch distance of (r, c) to (rn, cn) in float64, as
    patch_select defines it (rolled neighbours, zero fill at the edge)."""
    H, W = img.shape
    kern = TL._patch_kernel(pw).astype(np.float64)
    s = 0.0
    for a in range(-pw, pw + 1):
        for b in range(-pw, pw + 1):
            y, x = r + a, c + b
            if 0 <= y < H and 0 <= x < W:
                v = float(img[y, x]) - float(img[(y + rn - r) % H, (x + cn - c) % W])
                s += kern[a + pw, b + pw] * v * v
    return s


@pytest.mark.parametrize("noise", [0.08, 0.0], ids=["noisy", "noise-free"])
def test_patch_select_matches_jax(noise):
    """The tables are exactly equal, with one exception, which only the
    noise-free phantom shows: two neighbours whose patch distances are equal
    in exact arithmetic (mirror-image patches) but whose float32 sums the
    JAX package's XLA convolution and the port round apart, each in its own
    order.  No order of the 25 taps that PyTorch can express reproduces
    XLA's rounding, so there the tables may differ, and only between
    neighbours whose float64 distances agree to 1e-12.  The flat regions'
    exactly zero distances tie in both, and the stable sort orders them as
    ``lax.top_k`` does."""
    img = _phantom(noise)
    sw, pw, K = 5, 2, 10
    want = [np.asarray(a) for a in JL.patch_select(jnp.asarray(img), sw, pw, K, 0.2)]
    got = [t.numpy() for t in TL.patch_select(torch.from_numpy(img), sw, pw, K, 0.2)]
    assert got[0].dtype == np.int32 and want[0].dtype == np.uint16
    assert all(g.shape == w.shape == (K, 64, 64) for g, w in zip(got, want))
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    differ = np.argwhere((got[0] != want[0]) | (got[1] != want[1]))
    if noise:
        assert differ.size == 0
    assert len(differ) <= 0.005 * got[0].size
    for k, r, c in differ:
        a = _exact_patch_distance(img, pw, r, c, want[0][k, r, c], want[1][k, r, c])
        b = _exact_patch_distance(img, pw, r, c, got[0][k, r, c], got[1][k, r, c])
        assert abs(a - b) <= 1e-12 * max(a, b)
    if not noise:
        # the flat regions: every selected distance zero, the same neighbours
        flat = np.all(want[2] == 1.0, axis=0)
        assert flat.sum() > 100
        assert np.array_equal(got[0][:, flat], want[0][:, flat])
        assert np.array_equal(got[1][:, flat], want[1][:, flat])


def test_patch_select_runs_of_rows_equal_one_run(monkeypatch):
    """With the element budget lowered to runs of 5 rows, the tables equal
    those of one run bit for bit."""
    img = torch.from_numpy(_phantom(0.08)[:40, :36].copy())
    whole = TL.patch_select(img, 4, 2, 8, 0.2)
    monkeypatch.setattr(TL, "PATCH_BLOCK_ELEMENTS", 80 * 36 * 5)
    for a, b in zip(TL.patch_select(img, 4, 2, 8, 0.2), whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("noise", [0.08, 0.0], ids=["noisy", "noise-free"])
def test_nltv_matches_jax(noise):
    """NLTV on the JAX package's tables (numpy uint16, as the legacy demos
    pass them), 2D and as one slice.  The fixed point amplifies float32
    rounding about 4x per iteration where neighbours are within eps of each
    other (on the noise-free phantom both packages are ~4e-5 from a float64
    run after 5 iterations), so the comparison runs 3."""
    img = _phantom(noise)
    h_i, h_j, w = (np.asarray(a) for a in JL.patch_select(jnp.asarray(img), 5, 2, 10, 0.2))
    want = JL.NLTV(jnp.asarray(img), h_i, h_j, w, 0.03, 3)
    _close(TL.NLTV(torch.from_numpy(img), h_i, h_j, w, 0.03, 3), want)
    got3 = TL.NLTV(torch.from_numpy(img[None]), torch.from_numpy(h_i.astype(np.int64)),
                   torch.from_numpy(h_j.astype(np.int64)), torch.from_numpy(w), 0.03, 3)
    assert got3.shape == (1, 64, 64)
    _close(got3[0], want)


# ---------------------------------------------------------------------------
# prox_regul: every method string equals its direct call
# ---------------------------------------------------------------------------


class Owner:
    nonneg_regul = 1


BASE = {"regul_param": 0.05, "iterations": 6, "time_marching_step": 0.002,
        "methodTV": 0, "PD_LipschitzConstant": 12.0}


def _direct(method, x, reg):
    """What prox_regul must return for ``method``, by direct calls."""
    lam, its, tms = reg["regul_param"], reg["iterations"], reg["time_marching_step"]
    direct = {
        "ROF_TV": lambda: ROF_TV(x, lam, its, tms),
        "PD_TV": lambda: PD_TV(x, lam, its, 0, 1, 12.0),
        "FGP_TV": lambda: TL.FGP_TV(x, lam, its, 0, 1),
        "SB_TV": lambda: TL.SB_TV(x, lam, its, 0),
        "LLT_ROF": lambda: TL.LLT_ROF(x, lam, reg.get("regul_param2", 1e-05), its, tms),
        "TGV": lambda: TL.TGV(x, lam, 1.0, 2.0, its, 12.0),
        "NDF": lambda: TL.NDF(x, lam, 0.01, its, tms, 1),
        "Diff4th": lambda: TL.Diff4th(x, lam, 0.01, its, tms),
        "WAVELETS": lambda: x,
    }
    base = method.replace("_WAVELETS", "")
    out = direct[base]()
    if "WAVELET" in method:
        thr = lam if method == "WAVELETS" else reg.get("regul_param2", 1e-05)
        out = TL.WAVELET_SHRINK(out, thr, 3)
    return out


METHODS = ["ROF_TV", "PD_TV", "FGP_TV", "SB_TV", "LLT_ROF", "TGV", "NDF", "Diff4th",
           "WAVELETS", "PD_TV_WAVELETS", "LLT_ROF_WAVELETS", "FGP_TV_WAVELETS"]


@pytest.mark.parametrize("method", METHODS)
def test_prox_regul_equals_direct_call(method):
    x = torch.from_numpy(_noisy((2, 24, 20), 64))
    reg = dict(BASE, method=method, regul_param2=0.02)
    _build.reset_launch_counts()
    got = prox_regul(Owner(), x, dict(reg))
    assert torch.equal(got, _direct(method, x, reg))
    assert all(v == 0 for v in _build.launch_counts.values())


@pytest.mark.parametrize("method", ["FGP_TV", "TGV", "NDF", "PD_TV_WAVELETS", "WAVELETS"])
def test_prox_regul_matches_jax(method):
    """The port's dispatch against the JAX package's on the same dict."""
    x = _noisy((2, 24, 20), 65)
    reg = dict(BASE, method=method, regul_param2=0.02, NDF_penalty=2, edge_param=0.3)
    want = jax_prox_regul(Owner(), jnp.asarray(x), dict(reg))
    _close(prox_regul(Owner(), torch.from_numpy(x), dict(reg)), want)


def test_prox_regul_legacy_keys():
    """The legacy dict keys and the wavelet threshold rule."""
    x = torch.from_numpy(_noisy((2, 24, 20), 66))
    reg = dict(BASE, alpha1=0.5, alpha0=1.5, TGV_LipschitzConstant=16.0)
    assert torch.equal(prox_regul(Owner(), x, dict(reg, method="TGV")),
                       TL.TGV(x, 0.05, 0.5, 1.5, 6, 16.0))
    for pen in (1, 2, 3):
        got = prox_regul(Owner(), x, dict(reg, method="NDF", NDF_penalty=pen, edge_param=0.2))
        assert torch.equal(got, TL.NDF(x, 0.05, 0.2, 6, 0.002, pen))
    got = prox_regul(Owner(), x, dict(reg, method="Diff4th", edge_param=0.2))
    assert torch.equal(got, TL.Diff4th(x, 0.05, 0.2, 6, 0.002))
    # wavelet_threshold overrides both regul_param and regul_param2
    got = prox_regul(Owner(), x, dict(reg, method="SB_TV_WAVELETS", regul_param2=0.9,
                                      wavelet_threshold=0.1, wavelet_levels=2))
    assert torch.equal(got, TL.WAVELET_SHRINK(TL.SB_TV(x, 0.05, 6, 0), 0.1, 2))
    # a combination without regul_param2 shrinks by its default, 1e-5
    got = prox_regul(Owner(), x, dict(reg, method="FGP_TV_WAVELETS"))
    assert torch.equal(got, TL.WAVELET_SHRINK(TL.FGP_TV(x, 0.05, 6, 0, 1), 1e-05, 3))


def test_prox_regul_nltv_iternumb():
    """NLTV reads IterNumb and does not need "iterations"; without IterNumb
    it takes "iterations", then 5."""
    img = _phantom(0.08)
    h_i, h_j, w = (np.asarray(a) for a in JL.patch_select(jnp.asarray(img), 4, 2, 8, 0.2))
    reg = {"method": "NLTV", "regul_param": 0.03, "NLTV_H_i": h_i, "NLTV_H_j": h_j,
           "NLTV_Weights": w, "IterNumb": 3}
    x = torch.from_numpy(img[None])
    got = prox_regul(Owner(), x, dict(reg))
    assert torch.equal(got, TL.NLTV(x, h_i, h_j, w, 0.03, 3))
    _close(got, jax_prox_regul(Owner(), jnp.asarray(img[None]), dict(reg)))
    del reg["IterNumb"]
    assert torch.equal(prox_regul(Owner(), x, dict(reg)), TL.NLTV(x, h_i, h_j, w, 0.03, 5))
    assert torch.equal(prox_regul(Owner(), x, dict(reg, iterations=2)),
                       TL.NLTV(x, h_i, h_j, w, 0.03, 2))


def test_prox_regul_unknown_method_raises():
    x = torch.zeros((2, 8, 8))
    for method in ("NOPE", None):
        with pytest.raises(ValueError, match="Unknown regularisation method"):
            prox_regul(Owner(), x, dict(BASE, method=method))


def test_fista_with_fgp_tv_matches_jax():
    """RecToolsIRCuPy.FISTA with a legacy prox, both packages on the
    two-pass pair (JAX: interpret-mode Pallas), OS2, 3 outer iterations."""
    from tomobar_tpu import RecToolsIRCuPy as JaxIR
    from tomobar_tpu.ops import projector as jax_projector
    from tomobar_tpu.ops import projector_pallas as PP
    from tomobar_tpu_torch import RecToolsIRCuPy

    n, na, nz = 32, 20, 2
    angles = np.linspace(0.0, np.pi, na, endpoint=False)
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import radon_fp

    vol = np.stack([shepp_logan_slice(n)] * nz).astype(np.float32)
    sino = radon_fp(torch.from_numpy(vol), Geometry(n, nz, angles, 0.0, n)).numpy()
    alg = {"iterations": 3, "nonnegativity": True, "lipschitz_const": 150.0}
    reg = {"method": "FGP_TV", "regul_param": 5e-3, "iterations": 10}
    saved = (jax_projector._BACKEND, PP._INTERPRET[0])
    jax_projector._BACKEND, PP._INTERPRET[0] = "pallas", True
    try:
        want = JaxIR(n, 0, nz, 0.0, angles, n, OS_number=2).FISTA(
            {"projection_data": jnp.asarray(sino)}, dict(alg), dict(reg))
    finally:
        jax_projector._BACKEND, PP._INTERPRET[0] = saved
    got = RecToolsIRCuPy(n, 0, nz, 0.0, angles, n, OS_number=2, device="cpu").FISTA(
        {"projection_data": sino}, dict(alg), dict(reg))
    want = np.asarray(want)
    assert got.shape == want.shape == (nz, n, n)
    assert np.linalg.norm(got.numpy() - want) <= 2e-4 * np.linalg.norm(want)
