"""Port parity of the preprocessing modules: the native fused pass
(``tomobar_tpu_torch.native``), ``normaliser`` and ``autocropper``
(``utils/tools.py``), the dynamic flat fields (``utils/dffc.py``) and the
centre finder (``utils/center.py``) against the JAX package on the same
seeded inputs.

Tolerances: 1e-6 relative for the normalisation and dffc (float32
reductions in another order), 1e-9 for the centre (float64 host math on
the same rows), equal crop boxes.
"""

import numpy as np
import pytest
import torch

from tomobar_tpu import native as jax_native
from tomobar_tpu.utils import center as JC
from tomobar_tpu.utils import tools as JT

from tomobar_tpu_torch import native
from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops.projector import radon_fp
from tomobar_tpu_torch.utils import center as TC
from tomobar_tpu_torch.utils import tools as TT

torch.set_num_threads(1)

TOL = 1e-6
TOL_CENTRE = 1e-9


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def raw_stack(seed: int, n_flats: int = 4, axis: int = 0):
    """Raw projections, flats and darks, [angles, detY, detX] (axis 0) or
    [detY, angles, detX] (axis 1)."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(100, 60000, (12, 16, 20)).astype(np.float32)
    flats = rng.uniform(50000, 60000, (n_flats, 16, 20)).astype(np.float32)
    darks = rng.uniform(50, 150, (3, 16, 20)).astype(np.float32)
    if axis == 1:
        data, flats, darks = (np.ascontiguousarray(a.transpose(1, 0, 2)) for a in (data, flats, darks))
    return data, flats, darks


def test_native_builds_into_the_build_dir():
    assert native.available()
    lib = native._library_path()
    assert lib.exists() and lib.parent.name == "_build"
    assert lib.parent.parent.name == "tomobar_tpu_torch"


@pytest.mark.parametrize("log", [True, False])
def test_normalise_native_matches_jax(log):
    data, flats, darks = raw_stack(1)
    flat, dark = flats.mean(axis=0), darks.mean(axis=0)
    got = native.normalise_native(data, flat, dark, log)
    assert got is not None
    assert rel(got, jax_native.normalise_native(data, flat, dark, log)) <= TOL


def test_proj_stats_native_matches_jax():
    data, _, _ = raw_stack(2)
    for got, ref in zip(native.proj_stats_native(data), jax_native.proj_stats_native(data)):
        assert rel(got, ref) <= TOL


@pytest.mark.parametrize("method", ["mean", "median"])
@pytest.mark.parametrize("log", [True, False])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("with_darks", [True, False])
def test_normaliser_matches_jax(method, log, axis, with_darks):
    """numpy in against the JAX package; a CPU tensor in against the numpy
    path (flats as numpy, darks as a tensor)."""
    data, flats, darks = raw_stack(3, axis=axis)
    darks = darks if with_darks else None
    ref = JT.normaliser(data, flats, darks, log=log, method=method, axis=axis)
    got = TT.normaliser(data, flats, darks, log=log, method=method, axis=axis)
    assert isinstance(got, np.ndarray) and got.shape == data.shape
    assert rel(got, ref) <= TOL
    t = TT.normaliser(
        torch.from_numpy(data), flats,
        None if darks is None else torch.from_numpy(darks),
        log=log, method=method, axis=axis,
    )
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    assert rel(t.numpy(), got) <= TOL


@pytest.mark.parametrize("n_flats", [4, 5])
def test_median_of_even_and_odd_flat_counts(n_flats):
    """``np.median`` averages the two middle flats of an even count (where
    ``torch.median`` would take the lower one): the tensor path must too."""
    data, flats, _ = raw_stack(4, n_flats=n_flats)
    ref = TT.normaliser(data, flats, None, log=False, method="median")
    got = TT.normaliser(torch.from_numpy(data), torch.from_numpy(flats), None,
                        log=False, method="median")
    assert rel(got.numpy(), ref) <= TOL
    k = (n_flats - 1) // 2  # the lower middle flat, torch.median's choice
    lower = TT.normaliser(data, np.sort(flats, axis=0)[k : k + 1], None, log=False)
    assert (rel(ref, lower) > 1e-4) == (n_flats % 2 == 0)


@pytest.mark.parametrize("method", ["mean", "median"])
@pytest.mark.parametrize("log", [True, False])
def test_normaliser_guards(method, log):
    """flat <= dark (denominator -> 1), data < dark (numerator -> 1) and
    ratios > 1 (negative absorption, clamped to 0 after the log)."""
    data, flats, darks = raw_stack(5)
    flats[:, 0, :5] = 10.0  # below the darks
    data[:, 1, :] = 20.0  # below the darks
    data[:, 2, :] = 65000.0  # above the flats
    ref = JT.normaliser(data, flats, darks, log=log, method=method)
    got = TT.normaliser(data, flats, darks, log=log, method=method)
    t = TT.normaliser(torch.from_numpy(data), flats, darks, log=log, method=method)
    assert rel(got, ref) <= TOL and rel(t.numpy(), ref) <= TOL
    if log:
        assert (t[:, 2, :] == 0).all() and (t >= 0).all()


@pytest.mark.parametrize("family", ["numpy", "tensor"])
def test_normaliser_errors(family):
    data, flats, darks = raw_stack(6)
    wrap = torch.from_numpy if family == "tensor" else (lambda a: a)
    for pkg in (JT, TT):
        with pytest.raises(NameError):
            pkg.normaliser(wrap(data) if pkg is TT else data, flats, darks, method="bogus")
        with pytest.raises(NameError):
            pkg.normaliser(wrap(data[0]) if pkg is TT else data[0], flats[0], darks[0])


def dynamic_stack(seed: int):
    rng = np.random.default_rng(seed)
    dety, nfr, detx = 16, 10, 24
    base = 1.0 + 0.1 * np.sin(np.linspace(0, 3, detx))[None, :]
    drift = np.linspace(0.9, 1.1, nfr)
    flats = np.stack(
        [base * d + 0.01 * rng.standard_normal((dety, detx)) for d in drift], axis=1
    ).astype(np.float32)  # (detY, frames, detX)
    data = (0.6 * flats[:, :8] * (1 + 0.01 * rng.standard_normal((dety, 8, detx)))).astype(np.float32)
    return data, flats, np.zeros_like(flats)


@pytest.mark.parametrize("denoiser", [None, "wavelet"])
def test_dynamic_matches_jax(denoiser):
    data, flats, darks = dynamic_stack(7)
    kw = dict(log=True, method="dynamic", dyn_iterations=3, dyn_denoiser=denoiser)
    ref = JT.normaliser(data, flats, darks, **kw)
    got = TT.normaliser(data, flats, darks, **kw)
    assert got.shape == data.shape and np.isfinite(got).all()
    assert rel(got, ref) <= TOL
    t = TT.normaliser(torch.from_numpy(data), flats, torch.from_numpy(darks), **kw)
    assert isinstance(t, torch.Tensor) and rel(t.numpy(), ref) <= TOL


def test_dynamic_rejects_unknown_denoiser():
    data, flats, darks = dynamic_stack(8)
    with pytest.raises(NameError):
        TT.normaliser(data, flats, darks, method="dynamic", dyn_denoiser="bm3d")


def crop_stack(seed: int, second: bool):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 0.05, (4, 64, 80)).astype(np.float32)
    data[:, 20:44, 30:58] += 1.0
    if second:
        data[:, 50:58, 66:74] += 1.0
    return data


@pytest.mark.parametrize("second", [False, True])
@pytest.mark.parametrize("addbox", [0, 3])
def test_autocropper_box_matches_jax(second, addbox):
    data = crop_stack(9, second)
    ref = JT.autocropper(data, addbox=addbox, backgr_pix1=8)
    got = TT.autocropper(data, addbox=addbox, backgr_pix1=8)
    t = TT.autocropper(torch.from_numpy(data), addbox=addbox, backgr_pix1=8)
    assert isinstance(got, np.ndarray) and isinstance(t, torch.Tensor)
    assert got.shape == ref.shape == tuple(t.shape)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(t.numpy(), ref)


def test_autocropper_pure_noise_matches_jax():
    data = np.random.default_rng(10).uniform(0.0, 0.05, (2, 32, 40)).astype(np.float32)
    ref = JT.autocropper(data, addbox=0, backgr_pix1=4)
    assert TT.autocropper(data, addbox=0, backgr_pix1=4).shape == ref.shape
    assert tuple(TT.autocropper(torch.from_numpy(data), addbox=0, backgr_pix1=4).shape) == ref.shape


def centre_sino(cor: float, n: int = 128, nang: int = 180):
    from conftest import shepp_logan_slice

    angles = np.linspace(0, np.pi, nang, endpoint=False)
    ph = torch.as_tensor(shepp_logan_slice(n))[None]
    return radon_fp(ph, Geometry(n, 1, angles, cor, n))[0].numpy(), angles


@pytest.mark.parametrize("cor", [0.0, 3.25, -5.5, 10.0])
def test_find_center_matches_jax(cor):
    sino, angles = centre_sino(cor)
    ref = JC.find_center_correlation(sino, angles)
    got = TC.find_center_correlation(sino, angles)
    assert abs(got - ref) <= TOL_CENTRE
    assert abs(TC.find_center_correlation(torch.from_numpy(sino), angles) - ref) <= TOL_CENTRE
    assert abs(got - cor) < 0.35, (cor, got)
    assert abs(TC.find_center_correlation(sino) - JC.find_center_correlation(sino)) <= TOL_CENTRE


def test_find_center_3d_with_search_radius_matches_jax():
    sino, angles = centre_sino(4.5)
    rng = np.random.default_rng(11)
    noisy = sino + rng.normal(0, 0.05 * sino.max(), sino.shape)
    stack = np.stack([noisy, noisy, sino])
    ref = JC.find_center_correlation(stack, angles, search_radius=20.0)
    got = TC.find_center_correlation(stack, angles, search_radius=20.0)
    assert abs(got - ref) <= TOL_CENTRE
    got_t = TC.find_center_correlation(torch.from_numpy(stack), angles, search_radius=20.0)
    assert abs(got_t - ref) <= TOL_CENTRE
    assert abs(got - 4.5) < 0.5


@pytest.mark.parametrize("cor", [4.25, -7.6])
def test_find_center_stack_mode(cor):
    """``stack=True`` correlates the rows as they are and sums the slices:
    it finds the offset of a wide object that the JAX package's
    mean-subtracted rows pull toward 0 (1024 px, the two rows of a
    1801-angle scan that lie nearest pi apart, clean and with Poisson noise
    at 1e4 photons)."""
    from conftest import shepp_logan_slice

    n = 1024
    angles = np.array([0.0, np.pi - np.pi / 1801])
    ph = torch.as_tensor(shepp_logan_slice(n))[None] * torch.linspace(0.8, 1.2, 4)[:, None, None]
    clean = radon_fp(ph, Geometry(n, 4, angles, cor, n)).numpy() * (2.0 / n)
    biased = TC.find_center_correlation(clean, angles)
    assert biased == JC.find_center_correlation(clean, angles)
    assert abs(biased - cor) > 0.25
    assert abs(TC.find_center_correlation(clean, angles, stack=True) - cor) < 0.02
    assert abs(TC.find_center_correlation(clean[1:2], angles, stack=True) - cor) < 0.02
    counts = np.random.default_rng(12).poisson(1e4 * np.exp(-clean))
    noisy = np.maximum(-np.log(np.maximum(counts, 1) / 1e4), 0.0)
    got = TC.find_center_correlation(torch.from_numpy(noisy), angles, stack=True)
    assert abs(got - cor) < 0.15, got
