"""Port parity of the FBP filters: the host filter tables of
tomobar_tpu_torch equal the JAX package's numpy outputs exactly, and the
sinogram filters match the JAX package's to 1e-5 relative (float32 FFTs in
another library and order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomobar_tpu.ops import filters as JF
from tomobar_tpu_torch.ops import filters as PF

TOL = 1e-5  # of max |JAX output|


@pytest.mark.parametrize("n", [64, 65, 2560])
def test_sinc_half_and_extension_equal_jax(n):
    for a in (0.35, 1.1):
        half = PF.sinc_filter_half(n, a, 1.0 / 90)
        np.testing.assert_array_equal(half, JF.sinc_filter_half(n, a, 1.0 / 90))
        np.testing.assert_array_equal(
            PF.hermitian_extend_real(half, n), JF.hermitian_extend_real(half, n)
        )


@pytest.mark.parametrize("ftype", PF.CLASSIC_FILTER_TYPES)
def test_classic_half_equals_jax(ftype):
    assert PF.CLASSIC_FILTER_TYPES == JF.CLASSIC_FILTER_TYPES
    for n, prm, d in ((64, None, 1.0), (97, 0.3, 0.7)):
        np.testing.assert_array_equal(
            PF.classic_filter_half(n, ftype, prm, d, 0.5),
            JF.classic_filter_half(n, ftype, prm, d, 0.5),
        )


@pytest.mark.parametrize("ftype", PF.FILTER_TYPES)
def test_calc_filter_equals_jax(ftype):
    assert PF.FILTER_TYPES == JF.FILTER_TYPES
    for n, cutoff in ((256, 1.0), (8192, 0.6)):
        np.testing.assert_array_equal(
            PF.calc_filter_np(n, ftype, cutoff), JF.calc_filter_np(n, ftype, cutoff)
        )
    np.testing.assert_array_equal(PF._wint(12, np.arange(65) / 128), JF._wint(12, np.arange(65) / 128))


def test_unknown_filters_raise():
    with pytest.raises(ValueError):
        PF.classic_filter_half(64, "bogus")
    with pytest.raises(ValueError):
        PF.calc_filter_np(64, "bogus")


def _sino(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 17, 64), (16, 63)])
@pytest.mark.parametrize("cutoff", [0.35, 1.1])
def test_filter_sino_sinc_matches_jax(shape, cutoff):
    sino = _sino(shape, 1)
    ref = np.asarray(JF.filter_sino_sinc(jnp.asarray(sino), cutoff))
    got = PF.filter_sino_sinc(torch.from_numpy(sino), cutoff).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("ftype,prm", [("ram-lak", None), ("hamming", 0.6), ("kaiser", None)])
@pytest.mark.parametrize("shape", [(2, 9, 66), (15, 48)])
def test_filter_sino_classic_matches_jax(ftype, prm, shape):
    sino = _sino(shape, 2)
    ref = np.asarray(JF.filter_sino_classic(jnp.asarray(sino), ftype, prm, 0.9))
    got = PF.filter_sino_classic(torch.from_numpy(sino), ftype, prm, 0.9).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())
