"""Port parity of the split-complex FFT helpers: the port's axis-(-2)
transform and ``apply_freq_filter_real`` (their plain route on the CPU)
against the JAX package's fused Pallas pass F in interpret mode, with the
host tables and the size rule of that pass equal to the JAX package's.

Tolerance 2e-6 of max |JAX output|: both sides are float32 transforms of
length <= 1280 (error ~ eps * log n relative to the largest coefficient),
one a matmul DFT, the other ``torch.fft``.
"""

import numpy as np
import pytest
import torch

from tomobar_tpu.ops import fft_real as JFR
from tomobar_tpu_torch.ops import fft_kernels as FK
from tomobar_tpu_torch.ops import fft_real as PFR

TOL = 2e-6


@pytest.fixture()
def jax_fused(monkeypatch):
    """The JAX package's fused Pallas pass, in interpret mode on the CPU."""
    monkeypatch.setattr(JFR, "_FFT_INTERPRET", [True])
    monkeypatch.setattr(JFR, "use_native_complex_fft", lambda: False)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal(shape).astype(np.float32),
        rng.standard_normal(shape).astype(np.float32),
    )


@pytest.mark.parametrize("n", [256, 1280, 2560, 5120, 8192, 2042, 97, 4096 * 3])
def test_split_and_tables_equal_jax(jax_fused, n):
    """The port's F runs at exactly the sizes where the JAX package runs its
    fused pass (probed at a strip-aligned width, with a complex input)."""
    assert FK.best_split(n) == JFR._best_split(n)
    assert PFR.use_fused_axis2(n) == JFR._use_fused_axis2(n, JFR._pick_lb(n), object())
    B, C = FK.best_split(n)
    if B:
        for sign in (-1, 1):
            for mine, ref in zip(FK.dft_mats(B, sign), JFR._dft_mats(B, sign)):
                np.testing.assert_array_equal(mine, ref)
            for mine, ref in zip(FK.twiddle(n, B, C, sign), JFR._twiddle(n, B, C, sign)):
                np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("n,L,B", [(256, 256, 2), (1280, 256, None)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_fft_axis2_matches_jax_fused(jax_fused, n, L, B, sign):
    """(256, 256) drives the JAX pass directly at B=2, C=128 (the port's
    ``_fft_axis2`` takes its plain route at n <= 1024, as JAX takes its
    matmul DFT); (1280, 256) is a size both send to their fused pass."""
    if B is None:
        B, C = JFR._best_split(n)
    else:
        C = n // B
    re, im = _pair((2, n, L), 3)
    ref_re, ref_im = JFR._fft_axis2_fused(
        JFR.jnp.asarray(re), JFR.jnp.asarray(im), sign, B, C
    )
    got_re, got_im = PFR._fft_axis2(torch.from_numpy(re), torch.from_numpy(im), sign)
    scale = max(np.abs(ref_re).max(), np.abs(ref_im).max())
    np.testing.assert_allclose(got_re.numpy(), np.asarray(ref_re), rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(got_im.numpy(), np.asarray(ref_im), rtol=0, atol=TOL * scale)
    # the F wrapper on a CPU tensor is its plain version
    w_re, w_im = FK.fft_axis2(torch.from_numpy(re), torch.from_numpy(im), sign)
    p_re, p_im = FK.fft_axis2_plain(torch.from_numpy(re), torch.from_numpy(im), sign)
    assert torch.equal(w_re, p_re) and torch.equal(w_im, p_im)


@pytest.mark.parametrize("complex_w", [False, True])
def test_apply_freq_filter_real_matches_jax_fused(jax_fused, complex_w):
    """n = 256 takes the fused route on both sides; 7 rows per slab is odd,
    so the last pair carries a zero row."""
    n = 256
    x = np.random.default_rng(4).standard_normal((3, 7, n)).astype(np.float32)
    half = np.linspace(0.0, 2.0, n // 2 + 1)
    t = np.fft.fftfreq(n)
    w = np.empty(n, dtype=np.complex128)
    w[: n // 2 + 1] = half
    w[n // 2 + 1 :] = half[1 : n // 2][::-1]
    if complex_w:
        w = w * np.exp(-2j * np.pi * t * 3.25)
        w[0] = w[0].real
        w[n // 2] = w[n // 2].real
    w_re = w.real.astype(np.float32)
    w_im = w.imag.astype(np.float32) if complex_w else None
    assert JFR._use_fused_axis2(n, JFR._pick_lb(n), object())
    ref = np.asarray(
        JFR.apply_freq_filter_real(
            JFR.jnp.asarray(x), JFR.jnp.asarray(w_re),
            None if w_im is None else JFR.jnp.asarray(w_im),
        )
    )
    got = PFR.apply_freq_filter_real(
        torch.from_numpy(x), torch.from_numpy(w_re),
        None if w_im is None else torch.from_numpy(w_im),
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


def test_apply_freq_filter_real_last_axis_route():
    """A size with no fused split (n = 97, prime) takes the last-axis
    route; it equals numpy's irfft(rfft(x) * half)."""
    n = 97
    assert not PFR.use_fused_axis2(n)
    x = np.random.default_rng(5).standard_normal((2, 5, n)).astype(np.float32)
    half = np.linspace(1.0, 0.0, n // 2 + 1).astype(np.float32)
    full = np.concatenate([half, half[1 : (n + 1) // 2][::-1]])
    got = PFR.apply_freq_filter_real(torch.from_numpy(x), torch.from_numpy(full)).numpy()
    ref = np.fft.irfft(np.fft.rfft(x, axis=-1) * half, n, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


def test_fft_pairs_match_jax():
    re, im = _pair((3, 640), 6)
    for mine, ref in zip(
        PFR.fft_pairs(torch.from_numpy(re), torch.from_numpy(im)),
        JFR.fft_pairs(JFR.jnp.asarray(re), JFR.jnp.asarray(im)),
    ):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0, atol=TOL * np.abs(ref).max())
    for mine, ref in zip(
        PFR.ifft_pairs(torch.from_numpy(re), torch.from_numpy(im)),
        JFR.ifft_pairs(JFR.jnp.asarray(re), JFR.jnp.asarray(im)),
    ):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0, atol=TOL * np.abs(ref).max())
