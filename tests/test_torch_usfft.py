"""Port parity of the USFFT pipeline (FOURIER_INV's stages): the port's
gridding (the plain version of the G kernel) against the JAX package's XLA
scatter oracle and its Pallas kernels G1 (``_grid_kernel_astack``) and G0
(``_grid_kernel``, ``_ASTACK`` off) in interpret mode; then the 2-D inverse
FFT stage, the crop/phi stage and the whole ``fourier_inv`` against the JAX
package on the CPU.

Tolerances: gridding as ``tests/test_fourier.py`` holds Pallas against the
oracle (rtol 1e-4, atol 1e-5 of max: float32 sums of 121 taps in another
order); the later stages 1e-5 of max |JAX output| (float32 FFTs of length
<= 1024 in another library); ``fourier_inv`` 2e-5 of max (the stages
compound).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomobar_tpu import RecToolsDIRCuPy as JaxDIR
from tomobar_tpu.ops import usfft as JU
from tomobar_tpu.ops import usfft_pallas
from tomobar_tpu_torch import RecToolsDIRCuPy
from tomobar_tpu_torch.ops import usfft as PU
from tomobar_tpu_torch.ops import usfft_kernels as UK

THETAS = [
    -np.linspace(0, np.pi, 61, endpoint=False),  # incl. 0, ~pi/2
    np.linspace(-0.3, 2.8, 47),  # arbitrary range, both driven groups
    np.array([0.0, np.pi / 2, np.pi / 4, -np.pi / 2]),  # axis cases
]
GRID_RTOL, GRID_ATOL = 1e-4, 1e-5
TOL = 1e-5
TOL_PIPE = 2e-5


def _spectra(nproj, n, seed=5):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((2, nproj, n)).astype(np.float32),
        rng.standard_normal((2, nproj, n)).astype(np.float32),
    )


@pytest.mark.parametrize("kernel", ["oracle", "G1", "G0"])
@pytest.mark.parametrize("t", range(len(THETAS)))
def test_usfft_grid_matches_jax(kernel, t, monkeypatch):
    """The oracle, and the Pallas kernel in interpret mode with its default
    angle-stacked schedule (G1) and with ``_ASTACK`` off (G0)."""
    thetas = THETAS[t]
    n = 128
    dre, dim = _spectra(thetas.size, n)
    if kernel == "oracle":
        a_re, a_im = JU.usfft_grid(jnp.asarray(dre), jnp.asarray(dim), n, thetas)
    else:
        monkeypatch.setattr(usfft_pallas, "_INTERPRET", [True])
        monkeypatch.setattr(usfft_pallas, "_ASTACK", kernel == "G1")
        a_re, a_im = usfft_pallas.usfft_grid_pallas(
            jnp.asarray(dre), jnp.asarray(dim), n, thetas
        )
    b_re, b_im = PU.usfft_grid(torch.from_numpy(dre), torch.from_numpy(dim), n, thetas)
    ref = np.abs(np.asarray(a_re)).max()
    for got, want in ((b_re, a_re), (b_im, a_im)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=GRID_RTOL, atol=GRID_ATOL * ref
        )


def test_grid_params_match_oracle():
    """m = 5 at eps = 1e-4 for every n; the Pallas kernels' cap is the
    oracle's clamp in cell units."""
    for n in (64, 128, 2560):
        prm = UK.grid_params(n)
        assert prm.m == 5
        cap = float(2 * n * (0.5 - 1e-5) + n)
        assert 2 * n * float(prm.clamp) + n == pytest.approx(cap, rel=1e-7)


@pytest.mark.parametrize("n", [32, 48])
def test_ifft2_centered_matches_jax(n):
    rng = np.random.default_rng(7)
    fre = rng.standard_normal((3, 2 * n, 2 * n)).astype(np.float32)
    fim = rng.standard_normal((3, 2 * n, 2 * n)).astype(np.float32)
    for shift in (True, False):
        a = JU._ifft2_centered(jnp.asarray(fre), jnp.asarray(fim), n, shift)
        b = PU._ifft2_centered(torch.from_numpy(fre), torch.from_numpy(fim), n, shift)
        for got, want in zip(b, a):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("shift", [True, False], ids=["half-pixel", "no-shift"])
@pytest.mark.parametrize("n", [4, 640, 2560])
def test_centred_factors_are_the_checker_times_the_ramp(n, shift):
    """Fc's 2n-long table c: c(i) c(j) (a float32 product of the float32
    table, as the kernel forms it) is the (2n)^2 checkerboard times the
    half-pixel ramp that ``_ifft2_chain`` builds, to float32 rounding."""
    from tomobar_tpu_torch.ops import fft_kernels as FK

    two_n = 2 * n
    cre, cim = FK.centred_factors(n, shift)
    assert cre.dtype == cim.dtype == np.float32 and cre.shape == (two_n,)
    c = torch.complex(torch.from_numpy(cre), torch.from_numpy(cim))
    i = torch.arange(two_n)
    ang = 2.0 * np.pi * (np.arange(two_n) - n) * 0.5 / two_n
    r1 = torch.as_tensor(np.cos(ang), dtype=torch.float32)
    r2 = torch.as_tensor(np.sin(ang), dtype=torch.float32)
    for r0 in range(0, two_n, 512):  # row strips of the (2n)^2 tables
        rows = slice(r0, r0 + 512)
        checker = torch.where((i[rows, None] + i[None, :]) % 2 == 1, -1.0, 1.0)
        if shift:
            ramp = torch.complex(r1[rows, None] * r1[None, :] - r2[rows, None] * r2[None, :],
                                 r1[rows, None] * r2[None, :] + r2[rows, None] * r1[None, :])
        else:
            ramp = torch.ones_like(checker, dtype=torch.complex64)
        want = checker * ramp
        got = c[rows, None] * c[None, :]
        assert (got - want).abs().max() <= 4 * 2.0**-24
        if not shift:
            assert torch.equal(got, want)


def test_only_the_ifft2_stage_takes_the_centred_variant(monkeypatch):
    """Fc's two launches (planned on meta, where a card's call would launch
    them) serve ``_ifft2_centered`` on a card's tensor at the sizes where
    its passes run F, and nothing else: not the same stage on the CPU or
    below F's sizes, not F's other callers (axis -2 transforms, the FBP
    filter, FOURIER_INV's filter stage)."""
    from tomobar_tpu_torch.ops import fft_kernels as FK
    from tomobar_tpu_torch.ops import fft_real as FR

    calls = []
    real = FK._centred_pass
    monkeypatch.setattr(FK, "_centred_pass", lambda *a: (calls.append(a[0]), real(*a))[1])

    def grids(n, device="meta"):
        return torch.zeros((2, 2 * n, 2 * n), device=device), torch.zeros((2, 2 * n, 2 * n), device=device)

    out = PU._ifft2_centered(*grids(640), 640)
    assert calls == [1, 2] and out[0].is_meta and out[0].shape == (2, 1280, 1280)
    calls.clear()
    PU._ifft2_centered(*grids(256), 256)  # 2n = 512: torch.fft's size
    PU._ifft2_centered(*grids(640, "cpu"), 640)
    x = torch.zeros((2, 1280, 1280), device="meta")
    FR._fft_axis2(x, x, 1)
    FR.fft2_pairs(x, x)
    FR.ifft2_pairs(x, x)
    w = torch.zeros(8192, device="meta")
    FR.apply_freq_filter_real(torch.zeros((2, 6, 8192), device="meta"), w, w)
    assert calls == []
    angles = np.linspace(0, np.pi, 30, endpoint=False)
    rd = RecToolsDIRCuPy(640, 0, 4, 0.0, angles, 640, device="meta")
    rd.FBP(torch.zeros((30, 4, 640), device="meta"))
    assert calls == []
    rec = rd.FOURIER_INV(torch.zeros((4, 30, 640), device="meta"), chunk_count=2)
    assert rec.shape == (4, 640, 640) and calls == [1, 2, 1, 2]  # two launches a z-block


@pytest.mark.parametrize("odd_horiz,odd_vert", [(False, False), (True, True)])
@pytest.mark.parametrize("recon_size", [40, 41])
def test_unpad_mul_phi_matches_jax(odd_horiz, odd_vert, recon_size):
    n, nproj, nz = 48, 30, 4
    rng = np.random.default_rng(8)
    fre = rng.standard_normal((nz // 2, 2 * n, 2 * n)).astype(np.float32)
    fim = rng.standard_normal((nz // 2, 2 * n, 2 * n)).astype(np.float32)
    mu = -np.log(1e-4) / (2 * n * n)
    args = (n, nproj, nz, odd_horiz, odd_vert, recon_size, mu)
    want = np.asarray(JU._unpad_mul_phi(jnp.asarray(fre), jnp.asarray(fim), *args))
    got = PU._unpad_mul_phi(torch.from_numpy(fre), torch.from_numpy(fim), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _problem(nz, det, nproj, seed=9):
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    sino = rng.uniform(0.0, 1.0, (nz, nproj, det)).astype(np.float32)
    return angles, sino


def _compare_fourier_inv(det, nz, nproj, recon, cor=0.0, pad=0, **kwargs):
    angles, sino = _problem(nz, det, nproj)
    jrt = JaxDIR(det, pad, nz, cor, angles, recon)
    prt = RecToolsDIRCuPy(det, pad, nz, cor, angles, recon, device="cpu")
    want = np.asarray(jrt.FOURIER_INV(jnp.asarray(sino), **kwargs))
    got = prt.FOURIER_INV(torch.from_numpy(sino), **kwargs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PIPE * np.abs(want).max())


@pytest.mark.parametrize(
    "ftype", ["none", "ramp", "shepp", "cosine", "cosine2", "hamming", "hann", "parzen"]
)
def test_fourier_inv_every_filter_matches_jax(ftype):
    _compare_fourier_inv(48, 2, 40, 48, filter_type=ftype, cutoff_freq=0.8)


@pytest.mark.parametrize(
    "det,nz,recon,kwargs",
    [
        (47, 3, 47, {}),  # odd detX and odd nz: edge-padded, then unpadded
        (48, 5, 44, {"chunk_count": 2}),  # pair-aligned z chunks, odd tail
        (48, 4, 48, {"padding": 5, "power_of_2_oversampling": False}),
        (48, 2, 48, {"recon_mask_radius": 0.9, "power_of_2_cropping": True}),
    ],
)
def test_fourier_inv_options_match_jax(det, nz, recon, kwargs):
    _compare_fourier_inv(det, nz, 36, recon, cor=1.5, **kwargs)


def test_fourier_inv_detector_padding_matches_jax():
    _compare_fourier_inv(40, 2, 30, 40, pad=4)


def test_memory_chunks_match_jax():
    for nz, n, kw in [
        (8, 2560, {"min_mem_usage_ifft2": True}),
        (8, 2560, {"min_mem_usage_filter": True, "mem_budget_gb": 1.0}),
        (9, 64, {"chunk_count": 3}),
        (4, 64, {"chunk_count": 0}),
        (4, 64, {}),
    ]:
        assert PU._fourier_inv_memory_chunks(nz, n, kw) == JU._fourier_inv_memory_chunks(nz, n, kw)
