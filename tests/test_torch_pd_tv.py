"""Port parity: PD-TV of tomobar_tpu_torch against the JAX package's XLA
``PD_TV`` and its interpret-mode Pallas kernel ``pd_tv_pallas``.

Same numpy inputs on both sides; the tolerance (rtol 2e-5, atol 2e-6) is
the one ``tests/test_pallas_kernels.py`` holds the Pallas kernel to
against the XLA path.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomobar_tpu.ops.pd_tv_pallas import pd_tv_pallas
from tomobar_tpu.regularisers import PD_TV as jax_PD_TV

from tomobar_tpu_torch import _build
from tomobar_tpu_torch.ops.pd_tv import pd_tv_constants
from tomobar_tpu_torch.regularisers import PD_TV, ROF_TV, prox_regul

torch.set_num_threads(1)

LAM, ITERS, LC = 0.1, 14, 8.0  # two fused 7-iteration Pallas sweeps


def _vol(nz, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nz, 16, 128)).astype(np.float32)


@pytest.mark.parametrize("nz", [1, 3, 4])
@pytest.mark.parametrize("mtv,nn", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_pd_tv_matches_xla_and_pallas(nz, mtv, nn):
    v = _vol(nz)
    port = PD_TV(torch.from_numpy(v), LAM, ITERS, mtv, nn, LC).numpy()
    xla = np.asarray(jax_PD_TV(jnp.asarray(v), LAM, ITERS, mtv, nn, LC))
    pallas = np.asarray(
        pd_tv_pallas(jnp.asarray(v), LAM, ITERS, mtv, nn, LC, interpret=True)
    )
    assert port.shape == xla.shape == pallas.shape == v.shape
    np.testing.assert_allclose(port, xla, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(port, pallas, rtol=2e-5, atol=2e-6)


def test_pd_tv_2d_input_returns_1hw():
    v = _vol(1, seed=8)[0]
    port = PD_TV(torch.from_numpy(v), LAM, ITERS, 0, 1, LC).numpy()
    xla = np.asarray(jax_PD_TV(jnp.asarray(v), LAM, ITERS, 0, 1, LC))
    assert port.shape == xla.shape == (1,) + v.shape
    np.testing.assert_allclose(port, xla, rtol=2e-5, atol=2e-6)


def test_pd_tv_bf16_duals_follow_xla():
    """half_precision keeps the duals in bfloat16 between iterations, as
    the XLA path does; both round to nearest even."""
    v = _vol(3, seed=9)
    port = PD_TV(torch.from_numpy(v), LAM, ITERS, 0, 0, LC, half_precision=True)
    xla = np.asarray(
        jax_PD_TV(jnp.asarray(v), LAM, ITERS, 0, 0, LC, half_precision=True)
    )
    full = PD_TV(torch.from_numpy(v), LAM, ITERS, 0, 0, LC).numpy()
    err = np.abs(port.numpy() - xla).max()
    assert err < 1e-2 * np.abs(xla).max()
    assert err < 0.1 * np.abs(full - xla).max()


def test_constants_are_float32_of_the_reference():
    sigma, tau, lt, theta = pd_tv_constants(5e-4, 12.0)
    tau_ref = jnp.float32(5e-4 * 0.1)
    assert tau == float(tau_ref)
    assert sigma == float(jnp.float32(1.0 / (12.0 * tau_ref)))
    assert lt == float(jnp.float32(tau_ref / 5e-4))
    assert theta == 1.0


def test_prox_regul_dispatch():
    class Owner:
        nonneg_regul = 1

    reg = {"method": "PD_TV", "regul_param": LAM, "iterations": 3,
           "methodTV": 0, "PD_LipschitzConstant": LC}
    v = torch.from_numpy(_vol(2, seed=10))
    np.testing.assert_array_equal(
        prox_regul(Owner(), v, reg).numpy(), PD_TV(v, LAM, 3, 0, 1, LC).numpy()
    )
    rof = dict(reg, method="ROF_TV", time_marching_step=0.002)
    np.testing.assert_array_equal(
        prox_regul(Owner(), v, rof).numpy(), ROF_TV(v, LAM, 3, 0.002).numpy()
    )
    for method in ("FGP_TV", "PD_TV_WAVELETS"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            prox_regul(Owner(), v, dict(reg, method=method))


def test_cpu_pd_tv_launches_no_kernel():
    _build.reset_launch_counts()
    PD_TV(torch.from_numpy(_vol(2, seed=11)), LAM, 2)
    assert _build.launch_counts["PD"] == 0


# ---------------------------------------------------------------------------
# z-chunks with a halo: a deep stack in bounded memory, the same result
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("half", [False, True], ids=["f32-duals", "bf16-duals"])
@pytest.mark.parametrize("mtv,nn", [(0, 1), (1, 0)])
@pytest.mark.parametrize("nz", [5, 20, 41])
def test_pd_tv_z_chunks_equal_unchunked(monkeypatch, nz, mtv, nn, half):
    """With the byte budget lowered to 16 slices (and to 3, where a chunk
    keeps one slice), PD_TV on nz slices equals the single-chunk result bit
    for bit: a chunk runs with a halo of the iteration count on each side
    and keeps only its own slices."""
    from tomobar_tpu_torch.ops import pd_tv as P

    iters = 6
    rng = np.random.default_rng(nz)
    v = torch.from_numpy(rng.standard_normal((nz, 12, 20)).astype(np.float32))
    args = (LAM, iters, mtv, nn, LC, half)
    whole = PD_TV(v, *args)
    assert len(P.z_chunks(nz, 12, 20, iters, P.CHUNK_BYTES)) == 1
    for deep in (16, 3):
        monkeypatch.setattr(P, "CHUNK_BYTES", 32 * 12 * 20 * deep)
        chunks = P.z_chunks(nz, 12, 20, iters, P.CHUNK_BYTES)
        assert len(chunks) == (1 if deep >= nz else -(-nz // max(deep - 2 * iters, 1)))
        assert [c[:2] for c in chunks][0][0] == 0 and chunks[-1][1] == nz
        assert all(h1 - h0 <= max(deep, 1 + 2 * iters) for _, _, h0, h1 in chunks)
        assert torch.equal(PD_TV(v, *args), whole)


def test_pd_tv_element_cap_cuts_chunks(monkeypatch):
    """The element cap is a second limit on a chunk, never an error."""
    from tomobar_tpu_torch.ops import pd_tv as P

    v = torch.from_numpy(_vol(9))
    whole = PD_TV(v, LAM, 3, 0, 1, LC)
    monkeypatch.setattr(P, "MAX_ELEMENTS", 16 * 128 * 8)
    assert len(P.z_chunks(9, 16, 128, 3, P.CHUNK_BYTES)) == 5
    assert torch.equal(PD_TV(v, LAM, 3, 0, 1, LC), whole)


def test_pd_tv_z_chunks_match_xla(monkeypatch):
    """The chunked port against the JAX package's XLA PD_TV."""
    from tomobar_tpu_torch.ops import pd_tv as P

    v = _vol(12)
    monkeypatch.setattr(P, "CHUNK_BYTES", 32 * 16 * 128 * 10)
    assert len(P.z_chunks(12, 16, 128, 4, P.CHUNK_BYTES)) == 6
    port = PD_TV(torch.from_numpy(v), LAM, 4, 0, 1, LC).numpy()
    xla = np.asarray(jax_PD_TV(jnp.asarray(v), LAM, 4, 0, 1, LC))
    np.testing.assert_allclose(port, xla, rtol=2e-5, atol=2e-6)
