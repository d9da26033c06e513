"""Port parity of the remaining solvers and of ROF-TV: ``RecToolsIRCuPy``
``Landweber``, ``SIRT``, ``CGLS``, ``ADMM`` (with PD-TV and with ROF-TV)
and ``OSEM`` (both normalisation modes) of tomobar_tpu_torch on the CPU
against the JAX package on its interpret-mode Pallas projector at nz = 4
(K1/K4; the 2D cases, on the packed K1p/K4p route, are in
``tests/test_torch_solvers_2d.py``); ``ROF_TV`` against the JAX
``ROF_TV``.

Both sides get the same numpy sinogram and Lipschitz constant.  Solver
tolerance rel L2 2e-4, as ``tests/test_torch_slice.py``: the Pallas bf16x3
products compounded over the iterations; ROF-TV 1e-5 of max (fp32 sums in
another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tomobar_tpu import RecToolsIRCuPy as JaxIR
from tomobar_tpu import regularisers as jax_regularisers
from tomobar_tpu.ops import projector as jax_projector
from tomobar_tpu.ops import projector_pallas as PP

from tomobar_tpu_torch import RecToolsIRCuPy, _build
from tomobar_tpu_torch.regularisers import ROF_TV, prox_regul

torch.set_num_threads(1)

N, N_ANG = 32, 20
TOL_REL = 2e-4
TOL_ROF = 1e-5


@pytest.fixture()
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jax_projector, "_BACKEND", "pallas")
    PP._INTERPRET[0] = True
    yield
    PP._INTERPRET[0] = False


def _angles():
    return np.linspace(0.0, np.pi, N_ANG, endpoint=False)


def _sino(nz):
    """A smooth positive object's sinogram with multiplicative noise, made
    with the port's projector; 2D for ``nz`` None."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import radon_fp

    yy, xx = np.mgrid[-1 : 1 : N * 1j, -1 : 1 : N * 1j]
    blob = np.clip(1.0 - (xx / 0.7) ** 2 - (yy / 0.5) ** 2, 0.0, None) + 0.05
    vol = blob[None] * np.linspace(0.8, 1.2, nz or 1)[:, None, None]
    sino = radon_fp(torch.from_numpy(vol.astype(np.float32)),
                    Geometry(N, nz or 1, _angles(), 0.0, N)).numpy()
    sino = sino * np.random.default_rng(41).uniform(0.95, 1.05, sino.shape)
    return (sino[0] if nz is None else sino).astype(np.float32)


# method, OS_number, _algorithm_, _regularisation_
CASES = {
    "Landweber": ("Landweber", None, {"iterations": 6, "tau_step_lanweber": 2e-3}, None),
    "SIRT": ("SIRT", None, {"iterations": 6, "nonnegativity": True}, None),
    "CGLS": ("CGLS", None, {"iterations": 5}, None),
    "ADMM-PD_TV": (
        "ADMM", 2, {"iterations": 3, "nonnegativity": True, "lipschitz_const": 150.0},
        {"method": "PD_TV", "regul_param": 5e-3, "iterations": 10},
    ),
    "ADMM-ROF_TV": (
        "ADMM", 2, {"iterations": 3, "lipschitz_const": 150.0},
        {"method": "ROF_TV", "regul_param": 5e-3, "iterations": 10},
    ),
    "OSEM-reference": ("OSEM", 2, {"iterations": 2}, None),
    "OSEM-divide": (
        "OSEM", 2, {"iterations": 2, "osem_normalisation": "divide"},
        {"method": "PD_TV", "regul_param": 1e-3, "iterations": 5},
    ),
}


def run_case(case, nz):
    """One of ``CASES`` through both packages on the same data; asserts
    parity at rel L2 ``TOL_REL``."""
    method, os_n, alg, reg = CASES[case]
    sino = _sino(nz)
    args = (N, 0, nz, 0.0, _angles(), N)
    jax_args = () if reg is None else (dict(reg),)
    want = np.asarray(
        getattr(JaxIR(*args, OS_number=os_n), method)(
            {"projection_data": jnp.asarray(sino)}, dict(alg), *jax_args
        )
    )
    _build.reset_launch_counts()
    got = getattr(RecToolsIRCuPy(*args, OS_number=os_n, device="cpu"), method)(
        {"projection_data": sino}, dict(alg), *jax_args
    )
    assert all(v == 0 for v in _build.launch_counts.values())
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.shape == want.shape == (nz or 1, N, N)
    assert np.isfinite(got).all() and np.linalg.norm(want) > 0.0
    assert np.linalg.norm(got - want) <= TOL_REL * np.linalg.norm(want)


@pytest.mark.parametrize("case", list(CASES))
def test_solver_matches_jax(jax_pallas, case):
    run_case(case, 4)


@pytest.mark.parametrize(
    "shape,half",
    [((40, 36), False), ((1, 40, 36), False), ((3, 24, 20), False), ((3, 24, 20), True)],
    ids=["2d", "squeezed", "3d", "3d-bf16"],
)
def test_rof_tv_matches_jax(shape, half):
    x = np.random.default_rng(42).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_regularisers.ROF_TV(jnp.asarray(x), 0.05, 30, 0.002, half))
    got = ROF_TV(torch.from_numpy(x), 0.05, 30, 0.002, half).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_ROF * np.abs(want).max()


def test_prox_regul_serves_rof_tv_and_names_the_legacy_item():
    x = torch.from_numpy(np.random.default_rng(43).standard_normal((2, 16, 16)).astype(np.float32))
    reg = {"method": "ROF_TV", "regul_param": 0.05, "iterations": 5,
           "time_marching_step": 0.002}
    assert torch.equal(prox_regul(None, x, reg), ROF_TV(x, 0.05, 5, 0.002))
    with pytest.raises(NotImplementedError, match="item 10"):
        prox_regul(None, x, dict(reg, method="FGP_TV"))


def test_iterative_class_has_every_solver():
    for name in ("powermethod", "Landweber", "SIRT", "CGLS", "FISTA", "ADMM", "OSEM"):
        assert callable(getattr(RecToolsIRCuPy, name))


def test_admm_tolerance_and_verbose(capsys):
    rt = RecToolsIRCuPy(N, 0, None, 0.0, _angles(), N, OS_number=2, device="cpu")
    rec = rt.ADMM(
        {"projection_data": _sino(None)},
        {"iterations": 8, "tolerance": 0.5, "verbose": True, "lipschitz_const": 150.0},
    )
    out = capsys.readouterr().out
    assert "ADMM iteration (1) relative update" in out
    assert "tolerance reached" in out
    assert "ADMM iteration (8)" not in out
    assert rec.shape == (1, N, N)


def test_osem_rejects_unknown_normalisation():
    rt = RecToolsIRCuPy(N, 0, None, 0.0, _angles(), N, device="cpu")
    with pytest.raises(ValueError, match="osem_normalisation"):
        rt.OSEM({"projection_data": _sino(None)}, {"iterations": 1, "osem_normalisation": "sum"})


def test_sirt_cgls_landweber_reduce_the_residual():
    """Each iteration of the non-OS solvers brings A x closer to b."""
    from tomobar_tpu_torch.ops.projector import radon_fp

    sino = _sino(None)
    rt = RecToolsIRCuPy(N, 0, None, 0.0, _angles(), N, device="cpu")
    for method, alg in (("SIRT", {}), ("CGLS", {}), ("Landweber", {"tau_step_lanweber": 2e-3})):
        res = []
        for it in (2, 4):
            x = getattr(rt, method)({"projection_data": sino}, dict(alg, iterations=it))
            res.append(float(torch.linalg.vector_norm(
                radon_fp(x[0], rt._geometry) - torch.from_numpy(sino))))
        assert res[1] < res[0], (method, res)


@pytest.mark.parametrize("os_number", [1, 4])
def test_ax_atb_match_jax(jax_pallas, os_number):
    """``_Ax``/``_Atb`` of the iterative class (whole operator and one OS
    subset) against the JAX package's on its interpret-mode Pallas pair."""
    nz = 2
    rng = np.random.default_rng(50)
    x = rng.standard_normal((nz, N, N)).astype(np.float32)
    port = RecToolsIRCuPy(N, 0, nz, 0.0, _angles(), N, OS_number=os_number, device="cpu")
    ref = JaxIR(N, 0, nz, 0.0, _angles(), N, OS_number=os_number)
    for sub, os in ((1, False),) + (((2, True),) if os_number > 1 else ()):
        ax = port._Ax(torch.from_numpy(x), sub, os)
        want = np.asarray(ref._Ax(jnp.asarray(x), sub, os))
        assert ax.shape == want.shape
        np.testing.assert_allclose(ax.numpy(), want, rtol=0, atol=5e-5 * np.abs(want).max())
        atb = port._Atb(ax, sub, os)
        want = np.asarray(ref._Atb(jnp.asarray(ax.numpy()), sub, os))
        np.testing.assert_allclose(atb.numpy(), want, rtol=0, atol=5e-5 * np.abs(want).max())
