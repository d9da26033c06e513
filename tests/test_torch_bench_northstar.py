"""The port's north-star bench (``tomobar_tpu_torch/bench/northstar.py``) on
the CPU: its phantom against the JAX package's, its FISTA and ADMM steps
against the JAX package's ``solvers.core.fista`` / ``admm`` on the
interpret-mode Pallas projector, and a whole run at N 32.

Tolerances: the phantom exactly; the steps bit for bit against the port's
own ``fista``/``admm``, and rel L2 2e-4 after 3 outer iterations against
the JAX package's, the slice's tolerance (``tests/test_torch_slice.py``: the
Pallas bf16x3 products compounded over the iterations).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomobar_tpu.bench.northstar import ellipsoid_phantom_jax
from tomobar_tpu.geometry import Geometry as JaxGeometry
from tomobar_tpu.ops import projector as jax_projector
from tomobar_tpu.ops import projector_pallas as PP
from tomobar_tpu.regularisers import PD_TV as jax_PD_TV
from tomobar_tpu.solvers import core as jax_solvers

from tomobar_tpu_torch.bench import northstar as NS
from tomobar_tpu_torch.convert import geometry_from_reference
from tomobar_tpu_torch.ops.projector import Projector

torch.set_num_threads(1)

N, NZ, NA, OS, TV, LAM = 32, 4, 20, 2, 5, 2e-3
TOL_REL = 2e-4


@pytest.fixture()
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jax_projector, "_BACKEND", "pallas")
    PP._INTERPRET[0] = True
    yield
    PP._INTERPRET[0] = False


@pytest.mark.parametrize("n, nz", [(32, 4), (64, 20), (48, 7)])
def test_phantom_equals_jax(n, nz):
    got = NS.ellipsoid_phantom(n, nz, "cpu").numpy()
    want = np.asarray(ellipsoid_phantom_jax(n, nz))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _problem():
    """The JAX geometry (OS 2), the noisy sinogram of the phantom (counts at
    8000 photons from a seeded numpy generator) and a Lipschitz constant."""
    jg = JaxGeometry(detectors_x=N, detectors_y=NZ, angles=np.linspace(0, np.pi, NA, endpoint=False),
                     recon_size=N, os_number=OS)
    P = Projector(geometry_from_reference(jg))
    clean = P.fp(NS.ellipsoid_phantom(N, NZ, "cpu")).numpy() * (4.0 / N)
    counts = np.random.default_rng(11).poisson(8000.0 * np.exp(-clean))
    sino = (-np.log(np.maximum(counts, 1.0) / 8000.0) / (4.0 / N)).astype(np.float32)
    return jg, P, sino, 400.0


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_fista_steps_match_jax_fista(jax_pallas):
    jg, P, sino, L = _problem()
    step, carry = NS.make_fista_step(P, torch.as_tensor(sino), L, LAM, TV)
    for _ in range(3):
        carry = step(carry)
    want = np.asarray(jax_solvers.fista(
        jax_projector.Projector(jg), jnp.asarray(sino), 3, L, nonnegativity=True,
        fidelity="PWLS", regul_fn=lambda x: jax_PD_TV(x, LAM, TV, 0, 1, 12.0)))
    assert np.abs(want).max() > 0
    assert _rel(carry[0].numpy(), want) <= TOL_REL


def test_admm_steps_match_jax_admm(jax_pallas):
    """Warm-started at the same volume; the third step relaxes (outer index
    2), as the solver does."""
    jg, P, sino, L = _problem()
    x0 = np.random.default_rng(12).uniform(0.0, 1.0, (NZ, N, N)).astype(np.float32)
    step, carry = NS.make_admm_step(P, torch.as_tensor(sino), L, LAM, TV, torch.as_tensor(x0))
    for _ in range(3):
        carry = step(carry)
    want = np.asarray(jax_solvers.admm(
        jax_projector.Projector(jg), jnp.asarray(sino), 3, L, nonnegativity=True,
        regul_fn=lambda x: jax_PD_TV(x, LAM, TV, 0, 1, 12.0), x0=jnp.asarray(x0)))
    assert _rel(carry[0].numpy(), want) <= TOL_REL


def test_fista_steps_equal_the_ports_fista():
    """3 steps are 3 iterations of ``solvers.core.fista`` on the port, bit
    for bit: the bench's copy of the loop times what the solver computes."""
    from tomobar_tpu_torch.regularisers import PD_TV
    from tomobar_tpu_torch.solvers import core as solvers

    _, P, sino, L = _problem()
    b = torch.as_tensor(sino)
    step, carry = NS.make_fista_step(P, b, L, LAM, TV)
    for _ in range(3):
        carry = step(carry)
    want = solvers.fista(P, b, 3, L, nonnegativity=True, fidelity="PWLS",
                         regul_fn=lambda x: PD_TV(x, LAM, TV, 0, 1, 12.0))
    assert float(want.abs().max()) > 0
    assert torch.equal(carry[0], want)


def test_admm_steps_equal_the_ports_admm():
    """3 steps from a warm start are 3 iterations of ``solvers.core.admm``
    on the port, bit for bit (the third relaxes)."""
    from tomobar_tpu_torch.regularisers import PD_TV
    from tomobar_tpu_torch.solvers import core as solvers

    _, P, sino, L = _problem()
    b = torch.as_tensor(sino)
    x0 = torch.as_tensor(np.random.default_rng(12).uniform(0.0, 1.0, (NZ, N, N)).astype(np.float32))
    step, carry = NS.make_admm_step(P, b, L, LAM, TV, x0)
    for _ in range(3):
        carry = step(carry)
    want = solvers.admm(P, b, 3, L, nonnegativity=True,
                        regul_fn=lambda x: PD_TV(x, LAM, TV, 0, 1, 12.0), x0=x0)
    assert torch.equal(carry[0], want)


def test_inputs_are_the_runs():
    """``northstar_inputs`` gives the run its phantom and sinogram: the
    phantom is ``ellipsoid_phantom``'s and the noisy sinogram is finite,
    of the projector's shape, the same for the same seed."""
    P, phantom, sino = NS.northstar_inputs(32, 4, 24, 4, 8000.0, "cpu", seed=3)
    assert torch.equal(phantom, NS.ellipsoid_phantom(32, 4, "cpu"))
    assert tuple(sino.shape) == (4, 24, 32) and bool(torch.isfinite(sino).all())
    assert len(P.subset_indices) == 4
    assert torch.equal(sino, NS.northstar_inputs(32, 4, 24, 4, 8000.0, "cpu", seed=3)[2])


JAX_KEYS = {
    "shape", "os", "tv", "lipschitz_const", "powermethod_s", "powermethod_run_s",
    "powermethod_compile_s", "fbp_s", "rel_rmse_fbp", "fista", "admm",
}
JAX_FISTA_KEYS = {
    "rel_rmse_final", "rel_rmse_best", "rmse_target", "time_to_rmse_s", "time_to_rmse_cold_s",
    "time_to_rmse_warm_s", "time_to_fbp_rmse_s", "outer_iters", "total_s", "trajectory", "iter_s",
}
JAX_ADMM_KEYS = {"warm_start", "os", "rel_rmse_final", "outer_iters", "total_s", "trajectory"}


STEPS = []  # small_run's on_step calls


@pytest.fixture(scope="module")
def small_run():
    return NS.run_northstar(N=32, nz=4, nproj=24, os_number=4, tv_iters=5, fista_outer=6,
                            admm_outer=3, device="cpu", verbose=False,
                            on_step=lambda solver, i: STEPS.append((solver, i)))


def test_run_northstar_keys(small_run):
    """Every key of the JAX package's output but ``stall_excluded_s``."""
    assert set(small_run) == JAX_KEYS
    assert set(small_run["fista"]) == JAX_FISTA_KEYS
    assert set(small_run["admm"]) == JAX_ADMM_KEYS


def test_run_northstar_trajectories(small_run):
    """Raw step times that add up to the trajectory's times; FISTA's and
    ADMM's rel-RMSE fall; every number finite."""
    for name in ("fista", "admm"):
        traj = small_run[name]["trajectory"]
        assert len(traj) == small_run[name]["outer_iters"]
        steps = [d for _, _, d in traj]
        assert all(d > 0 for d in steps)
        assert np.allclose(np.cumsum(steps), [t for t, _, _ in traj], atol=1e-3)
        rmse = [r for _, r, _ in traj]
        assert all(a > b for a, b in zip(rmse, rmse[1:])), (name, rmse)
    assert 0 < small_run["rel_rmse_fbp"] < 1 and small_run["lipschitz_const"] > 0
    assert small_run["fista"]["iter_s"] > 0


def test_run_northstar_on_step(small_run):
    """``on_step`` is called after each outer step of the FISTA and then of
    the ADMM trajectory, and only there (not in the steps that time
    ``iter_s``)."""
    assert STEPS == [("fista", i) for i in range(6)] + [("admm", i) for i in range(3)]


def test_trajectory_keeps_a_slow_step():
    """A step 10x the median stays in the trajectory as measured (the JAX
    package's bench clamped it to the median)."""
    phantom = torch.ones((1, 4, 4))
    delays = iter([0.01, 0.01, 0.1, 0.01, 0.01])

    def step(carry):
        time.sleep(next(delays))
        return (carry[0] * 0.5,)

    _, traj = NS._trajectory(step, (torch.full((1, 4, 4), 2.0),), phantom, 5)
    steps = [d for _, _, d in traj]
    assert steps[2] >= 0.1 and steps[2] > 5 * np.median(steps)
    assert traj[-1][0] == pytest.approx(sum(steps)) and traj[-1][0] >= 0.14
