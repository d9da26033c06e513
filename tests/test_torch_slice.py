"""Port parity of the whole slice: power method and
``RecToolsIRCuPy.FISTA`` (PWLS, ordered subsets, non-negativity, PD-TV) of
tomobar_tpu_torch on the CPU against the JAX package on its interpret-mode
Pallas projector backend.

Both sides get the same numpy sinogram and the same Lipschitz constant.
The slice tolerance (rel L2 2e-4) allows the Pallas bf16x3 matmul errors
(~2^-17 relative per projection) to compound over the FISTA and PD-TV
iterations.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tomobar_tpu import RecToolsIRCuPy as JaxRecTools
from tomobar_tpu.geometry import Geometry as JaxGeometry
from tomobar_tpu.ops import projector as jax_projector
from tomobar_tpu.ops import projector_pallas as PP
from tomobar_tpu.solvers import core as jax_solvers

from tomobar_tpu_torch import RecToolsIRCuPy, _build
from tomobar_tpu_torch.convert import geometry_from_reference, tensor_from_reference
from tomobar_tpu_torch.ops.projector import Projector
from tomobar_tpu_torch.solvers import core as solvers

torch.set_num_threads(1)

N, NZ, N_ANG, OS = 64, 2, 16, 2


@pytest.fixture()
def jax_pallas(monkeypatch):
    monkeypatch.setattr(jax_projector, "_BACKEND", "pallas")
    PP._INTERPRET[0] = True
    yield
    PP._INTERPRET[0] = False


def _angles():
    return np.linspace(0.0, np.pi, N_ANG, endpoint=False)


def _sino():
    """A smooth positive object's sinogram with multiplicative noise."""
    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[-1 : 1 : N * 1j, -1 : 1 : N * 1j]
    blob = np.clip(1.0 - (xx / 0.7) ** 2 - (yy / 0.5) ** 2, 0.0, None)
    vol = np.stack([blob, 0.8 * blob]).astype(np.float32)
    g = geometry_from_reference(
        JaxGeometry(detectors_x=N, detectors_y=NZ, angles=_angles(), recon_size=N)
    )
    from tomobar_tpu_torch.ops.projector import radon_fp

    sino = radon_fp(torch.from_numpy(vol), g).numpy()
    return (sino * rng.uniform(0.95, 1.05, sino.shape)).astype(np.float32)


def test_power_method_matches_jax(jax_pallas):
    """(h) fed the JAX start vector, the port's power method gives the
    JAX value."""
    jg = JaxGeometry(
        detectors_x=N, detectors_y=NZ, angles=_angles(), recon_size=N,
        os_number=OS,
    )
    shape = (NZ, N, N)
    ref = jax_solvers.power_method(jax_projector.Projector(jg), shape, iterations=5)
    start = np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), shape, dtype=jnp.float32)
    )
    port = solvers.power_method(
        Projector(geometry_from_reference(jg)), shape, iterations=5,
        x0=tensor_from_reference(start, "volume"), device="cpu",
    )
    assert port == pytest.approx(ref, rel=1e-4)


def test_power_method_seeded_start():
    g = geometry_from_reference(
        JaxGeometry(detectors_x=N, detectors_y=1, angles=_angles(), recon_size=N)
    )
    a = solvers.power_method(Projector(g), (1, N, N), iterations=3, seed=4, device="cpu")
    b = solvers.power_method(Projector(g), (1, N, N), iterations=3, seed=4, device="cpu")
    assert a == b and a > 0.0


def test_power_method_runs_on_the_card_unless_asked(monkeypatch):
    """With no start vector and no device the power method takes the card
    (the JAX package's runs on its default device): without CUDA it raises
    and names ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = geometry_from_reference(
        JaxGeometry(detectors_x=N, detectors_y=1, angles=_angles(), recon_size=N)
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solvers.power_method(Projector(g), (1, N, N), iterations=3)


def test_power_method_cpu_matches_jax(jax_pallas):
    """``device="cpu"`` with the seeded start runs on the host; the value is
    the operator's norm, so it matches the JAX package's from its own start
    vector to the iteration's convergence (15 iterations, 1e-3)."""
    jg = JaxGeometry(
        detectors_x=N, detectors_y=NZ, angles=_angles(), recon_size=N,
        os_number=OS,
    )
    ref = jax_solvers.power_method(jax_projector.Projector(jg), (NZ, N, N), iterations=15)
    port = solvers.power_method(Projector(geometry_from_reference(jg)), (NZ, N, N),
                                iterations=15, device="cpu")
    assert port == pytest.approx(ref, rel=1e-3)


def test_fista_slice_matches_jax(jax_pallas):
    """(i) the whole slice on the CPU against JAX FISTA on Pallas."""
    sino = _sino()
    lc = 500.0  # the power method gives 491.6 here
    alg = {"iterations": 2, "nonnegativity": True, "lipschitz_const": lc}
    reg = {"method": "PD_TV", "regul_param": 5e-3, "iterations": 10}
    ref = np.asarray(
        JaxRecTools(N, 0, NZ, 0.0, _angles(), N, OS_number=OS).FISTA(
            {"projection_data": jnp.asarray(sino), "data_fidelity": "PWLS"},
            dict(alg), dict(reg),
        )
    )
    _build.reset_launch_counts()
    port = RecToolsIRCuPy(N, 0, NZ, 0.0, _angles(), N, OS_number=OS, device="cpu").FISTA(
        {"projection_data": sino, "data_fidelity": "PWLS"}, dict(alg), dict(reg)
    )
    assert all(v == 0 for v in _build.launch_counts.values())
    port = port.numpy()
    assert port.shape == ref.shape == (NZ, N, N)
    assert np.isfinite(port).all()
    assert np.linalg.norm(ref) > 0.0
    assert np.linalg.norm(port - ref) <= 2e-4 * np.linalg.norm(ref)


def test_fista_tolerance_and_verbose(capsys):
    sino = _sino()
    rt = RecToolsIRCuPy(N, 0, NZ, 0.0, _angles(), N, OS_number=OS, device="cpu")
    rec = rt.FISTA(
        {"projection_data": sino},
        {"iterations": 6, "tolerance": 0.5, "verbose": True, "lipschitz_const": 4000.0},
    )
    out = capsys.readouterr().out
    assert "FISTA iteration (1) relative update" in out
    assert "tolerance reached" in out
    assert "FISTA iteration (6)" not in out
    assert rec.shape == (NZ, N, N)
