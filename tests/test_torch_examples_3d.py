"""The port's 3D phantom example and its SWLS/Huber artifacts example
against their JAX counterparts at N = 48 (4 slices where the example takes
a slice count), each printed rel-RMSE to 1e-3 absolute; see
``test_torch_examples_2d.py``."""

import pytest

from test_torch_examples_2d import Parity, check_metric, check_prints, run_jax, run_port

NZ = 4
PARITY = Parity({
    "phantom3d_fista_os_tv": (lambda: run_port("phantom3d_fista_os_tv", nz=NZ),
                              lambda: run_jax("phantom3d_fista_os_tv", nz=NZ)),
    "artifacts3d_swls_huber": (lambda: run_port("artifacts3d_swls_huber"),
                               lambda: run_jax("artifacts3d_swls_huber")),
})


@pytest.mark.parametrize("metric", ["fbp", "fourier_inv", "fista"])
def test_phantom3d_fista_os_tv_matches_jax(metric):
    check_metric(PARITY, "phantom3d_fista_os_tv", metric)


@pytest.mark.parametrize("metric", ["pwls", "huber", "swls"])
def test_artifacts3d_swls_huber_matches_jax(metric):
    check_metric(PARITY, "artifacts3d_swls_huber", metric)


@pytest.mark.parametrize("name", ["phantom3d_fista_os_tv", "artifacts3d_swls_huber"])
def test_prints_what_it_returns(name):
    check_prints(PARITY, name)
