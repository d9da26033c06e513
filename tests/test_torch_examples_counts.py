"""The port's count-data examples against their JAX counterparts at N = 48:
OSEM, MLEM and FISTA-KL on Poisson counts, and raw counts through the
normaliser to a padded-detector FBP warm start and ADMM-OS24 (4 slices),
each printed rel-RMSE to 1e-3 absolute; see ``test_torch_examples_2d.py``."""

import pytest

from test_torch_examples_2d import Parity, check_metric, check_prints, run_jax, run_port

NZ = 4
PARITY = Parity({
    "osem_kl_counts": (lambda: run_port("osem_kl_counts"), lambda: run_jax("osem_kl_counts")),
    "realdata_warmstart_admm": (lambda: run_port("realdata_warmstart_admm", nz=NZ),
                                lambda: run_jax("realdata_warmstart_admm", nz=NZ)),
})


@pytest.mark.parametrize("metric", ["osem", "mlem", "kl", "ls"])
def test_osem_kl_counts_matches_jax(metric):
    check_metric(PARITY, "osem_kl_counts", metric)


@pytest.mark.parametrize("metric", ["fbp", "admm"])
def test_realdata_warmstart_admm_matches_jax(metric):
    check_metric(PARITY, "realdata_warmstart_admm", metric)


@pytest.mark.parametrize("name", ["osem_kl_counts", "realdata_warmstart_admm"])
def test_prints_what_it_returns(name):
    check_prints(PARITY, name)
