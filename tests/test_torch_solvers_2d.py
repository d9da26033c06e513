"""Port parity of the remaining solvers in 2D, where every projection runs
the packed nz = 1 pair K1p/K4p: the cases of ``tests/test_torch_solvers.py``
on one slice (a separate file so that the two halves run in parallel)."""

import pytest

from test_torch_solvers import CASES, jax_pallas, run_case  # noqa: F401


@pytest.mark.parametrize("case", list(CASES))
def test_solver_2d_matches_jax(jax_pallas, case):  # noqa: F811
    run_case(case, None)
