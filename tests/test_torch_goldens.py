"""The port's CPU path on the Joseph pair (``set_projector_backend("xla")``)
held to the JAX package's frozen ``GOLDEN_CPU``: the nine cases of
``tests/test_goldens.py`` (power method, Landweber, SIRT, CGLS, FISTA-OS
with PD-TV, ADMM with ROF-TV, OSEM, FOURIER_INV, FBP) on the same phantom
sinogram, at the same RTOL 3e-4 on min / max / mean.  The calls are
``tests/test_torch_goldens_cuda.py``'s ``CASES``, which ``GOLDEN_CUDA``
freezes on the card.
"""

import numpy as np
import pytest
import torch

from test_goldens import GOLDEN_CPU, RTOL
from test_torch_goldens_cuda import CASES, _data, golden_sinogram, stats

from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy
from tomobar_tpu_torch.ops import projector as TP

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port(sino3d, angles180):
    """The port on the CPU with the Joseph pair, for this module only."""
    saved = TP._BACKEND
    TP.set_projector_backend("xla")
    args = (64, 0, 4, 0.0, angles180, 64)
    yield dict(
        sino=sino3d,
        os5=RecToolsIRCuPy(*args, OS_number=5, device="cpu"),
        classic=RecToolsIRCuPy(*args, device="cpu"),
        direct=RecToolsDIRCuPy(*args, device="cpu"),
    )
    TP.set_projector_backend(saved)


def _check(name, rec):
    for g, w, label in zip(stats(rec), GOLDEN_CPU[name], ("min", "max", "mean")):
        assert g == pytest.approx(w, rel=RTOL, abs=1e-7), f"{name}.{label}: got {g!r}, golden {w!r}"


def test_lipschitz(port):
    lc = float(port["os5"].powermethod(_data(port)))
    assert lc == pytest.approx(GOLDEN_CPU["lc_os5"], rel=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_golden(port, name):
    _check(name, CASES[name](port))


def test_cuda_golden_input_matches_sino3d(sino3d):
    """``GOLDEN_CUDA``'s input, built without JAX, is ``conftest.sino3d``."""
    got = golden_sinogram()
    assert got.shape == sino3d.shape
    assert np.linalg.norm(got - sino3d) / np.linalg.norm(sino3d) <= 1e-6
