"""The port's CPU path on the Joseph pair (``set_projector_backend("xla")``)
held to the JAX package's frozen ``GOLDEN_CPU``: the nine cases of
``tests/test_goldens.py`` (power method, Landweber, SIRT, CGLS, FISTA-OS
with PD-TV, ADMM with ROF-TV, OSEM, FOURIER_INV, FBP) on the same phantom
sinogram, at the same RTOL 3e-4 on min / max / mean.
"""

import numpy as np
import pytest
import torch

from test_goldens import GOLDEN_CPU, RTOL

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


def _data(port):
    return {"projection_data": port["sino"].copy()}


def _check(name, rec):
    rec = rec.numpy() if isinstance(rec, torch.Tensor) else np.asarray(rec)
    got = (float(rec.min()), float(rec.max()), float(rec.mean()))
    for g, w, label in zip(got, GOLDEN_CPU[name], ("min", "max", "mean")):
        assert g == pytest.approx(w, rel=RTOL, abs=1e-7), f"{name}.{label}: got {g!r}, golden {w!r}"


CASES = {
    "landweber": lambda p: p["classic"].Landweber(_data(p), {"iterations": 50}),
    "sirt": lambda p: p["classic"].SIRT(_data(p), {"iterations": 50}),
    "cgls": lambda p: p["classic"].CGLS(_data(p), {"iterations": 10}),
    "fista_os_tv": lambda p: p["os5"].FISTA(
        _data(p), {"iterations": 8, "nonnegativity": True},
        {"method": "PD_TV", "regul_param": 5e-4, "iterations": 30}),
    "admm_rof": lambda p: p["os5"].ADMM(
        _data(p), {"iterations": 3},
        {"method": "ROF_TV", "regul_param": 1e-3, "iterations": 40}),
    "osem": lambda p: p["os5"].OSEM(_data(p), {"iterations": 5}),
    "fourier_inv_shepp": lambda p: p["direct"].FOURIER_INV(p["sino"], filter_type="shepp"),
    "fbp_device": lambda p: p["direct"].FBP(np.swapaxes(p["sino"], 0, 1)),
}


def test_lipschitz(port):
    lc = float(port["os5"].powermethod(_data(port)))
    assert lc == pytest.approx(GOLDEN_CPU["lc_os5"], rel=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_golden(port, name):
    _check(name, CASES[name](port))
