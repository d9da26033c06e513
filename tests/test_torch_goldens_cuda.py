"""``GOLDEN_CUDA``: the nine cases of ``GOLDEN_CPU`` (``tests/test_goldens.py``)
on the card's default kernel path, frozen once on the card.

The calls (power method, Landweber, SIRT, CGLS, FISTA-OS with PD-TV, ADMM
with ROF-TV, OSEM, FOURIER_INV, FBP) are ``CASES`` here, which
``tests/test_torch_goldens.py`` also holds to ``GOLDEN_CPU``, at the same
RTOL 3e-4 on min / max / mean, on ``cuda:0``
with the two-pass kernel pair ("auto").  The input is built here, as
``tests/conftest.py``'s ``sino3d`` is (which projects through JAX): the
Shepp-Logan slice of 64^2 times 0.8 ... 1.2 over 4 slices, 90 angles,
projected by the port's Joseph pair on the CPU (``tests/test_torch_goldens.py``
holds it to ``sino3d``).  GPU lane only::

    TOMOBAR_TORCH_TEST_DEVICE=cuda python -m pytest --noconftest tests/test_torch_goldens_cuda.py

Regenerate the table deliberately, after an intended numeric change, on
the card: ``python tests/test_torch_goldens_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy  # noqa: E402
from tomobar_tpu_torch.geometry import Geometry  # noqa: E402
from tomobar_tpu_torch.ops import projector as TP  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def gpu_lane():
    """Skip unless the lane asks for the card (``TOMOBAR_TORCH_TEST_DEVICE=cuda``)
    and there is one, decided when the tests run, not when they are collected."""
    if os.environ.get("TOMOBAR_TORCH_TEST_DEVICE") != "cuda" or not torch.cuda.is_available():
        pytest.skip("GPU lane only (TOMOBAR_TORCH_TEST_DEVICE=cuda on a machine with CUDA)")

RTOL = 3e-4
ANGLES = np.linspace(0, np.pi, 90, endpoint=False)

# frozen by `python tests/test_torch_goldens_cuda.py` on an NVIDIA H100 80GB
# HBM3, power limit 700.00 W (nvidia-smi name, power.limit), torch
# 2.11.0+cu128, CUDA 12.8.  Beside GOLDEN_CPU (the Joseph pair): the kernel
# pair's operator differs from the one-pass Joseph pair by 1-2%, and the
# results here differ from GOLDEN_CPU's by up to 0.23% in a mean and 19% in
# an extreme; FOURIER_INV, which takes no projector, by 3.1e-7.
GOLDEN_CUDA = {
    "lc_os5": 1102.5218505859375,
    "landweber": (0.0, 0.3112265467643738, 0.10712888091802597),
    "sirt": (-0.09856358915567398, 1.2082761526107788, 0.12143464386463165),
    "cgls": (-0.27085429430007935, 1.500738263130188, 0.12193500250577927),
    "fista_os_tv": (0.0, 1.4407542943954468, 0.12208874523639679),
    "admm_rof": (-0.032834138721227646, 0.6972980499267578, 0.1200958639383316),
    "osem": (0.0, 611.9783935546875, 39.648216247558594),
    "fourier_inv_shepp": (-1.526920199394226, 3.2038707733154297, 0.2956569790840149),
    "fbp_device": (-0.4911212921142578, 1.9819815158843994, 0.06778475642204285),
}


def shepp_logan_slice(n: int) -> np.ndarray:
    """The Shepp-Logan-like slice of ``tests/conftest.py`` (a copy)."""
    ellipses = [
        (1.0, 0.69, 0.92, 0.0, 0.0, 0.0),
        (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0.0),
        (-0.2, 0.11, 0.31, 0.22, 0.0, -18.0),
        (-0.2, 0.16, 0.41, -0.22, 0.0, 18.0),
        (0.1, 0.21, 0.25, 0.0, 0.35, 0.0),
        (0.1, 0.046, 0.046, 0.0, 0.1, 0.0),
        (0.1, 0.046, 0.023, -0.08, -0.605, 0.0),
        (0.1, 0.023, 0.046, 0.06, -0.605, 0.0),
    ]
    y, x = np.mgrid[-1 : 1 : n * 1j, -1 : 1 : n * 1j]
    img = np.zeros((n, n), dtype=np.float32)
    for val, a, b, x0, y0, phi in ellipses:
        phi = np.deg2rad(phi)
        xr = (x - x0) * np.cos(phi) + (y - y0) * np.sin(phi)
        yr = -(x - x0) * np.sin(phi) + (y - y0) * np.cos(phi)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += val
    return img


def golden_sinogram() -> np.ndarray:
    """The goldens' (4, 90, 64) sinogram: the phantom of ``sino3d``
    projected by the port's Joseph pair on the CPU."""
    phantom = shepp_logan_slice(64)[None] * np.linspace(0.8, 1.2, 4, dtype=np.float32)[:, None, None]
    saved = TP._BACKEND
    TP.set_projector_backend("xla")
    try:
        return TP.radon_fp(torch.as_tensor(phantom), Geometry(64, 4, ANGLES, 0.0, 64)).numpy()
    finally:
        TP.set_projector_backend(saved)


def _data(p):
    return {"projection_data": p["sino"].copy()}


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


def card_instances(sino: np.ndarray) -> dict:
    """The cases' instances on ``cuda:0`` (the default device) and their input."""
    args = (64, 0, 4, 0.0, ANGLES, 64)
    return dict(sino=sino, os5=RecToolsIRCuPy(*args, OS_number=5),
                classic=RecToolsIRCuPy(*args), direct=RecToolsDIRCuPy(*args))


def stats(rec) -> tuple:
    rec = rec.cpu().numpy() if isinstance(rec, torch.Tensor) else np.asarray(rec)
    return float(rec.min()), float(rec.max()), float(rec.mean())


@pytest.fixture(scope="module")
def card():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    saved = TP._BACKEND
    TP.set_projector_backend("auto")
    yield card_instances(golden_sinogram())
    TP.set_projector_backend(saved)


def test_lipschitz(card):
    lc = float(card["os5"].powermethod(_data(card)))
    assert lc == pytest.approx(GOLDEN_CUDA["lc_os5"], rel=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_golden(card, name):
    got = stats(CASES[name](card))
    for g, w, label in zip(got, GOLDEN_CUDA[name], ("min", "max", "mean")):
        assert g == pytest.approx(w, rel=RTOL, abs=1e-7), f"{name}.{label}: got {g!r}, golden {w!r}"


def _regenerate() -> None:
    """Compute the table on the card and print it (paste into GOLDEN_CUDA)."""
    import subprocess

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = card_instances(golden_sinogram())
    out = {"lc_os5": float(p["os5"].powermethod(_data(p)))}
    out.update({name: stats(fn(p)) for name, fn in CASES.items()})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"# {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("GOLDEN_CUDA = {")
    for k, v in out.items():
        print(f'    "{k}": {v!r},')
    print("}")


if __name__ == "__main__":
    _regenerate()
