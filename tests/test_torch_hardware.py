"""The GPU lane: the port's CUDA kernels and paths on the card.

These only run where there is a card and the lane asks for it::

    TOMOBAR_TORCH_TEST_DEVICE=cuda python -m pytest --noconftest \\
        tests/test_torch_hardware.py tests/test_torch_goldens_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports jax, which the card's
machine need not have; nothing here needs it.)  A CUDA kernel has no
interpret mode, so the tier-1 run on the CPU skips this file.  The kernel
checks are ``chip_smoke.py``'s own functions, imported, not copied: each
kernel against its plain PyTorch version on the same inputs (K1, K1p, K3,
K4, K4p bit for bit; K2, PD, G, F within 1e-5 of the largest value; PD
with bf16 duals within 1e-3).  Beside them: the pair's adjointness at
nz = 8 and nz = 1 (phases 4 and 8's own check), the GPU against the CPU at 256^2 x 4 x 90 (3D FISTA,
FBP, FOURIER_INV) and on the examples' paths at 64^2 (SWLS/Huber,
OSEM/MLEM/KL, the padded warm start and ADMM, and plain PWLS and LS on data
where they are stable to rounding), all within 1e-4 rel L2; and the direct
entry points against the closed-form Radon transform of ellipses at the
sizes and thresholds of ``tests/test_torch_crosscheck_analytic.py``, on
both projector pairs (``chip_smoke.py``'s phase-17 check).
"""

import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def gpu_lane():
    """Skip unless the lane asks for the card (``TOMOBAR_TORCH_TEST_DEVICE=cuda``)
    and there is one, decided when the tests run, not when they are collected."""
    if os.environ.get("TOMOBAR_TORCH_TEST_DEVICE") != "cuda" or not torch.cuda.is_available():
        pytest.skip("GPU lane only (TOMOBAR_TORCH_TEST_DEVICE=cuda on a machine with CUDA)")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as CS  # noqa: E402
from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy  # noqa: E402
from tomobar_tpu_torch.geometry import Geometry  # noqa: E402
from tomobar_tpu_torch.ops import pd_tv as PDT  # noqa: E402
from tomobar_tpu_torch.ops import projector_kernels as K  # noqa: E402
from tomobar_tpu_torch.ops.projector import radon_fp  # noqa: E402

TOL_GPU_CPU = CS.TOL_SLICE  # 1e-4 rel L2
ANGLES180 = np.linspace(0.0, np.pi, 180, endpoint=False)
COR = {"cor 3.5": 3.5, "per-angle cor": 3.5 + 2.0 * np.sin(3.0 * ANGLES180)}


@pytest.fixture(scope="module")
def dev():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def errs(dev):
    return CS.Errors(torch)


@pytest.mark.parametrize("seed,cor", enumerate(COR), ids=list(COR))
def test_projector_kernels(errs, dev, seed, cor):
    CS.check_projector_kernels(torch, K, errs, Geometry(512, 8, ANGLES180, COR[cor], 512), dev,
                               seed=10 + seed)


def test_k1_shapes(errs, dev):
    CS.check_k1_shapes(torch, K, errs, dev)


def test_k4_shapes(errs, dev):
    CS.check_k4_shapes(torch, K, errs, dev)


def test_k3_shapes(errs, dev):
    CS.check_k3_shapes(torch, K, errs, dev)


def test_k3_index_guard(dev):
    CS.check_k3_index_guard()


def test_pd_shapes(errs, dev):
    CS.check_pd_shapes(torch, PDT, errs, dev)


def test_direct_kernels(errs, dev):
    CS.check_direct_kernels(torch, errs, dev)


@pytest.mark.parametrize("seed,cor", enumerate(COR), ids=list(COR))
def test_packed_kernels(errs, dev, seed, cor):
    CS.check_packed_kernels(torch, K, errs, Geometry(512, 1, ANGLES180, COR[cor], 512), dev,
                            seed=81 + seed)


def test_k1p_shapes(errs, dev):
    CS.check_k1p_shapes(torch, K, errs, dev)


def test_k4p_shapes(errs, dev):
    CS.check_k4p_shapes(torch, K, errs, dev)


@pytest.mark.parametrize("nz,seed,phase", [(8, 4, "4"), (1, 80, "8")])
def test_adjointness(dev, nz, seed, phase):
    """Phases 4 and 8: |<Ax,y> - <x,A^T y>| / |<Ax,y>| <= 1e-5 at both centre
    offsets, on their own draws."""
    CS.check_adjointness(
        torch, {k: Geometry(512, nz, ANGLES180, cor, 512) for k, cor in COR.items()}, dev,
        seed, phase)


def rel_l2(got, ref) -> float:
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    assert bool(torch.isfinite(got).all())
    assert got.shape == ref.shape
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


@pytest.fixture(scope="module")
def slice_runs(dev):
    """Phases 5 and 7's GPU-against-CPU runs at 256^2 x 4 x 90: 3D FISTA
    (OS5, PWLS, nonneg, PD-TV 20, 3 iterations), FBP and FOURIER_INV on
    the card and on the CPU."""
    angles = np.linspace(0.0, np.pi, 90, endpoint=False)
    sino = radon_fp(torch.as_tensor(CS.phantom(256, 4), device=dev),
                    Geometry(256, 4, angles, 0.0, 256))
    lc = RecToolsIRCuPy(256, 0, 4, 0.0, angles, 256, OS_number=5).powermethod(
        {"projection_data": sino})
    out = {}
    for name, device, data in (("cpu", "cpu", sino.cpu()), ("gpu", dev, sino)):
        rt = RecToolsIRCuPy(256, 0, 4, 0.0, angles, 256, OS_number=5, device=device)
        rd = RecToolsDIRCuPy(256, 0, 4, 0.0, angles, 256, device=device)
        out[name] = {
            "fista": rt.FISTA({"projection_data": data, "data_fidelity": "PWLS"},
                              {"iterations": 3, "nonnegativity": True, "lipschitz_const": lc},
                              {"method": "PD_TV", "regul_param": 5e-4, "iterations": 20}).cpu(),
            "fbp": rd.FBP(data.transpose(0, 1)).cpu(),
            "fourier_inv": rd.FOURIER_INV(data).cpu(),
        }
    return out


@pytest.mark.parametrize("path", ["fista", "fbp", "fourier_inv"])
def test_gpu_matches_cpu(slice_runs, path):
    assert rel_l2(slice_runs["gpu"][path], slice_runs["cpu"][path]) <= TOL_GPU_CPU


def _artifacts(device, n):
    """A3: the artifacts example's FISTA runs (PWLS, PWLS + Huber, SWLS +
    Huber) on its corrupted data, made once on the CPU."""
    ex = CS.load_example("artifacts3d_swls_huber")
    angles = np.linspace(0, np.pi, int(1.5 * n), endpoint=False)
    ph = ex.shepp_logan(n)[None] * np.asarray([0.95, 1.05], np.float32)[:, None, None]
    sino = ex.corrupted_data(RecToolsIRCuPy(n, 0, 2, 0.0, angles, n, OS_number=10,
                                            device="cpu"), ph)
    rt = RecToolsIRCuPy(n, 0, 2, 0.0, angles, n, OS_number=10, device=device)
    return ex.reconstruct(rt, sino, ph, volumes=True)["volumes"]


def _counts(device, n):
    """A4: OSEM (OS 8), MLEM, FISTA-KL from OSEM and FISTA-LS on the
    example's counts, made once on the CPU."""
    ex = CS.load_example("osem_kl_counts")
    angles = np.linspace(0, np.pi, int(1.5 * n), endpoint=False)
    ph = ex.shepp_logan(n)[None] * np.asarray([0.95, 1.05], np.float32)[:, None, None]
    counts, scale = ex.count_data(RecToolsIRCuPy(n, 0, 2, 0.0, angles, n, OS_number=8,
                                                 device="cpu"), ph, 50.0)
    rt = RecToolsIRCuPy(n, 0, 2, 0.0, angles, n, OS_number=8, device=device)
    rt1 = RecToolsIRCuPy(n, 0, 2, 0.0, angles, n, OS_number=1, device=device)
    return ex.reconstruct(rt, rt1, counts / scale, ph, volumes=True)["volumes"]


def _realdata(device, n):
    """A5: the padded-detector FBP warm start and ADMM-OS24 on the example's
    raw counts (4 slices), normalised once on the host."""
    ex = CS.load_example("realdata_warmstart_admm")
    angles = np.linspace(0, np.pi, 360, endpoint=False).astype(np.float32)
    proj, flats, darks = ex.synth_raw_counts(ex.ellipsoid_phantom(n, 4), angles, "cpu")
    data = ex.normalise(proj, flats, darks, n)
    fbp = ex.warm_start(data, angles, n, device)
    return {"fbp": fbp, "admm": ex.admm(data, fbp, angles, n, device)}


LS_PEAK_COUNTS = 1000.0


def noisy_projections(rt, phantom: np.ndarray, seed: int = 3) -> np.ndarray:
    """The artifacts example's data without its stripes and zingers: the
    phantom's projections through ``rt`` plus the example's Gaussian noise
    (0.3, seed 3), on the host."""
    clean = rt.Atools.fp(torch.as_tensor(phantom, device=rt.device)).cpu().numpy()
    return clean + np.random.default_rng(seed).normal(0, 0.3, clean.shape).astype(np.float32)


def _plain_fidelities(device, n):
    """The examples' plain PWLS (OS 10) and LS (OS 8) FISTA runs with their
    own dicts, on data where they are stable to rounding: PWLS on
    ``noisy_projections``, LS on the counts example's counts at a peak of
    ``LS_PEAK_COUNTS`` instead of 50.  On the examples' own data a 1e-7
    change of the data moves these two runs by about 1e-3 on the CPU alone
    (``tools/torch_example_sensitivity.py``), where a bound of 1e-4 between
    the card and the CPU would say nothing of the kernels."""
    art = CS.load_example("artifacts3d_swls_huber")
    cnt = CS.load_example("osem_kl_counts")
    angles = np.linspace(0, np.pi, int(1.5 * n), endpoint=False)
    ph = art.shepp_logan(n)[None] * np.asarray([0.95, 1.05], np.float32)[:, None, None]
    sino = noisy_projections(RecToolsIRCuPy(n, 0, 2, 0.0, angles, n, device="cpu"), ph)
    counts, scale = cnt.count_data(RecToolsIRCuPy(n, 0, 2, 0.0, angles, n, device="cpu"), ph,
                                   LS_PEAK_COUNTS)
    rt10 = RecToolsIRCuPy(n, 0, 2, 0.0, angles, n, OS_number=10, device=device)
    rt8 = RecToolsIRCuPy(n, 0, 2, 0.0, angles, n, OS_number=8, device=device)
    return {
        "pwls": rt10.FISTA({"projection_data": sino, "data_fidelity": "PWLS"},
                           dict(art.ALGORITHM), dict(art.REGULARISATION)).cpu().numpy(),
        "ls": rt8.FISTA({"projection_data": counts / scale}, dict(cnt.FISTA),
                        dict(cnt.REGULARISATION)).cpu().numpy(),
    }


# the paths that the examples bring to the card, by the volumes that hold
# them: the Huber residual and the SWLS weights; OSEM, MLEM and KL; the
# padded warm start and ADMM; and the plain PWLS and LS fidelities, on the
# data of ``_plain_fidelities``.
EXAMPLE_PATHS = {"artifacts3d_swls_huber": (_artifacts, ("huber", "swls")),
                 "osem_kl_counts": (_counts, ("osem", "mlem", "kl")),
                 "realdata_warmstart_admm": (_realdata, ("fbp", "admm")),
                 "plain_fidelities": (_plain_fidelities, ("pwls", "ls"))}


@pytest.fixture(scope="module")
def example_runs(dev):
    runs = {}

    def get(name):
        if name not in runs:
            fn = EXAMPLE_PATHS[name][0]
            runs[name] = {device: fn(device, 64) for device in ("cpu", dev)}
        return runs[name]

    return get


@pytest.mark.parametrize("name,volume", [
    (name, v) for name, (_, volumes) in EXAMPLE_PATHS.items() for v in volumes])
def test_example_path_gpu_matches_cpu(example_runs, dev, name, volume):
    runs = example_runs(name)
    assert rel_l2(runs[dev][volume], runs["cpu"][volume]) <= TOL_GPU_CPU


# the closed-form Radon transform (bench.analytic) at the CPU cross-check's
# size and thresholds, and the kernels each projector pair must launch
ANALYTIC_N, ANALYTIC_NZ, ANALYTIC_COR = 256, 4, 3.5
ANALYTIC_TOL_FP, ANALYTIC_MIN_COR = 0.01, CS.MIN_FLIP
ANALYTIC_PATHS = {"pallas": CS.ANALYTIC_PATH, "xla": ("F", "G")}


@pytest.mark.parametrize("backend", list(ANALYTIC_PATHS))
def test_analytic_crosscheck(dev, monkeypatch, backend):
    from tomobar_tpu_torch.ops import projector as TP

    monkeypatch.setattr(TP, "_BACKEND", TP._BACKEND)
    TP.set_projector_backend(backend)
    CS.analytic_crosscheck(torch, dev, ANALYTIC_N, ANALYTIC_NZ,
                           np.linspace(0.0, np.pi, 360, endpoint=False), ANALYTIC_COR,
                           ANALYTIC_TOL_FP, ANALYTIC_MIN_COR, ANALYTIC_PATHS[backend],
                           tag=f"[lane, {backend}]")
