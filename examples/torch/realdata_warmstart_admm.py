#!/usr/bin/env python3
"""Production pattern: normalise raw counts -> FBP warm start -> ADMM-OS24.

The port's counterpart of ``examples/realdata_warmstart_admm.py`` (the
reference's real-data recipe, ``Demos/RealData.py:228-235``): flat/dark
normalisation with the -log transform, an FBP on the padded detector (the
grid enlarged by the padding on each side) as the ADMM initialiser, then 2
outer ADMM iterations with 24 ordered subsets, PWLS fidelity,
over-relaxation 1.7 and a PD-TV prox.  The raw counts are synthesised
(a phantom's projections through flats and darks), so the script runs
self-contained.

Run (``cuda:0``; ``--device cpu`` runs the plain PyTorch versions):

    python examples/torch/realdata_warmstart_admm.py [--device cpu]
"""

import os
import sys
import timeit

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import (  # noqa: E402
    arguments, ellipsoid_phantom, example_device, example_size, rel_rmse)

from tomobar_tpu_torch import RecToolsDIR, RecToolsDIRCuPy, RecToolsIRCuPy  # noqa: E402
from tomobar_tpu_torch.utils.tools import normaliser  # noqa: E402

PAD = 24  # horizontal detector padding of the warm start and of ADMM
ALGORITHM = {
    "iterations": 2,
    "ADMM_rho_const": 0.9,
    "ADMM_relax_par": 1.7,
    "recon_mask_radius": 2.0,  # radius > 1: no cropping (suppTools.py:387)
}
REGULARISATION = {"method": "PD_TV", "regul_param": 3e-4, "iterations": 40}


def synth_raw_counts(phantom, angles, device, I0=6000.0, n_flats=20, n_darks=10):
    """Raw projections/flats/darks (angles, detY, detX) like a beamline."""
    nz, N, _ = phantom.shape
    rt = RecToolsDIR(N, 0, nz, 0.0, angles, N, device=device)
    sino = np.asarray(
        rt.FORWPROJ(phantom, data_axes_labels_order=["detY", "angles", "detX"])
    )
    rng = np.random.default_rng(1)
    flat_field = I0 * (1.0 + 0.05 * rng.standard_normal((nz, N)))
    dark_field = 40.0 * np.ones((nz, N))
    intensity = (
        flat_field[:, None, :] * np.exp(-sino / N * 4.0) + dark_field[:, None, :]
    )
    proj = rng.poisson(np.swapaxes(intensity, 0, 1)).astype(np.float32)
    flats = rng.poisson(flat_field[None] + dark_field[None], (n_flats, nz, N)).astype(np.float32)
    darks = rng.poisson(dark_field[None] * np.ones((n_darks, nz, N))).astype(np.float32)
    return proj, flats, darks


def normalise(proj, flats, darks, N: int) -> np.ndarray:
    """Flat/dark normalisation + -log (``normaliser`` reduces the stacks
    along axis 0), to (detY, angles, detX) in the projector's scale."""
    data_norm = normaliser(proj, flats, darks, log=True, method="mean")
    # -> (detY, angles, detX), undo the attenuation scaling
    return np.ascontiguousarray(np.swapaxes(data_norm, 0, 1) * N / 4.0)


def warm_start(data_norm, angles, N: int, device) -> np.ndarray:
    """FBP on the padded detector: a (detY, N + 2 PAD, N + 2 PAD) volume
    (the reference feeds the padded-grid FBP to ADMM)."""
    nz = data_norm.shape[0]
    rec_dir = RecToolsDIRCuPy(N, PAD, nz, 0.0, angles, N + 2 * PAD, device=device)
    return rec_dir.FBP(np.swapaxes(data_norm, 0, 1), cutoff_freq=1.1).cpu().numpy()


def admm(data_norm, fbp_warm, angles, N: int, device, iterations=None,
         rec_it=None) -> np.ndarray:
    """ADMM-OS24 warm-started from the padded-grid FBP (``ALGORITHM``, with
    ``iterations`` outer iterations when given), on the padded detector;
    returns the N x N volume.  ``rec_it``: an instance to reuse (its
    Lipschitz constant is computed once)."""
    nz = data_norm.shape[0]
    if rec_it is None:
        rec_it = RecToolsIRCuPy(N, PAD, nz, 0.0, angles, N, OS_number=24, device=device)
    algorithm = dict(ALGORITHM, initialise=fbp_warm)  # padded-grid volume
    if iterations is not None:
        algorithm["iterations"] = iterations
    return rec_it.ADMM({"projection_data": data_norm, "data_fidelity": "PWLS"},
                       algorithm, dict(REGULARISATION)).cpu().numpy()


def main(N=None, nz=None, device=None) -> dict:
    """Runs the example at ``N`` x ``nz`` (default ``TOMOBAR_EXAMPLE_N`` /
    ``_NZ``, else 256 / 8) and returns the rel-RMSEs it prints (``fbp`` of
    the warm start inside the padding, ``admm``)."""
    N_size = example_size(N, "TOMOBAR_EXAMPLE_N", 256)
    nz = example_size(nz, "TOMOBAR_EXAMPLE_NZ", 8)
    dev = example_device(device)
    angles = np.linspace(0, np.pi, 360, endpoint=False).astype(np.float32)
    phantom = ellipsoid_phantom(N_size, nz)
    proj, flats, darks = synth_raw_counts(phantom, angles, dev)
    data_norm = normalise(proj, flats, darks, N_size)

    t0 = timeit.default_timer()
    fbp_warm = warm_start(data_norm, angles, N_size, dev)
    t_fbp = timeit.default_timer() - t0
    print(f"warm-start FBP done ({t_fbp:.2f} s), grid {fbp_warm.shape}")

    # ADMM-OS24, 2 outer iterations, warm-started (RealData.py:228-235)
    t0 = timeit.default_timer()
    rec = admm(data_norm, fbp_warm, angles, N_size, dev)
    t_admm = timeit.default_timer() - t0

    inner = fbp_warm[:, PAD:-PAD, PAD:-PAD] if PAD else fbp_warm
    out = {"fbp": rel_rmse(inner, phantom), "admm": rel_rmse(rec, phantom)}
    print(f"FBP warm start rel-RMSE {out['fbp']:.4f}")
    print(f"ADMM-OS24 x2   rel-RMSE {out['admm']:.4f}  ({t_admm:.2f} s)")
    return out


if __name__ == "__main__":
    main(**arguments(__doc__))
