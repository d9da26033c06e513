#!/usr/bin/env python3
"""3D phantom -> noisy projections -> FBP, FOURIER_INV and FISTA-OS-TV.

The port's counterpart of ``examples/phantom3d_fista_os_tv.py`` (the
reference workflow of ``Demos/tomophantom_3D_recon1.py``): an ellipsoid
stack, its projections with Poisson counting noise in intensity space,
FBP and FOURIER_INV as direct baselines, then FISTA with 8 ordered subsets
and a PD-TV prox, each scored by its rel-RMSE against the phantom.  On the
card: K1-K4 and PD (FISTA), K3/K4 and F (FBP's filter), G and F
(FOURIER_INV).

Run (``cuda:0``; ``--device cpu`` runs the plain PyTorch versions):

    python examples/torch/phantom3d_fista_os_tv.py [--device cpu]
"""

import os
import sys
import timeit

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import (  # noqa: E402
    arguments, ellipsoid_phantom, example_device, example_size, rel_rmse)

from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy  # noqa: E402


def main(N=None, nz=None, device=None) -> dict:
    """Runs the example at ``N`` x ``nz`` (default ``TOMOBAR_EXAMPLE_N`` /
    ``_NZ``, else 256 / 8) and returns the rel-RMSEs it prints (FOURIER_INV's
    after the scalar fit)."""
    N_size = example_size(N, "TOMOBAR_EXAMPLE_N", 256)
    nz = example_size(nz, "TOMOBAR_EXAMPLE_NZ", 8)
    dev = example_device(device)
    angles_num = int(0.5 * np.pi * N_size)
    angles = np.linspace(0.0, np.pi, angles_num, endpoint=False).astype(np.float32)

    print(f"Building {nz}x{N_size}^2 phantom, {angles_num} angles")
    phantom = ellipsoid_phantom(N_size, nz)

    # forward project + Poisson counting noise in intensity space
    rec_dir = RecToolsDIRCuPy(N_size, 0, nz, 0.0, angles, N_size, device=dev)
    sino_clean = rec_dir.FORWPROJ(
        phantom, data_axes_labels_order=["detY", "angles", "detX"]).cpu().numpy()
    rng = np.random.default_rng(0)
    I0 = 8000.0
    counts = rng.poisson(I0 * np.exp(-sino_clean / N_size * 4.0))
    sino = (-np.log(np.maximum(counts, 1) / I0) * N_size / 4.0).astype(np.float32)

    # direct baselines.  cutoff 1.1 is the amplitude-true sinc setting;
    # FOURIER_INV keeps the reference's log-polar output scale (~2.5x FBP),
    # so its RMSE is reported after a least-squares scalar fit.
    t0 = timeit.default_timer()
    fbp = rec_dir.FBP(np.swapaxes(sino, 0, 1), cutoff_freq=1.1).cpu().numpy()
    t_fbp = timeit.default_timer() - t0
    t0 = timeit.default_timer()
    lprec = rec_dir.FOURIER_INV(sino, filter_type="shepp").cpu().numpy()
    t_fi = timeit.default_timer() - t0
    scale = float((lprec * phantom).sum() / np.maximum((lprec**2).sum(), 1e-30))
    out = {"fbp": rel_rmse(fbp, phantom), "fourier_inv": rel_rmse(scale * lprec, phantom)}
    print(f"FBP          rel-RMSE {out['fbp']:.4f}  ({t_fbp:.2f} s)")
    print(f"FOURIER_INV  rel-RMSE {out['fourier_inv']:.4f}"
          f"  (scalar-fitted x{scale:.3f}, {t_fi:.2f} s)")

    # FISTA-OS-TV (the flagship iterative config)
    rec_it = RecToolsIRCuPy(N_size, 0, nz, 0.0, angles, N_size, OS_number=8, device=dev)
    _data_ = {"projection_data": sino, "data_fidelity": "LS"}
    _algorithm_ = {"iterations": 12, "nonnegativity": True}
    _regularisation_ = {"method": "PD_TV", "regul_param": 2e-4, "iterations": 30}
    t0 = timeit.default_timer()
    rec = rec_it.FISTA(_data_, _algorithm_, _regularisation_).cpu().numpy()
    t_fista = timeit.default_timer() - t0
    out["fista"] = rel_rmse(rec, phantom)
    print(f"FISTA-OS8-TV rel-RMSE {out['fista']:.4f}  ({t_fista:.2f} s)")
    return out


if __name__ == "__main__":
    main(**arguments(__doc__))
