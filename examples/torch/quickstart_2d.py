#!/usr/bin/env python3
"""2D quick-start on PyTorch: phantom -> sinogram -> FBP -> FISTA-TV.

The port's counterpart of ``examples/quickstart_2d.py``, the smallest
end-to-end tour: build a phantom, forward project it, add noise, FBP with
the Shepp-Logan filter, then FISTA with 8 ordered subsets and a PD-TV prox.
On the card one slice runs the packed projector kernels (K1p, K2, K3,
K4p) and the PD-TV kernel.

Run (``cuda:0``; ``--device cpu`` runs the plain PyTorch versions):

    python examples/torch/quickstart_2d.py [--device cpu]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arguments, example_device, example_size, rel_rmse, shepp_logan  # noqa: E402

from tomobar_tpu_torch import RecToolsDIR, RecToolsIRCuPy  # noqa: E402


def main(N=None, nz=None, device=None) -> dict:
    """Runs the tour at ``N`` (default ``TOMOBAR_EXAMPLE_N``, else 256; the
    example is 2D, ``nz`` is not used) and returns the rel-RMSEs it prints."""
    del nz
    N = example_size(N, "TOMOBAR_EXAMPLE_N", 256)
    dev = example_device(device)
    angles = np.linspace(0, np.pi, int(1.5 * N), endpoint=False)
    phantom = shepp_logan(N)

    # --- direct reconstruction (RecToolsDIR surface: numpy in and out) ----
    rt_dir = RecToolsDIR(
        DetectorsDimH=N,
        DetectorsDimH_pad=0,
        DetectorsDimV=None,  # 2D
        CenterRotOffset=0.0,
        AnglesVec=angles,
        ObjSize=N,
        device=dev,
    )
    sino = np.array(rt_dir.FORWPROJ(phantom))
    sino += np.random.default_rng(0).normal(0, 0.5, sino.shape).astype(np.float32)
    fbp = np.asarray(rt_dir.FBP(sino, filter_type="shepp-logan"))

    # --- iterative reconstruction (three-dict API) ------------------------
    rt_it = RecToolsIRCuPy(
        DetectorsDimH=N,
        DetectorsDimH_pad=0,
        DetectorsDimV=None,  # 2D
        CenterRotOffset=0.0,
        AnglesVec=angles,
        ObjSize=N,
        OS_number=8,
        device=dev,
    )
    rec = rt_it.FISTA(
        {"projection_data": sino},
        {"iterations": 15, "nonnegativity": True},
        {"method": "PD_TV", "regul_param": 3e-4, "iterations": 40},
    ).cpu().numpy()

    out = {"fbp": rel_rmse(fbp, phantom), "fista": rel_rmse(rec, phantom)}
    print(f"FBP (shepp-logan filter) rel-RMSE: {out['fbp']:.4f}")
    print(f"FISTA-OS8-TV             rel-RMSE: {out['fista']:.4f}")
    assert out["fista"] < out["fbp"], "iterative recon should beat FBP on noisy data"
    print("quick-start OK")
    return out


if __name__ == "__main__":
    main(**arguments(__doc__))
