#!/usr/bin/env python3
"""OSEM and FISTA-KL on Poisson count data (emission model).

The port's counterpart of ``examples/osem_kl_counts.py``: the two
count-statistics solvers on the model they are derived for,
``counts ~ Poisson(A x)`` with ``x`` a nonnegative activity map:

* **OSEM** (``RecToolsIRCuPy.OSEM``, reference ``methodsIR_CuPy.py:587``),
  multiplicative EM updates over ordered subsets (MLEM with one subset),
  with ``osem_normalisation="divide"`` (textbook EM; the default
  ``"reference"`` keeps the reference's multiply-by-sensitivity quirk);
* **FISTA with the KL fidelity** (gradient ``A^T(1 - b/clip(Ax))`` on the
  pre-log counts), warm-started from OSEM, with a TV prox;
* **FISTA-LS** at the same iteration budget, the Gaussian approximation.

Run (``cuda:0``; ``--device cpu`` runs the plain PyTorch versions):

    python examples/torch/osem_kl_counts.py [--device cpu]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arguments, example_device, example_size, rel_rmse, shepp_logan  # noqa: E402

from tomobar_tpu_torch import RecToolsIRCuPy  # noqa: E402

OSEM = {"iterations": 15, "recon_mask_radius": 2.0, "osem_normalisation": "divide"}
MLEM = {"iterations": 30, "recon_mask_radius": 2.0, "osem_normalisation": "divide"}
FISTA = {"iterations": 20, "nonnegativity": True}
REGULARISATION = {"method": "PD_TV", "regul_param": 3e-4, "iterations": 40}


def count_data(rt, phantom: np.ndarray, peak_counts: float, seed: int = 7):
    """Poisson counts of the phantom's projections through ``rt``'s
    projector, scaled to ``peak_counts`` at the sinogram's peak; returns
    the counts and the scale (host arrays)."""
    import torch

    lam = rt.Atools.fp(torch.as_tensor(phantom, device=rt.device)).cpu().numpy()
    scale = peak_counts / lam.max()
    counts = np.random.default_rng(seed).poisson(lam * scale).astype(np.float32)
    return counts, scale


def reconstruct(rt, rt1, b, phantom, volumes=False) -> dict:
    """OSEM (``rt``'s subsets), MLEM (``rt1``, one subset), FISTA-KL-TV
    warm-started from OSEM and FISTA-LS-TV on the count data ``b`` (in the
    projector's scale); prints and returns their rel-RMSEs."""
    out, recs = {}, {}
    # ---- OSEM: exact EM for Poisson(Ax) ----------------------------------
    recs["osem"] = rt.OSEM({"projection_data": b}, dict(OSEM)).cpu().numpy()
    out["osem"] = rel_rmse(recs["osem"], phantom)
    print(f"OSEM (OS={rt.OS_number}, {OSEM['iterations']} it)      rel-RMSE: {out['osem']:.4f}")

    # ---- MLEM = OSEM with OS_number=1 ------------------------------------
    recs["mlem"] = rt1.OSEM({"projection_data": b}, dict(MLEM)).cpu().numpy()
    out["mlem"] = rel_rmse(recs["mlem"], phantom)
    print(f"MLEM ({MLEM['iterations']} it)            rel-RMSE: {out['mlem']:.4f}")

    # ---- FISTA-KL-TV on the same counts ----------------------------------
    # KL's gradient divides by clip(Ax, 1e-8): a zero initialisation makes
    # the first residual ~1e8x too large, so warm-start from the OSEM
    # estimate (the EM -> regularised refinement pipeline)
    recs["kl"] = rt.FISTA(
        {"projection_data": b, "data_fidelity": "KL"},
        dict(FISTA, initialise=recs["osem"]), dict(REGULARISATION),
    ).cpu().numpy()
    out["kl"] = rel_rmse(recs["kl"], phantom)
    print(f"FISTA-OS{rt.OS_number}-KL-TV ({FISTA['iterations']} it) rel-RMSE: {out['kl']:.4f}")

    # ---- FISTA-LS-TV comparison (Gaussian approximation) -----------------
    recs["ls"] = rt.FISTA({"projection_data": b}, dict(FISTA),
                          dict(REGULARISATION)).cpu().numpy()
    out["ls"] = rel_rmse(recs["ls"], phantom)
    print(f"FISTA-OS{rt.OS_number}-LS-TV ({FISTA['iterations']} it) rel-RMSE: {out['ls']:.4f}")
    if volumes:
        out["volumes"] = recs
    return out


def main(N=None, nz=None, device=None) -> dict:
    """Runs the example at ``N`` (default ``TOMOBAR_EXAMPLE_N``, else 256)
    on 2 slices (``nz`` is not used, as in the JAX example), at
    ``TOMOBAR_EXAMPLE_COUNTS`` (default 50) counts per cell at the peak, and
    returns its rel-RMSEs."""
    del nz
    N = example_size(N, "TOMOBAR_EXAMPLE_N", 256)
    dev = example_device(device)
    nz = 2
    # mean counts per detector cell at the sinogram's peak; lower = noisier
    peak_counts = float(os.environ.get("TOMOBAR_EXAMPLE_COUNTS", 50.0))
    angles = np.linspace(0, np.pi, int(1.5 * N), endpoint=False)
    phantom = shepp_logan(N)[None] * np.asarray([0.95, 1.05], np.float32)[:, None, None]

    rt = RecToolsIRCuPy(
        DetectorsDimH=N,
        DetectorsDimH_pad=0,
        DetectorsDimV=nz,
        CenterRotOffset=0.0,
        AnglesVec=angles,
        ObjSize=N,
        OS_number=8,
        device=dev,
    )
    counts, scale = count_data(rt, phantom, peak_counts)
    print(
        f"{nz}x{N}^2 activity phantom, {len(angles)} angles, "
        f"peak {peak_counts:g} counts/cell "
        f"(total {counts.sum() / 1e6:.1f}M events)"
    )
    # solvers reconstruct in the projector's native scale
    rt1 = RecToolsIRCuPy(N, 0, nz, 0.0, angles, N, OS_number=1, device=dev)
    return reconstruct(rt, rt1, counts / scale, phantom)


if __name__ == "__main__":
    main(**arguments(__doc__))
