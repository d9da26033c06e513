#!/usr/bin/env python3
"""Artifact-robust reconstruction: SWLS + Huber on corrupted 3D data.

The port's counterpart of ``examples/artifacts3d_swls_huber.py`` (the
reference's ``Demos/methods_IR_legacy/DemoFISTA_artifacts3D.py:204-298``):
projections with noise, **stripes** (a few detector columns with a
persistent offset, which back-project into rings) and **zingers**
(isolated huge hits), then three FISTA-OS-TV runs that compare the
fidelities: plain PWLS, PWLS with a Huber residual (clips the zingers) and
SWLS with a Huber residual (also down-weights the stripes' columns).

Run (``cuda:0``; ``--device cpu`` runs the plain PyTorch versions):

    python examples/torch/artifacts3d_swls_huber.py [--device cpu]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arguments, example_device, example_size, rel_rmse, shepp_logan  # noqa: E402

from tomobar_tpu_torch import RecToolsIRCuPy  # noqa: E402

ALGORITHM = {"iterations": 20, "nonnegativity": True}
REGULARISATION = {"method": "PD_TV", "regul_param": 3e-4, "iterations": 40}


def fidelities(scale: float = 1.0) -> tuple:
    """The three fidelities compared, as (printed label, data dict without
    the data); ``scale`` multiplies the Huber threshold as it does the
    artifacts (``add_artifacts``)."""
    huber = 1.5 * scale
    return (
        ("FISTA-PWLS-TV", {"data_fidelity": "PWLS"}),
        ("FISTA-PWLS-Huber-TV", {"data_fidelity": "PWLS", "huber_threshold": huber}),
        ("FISTA-SWLS-Huber-TV", {"data_fidelity": "SWLS", "beta_SWLS": 0.2,
                                 "huber_threshold": huber}),
    )


def add_artifacts(sino: np.ndarray, rng, scale: float = 1.0) -> np.ndarray:
    """Noise + stripes + zingers (the DemoFISTA_artifacts3D recipe,
    rebuilt: the reference uses TomoPhantom's artefacts module).  The
    amplitudes are the JAX example's times ``scale``: the example keeps 1 at
    every N; a sinogram of N / 256 times its peak keeps their proportion
    with ``scale = N / 256``."""
    nz, nang, ndet = sino.shape
    out = sino + rng.normal(0, 0.3 * scale, sino.shape).astype(np.float32)
    # stripes: 4 random detector columns per slice, persistent offset
    for z in range(nz):
        cols = rng.choice(ndet, size=4, replace=False)
        out[z, :, cols] += (scale * rng.uniform(1.5, 3.0, size=(4, 1))).astype(np.float32)
    # zingers: 60 isolated huge hits
    zi = rng.integers(0, nz, 60), rng.integers(0, nang, 60), rng.integers(0, ndet, 60)
    out[zi] += (scale * rng.uniform(20.0, 60.0, 60)).astype(np.float32)
    return out


def corrupted_data(rt, phantom: np.ndarray, seed: int = 3, scale: float = 1.0) -> np.ndarray:
    """The phantom's projections through ``rt``'s projector with noise,
    stripes and zingers (``add_artifacts`` at ``scale``, seed ``seed``), on
    the host."""
    import torch

    clean = rt.Atools.fp(torch.as_tensor(phantom, device=rt.device)).cpu().numpy()
    return add_artifacts(clean, np.random.default_rng(seed), scale)


def reconstruct(rt, sino, phantom, volumes=False, scale: float = 1.0) -> dict:
    """FISTA with each of ``fidelities(scale)`` on ``sino``; prints and
    returns their rel-RMSEs (keys ``pwls``, ``huber``, ``swls``) and checks
    that the robust fidelities beat plain PWLS.  One instance serves the
    three runs: its Lipschitz constant depends on the geometry only and is
    computed once."""
    out, recs = {}, {}
    for (label, fidelity), key in zip(fidelities(scale), ("pwls", "huber", "swls")):
        recs[key] = rt.FISTA(dict(fidelity, projection_data=sino), dict(ALGORITHM),
                             dict(REGULARISATION)).cpu().numpy()
        out[key] = rel_rmse(recs[key], phantom)
        print(f"{label + ' ':24s}rel-RMSE: {out[key]:.4f}")
    assert out["swls"] < out["pwls"], (
        "robust fidelities should beat plain PWLS on corrupted data"
    )
    if volumes:
        out["volumes"] = recs
    return out


def main(N=None, nz=None, device=None) -> dict:
    """Runs the example at ``N`` (default ``TOMOBAR_EXAMPLE_N``, else 256)
    on 2 slices (``nz`` is not used, as in the JAX example) and returns its
    rel-RMSEs."""
    del nz
    N = example_size(N, "TOMOBAR_EXAMPLE_N", 256)
    dev = example_device(device)
    nz = 2
    angles = np.linspace(0, np.pi, int(1.5 * N), endpoint=False)
    phantom = shepp_logan(N)[None] * np.asarray([0.95, 1.05], np.float32)[:, None, None]

    rt = RecToolsIRCuPy(
        DetectorsDimH=N,
        DetectorsDimH_pad=0,
        DetectorsDimV=nz,
        CenterRotOffset=0.0,
        AnglesVec=angles,
        ObjSize=N,
        OS_number=10,
        device=dev,
    )
    sino = corrupted_data(rt, phantom)
    print(f"{nz}x{N}^2 phantom, {len(angles)} angles, stripes + zingers")
    return reconstruct(rt, sino, phantom)


if __name__ == "__main__":
    main(**arguments(__doc__))
