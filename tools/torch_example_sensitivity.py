#!/usr/bin/env python3
"""How far the examples' FISTA runs move when their data move by 1e-7, and why.

The GPU lane holds the examples' paths on the card to their CPU results
within 1e-4 rel L2 (``tests/test_torch_hardware.py``).  That bound says
something about the kernels only where the run itself is stable to
rounding.  This script runs FISTA at 64^2 twice, the second time on data
multiplied by ``1 + 1e-7 * noise`` (seed 0), and prints the rel L2 between
the two reconstructions:

* each FISTA fidelity of ``examples/torch/artifacts3d_swls_huber.py`` and
  ``examples/torch/osem_kl_counts.py`` on the example's own data;
* the plain PWLS and LS runs again with one thing changed (no
  nonnegativity bound, no regulariser, one subset), to find what carries
  the growth, and the PWLS weights' range;
* the same two runs in lock step, the changed one clamped by the first
  run's nonnegativity mask, so that no voxel's clamp differs between them:
  growth there is the iteration's own, not a clamp that flips;
* the lane's settings for PWLS and LS (``noisy_projections`` and
  ``LS_PEAK_COUNTS`` in the lane's file).

A run that moves by more than 1e-4 amplifies a change of rounding beyond
the lane's bound on one device alone.

Usage:  python3 tools/torch_example_sensitivity.py --device cpu
"""

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import chip_smoke  # noqa: E402
import test_torch_hardware as lane  # noqa: E402
from tomobar_tpu_torch import RecToolsIRCuPy  # noqa: E402
from tomobar_tpu_torch.fidelity import grad_data_term  # noqa: E402
from tomobar_tpu_torch.solvers import core  # noqa: E402

N, EPS = 64, 1e-7


def changed(b: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(0)
    return (b * (1 + EPS * rng.standard_normal(b.shape))).astype(np.float32)


def moved(rt, data: dict, algorithm: dict, regularisation) -> float:
    """rel L2 between FISTA on ``data`` and on its projection data
    multiplied by ``1 + EPS * noise``."""
    b = np.asarray(data["projection_data"], np.float32)
    recs = [rt.FISTA(dict(data, projection_data=d), dict(algorithm),
                     dict(regularisation) if regularisation else None).cpu().numpy()
            for d in (b, changed(b))]
    return float(np.linalg.norm(recs[1] - recs[0]) / np.linalg.norm(recs[0]))


def shared_active_set(rt, b: np.ndarray, fidelity: str, algorithm: dict,
                      regularisation: dict) -> list:
    """``solvers.core.fista`` on ``b`` and on ``changed(b)`` in lock step,
    both clamped by the first run's nonnegativity mask; the rel L2 between
    them after each outer iteration."""
    _, a, r = rt._prep_data({"projection_data": b}, dict(algorithm), dict(regularisation), "FISTA")
    prox, proj = rt._regul_fn(r), rt.Atools
    step = float(np.float32(1.0 / rt.powermethod({"projection_data": b})))
    runs = []
    for d in (b, changed(b)):
        d = torch.as_tensor(d, device=rt.device)
        subs, w_subs = core._subset_slices(proj, d, core._prepare_weights(proj, d, fidelity, {}))
        x = torch.zeros(rt.vol_shape, device=rt.device)
        runs.append({"subs": subs, "w": w_subs, "x": x, "x_t": x})
    t, gaps = np.float32(1.0), []
    for _ in range(a["iterations"]):
        for s in range(len(proj.subset_indices)):
            mask = None
            for run in runs:
                free = run["x_t"] - step * grad_data_term(
                    proj, run["x_t"], run["subs"][s], sub_ind=s, w=run["w"][s], fidelity=fidelity)
                mask = (free > 0).to(free.dtype) if mask is None else mask
                run["x_old"], run["x"] = run["x"], prox(free * mask)
            t_old, t = t, np.float32((1 + np.sqrt(1 + 4 * t * t)) * 0.5)
            for run in runs:
                run["x_t"] = run["x"] + float(np.float32((t_old - 1) / t)) * (run["x"] - run["x_old"])
        x0, x1 = runs[0]["x"], runs[1]["x"]
        gaps.append(float((x1 - x0).norm() / x0.norm()))
    return gaps


def report(label: str, rel: float) -> None:
    print(f"{label}: moved {rel:.3e} rel L2 for {EPS:g} of the data", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", required=True, help="torch device, e.g. cpu or cuda:0")
    device = torch.device(parser.parse_args().device)
    angles = np.linspace(0, np.pi, int(1.5 * N), endpoint=False)

    art = chip_smoke.load_example("artifacts3d_swls_huber")
    phantom = art.shepp_logan(N)[None] * np.asarray([0.95, 1.05], np.float32)[:, None, None]
    rt10 = RecToolsIRCuPy(N, 0, 2, 0.0, angles, N, OS_number=10, device=device)
    rt1 = RecToolsIRCuPy(N, 0, 2, 0.0, angles, N, OS_number=1, device=device)
    sino = art.corrupted_data(rt10, phantom)
    for label, fidelity in art.fidelities():
        report(label, moved(rt10, dict(fidelity, projection_data=sino), art.ALGORITHM,
                            art.REGULARISATION))
    w = core._prepare_pwls_weights(rt10.Atools, torch.as_tensor(sino, device=device))
    print(f"PWLS weights: min {float(w.min()):.3e}, median {float(w.median()):.3e}, "
          f"max {float(w.max()):.3e}")

    cnt = chip_smoke.load_example("osem_kl_counts")
    rt8 = RecToolsIRCuPy(N, 0, 2, 0.0, angles, N, OS_number=8, device=device)
    counts, scale = cnt.count_data(rt8, phantom, 50.0)
    b = counts / scale
    osem = rt8.OSEM({"projection_data": b}, dict(cnt.OSEM)).cpu().numpy()
    report("FISTA-OS8-KL-TV", moved(rt8, {"projection_data": b, "data_fidelity": "KL"},
                                    dict(cnt.FISTA, initialise=osem), cnt.REGULARISATION))
    report("FISTA-OS8-LS-TV", moved(rt8, {"projection_data": b}, cnt.FISTA, cnt.REGULARISATION))

    pwls = {"projection_data": sino, "data_fidelity": "PWLS"}
    free = dict(art.ALGORITHM, nonnegativity=False)
    report("FISTA-PWLS-TV without the nonnegativity bound",
           moved(rt10, pwls, free, art.REGULARISATION))
    report("FISTA-PWLS without the regulariser", moved(rt10, pwls, art.ALGORITHM, None))
    report("FISTA-PWLS-TV at OS 1", moved(rt1, pwls, art.ALGORITHM, art.REGULARISATION))
    report("FISTA-OS8-LS-TV (counts) without the nonnegativity bound",
           moved(rt8, {"projection_data": b}, dict(cnt.FISTA, nonnegativity=False),
                 cnt.REGULARISATION))
    for label, rt, data, fidelity, algorithm, regularisation in (
        ("FISTA-PWLS-TV", rt10, sino, "PWLS", art.ALGORITHM, art.REGULARISATION),
        ("FISTA-OS8-LS-TV (counts)", rt8, b, "LS", cnt.FISTA, cnt.REGULARISATION),
    ):
        gaps = shared_active_set(rt, data, fidelity, algorithm, regularisation)
        print(f"{label}, the first run's active set shared, after each outer iteration: "
              + " ".join(f"{g:.2e}" for g in gaps), flush=True)

    report("the lane's FISTA-PWLS-TV (noise only)",
           moved(rt10, dict(pwls, projection_data=lane.noisy_projections(rt10, phantom)),
                 art.ALGORITHM, art.REGULARISATION))
    counts, scale = cnt.count_data(rt8, phantom, lane.LS_PEAK_COUNTS)
    report(f"the lane's FISTA-OS8-LS-TV (peak {lane.LS_PEAK_COUNTS:g} counts)",
           moved(rt8, {"projection_data": counts / scale}, cnt.FISTA, cnt.REGULARISATION))


if __name__ == "__main__":
    main()
