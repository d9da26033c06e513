#!/usr/bin/env python3
"""Spread of the centre-of-rotation estimate on ``chip_smoke.py`` phase 13's
raw model, over noise seeds.

Projects phase 6's phantom (8 x 2560^2 by default) at the two angles of a
1801-angle [0, pi) scan that lie nearest pi apart (the only rows the
mirror-correlation estimator reads), makes raw counts with phase 13's
``raw_stack`` (flat x exp(-p), Poisson at 1e4 photons, dark frames, 20 flats,
10 darks) for each seed, normalises them and runs
``find_center_correlation`` with the JAX package's defaults and with
``stack=True``::

    python3 tools/torch_centre_spread.py [--seeds 8] [--n 2560] [--device cpu]

Prints each seed's errors and their root mean square.  Runs on the CPU in
about a minute at the default size.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    import chip_smoke as CS
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import radon_fp
    from tomobar_tpu_torch.utils.center import find_center_correlation
    from tomobar_tpu_torch.utils.tools import normaliser

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--n", type=int, default=2560)
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    dev = torch.device(args.device)
    n_angles = 1801
    angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)[[0, n_angles - 1]]
    truth = torch.as_tensor(CS.phantom(args.n, args.nz), device=dev)
    clean = radon_fp(truth, Geometry(args.n, args.nz, angles, CS.C_TRUE, args.n)) * (2.0 / args.n)
    print(f"{args.nz} x {args.n}^2 phantom, rows 0 and {n_angles - 1} of {n_angles} angles, "
          f"CoR offset {CS.C_TRUE} px; clean, stack=True: "
          f"{find_center_correlation(clean, angles, stack=True) - CS.C_TRUE:+.4f}")
    errors = []
    for seed in range(args.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        raw, flats, darks, _ = CS.raw_stack(torch, clean, gen)
        stack = normaliser(raw, flats, darks).transpose(0, 1)  # [detY, angles, detX]
        errors.append([find_center_correlation(stack, angles) - CS.C_TRUE,
                       find_center_correlation(stack, angles, stack=True) - CS.C_TRUE])
        print(f"seed {seed}: error of the JAX package's estimator {errors[-1][0]:+.4f} px, "
              f"stack=True {errors[-1][1]:+.4f} px")
    rms = np.sqrt(np.mean(np.square(errors), axis=0))
    print(f"RMS over {args.seeds} seeds: JAX package's {rms[0]:.4f} px, stack=True {rms[1]:.4f} px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
