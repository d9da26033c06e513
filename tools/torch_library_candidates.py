#!/usr/bin/env python3
"""Whether one PyTorch call computes a kernel's function: K2 (the 2-tap
linear resample, ``resample_fp``) against ``torch.nn.functional.grid_sample``
on a one-row grid (bilinear, zero padding, ``align_corners=True``), on the
flagship's OS subset-0 groups (2560^2, 1801 angles, OS10; one slice, since
the function is the same for every slice).

grid_sample takes positions normalised to [-1, 1] and, in float32, rounds
them to about one part in 2^24 of the row: for rows of LU = 5760 that is
an error of ~3e-4 of a tap in the interpolation weights.  K2 also scales by
|alpha| per angle, which grid_sample does not, so the library route is two
calls (grid_sample, then the scale).  Prints each group's max |grid_sample
- plain| / max |plain| in float32 and in float64, on the CPU (the plain
version is the kernel's reference, bit for bit on the card).

    python3 tools/torch_library_candidates.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops import projector_kernels as K
    from tomobar_tpu_torch.ops.projector import Projector

    N, NA, OS = 2560, 1801, 10
    angles = np.linspace(0.0, np.pi, NA, endpoint=False)
    proj = Projector(Geometry(N, 1, angles, 0.0, N, os_number=OS))
    sub0 = Projector(proj._sub_geoms[0])
    gen = torch.Generator().manual_seed(0)
    for g in sub0._plan.groups(N, N, torch.device("cpu")):
        A, LU, U0 = g.prm.A, g.prm.LU, g.prm.U0
        s = torch.rand((A, 1, LU), generator=gen)
        ref = K.resample_fp_plain(s, g.alpha, g.gamma, U0, N)
        pos = (U0 + g.gamma)[:, None] + g.alpha[:, None] * torch.arange(N, dtype=torch.float32)
        errs = {}
        for dt in (torch.float32, torch.float64):
            x = 2.0 * pos.to(dt) / (LU - 1) - 1.0
            grid = torch.stack([x, torch.zeros_like(x)], -1)[:, None]  # (A, 1, det_x, 2)
            out = torch.nn.functional.grid_sample(s.to(dt)[:, :, None, :], grid, mode="bilinear",
                                                  padding_mode="zeros", align_corners=True)
            p = (out[:, :, 0, :] * g.alpha.abs().to(dt)[:, None, None]).transpose(0, 1).float()
            errs[str(dt).split(".")[-1]] = float((p - ref).abs().max() / ref.abs().max())
        print(f"K2 {'y' if g.swap else 'x'}-driven, {A} angles, LU {LU}: grid_sample x |alpha| "
              f"against the plain version, max |diff| / max |plain|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (needed: 1e-6)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
