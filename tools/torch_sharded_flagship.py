#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone: the sharded layer on the 3D
flagship (1801 angles x 8 x 2560^2, OS10, PWLS, nonneg, PD-TV 20).

Makes phase 6's and phase 7's single-device references on card 0 (the
phantom, the noisy sinogram, the power method's L, FISTA after 1, 2 and 3
outer iterations, ``fp_sub``/``bp_sub`` of subset 0, FOURIER_INV and FBP of
the clean sinogram), then runs ``chip_smoke.sharded_path``: worlds of ranks
on the meshes (2, 1), (1, 2) and (2, 2), with NCCL and one rank per card
where the machine has as many cards as a mesh has ranks, else gloo with
the ranks sharing card 0::

    python3 tools/torch_sharded_flagship.py     # from the repository root

It prints the cards' names and power limits, the single card's FISTA
times, and each rank's launches, outer-iteration times, peak memory and
collective bytes and seconds, and exits non-zero where phase 14 would
fail.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    import chip_smoke as cs

    cs.require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    from tomobar_tpu_torch import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()  # built once, before the ranks start
    t0 = time.perf_counter()
    work, refs, ms = cs.sharded_references(torch, dev)
    print(f"one card: FISTA calls {', '.join(f'{t:.1f}' for t in ms)} ms, per outer "
          f"iteration {ms[2] - ms[1]:.1f} ms (the 3- less the 2-iteration call)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"references on one card: {time.perf_counter() - t0:.1f} s")
    cs.sharded_path(torch, work, refs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
