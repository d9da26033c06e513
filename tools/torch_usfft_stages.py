#!/usr/bin/env python3
"""FOURIER_INV's five stages on the card, from the port's own spans, for
several source trees in one call, in turns.

    git archive <commit> | tar -x -C _archive/parent
    python3 tools/torch_usfft_stages.py --repo . --repo _archive/parent

Each tree runs in a process of its own (its kernel library built from its
sources): ``RecToolsDIRCuPy(...).FOURIER_INV`` with its default keywords on
one chunk of ``--slices`` rows of a 1801 x 2560 scan (random counts on the
card; the stages' times do not depend on the values), one warm-up call,
``--calls`` calls timed between CUDA events with the peak of
``torch.cuda.max_memory_allocated``, then ``--calls`` calls under
``torch.profiler``, read by the tree's
``tomobar_tpu_torch.bench.fourier_breakdown.stage_seconds``: the device
seconds of the spans ``tomobar::usfft.filter``, ``.fft1d``, ``.grid``,
``.ifft2`` and ``.unpad`` (one of each a z-block), summed over the
z-blocks of a call (a tree without that function is run by its own copy
of this tool).  The launches per call come from the kernels' counters.
The first line of output is the card's name and power limit; then one
JSON line per tree and round.  ``--device cpu --slices 4 --width 128`` runs the same on
the CPU at a toy size (host times: no card figure).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def worker(repo: str, slices: int, width: int, nproj: int, calls: int, device: str) -> dict:
    sys.path.insert(0, os.path.abspath(repo))
    import numpy as np
    import torch

    from tomobar_tpu_torch import RecToolsDIRCuPy, _build
    from tomobar_tpu_torch.bench.fourier_breakdown import stage_seconds

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    angles = np.linspace(0.0, np.pi, nproj, endpoint=False)
    gen = torch.Generator(device=dev).manual_seed(18)
    data = torch.rand((slices, nproj, width), generator=gen, device=dev)
    rt = RecToolsDIRCuPy(width, 0, slices, 0.0, angles, width, device=dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rt.FOURIER_INV(data)  # warm-up: tables, plans, the library
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    ms = []
    for _ in range(calls):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            rt.FOURIER_INV(data)
            end.record()
            sync()
            ms.append(start.elapsed_time(end))
        else:
            rt.FOURIER_INV(data)
    launches = {k: v // calls for k, v in _build.launch_counts.items() if v}
    stage_s, spans = stage_seconds(lambda: rt.FOURIER_INV(data), calls)
    return {
        "tree": repo,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu (host times)",
        "call_ms": ms,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
        "z_blocks": spans["filter"],
        "stage_s_per_call": stage_s,
        "launches_per_call": launches,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", action="append", default=[], help="a source tree to run")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--slices", type=int, default=512)
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--angles", type=int, default=1801)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        res = worker(args.worker, args.slices, args.width, args.angles, args.calls, args.device)
        print("RESULT " + json.dumps(res))
        return 0
    if args.device.startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    trees = args.repo or ["."]
    for rnd in range(args.rounds):
        for repo in (trees if rnd % 2 == 0 else trees[::-1]):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", repo,
                 "--calls", str(args.calls), "--slices", str(args.slices), "--width",
                 str(args.width), "--angles", str(args.angles), "--device", args.device],
                capture_output=True, text=True)
            line = [x for x in run.stdout.splitlines() if x.startswith("RESULT ")]
            if run.returncode != 0 or not line:
                print(run.stdout[-2000:], run.stderr[-4000:])
                raise SystemExit(f"{repo}: the worker failed")
            print(json.dumps(dict(json.loads(line[0][7:]), round=rnd)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
