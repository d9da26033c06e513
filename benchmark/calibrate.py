#!/usr/bin/env python3
"""Readings that a cell's limit is set from, on the card at the cell's size.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--controls <k>]

For each seed: the cell's inputs, one call of the timed entry point on
each input chunk, and the compared number (the largest rel L2 of the
answers a run would keep against the plain reference): the program's
lower reading.  On the first ``--controls`` seeds also the control's
reading: the reference computed in bfloat16 put in the program's place,
and, for FISTA, the program's own lower-precision path (PD-TV with
bfloat16 duals, ``"half_precision": true``).  One JSON line per seed; the
benchmark's own runs never run this.

Each chunk's call follows the entry's ``warmup`` on it, where the entry has
one (the ADMM entry makes a chunk's raw frames there), and each seed loads
the entry anew, so what it keeps for a seed's chunks goes with them.  A
cell whose ``chips`` is over 1 runs as ``run.py`` runs it: a world of one
process a card (``benchmark/world.py``), in which rank 0 makes the inputs
and broadcasts them, every rank calls the entry on its ``local`` part and
runs the reference on the whole chunk, and rank 0 compares and prints.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import inputs, registry  # noqa: E402
from benchmark.reference.common import rel_l2  # noqa: E402
from benchmark.world import T0, World, launch  # noqa: E402


def readings(cell: str, seeds, controls: int, chunks_read: int = 2, root: Path = ROOT,
             device=None, world: World = None) -> list:
    """The readings of each seed (on a world, rank 0's; the other ranks
    return an empty list)."""
    c = registry.load_cell(root, cell)
    if world is not None:
        device = world.device
    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    lead = world is None or world.rank == 0
    k = int(c.own["answers_kept"])
    lines = []
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        entry = registry.entry(root, c.traffic["entry"])

        def make():
            return inputs.make_chunks(c.config, c.traffic, seed, device)

        chunks = make() if world is None else world.inputs(make)
        local = getattr(entry, "local", None) if world is not None else None
        rng = np.random.default_rng([seed, 2])
        line = {"seed": seed, "program": 0.0}
        ctrl = n < controls
        if ctrl:
            line.update(control_bf16=0.0)
        for chunk in chunks[:chunks_read]:
            mine = chunk if local is None else local(c.config, c.traffic, chunk)
            if hasattr(entry, "warmup"):
                entry.warmup(c.config, c.traffic, mine, device)
            out = entry.call(c.config, c.traffic, mine, device)
            ids = got = None
            if lead:
                count = entry.answer_count(out)
                ids = sorted(rng.choice(count, size=min(k, count), replace=False).tolist())
                got = {j: entry.answer(out, j).to("cpu", copy=True) for j in ids}
            if world is not None:
                ids = world.share(ids)
            del out
            half = None
            if ctrl and c.traffic["entry"] == "FISTA":
                cfg = copy.deepcopy(c.config)
                cfg["FISTA"]["regularisation"]["half_precision"] = True
                half = entry.call(cfg, c.traffic, mine, device)
                half = half.to("cpu") if lead else None
            ref = entry.reference(c.config, c.traffic, chunk, ids)
            low = entry.reference(c.config, c.traffic, chunk, ids, "bf16") if ctrl else None
            if lead:
                line["program"] = max(line["program"], *(rel_l2(got[j], ref[j].cpu()) for j in ids))
                if half is not None:
                    line["control_program_bf16_duals"] = max(
                        line.get("control_program_bf16_duals", 0.0), rel_l2(half, ref[0].cpu()))
                if ctrl:
                    line["control_bf16"] = max(line["control_bf16"],
                                               *(rel_l2(low[j].cpu(), ref[j].cpu()) for j in ids))
            del ref, low, mine
        del chunks, entry
        line["seconds"] = time.perf_counter() - t0
        if lead:
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--chunks", type=int, default=2, help="input chunks read per seed")
    a = ap.parse_args(argv)
    if T0 in os.environ:
        w = World()
        readings(a.workload, a.seeds, a.controls, a.chunks, world=w)
        w.end()
        return 0
    chips = int(registry.load_cell(ROOT, a.workload).cell["chips"])
    if chips > 1:
        rc, lines = launch(Path(__file__).resolve(), sys.argv[1:] if argv is None else list(argv),
                           chips, time.monotonic(), "cuda" if torch.cuda.is_available() else "cpu")
        print("\n".join(lines), flush=True)
        return rc
    readings(a.workload, a.seeds, a.controls, a.chunks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
