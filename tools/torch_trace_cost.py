#!/usr/bin/env python3
"""What a span of ``tomobar_tpu_torch.trace`` costs the host, off and on.

    python3 tools/torch_trace_cost.py            # from the repository root

Off (no profiler records): the nanoseconds that ``with span(name):`` and
``with span(name, nz=.., n=..):`` add to an empty function, beside the
read of ``torch.autograd.profiler._is_profiler_enabled`` alone.  On (under
``torch.profiler`` with CPU and, where there is a card, CUDA activities):
the microseconds of one span around nothing, of its
``record_function`` range alone and of its two timestamps alone (a CUDA
event pair on a card, the host clock otherwise).  Each figure is the
least of 5 repeats.  Prints one JSON object, with the card's name and
power limit where there is one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ns(fn, number: int) -> float:
    return min(timeit.repeat(fn, number=number, repeat=5)) / number * 1e9


def main() -> int:
    import torch
    from torch.autograd import profiler as _profiler

    from tomobar_tpu_torch import trace

    cuda = torch.cuda.is_available()
    out = {"device": "cpu", "torch": torch.__version__}
    if cuda:
        torch.cuda.init()
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()

    def empty(n=3):
        pass

    def flag(n=3):
        if _profiler._is_profiler_enabled:
            pass

    def bare(n=3):
        with trace.span("tomobar::cost"):
            pass

    def attrs(n=3):
        with trace.span("tomobar::cost", nz=n, n=n):
            pass

    number = 1_000_000
    base = _ns(empty, number)
    out["off_ns"] = {"flag": _ns(flag, number) - base, "span": _ns(bare, number) - base,
                     "span_with_2_attrs": _ns(attrs, number) - base}

    def range_only():
        with _profiler.record_function("tomobar::cost"):
            pass

    def marks_only():
        if cuda:
            stream = torch.cuda.current_stream()
            return trace._event(stream), trace._event(stream)
        return time.perf_counter_ns(), time.perf_counter_ns()

    number = 2000
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        on = {"span": _ns(bare, number) / 1e3, "record_function": _ns(range_only, number) / 1e3,
              "two_marks": _ns(marks_only, number) / 1e3}
        trace.reset()
    if cuda:
        torch.cuda.synchronize()
    out["on_us"] = on
    trace.reset()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
