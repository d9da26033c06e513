#!/usr/bin/env python3
"""Where a 2D FISTA call of tomobar_tpu_torch spends its time on one NVIDIA GPU.

Runs ``RecToolsIRCuPy.FISTA`` (OS10, LS, nonneg, PD-TV 20) on one 2560^2
slice x 1801 angles for 1, 2 and 3 outer iterations, each between CUDA
events and under a host clock, then the 1-iteration call once more under
``torch.profiler`` (CPU and CUDA activities)::

    python3 tools/torch_profile_2d.py            # from the repository root

It prints the card's name and power limit, per call the time between the
events and on the host's clock, and from the profile: the device's busy
time (sum of kernel and memcpy durations), the host operators by their own
CPU time, the device kernels by their time, and the gaps of the device
timeline longer than a millisecond with the host operator that was running
when each began.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    N, NA, OS = 2560, 1801, 10
    angles = np.linspace(0.0, np.pi, NA, endpoint=False)
    yy, xx = np.mgrid[-1:1:N * 1j, -1:1:N * 1j]
    truth = torch.as_tensor(((xx / 0.7) ** 2 + (yy / 0.9) ** 2 <= 1.0).astype(np.float32), device=dev)
    data = RecToolsDIRCuPy(N, 0, None, 0.0, angles, N, device=dev).FORWPROJ(truth)
    rt = RecToolsIRCuPy(N, 0, None, 0.0, angles, N, OS_number=OS, device=dev)
    lc = rt.powermethod({"projection_data": data})
    reg = {"method": "PD_TV", "regul_param": 5e-4, "iterations": 20}

    def call(iters):
        return rt.FISTA({"projection_data": data},
                        {"iterations": iters, "nonnegativity": True, "lipschitz_const": lc},
                        dict(reg))

    for rnd in range(2):
        for iters in (1, 2, 3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            call(iters)
            end.record()
            t_enqueued = time.perf_counter() - t0
            torch.cuda.synchronize()
            print(f"round {rnd}: FISTA {iters} outer iteration(s): {start.elapsed_time(end):.2f} ms "
                  f"between events, host returned after {t_enqueued * 1e3:.2f} ms, "
                  f"{(time.perf_counter() - t0) * 1e3:.2f} ms with the synchronize")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call(1)
        torch.cuda.synchronize()
    events = prof.events()
    dev_ev = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    cpu_ev = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    if not dev_ev:
        print("the profile holds no device activity")
        return 1
    busy = sum(e.time_range.elapsed_us() for e in dev_ev)
    span = dev_ev[-1].time_range.end - dev_ev[0].time_range.start
    print(f"profile of the 1-iteration call: {len(dev_ev)} device activities, busy "
          f"{busy / 1e3:.2f} ms of a span of {span / 1e3:.2f} ms")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=14,
                                    max_name_column_width=60))
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10,
                                    max_name_column_width=60))
    print("gaps of the device timeline over 1 ms (start after the first activity, length, "
          "host operators running at its start, innermost last):")
    for prev, nxt in zip(dev_ev, dev_ev[1:]):
        gap = nxt.time_range.start - prev.time_range.end
        if gap > 1000:
            at = prev.time_range.end
            running = sorted((e for e in cpu_ev if e.time_range.start <= at < e.time_range.end),
                             key=lambda e: e.time_range.start)
            print(f"  +{(at - dev_ev[0].time_range.start) / 1e3:8.2f} ms: {gap / 1e3:7.2f} ms  after "
                  f"{prev.name[:50]}; host: {' > '.join(e.name[:40] for e in running[-3:]) or 'no operator (Python)'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
