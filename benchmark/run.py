#!/usr/bin/env python3
"""The benchmark of ``tomobar_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's input chunks on the card from the seed, warms the
entry point up on them (the entry's ``warmup`` where it has one: the same
shapes for less time) and counts all of that, from the start of the
process, as ``setup_s``.  The window then calls the public entry point on
the chunks in turn, one call after another (a closed loop, as a pipeline
reconstructs a scan chunk by chunk), each call waited for, until
``--seconds`` have passed.  A sample of the answers, drawn from the seed,
is kept on the host; each kept answer is copied, and the copy waited for,
after its call and before the next call starts, so the card is idle when
a call starts.  With ``--trace 1`` the window is the traffic's
``trace_calls`` calls under ``torch.profiler``, with spans around the
layers that the cell's per-layer metrics read; the answers of its last
call are kept once the traced window has closed, so no copy lands in the
trace.  After the window the
program's state is freed, the plain reference (``benchmark/reference/``)
recomputes every kept answer from the same inputs, and ``correct`` says
whether each compared number stays within its limit
(``benchmark/workloads/<cell>.json``).  The last line of standard output is
the result as one JSON object.

The run needs as many CUDA devices as the cell asks for and exits with 2
(printing no result) otherwise.  Its host side runs on one thread (OpenMP,
BLAS and PyTorch's intra-op pool).  It writes nothing but standard output
and standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# kernel caches at fixed places inside the checkout: the port builds with
# nvcc into its own ``_build/``; these hold whatever a Triton kernel or a
# PyTorch extension of a later version of the port would cache
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "benchmark" / ".cache" / "torch_extensions")
if __name__ == "__main__":
    # one host thread for OpenMP, BLAS and PyTorch's intra-op pool: the
    # port's host work per call is small, and pools of idle threads on a
    # shared host's cores made whole preview runs up to 10% slower
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import inputs, registry, tracing  # noqa: E402
from benchmark.reference.common import rel_l2  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tomobar_tpu")


class Window:
    """What the window measured, for the metric readers."""

    def __init__(self):
        self.calls = 0
        self.failed = 0
        self.slices = 0
        self.elapsed_s = 0.0
        self.setup_s = 0.0
        self.window_peak_bytes = 0
        self.call_ms = []
        self.trace = None
        self._records = []

    def records(self, layer):
        """(span index, record) of the traced calls into ``layer``."""
        return [(i, r) for i, r in enumerate(self._records) if r is not None and r.layer == layer]

    def device_s(self, i):
        return self.trace.span_device_s.get(i, 0.0) if self.trace else 0.0


class Reservoir:
    """A uniform sample of ``k`` answers over every answer offered
    (reservoir sampling with a generator seeded from the run's seed).  A
    drawn answer is copied into one of ``k`` page-locked host buffers made
    during set-up, and the copy is waited for: the next call finds the card
    idle."""

    def __init__(self, k: int, seed: int, like: torch.Tensor):
        self.k, self.seen = k, 0
        self.rng = np.random.default_rng([seed, 1])
        pin = like.device.type == "cuda"
        self.bufs = [torch.empty(like.shape, dtype=like.dtype, pin_memory=pin) for _ in range(k)]
        self.kept = []  # (chunk index, answer index) of each filled buffer

    def offer(self, chunk, out, entry):
        for j in range(entry.answer_count(out)):
            self.seen += 1
            if len(self.kept) < self.k:
                slot = len(self.kept)
                self.kept.append(None)
            else:
                slot = int(self.rng.integers(0, self.seen))
                if slot >= self.k:
                    continue
            self.bufs[slot].copy_(entry.answer(out, j))
            self.kept[slot] = (chunk, j)

    def answers(self):
        """(chunk index, answer index, answer on the host) of each kept
        answer."""
        return [(*key, buf) for key, buf in zip(self.kept, self.bufs)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _slices(out) -> int:
    return 1 if out.dim() == 2 else int(out.shape[0])


def _one_call(entry, c, chunks, i, device, win, events):
    """Call the entry point on chunk ``i % len(chunks)`` and wait for it;
    return the chunk's index and the answer (None where the call failed)."""
    k = i % len(chunks)
    if events:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    try:
        out = entry.call(c.config, c.traffic, chunks[k], device)
        if events:
            ev[1].record()
        _sync(device)
    except Exception as exc:  # a failed call counts as failed, and the run goes on
        print(f"call {i} failed: {exc!r}", file=sys.stderr)
        win.failed += 1
        return k, None
    win.call_ms.append(ev[0].elapsed_time(ev[1]) if events else (time.perf_counter() - t0) * 1e3)
    win.slices += _slices(out)
    return k, out


def run(workload: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
        device=None, check_device: bool = True) -> dict:
    """One run of cell ``workload``; returns the result object.  Tests pass
    ``device="cpu"`` and ``check_device=False`` to drive it without a card."""
    c = registry.load_cell(root, workload)
    if check_device:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(c.cell["chips"]):
            raise SystemExit(2)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    entry = registry.entry(root, c.traffic["entry"])
    kinds = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: registry.metric(root, m["name"]) for m in registry.cell_metrics(c, kinds)}
    win = Window()

    chunks = inputs.make_chunks(c.config, c.traffic, seed, device)
    warm = getattr(entry, "warmup", entry.call)
    for i in range(int(c.traffic.get("warmup_calls", 1))):
        out = warm(c.config, c.traffic, chunks[i % len(chunks)], device)
        _sync(device)
        like = entry.answer(out, 0)
        del out
    events = device.type == "cuda"
    keep = Reservoir(int(c.own["answers_kept"]), seed, like)
    del like
    setup_peak = torch.cuda.max_memory_allocated(device) if events else 0
    if events:
        torch.cuda.reset_peak_memory_stats(device)
    # what set-up made stays: the collector need not scan it in the window
    gc.collect()
    gc.freeze()
    win.setup_s = time.perf_counter() - T_START

    if trace:
        spec = {}
        for mod in readers.values():
            spec.update(mod.SPANS)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if events:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with tracing.spans(spec, win._records), torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(tracing.WINDOW):
                t0 = time.perf_counter()
                for i in range(int(c.traffic["trace_calls"])):
                    last = None  # only the last call's answer is kept
                    last = _one_call(entry, c, chunks, i, device, win, events)
                    win.calls += 1
                win.elapsed_s = time.perf_counter() - t0
        k, out = last
        if out is not None:
            keep.offer(k, out, entry)
        del last, out
        win.trace = tracing.read(prof)
        del prof
    else:
        t0 = time.perf_counter()
        while True:
            k, out = _one_call(entry, c, chunks, win.calls, device, win, events)
            if out is not None:
                keep.offer(k, out, entry)
            del out
            win.calls += 1
            win.elapsed_s = time.perf_counter() - t0
            if win.elapsed_s >= seconds:
                break
    _sync(device)
    if events:
        win.window_peak_bytes = torch.cuda.max_memory_allocated(device)
    memory_peak = max(setup_peak, win.window_peak_bytes)

    metrics = {}
    units = {m["name"]: m["unit"] for m in c.bench[kinds]}
    for name, mod in readers.items():
        value = mod.read(win)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}

    # the reference, once the program's state is gone
    if events:
        torch.cuda.empty_cache()
    checks = compare(c, entry, chunks, keep, device)
    correct = win.failed == 0 and bool(keep.answers()) and all(
        ch["value"] <= ch["limit"] for ch in checks.values())

    device_info = {"platform": "gpu" if events else device.type,
                   "kind": torch.cuda.get_device_name(device) if events else "cpu",
                   "count": 1 if events else 0, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": win.calls, "failed": win.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        t = win.trace
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
        print(f"trace: device s outside every span {t.unassigned_s}", file=sys.stderr)
    result["checks"] = checks
    return result


def compare(c, entry, chunks, keep, device) -> dict:
    """Recompute every kept answer with the reference, chunk by chunk, and
    return each compared number with its limit."""
    worst = 0.0
    by_chunk = {}
    for k, j, ans in keep.answers():
        by_chunk.setdefault(k, []).append((j, ans))
    for k, items in sorted(by_chunk.items()):
        ref = entry.reference(c.config, c.traffic, chunks[k], sorted({j for j, _ in items}))
        for j, ans in items:
            worst = max(worst, rel_l2(ans.to(device), ref[j]))
        del ref
    return {"rel_l2": {"value": worst, "limit": float(c.own["limits"]["rel_l2"])}}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    result = run(a.workload, a.seed, a.seconds, bool(a.trace))
    found = forbidden_modules()
    if found:
        print(f"the run imported {found}", file=sys.stderr)
        return 3
    for name, ch in result["checks"].items():
        print(f"check {name} = {ch['value']!r} (limit {ch['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
