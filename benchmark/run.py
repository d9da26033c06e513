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

A cell whose ``chips`` N is over 1 runs as a world of N ranks
(``benchmark/world.py``); the branch is taken before set-up, so a one-chip
cell runs as described above.  The process the command starts checks the
cards, makes no CUDA context, starts one process of this script a card
(rank r on ``cuda:r``) and waits for them.  Each rank starts the default
process group (NCCL) before it loads the entry, then:

* inputs: rank 0 makes the chunks from the seed and broadcasts them, so
  every rank holds the same bits; an entry's ``local`` keeps a rank's part
  of each;
* set-up: every rank warms the entry up, then all wait at a barrier;
  ``setup_s`` runs from the launcher's start to the barrier's end;
* window: every rank calls the entry and waits for its card, and one
  all-reduce (on the host) closes the call on every rank, with whether it
  failed on any rank and whether rank 0's clock had reached ``--seconds``
  when its part ended: then the call is the window's last.  So rank 0's
  clock and events time the slowest rank, and every rank makes the same
  calls.  A call that failed on one rank failed on all, and stops the
  world (a rank that raised may have left the others inside a collective
  of the entry);
* metrics: rank 0's answers are the world's (the entry gathers them): they
  are counted and kept.  ``setup_s`` and the rates and times are rank 0's;
  the window's peak and ``memory_peak_bytes`` are the fullest rank's;
  ``device.count`` is N.  Traced, every rank traces its own calls (the
  traced windows open together, at a barrier), each per-layer metric (and ``busy_s``, ``window_s``) is the mean over the
  ranks, each rank's reading is written to standard error, and the
  breakdown is rank 0's;
* check: every rank frees the program's state and runs the entry's
  ``reference`` on the same whole chunks with the group up (a plain
  reference may spread its own work over the cards); rank 0 compares.
  If any rank imported JAX, every rank exits with 3.

The launcher prints rank 0's result.  A rank that dies, or a collective
that outlives the group's timeout, ends the run with another code than 0
and no result; no rank outlives the run.
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
from benchmark.world import T0, World, launch  # noqa: E402
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


def _one_call(entry, c, chunks, i, device, win, events, world=None, deadline=None):
    """Call the entry point on chunk ``i % len(chunks)`` and wait for it;
    return the chunk's index, the answer (None where the call failed) and,
    on a world, whether the window ends with this call.  On a world the
    call ends with the all-reduce that closes it on every rank (rank 0's
    events and clock end with the slowest rank's call); it is the last
    where rank 0's clock had passed ``deadline`` when its part ended."""
    k = i % len(chunks)
    if events:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    out, failed, last = None, False, False
    try:
        out = entry.call(c.config, c.traffic, chunks[k], device)
        if events and world is None:
            ev[1].record()
        _sync(device)
    except Exception as exc:  # a failed call counts as failed; one rank goes on, a world stops
        print(f"call {i} failed: {exc!r}", file=sys.stderr)
        failed = True
    if world is not None:
        late = deadline is not None and time.perf_counter() >= deadline
        failed, last = world.close(failed, late, mark=ev[1] if events else None)
    if failed:
        win.failed += 1
        return k, None, last
    win.call_ms.append(ev[0].elapsed_time(ev[1]) if events else (time.perf_counter() - t0) * 1e3)
    if out is not None:  # a rank other than 0 of a world may answer nothing
        win.slices += _slices(out)
    return k, out, last


def run(workload: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
        device=None, check_device: bool = True, world: World = None) -> dict:
    """One run of cell ``workload``; returns the result object.  Tests pass
    ``device="cpu"`` and ``check_device=False`` to drive it without a card.
    With ``world`` this is one rank's run on the world's device, and rank
    0's result is the world's."""
    c = registry.load_cell(root, workload)
    if world is not None:
        device = world.device
    elif check_device:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(c.cell["chips"]):
            raise SystemExit(2)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    lead = world is None or world.rank == 0
    entry = registry.entry(root, c.traffic["entry"])
    kinds = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: registry.metric(root, m["name"]) for m in registry.cell_metrics(c, kinds)}
    win = Window()

    def make():
        return inputs.make_chunks(c.config, c.traffic, seed, device)

    if world is None:
        chunks = make()
    else:
        local = getattr(entry, "local", None)
        part = None if local is None else (lambda t: local(c.config, c.traffic, t))
        chunks = world.inputs(make, part)
    warm = getattr(entry, "warmup", entry.call)
    for i in range(int(c.traffic.get("warmup_calls", 1))):
        out = warm(c.config, c.traffic, chunks[i % len(chunks)], device)
        _sync(device)
        like = entry.answer(out, 0) if lead else None
        del out
    events = device.type == "cuda"
    keep = Reservoir(int(c.own["answers_kept"]), seed, like) if lead else None
    del like
    setup_peak = torch.cuda.max_memory_allocated(device) if events else 0
    if events:
        torch.cuda.reset_peak_memory_stats(device)
    # what set-up made stays: the collector need not scan it in the window
    gc.collect()
    gc.freeze()
    if world is None:
        win.setup_s = time.perf_counter() - T_START
    else:
        world.barrier()
        win.setup_s = world.since_start()

    if trace:
        spec = {}
        for mod in readers.values():
            spec.update(mod.SPANS)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if events:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with tracing.spans(spec, win._records), torch.profiler.profile(activities=acts) as prof:
            if world is not None:  # the ranks' profilers start in their own time
                world.barrier()
            with torch.profiler.record_function(tracing.WINDOW):
                t0 = time.perf_counter()
                for i in range(int(c.traffic["trace_calls"])):
                    kept = None  # only the last call's answer is kept
                    kept = _one_call(entry, c, chunks, i, device, win, events, world)[:2]
                    win.calls += 1
                    if world is not None and win.failed:  # a failed call stops the world
                        break
                win.elapsed_s = time.perf_counter() - t0
        k, out = kept
        if out is not None and lead:
            keep.offer(k, out, entry)
        del kept, out
        win.trace = tracing.read(prof)
        del prof
    else:
        t0 = time.perf_counter()
        while True:
            k, out, last = _one_call(entry, c, chunks, win.calls, device, win, events, world,
                                     t0 + seconds)
            if out is not None and lead:
                keep.offer(k, out, entry)
            del out
            win.calls += 1
            win.elapsed_s = time.perf_counter() - t0
            if world is None:
                last = win.elapsed_s >= seconds
            if last or (world is not None and win.failed):
                break
    _sync(device)
    if events:
        win.window_peak_bytes = torch.cuda.max_memory_allocated(device)
    memory_peak = max(setup_peak, win.window_peak_bytes)
    if world is not None:  # the fullest rank's
        win.window_peak_bytes = max(world.gather(win.window_peak_bytes))
        memory_peak = max(world.gather(memory_peak))

    metrics = {}
    units = {m["name"]: m["unit"] for m in c.bench[kinds]}
    for name, mod in readers.items():
        value = mod.read(win)
        if trace and world is not None:
            value = world.mean(name, value)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}

    # the reference, once the program's state is gone
    if events:
        torch.cuda.empty_cache()
    if world is not None and getattr(entry, "local", None) is not None:
        del chunks
        chunks = world.inputs(make)  # whole again, for the reference
    checks = compare(c, entry, chunks, keep, device, world)
    correct = win.failed == 0 and lead and bool(keep.answers()) and all(
        ch["value"] <= ch["limit"] for ch in checks.values())

    device_info = {"platform": "gpu" if events else device.type,
                   "kind": torch.cuda.get_device_name(device) if events else "cpu",
                   "count": 1 if events else 0, "memory_peak_bytes": int(memory_peak)}
    if world is not None:
        device_info["count"] = world.size
    result = {"correct": correct, "attempted": win.calls, "failed": win.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        t = win.trace
        busy, window_s = t.busy_s, t.window_s
        if world is not None:
            busy, window_s = world.mean("busy_s", busy), world.mean("window_s", window_s)
        device_info.update(busy_s=busy, window_s=window_s)
        result["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
        print(f"trace: device s outside every span {t.unassigned_s}", file=sys.stderr)
    result["checks"] = checks
    return result


def compare(c, entry, chunks, keep, device, world=None) -> dict:
    """Recompute every kept answer with the reference, chunk by chunk, and
    return each compared number with its limit.  On a world every rank
    runs the reference on rank 0's chunks and answers, in rank 0's order;
    rank 0 compares."""
    worst = 0.0
    by_chunk = {}
    for k, j, ans in keep.answers() if keep is not None else ():
        by_chunk.setdefault(k, []).append((j, ans))
    plan = [(k, sorted({j for j, _ in items})) for k, items in sorted(by_chunk.items())]
    if world is not None:
        plan = world.share(plan)
    for k, ids in plan:
        ref = entry.reference(c.config, c.traffic, chunks[k], ids)
        for j, ans in by_chunk.get(k, ()):
            worst = max(worst, rel_l2(ans.to(device), ref[j]))
        del ref
    return {"rel_l2": {"value": worst, "limit": float(c.own["limits"]["rel_l2"])}}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _report(result: dict) -> int:
    """Print the result (the numbers compared last on standard error, the
    object last on standard output), unless this process imported JAX."""
    found = forbidden_modules()
    if found:
        print(f"the run imported {found}", file=sys.stderr)
        return 3
    for name, ch in result["checks"].items():
        print(f"check {name} = {ch['value']!r} (limit {ch['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def _rank(a) -> int:
    """One rank of a world: its run, then the check of every rank's
    imports; rank 0 writes the result for the launcher."""
    w = World()
    result = run(a.workload, a.seed, a.seconds, bool(a.trace), world=w)
    found = w.gather(forbidden_modules())
    w.end()
    if any(found):
        if w.rank == 0:
            print(f"the run imported {found} (by rank)", file=sys.stderr)
        return 3
    if w.rank == 0:
        print(json.dumps(result))
    return 0


def run_world(argv: list, chips: int, root: Path = ROOT, device: str = "cuda") -> int:
    """Run this script's ``argv`` as a world of ``chips`` ranks
    (``benchmark/world.py``) and print rank 0's result; tests pass
    ``device="cpu"`` for a world of gloo ranks on the CPU."""
    t0 = time.monotonic() - (time.perf_counter() - T_START)
    rc, lines = launch(Path(root) / "benchmark" / "run.py", argv, chips, t0, device)
    if rc or not lines:
        return rc or 1
    for line in lines[:-1]:
        print(line, file=sys.stderr)
    return _report(json.loads(lines[-1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if T0 in os.environ:
        return _rank(a)
    chips = int(registry.load_cell(ROOT, a.workload).cell["chips"])
    if chips > 1:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            return 2
        return run_world(sys.argv[1:] if argv is None else list(argv), chips)
    return _report(run(a.workload, a.seed, a.seconds, bool(a.trace)))


if __name__ == "__main__":
    sys.exit(main())
