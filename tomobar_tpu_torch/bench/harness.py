"""Timing and quality measurement.

Counterpart of ``tomobar_tpu/bench/harness.py``:

* :func:`time_fn`: mean seconds per call after warm-up calls, between
  ``torch.cuda.Event`` pairs for work on a card and by ``time.perf_counter``
  on the CPU.  A card's events bracket the stream, so no readback latency
  needs subtracting;
* :func:`time_cuda` / :func:`time_device`: milliseconds of calls enqueued
  one by one, and of calls replayed from a CUDA graph (the device alone);
* :class:`Marks`: times between points of one run, for stage breakdowns;
* :func:`rmse` / :func:`rel_rmse`: the RMSE-against-phantom quality metric
  of the reference demos (TomoPhantom's QualityTools);
* :func:`trace`: a ``torch.profiler`` trace of the card, exported for
  Chrome's viewer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

__all__ = ["device_sync", "time_fn", "time_cuda", "time_device", "Marks", "rmse",
           "rel_rmse", "trace"]


def _device_of(x) -> torch.device:
    """The device of the first tensor in ``x`` (any nesting), else the CPU."""
    for leaf in tree_flatten(x)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def device_sync(x=None) -> None:
    """Wait for the work queued on the card of ``x`` (any tensor in it; the
    current card where ``x`` is None); a no-op on the CPU."""
    dev = _device_of(x) if x is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, warmup: int = 1, reps: int = 5) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``reps`` calls, after
    ``warmup`` calls (at least one): CUDA events where the warm-up's result
    lies on a card, ``time.perf_counter`` otherwise."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    dev = _device_of((out, args))
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return time_cuda(lambda: fn(*args), reps, warmup=0) / 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps


def time_cuda(fn: Callable, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the current card over ``reps`` calls
    enqueued one by one, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_device(fn: Callable, calls: int = 20, reps: int = 5) -> float:
    """Mean milliseconds of one ``fn()`` on the device alone: ``calls`` calls
    are captured in a CUDA graph and the graph is replayed, so the host's
    time to enqueue a call, which is more than a small kernel takes, is
    left out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_cuda(graph.replay, reps) / calls


class Marks:
    """Points in one run on ``device``: ``mark()`` records one (a CUDA event
    on a card, ``time.perf_counter`` on the CPU), :meth:`elapsed_ms` gives
    the milliseconds between each point and the next (after waiting for the
    card)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._points: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._points.append(ev)
        else:
            self._points.append(time.perf_counter())

    def elapsed_ms(self) -> List[float]:
        pts = self._points
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(pts, pts[1:])]
        return [(b - a) * 1e3 for a, b in zip(pts, pts[1:])]


def rmse(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def rel_rmse(rec, ref) -> float:
    ref_n = np.sqrt(np.mean(np.asarray(ref, dtype=np.float64) ** 2))
    return rmse(rec, ref) / max(ref_n, 1e-30)


@contextlib.contextmanager
def trace(log_dir: str = "torch_trace"):
    """``with trace(dir) as prof: ...`` records the host and, where there
    is a card, the card's kernels with ``torch.profiler``, and exports a
    Chrome trace ``trace.json`` into ``log_dir`` (relative to the working
    directory) on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
