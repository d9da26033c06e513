"""Spans around calls into the program's layers, and the reading of a
``torch.profiler`` trace of the card.

A metric module names its layer's entry points in ``SPANS`` ({layer:
["module:Attr.attr", ...]}).  For the traced calls each of them is wrapped
by a ``record_function`` range ``bench::<layer>#<i>``, and the call's
argument and result shapes are kept.  A device operation belongs to the
span whose host range holds its launch (the CUDA runtime call with its
correlation id), so a layer's time is the device time of what it launched,
whatever kernels do the work.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
from collections import defaultdict
from typing import Dict, List, NamedTuple

import torch

WINDOW = "bench::window"


class Record(NamedTuple):
    layer: str
    fn: str
    args: list  # summaries of the positional arguments after self
    kwargs: dict
    out: object


def _summary(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape))
    if isinstance(x, dict):
        return {k: v for k, v in x.items() if isinstance(v, (int, float, str, bool, type(None)))}
    if isinstance(x, (int, float, str, bool, type(None))):
        return x
    if isinstance(x, (tuple, list)):
        return [_summary(v) for v in x]
    return type(x).__name__


def _resolve(target: str):
    mod_name, attr = target.split(":")
    owner = importlib.import_module(mod_name)
    parts = attr.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


@contextlib.contextmanager
def spans(spec: Dict[str, List[str]], records: List[Record]):
    """Wrap every entry point of ``spec`` while the block runs; each call
    appends its :class:`Record` to ``records``."""
    undo = []
    try:
        for layer, targets in spec.items():
            for target in targets:
                owner, name = _resolve(target)
                own = name in vars(owner)
                raw = vars(owner).get(name)
                fn = getattr(owner, name)

                def make(fn, layer, target):
                    method = isinstance(owner, type)

                    @functools.wraps(fn)
                    def wrapped(*args, **kwargs):
                        i = len(records)
                        records.append(None)
                        with torch.profiler.record_function(f"bench::{layer}#{i}"):
                            out = fn(*args, **kwargs)
                        rest = args[1:] if method else args
                        records[i] = Record(layer, target, [_summary(a) for a in rest],
                                            _summary(kwargs), _summary(out))
                        return out
                    return wrapped

                setattr(owner, name, make(fn, layer, target))
                undo.append((owner, name, raw, own))
        yield records
    finally:
        for owner, name, raw, own in reversed(undo):
            if own:
                setattr(owner, name, raw)
            else:
                delattr(owner, name)


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    span_device_s: Dict[int, float]  # span index -> device seconds
    unassigned_s: float  # device seconds launched outside every span
    device_ops: list  # [[name, seconds]] largest first
    idle_gaps: list  # [[what the host did, seconds]] largest first


def read(prof) -> Trace:
    """Reduce a finished profile to device busy time, per-span device time
    and the breakdown's two lists."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host, dev, launch, op_start = [], [], {}, {}
    window = None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            host.append((e.start_ns(), e.end_ns(), name))
            if name.startswith("cu"):
                launch[e.correlation_id()] = e.start_ns()
            else:
                op_start.setdefault(e.correlation_id(), e.start_ns())
        elif not name.startswith("bench::") and not e.is_user_annotation():
            dev.append(e)
    if window is None:
        raise RuntimeError("the profile holds no bench::window range")
    w0, w1 = window
    spans_ = sorted((s, t, int(n.split("#")[1])) for s, t, n in host
                    if n.startswith("bench::") and "#" in n)
    starts = [s for s, _, _ in spans_]
    per_span, by_name = defaultdict(float), defaultdict(float)
    intervals, unassigned = [], 0.0
    for e in dev:
        t0, t1 = e.start_ns(), e.end_ns()
        if t1 <= w0 or t0 >= w1:
            continue
        dur = (t1 - t0) / 1e9
        by_name[e.name()] += dur
        intervals.append((max(t0, w0), min(t1, w1)))
        at = launch.get(e.correlation_id(), op_start.get(e.linked_correlation_id()))
        k = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        if k >= 0 and spans_[k][0] <= at <= spans_[k][1]:
            per_span[spans_[k][2]] += dur
        else:
            unassigned += dur
    intervals.sort()
    busy, gaps, end = 0.0, [], w0
    for s, t in intervals:
        if s > end:
            gaps.append((end, s))
        if t > end:
            busy += (t - max(s, end)) / 1e9
            end = t
    if end < w1:
        gaps.append((end, w1))
    idle = defaultdict(float)
    inner = sorted((s, t, n) for s, t, n in host if n != WINDOW and not n.startswith("bench::"))
    inner_starts = [s for s, _, _ in inner]
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        k = bisect.bisect_right(inner_starts, mid) - 1
        label, best = "host (no op)", None
        for j in range(k, max(k - 400, -1), -1):
            s, t, n = inner[j]
            if s <= mid <= t and (best is None or t - s < best):
                label, best = n, t - s
        idle[label] += (g1 - g0) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Trace((w1 - w0) / 1e9, busy, dict(per_span), unassigned, top(by_name), top(idle))
