"""Spans and counters of ``tomobar_tpu_torch``, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` records
(``torch.autograd.profiler._is_profiler_enabled``); nothing else turns it
on or off.  While it is off a span costs one check of that flag.

* :func:`span` marks one layer boundary.  While a profiler records it
  enters ``torch.profiler.record_function(name)``, so the range sits in
  the same trace as the device's kernels and labels what the device did
  (or why it idled) under it; it records a CUDA event in the current
  stream at its start and its end (where CUDA is not initialised, the
  device's times are the host's); and it keeps its id, its parent's id,
  the id of the public call it belongs to (the outermost
  ``tomobar::api.*`` span around it), its name, its host start and end
  and its ``attrs`` in one in-memory record of at most :data:`MAX_SPANS`
  spans, which counts the spans it drops.  The events are read by
  :func:`snapshot`, never inside a span, so tracing adds no
  synchronisation.
* :func:`count` adds to one of the counters: the kernels' launches by
  kernel name (:data:`launches`, which ``_build.launch_counts`` is) and
  the projector's plan cache, the wavefront PD-TV kernel's block-rows and
  the sharded layer's bytes and halo slices (:data:`counters`).  The
  counters always count; while a profiler records, the record keeps each
  one's increase.
* :func:`snapshot` returns the record: every finished span with its host
  and device seconds and its self time (its time less that of its child
  spans), each counter's increase over the recording, and the spans
  dropped.  :func:`reset` clears it.

The spans:

| Span | Where |
|---|---|
| ``tomobar::api.<Method>`` | the public methods of ``models/iterative.py`` and ``models/direct.py`` |
| ``tomobar::api.init`` | ``RecToolsDIR.__init__``, ``RecToolsIRTPU.__init__`` (geometry, projector, plans) |
| ``tomobar::projector.plan`` | ``_DrivenPlan.group`` on a miss of its cache (the group's parameters, uploaded) |
| ``tomobar::projector.fp`` / ``.bp`` | ``_Plan.fp`` / ``_Plan.bp`` (every FP and BP of ``Projector``) |
| ``tomobar::solver.subset`` | one ordered subset of ``solvers.core.fista`` |
| ``tomobar::solver.admm_subset`` | one ordered subset of ``solvers.core.admm`` |
| ``tomobar::fidelity.grad`` | ``fidelity.grad_data_term`` |
| ``tomobar::regul.prox`` | ``regularisers.prox_regul`` |
| ``tomobar::usfft.<stage>`` | the five stages of ``ops/usfft.py``'s ``fourier_inv``: ``filter``, ``fft1d``, ``grid``, ``ifft2``, ``unpad`` |
| ``tomobar::prep.normalise`` | ``utils.tools.normaliser`` on a tensor ("mean" or "median") |
| ``tomobar::parallel.mesh`` | ``parallel.make_mesh`` (the mesh's process groups) |
| ``tomobar::regul.sharded_prox`` | ``parallel.sharded_prox``'s function: the halo exchange, the prox on the widened slab and the crop (``nz`` and ``n`` of the slab, ``before``, ``after``, ``wide_nz``, ``method``, ``iterations``) |
| ``tomobar::comm.<op>`` | the collectives of ``parallel/comm.py``: ``all_reduce``, ``all_gather``, ``gather``, ``z_halo`` (``bytes`` reduced or received, ``peers``; the halo's holds its exchange only) |

The counters beside the launches:

| Counter | Where, what |
|---|---|
| ``projector.plan_builds`` / ``.plan_hits`` | ``_DrivenPlan.group``: misses (builds) and hits of its cache |
| ``pdw.rows_launched`` | ``ops/pd_tv.py`` at each ``PDw`` launch: the launch's waves x slots x slab slices x (segment rows + 2K), the block-rows its blocks sweep (``wave_rows``) |
| ``pdw.rows_kept`` | the same launch's strips x nz x ny, the block-rows it keeps; over ``pdw.rows_launched``, the plan's share of useful block-rows |
| ``comm.reduce_bytes`` / ``.gather_bytes`` / ``.halo_bytes`` | ``parallel/comm.py``: the bytes all-reduced, received in a gather (``all_gather`` or ``gather``) and received in a halo exchange |
| ``halo.rows_computed`` / ``.rows_kept`` | ``parallel.sharded_prox``: the widened slab's slices x the prox's iterations, and the slab's; their ratio is the halo's extra prox work |

The record is one per process and assumes the spans of one thread.
"""

from __future__ import annotations

import functools
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["MAX_SPANS", "launches", "counters", "span", "spanned", "count", "snapshot",
           "reset"]

#: spans the record keeps before it drops (and counts) the rest
MAX_SPANS = 1 << 17

_API = "tomobar::api."

#: launches by kernel name; each kernel wrapper counts one where it launches
launches = dict.fromkeys(
    ("K1", "K1p", "K2", "K3", "K4", "K4p", "PD", "PDw", "G", "F", "Fc", "Ff"), 0)
#: misses (builds) and hits of ``_DrivenPlan.group``'s cache of parameters;
#: block-rows that PDw launches sweep and keep; the sharded layer's bytes
#: and the slices its halo prox computes and keeps
counters = {"projector.plan_builds": 0, "projector.plan_hits": 0, "pdw.rows_launched": 0,
            "pdw.rows_kept": 0, "comm.reduce_bytes": 0, "comm.gather_bytes": 0,
            "comm.halo_bytes": 0, "halo.rows_computed": 0, "halo.rows_kept": 0}


class _Record:
    """The spans and counter increases of the recordings since the last
    :func:`reset`; a span is the list ``[id, parent, call, name, attrs,
    host start ns, host end ns, start event, end event, device s]``."""

    def __init__(self):
        self.spans = []
        self.counts = {}
        self.dropped = 0
        self.stack = []  # (id, call) of the open spans, id -1 where dropped


_rec = _Record()


class _Off:
    """What :func:`span` returns while no profiler records.  Its enter and
    exit are a C function that does nothing (``"".format`` ignores its
    arguments and returns the empty, false string), so a ``with`` on it
    runs no Python frame and lets every exception through."""

    __slots__ = ()
    __enter__ = "".format
    __exit__ = "".format


_OFF = _Off()


def _event(stream) -> torch.cuda.Event:
    """A CUDA event recorded in ``stream``."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "attrs", "range", "row", "stream")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        rec = _rec
        self.range = _profiler.record_function(self.name)
        self.range.__enter__()
        parent, call = rec.stack[-1] if rec.stack else (None, None)
        i = len(rec.spans)
        if i >= MAX_SPANS:  # full: this span and those inside it are dropped
            rec.dropped += 1
            self.row = None
            rec.stack.append((-1, call))
            return self
        if call is None and self.name.startswith(_API):
            call = i
        # both events go to the stream current at the start
        self.stream = torch.cuda.current_stream() if torch.cuda.is_initialized() else None
        t0 = time.perf_counter_ns()
        self.row = [i, parent, call, self.name, self.attrs, t0, None,
                    t0 if self.stream is None else _event(self.stream), None, None]
        rec.spans.append(self.row)
        rec.stack.append((i, call))
        return self

    def __exit__(self, *exc):
        row = self.row
        if row is not None:
            row[6] = time.perf_counter_ns()
            row[8] = row[6] if self.stream is None else _event(self.stream)
        _rec.stack.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """``with span(name, **attrs):`` marks the block as span ``name``
    while a profiler records (see the module notes); otherwise it does
    nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """A decorator: every call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``: a kernel's name in :data:`launches`,
    else a key of :data:`counters`."""
    if name in launches:
        launches[name] += n
    else:
        counters[name] += n
    if _profiler._is_profiler_enabled:
        _rec.counts[name] = _rec.counts.get(name, 0) + n


def _seconds(a, b) -> float:
    if isinstance(a, int):
        return (b - a) / 1e9
    return a.elapsed_time(b) / 1e3


def snapshot() -> dict:
    """The record: ``spans`` (each finished span as a dict: ``id``,
    ``parent``, ``call``, ``name``, ``attrs``, ``start_ns`` on the host,
    ``host_s``, ``device_s``, ``self_host_s``, ``self_device_s``),
    ``counters`` (every counter's increase while a profiler recorded) and
    ``dropped`` (spans the full record did not keep).  Waits for the card
    where a span's events are not read yet."""
    rows = [r for r in _rec.spans if r[6] is not None]
    if any(r[9] is None and not isinstance(r[7], int) for r in rows):
        torch.cuda.synchronize()
    for r in rows:
        if r[9] is None:
            r[9] = _seconds(r[7], r[8])
            r[7] = r[8] = None  # the events are read: let them go
    child_host, child_dev = {}, {}
    for r in rows:
        if r[1] is not None:
            child_host[r[1]] = child_host.get(r[1], 0.0) + (r[6] - r[5]) / 1e9
            child_dev[r[1]] = child_dev.get(r[1], 0.0) + r[9]
    spans = []
    for i, parent, call, name, attrs, t0, t1, _, _, dev in rows:
        host = (t1 - t0) / 1e9
        spans.append({"id": i, "parent": parent, "call": call, "name": name, "attrs": attrs,
                      "start_ns": t0, "host_s": host, "device_s": dev,
                      "self_host_s": host - child_host.get(i, 0.0),
                      "self_device_s": dev - child_dev.get(i, 0.0)})
    names = list(launches) + list(counters)
    return {"spans": spans, "counters": {k: _rec.counts.get(k, 0) for k in names},
            "dropped": _rec.dropped}


def reset() -> None:
    """Clear the record (spans, counter increases, drops) between
    recordings; the counters themselves keep counting."""
    _rec.spans, _rec.counts, _rec.dropped = [], {}, 0
