"""The program's own record of the traced window: the spans and counters of
``tomobar_tpu_torch.trace``, which record while the window's
``torch.profiler`` does.  A program without them (a tree older than that
module) gives None, and the metrics that read them report nothing."""

from __future__ import annotations


def snapshot():
    """``tomobar_tpu_torch.trace.snapshot()``, or None where the program has
    no such module."""
    try:
        from tomobar_tpu_torch import trace
    except ImportError:
        return None
    return trace.snapshot()


def spans(snap: dict, *names: str) -> list:
    """The spans of ``snap`` named one of ``names``."""
    return [s for s in snap["spans"] if s["name"] in names]
