"""Driven-group plans the projector builds per call: the increase of the
program's ``projector.plan_builds`` counter (misses of its plan cache)
over the traced window, over the window's calls
(``benchmark/program.py``)."""

from benchmark import program

SPANS = {}


def read(ctx):
    snap = program.snapshot()
    builds = snap["counters"].get("projector.plan_builds") if snap else None
    if builds is None or not ctx.calls:
        return None
    return builds / ctx.calls
