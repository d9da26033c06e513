"""The USFFT gridding against its roofline: the least time of every
gridding stage of the traced window (``work.stage_work``'s ``grid`` at
each z-block's shape) over the device time of the program's
``tomobar::usfft.grid`` spans (``benchmark/program.py``)."""

from benchmark import program
from benchmark.work import bound_s, stage_work

SPANS = {}
STAGES = ("grid",)


def read(ctx, stages=STAGES):
    snap = program.snapshot()
    found = program.spans(snap, *(f"tomobar::usfft.{s}" for s in stages)) if snap else []
    dev = sum(s["device_s"] for s in found)
    if not found or dev <= 0:
        return None
    bound = 0.0
    for s in found:
        a = s["attrs"]
        bound += bound_s(*stage_work(a["n"], a["nz"], a["nproj"], a["ow"])[s["name"].split(".")[-1]])
    return 100.0 * bound / dev
