"""The host's set-up of one call, in ms: the host time of the program's
``tomobar::api.init`` spans (the reconstructor: geometry, projector,
plans) and of its ``tomobar::projector.plan`` spans outside them (a driven
group's parameters, built and uploaded at first use), over the traced
window's calls (``benchmark/program.py``)."""

from benchmark import program

SPANS = {}
INIT, PLAN = "tomobar::api.init", "tomobar::projector.plan"


def read(ctx):
    snap = program.snapshot()
    found = program.spans(snap, INIT, PLAN) if snap else []
    if not found or not ctx.calls:
        return None
    by_id = {s["id"]: s for s in snap["spans"]}

    def in_init(s):
        p = s["parent"]
        while p is not None and p in by_id:
            if by_id[p]["name"] == INIT:
                return True
            p = by_id[p]["parent"]
        return False

    host = sum(s["host_s"] for s in found if s["name"] == INIT or not in_init(s))
    return 1e3 * host / ctx.calls
