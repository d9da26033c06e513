"""The sharded PD-TV prox against the roofline of its useful work: the
least time of PD-TV on each rank's own slab (``work.work_pd`` at the slab's
slices, not the halo-widened ones) over the device time of the program's
``tomobar::regul.sharded_prox`` spans, which hold the halo exchange, the
prox on the widened slab and the crop (``benchmark/program.py``).  A
program without those spans reports nothing."""

from benchmark import program
from benchmark.work import bound_s, work_pd

SPANS = {}


def read(ctx):
    snap = program.snapshot()
    proxes = [s for s in (program.spans(snap, "tomobar::regul.sharded_prox") if snap else ())
              if s["attrs"].get("method") == "PD_TV"]
    dev = sum(s["device_s"] for s in proxes)
    if not proxes or dev <= 0:
        return None
    bound = sum(bound_s(*work_pd(s["attrs"]["nz"], s["attrs"]["n"], s["attrs"]["iterations"]))
                for s in proxes)
    return 100.0 * bound / dev
