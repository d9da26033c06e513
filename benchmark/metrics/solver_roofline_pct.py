"""FISTA's own update against its roofline: the least bytes of one ordered
subset's update, 6 volumes of nz n^2 float32 (x_t and the gradient in, x
out; x and x_old in, x_t out; ``work.bound_s``), over the self device time
of the program's ``tomobar::solver.subset`` spans: their time on the
card's clock less that of their ``tomobar::fidelity.grad`` and
``tomobar::regul.prox`` children (``benchmark/program.py``)."""

from benchmark import program
from benchmark.work import bound_s

SPANS = {}


def read(ctx):
    snap = program.snapshot()
    subsets = program.spans(snap, "tomobar::solver.subset") if snap else []
    dev = sum(s["self_device_s"] for s in subsets)
    if not subsets or dev <= 0:
        return None
    bound = sum(bound_s(None, 6 * 4 * s["attrs"]["nz"] * s["attrs"]["n"] ** 2) for s in subsets)
    return 100.0 * bound / dev
