"""ADMM's own update against its roofline: the least bytes of one ordered
subset's update, 6 volumes of nz n^2 float32 (z, the gradient, x and u
read once; z and x written once; ``update_bytes``), over the self device
time of the program's ``tomobar::solver.admm_subset`` spans: their time on
the card's clock less that of their ``tomobar::fidelity.grad`` and
``tomobar::regul.prox`` children (``benchmark/program.py``).  FISTA's
subsets are the ``tomobar::solver.subset`` spans, which this reads not."""

from benchmark import program
from benchmark.work import bound_s

SPANS = {}


def update_bytes(nz: int, n: int) -> int:
    """Bytes one subset's update must move: 6 float32 volumes of nz n^2."""
    return 6 * 4 * nz * n * n


def read(ctx):
    snap = program.snapshot()
    subsets = program.spans(snap, "tomobar::solver.admm_subset") if snap else []
    dev = sum(s["self_device_s"] for s in subsets)
    if not subsets or dev <= 0:
        return None
    bound = sum(bound_s(None, update_bytes(s["attrs"]["nz"], s["attrs"]["n"])) for s in subsets)
    return 100.0 * bound / dev
