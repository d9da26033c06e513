"""The halo exchanges' share of the card's link: the bytes each rank
receives in the program's ``tomobar::comm.z_halo`` spans over those spans'
device time (from the card's work before the exchange to the slices'
arrival: a neighbour that comes late counts), against 450 GB/s into one
H100 SXM (``benchmark/links.py``).  A program without those spans reports
nothing."""

from benchmark import program
from benchmark.links import H100_SXM_NVLINK_BYTES

SPANS = {}


def read(ctx):
    snap = program.snapshot()
    halos = program.spans(snap, "tomobar::comm.z_halo") if snap else []
    dev = sum(s["device_s"] for s in halos)
    if not halos or dev <= 0:
        return None
    return 100.0 * sum(s["attrs"]["bytes"] for s in halos) / dev / H100_SXM_NVLINK_BYTES
