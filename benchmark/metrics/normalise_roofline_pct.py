"""The flat/dark normalisation against its roofline: the least bytes of
each call (``normalise_bytes``: the raw frames, the flats and the darks
read once and the normalised sinogram written once, float32), over the
device time of the program's ``tomobar::prep.normalise`` spans
(``benchmark/program.py``), at the HBM bandwidth of ``work.bound_s``."""

from benchmark import program
from benchmark.work import bound_s

SPANS = {}


def normalise_bytes(frames: int, rows: int, det_x: int, flats: int, darks: int) -> int:
    """Bytes of one normalisation: frames, flats and darks in, the
    sinogram out, 4 bytes an element."""
    return 4 * rows * det_x * (2 * frames + flats + darks)


def read(ctx):
    snap = program.snapshot()
    found = program.spans(snap, "tomobar::prep.normalise") if snap else []
    dev = sum(s["device_s"] for s in found)
    if not found or dev <= 0:
        return None
    bound = sum(bound_s(None, normalise_bytes(**{k: s["attrs"][k] for k in
                                                 ("frames", "rows", "det_x", "flats", "darks")}))
                for s in found)
    return 100.0 * bound / dev
