"""Slices reconstructed per second: every slice of every call in the
window, over the window's whole length (host clock; the window ends with
the call that crosses ``--seconds``, so it holds whole calls only)."""

SPANS = {}


def read(ctx):
    return ctx.slices / ctx.elapsed_s if ctx.elapsed_s > 0 else None
