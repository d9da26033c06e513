"""Seconds from the start of the process to the start of the window:
imports, the CUDA context, loading (or, in a fresh checkout, building)
the kernels, making the inputs and the warm-up calls."""

SPANS = {}


def read(ctx):
    return ctx.setup_s
