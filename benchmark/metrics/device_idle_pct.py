"""Share of the traced window in which no kernel, copy or set ran on the
card, from the profiler's device timeline."""

SPANS = {}


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
