"""``torch.cuda.max_memory_allocated()`` over the window, in GiB: the
memory a chunk of this size costs, which sets the chunk a pipeline can
use."""

SPANS = {}


def read(ctx):
    return ctx.window_peak_bytes / 2**30 if ctx.window_peak_bytes else None
