"""The USFFT pipeline's stages around the gridding against their roofline:
the least time of the filter, fft1d, ifft2 and unpad stages of every
z-block of the traced window (``work.stage_work``) over the device time of
the program's ``tomobar::usfft.filter``, ``.fft1d``, ``.ifft2`` and
``.unpad`` spans (``benchmark/program.py``)."""

from benchmark.metrics import usfft_grid_roofline_pct

SPANS = {}


def read(ctx):
    return usfft_grid_roofline_pct.read(ctx, ("filter", "fft1d", "ifft2", "unpad"))
