"""95th percentile of one call's time over every call of the window, in
ms.  Each call is bracketed by CUDA events on the card's clock: the card
is idle when a call starts (the previous one was waited for), so the
interval holds the host's work inside the call as well as the device's."""

import numpy as np

SPANS = {}


def read(ctx):
    if not ctx.call_ms:
        return None
    return float(np.percentile(np.asarray(ctx.call_ms), 95))
