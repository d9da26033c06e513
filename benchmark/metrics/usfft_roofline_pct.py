"""The USFFT pipeline's share of its roofline: the least time of every
FOURIER_INV call of the traced window (the sum of its five stages'
bounds, ``work.stage_work``) over the device time of the kernels it
launched."""

from benchmark.work import fourier_inv_bound_s

SPANS = {"usfft": ["tomobar_tpu_torch.models.direct:RecToolsDIRTPU.FOURIER_INV"]}


def read(ctx):
    recs = ctx.records("usfft")
    dev = sum(ctx.device_s(i) for i, _ in recs)
    if not recs or dev <= 0:
        return None
    bound = 0.0
    for _, r in recs:
        nz, nproj, n = r.args[0][1]
        bound += fourier_inv_bound_s(n, nz, nproj)
    return 100.0 * bound / dev
