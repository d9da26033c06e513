"""The projector's share of its roofline: the least time of every FP and
BP call of the traced window (4 nz A n^2 operations; the volume and the
sinogram moved once: ``work.projector_work``) over the device time of the
kernels those calls launched."""

from benchmark.work import bound_s, projector_work

SPANS = {"projector": [
    "tomobar_tpu_torch.ops.projector:Projector.fp",
    "tomobar_tpu_torch.ops.projector:Projector.bp",
    "tomobar_tpu_torch.ops.projector:Projector.fp_sub",
    "tomobar_tpu_torch.ops.projector:Projector.bp_sub",
]}


def _work(rec):
    vol, sino = (rec.out, rec.args[0]) if rec.fn.endswith(("bp", "bp_sub")) else (rec.args[0], rec.out)
    v, s = vol[1], sino[1]
    if len(v) == 2:  # one slice
        v, s = (1, *v), (1, *s)
    return projector_work(v[0], s[1], v[-1], s[-1])


def read(ctx):
    recs = ctx.records("projector")
    dev = sum(ctx.device_s(i) for i, _ in recs)
    if not recs or dev <= 0:
        return None
    return 100.0 * sum(bound_s(*_work(r)) for _, r in recs) / dev
