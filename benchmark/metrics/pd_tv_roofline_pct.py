"""The PD-TV prox's share of its roofline: the least time of every PD-TV
prox of the traced window (``work.work_pd``: 36 operations a voxel and
iteration, 28 for one slice; data in and result out once) over the device
time of the kernels those proxes launched."""

from benchmark.work import bound_s, work_pd

SPANS = {"prox": ["tomobar_tpu_torch.models.iterative:prox_regul"]}


def read(ctx):
    recs = [(i, r) for i, r in ctx.records("prox") if r.args[2].get("method") == "PD_TV"]
    dev = sum(ctx.device_s(i) for i, _ in recs)
    if not recs or dev <= 0:
        return None
    bound = 0.0
    for _, r in recs:
        shape = r.args[1][1]
        nz = shape[0] if len(shape) == 3 else 1
        bound += bound_s(*work_pd(nz, shape[-1], int(r.args[2]["iterations"])))
    return 100.0 * bound / dev
