"""Multi-device reconstruction: a ("z", "angles") mesh of
``torch.distributed`` ranks, one process per device (counterpart of
``tomobar_tpu/parallel``)."""

from tomobar_tpu_torch.parallel.sharding import (
    Mesh,
    ShardedProjector,
    distributed_init,
    make_mesh,
    sharded_prox,
    sharded_regul_fn,
    sharded_wavelet,
)
from tomobar_tpu_torch.parallel.direct import ShardedDirect

__all__ = [
    "Mesh",
    "ShardedProjector",
    "ShardedDirect",
    "distributed_init",
    "make_mesh",
    "sharded_prox",
    "sharded_regul_fn",
    "sharded_wavelet",
]
