"""z-slab sharded direct reconstruction (FBP / FOURIER_INV) on a mesh of
ranks.

Counterpart of ``tomobar_tpu/parallel/direct.py``.  Every detY slab
reconstructs independently (the reference's blockwise-consistency
invariant, ``methodsDIR_CuPy.py:493-541``), so a rank runs the pipeline on
its own canonical slab:

* ``fbp``: the sinc or classic filter on the slab, then
  :meth:`ShardedProjector.bp` (an ``all_reduce`` over the angle group
  where the mesh deals angles);
* ``fourier_inv``: the whole USFFT pipeline on the slab, with no
  collective; an angle axis, if present, repeats the work on each of its
  ranks, so direct methods are best run on z-only meshes.
"""

from __future__ import annotations

import torch

from tomobar_tpu_torch.models.direct import filtered_bp
from tomobar_tpu_torch.parallel.sharding import Mesh, ShardedProjector

__all__ = ["ShardedDirect"]


class ShardedDirect:
    """Sharded counterparts of ``RecToolsDIRTPU.FBP`` / ``FOURIER_INV``.

    ``model`` is a :class:`~tomobar_tpu_torch.models.direct.RecToolsDIRTPU`
    of the whole volume; data is this rank's slab of the canonical
    ``(detY, angles, detX)`` sinogram (:meth:`device_put_sino` cuts it)."""

    def __init__(self, model, mesh: Mesh):
        self.model = model
        self.mesh = mesh
        self.sp = ShardedProjector(model.geom, mesh)

    @staticmethod
    def _require_canonical_axes(kwargs):
        """Sharded entry points take canonical (detY, angles, detX) only:
        detY is the sharded axis, so another order would cut the wrong axis
        into slabs and return a wrong reconstruction.  Reorder on the host
        (``data_dims_swapper``) before ``device_put_sino``."""
        order = kwargs.pop("data_axes_labels_order", None)
        if order is not None and list(order) != ["detY", "angles", "detX"]:
            raise ValueError(
                f"ShardedDirect requires canonical axes ['detY', 'angles', "
                f"'detX'] (got {list(order)}): the detY axis is mesh-sharded, "
                "so reorder with tomobar_tpu_torch.utils.tools.data_dims_swapper "
                "before device_put_sino"
            )

    def device_put_sino(self, sino) -> torch.Tensor:
        """This rank's slab of a whole canonical sinogram."""
        return self.sp.device_put_sino(sino)

    def _local(self, data) -> torch.Tensor:
        return torch.as_tensor(data).to(device=self.mesh.device, dtype=torch.float32)

    def fbp(self, data, **kwargs) -> torch.Tensor:
        """Sharded 3D FBP of this rank's slab: ``RecToolsDIRTPU.FBP``'s body
        (the sinc filter, ``cutoff_freq`` default 0.35, or with
        ``filter_type`` a classic one) with :meth:`ShardedProjector.bp`;
        returns the volume's slab."""
        self._require_canonical_axes(kwargs)
        data = self._local(data)
        n_angles = self.model.geom.n_angles
        if data.dim() != 3 or data.shape[1] != n_angles:
            raise ValueError(
                f"ShardedDirect.fbp expects this rank's slab as [detY, angles, detX] "
                f"with {n_angles} angles (got {tuple(data.shape)})")
        cutoff = kwargs.get("cutoff_freq")
        return filtered_bp(data, self.sp.bp, self.model.detectors_x_pad,
                           0.35 if cutoff is None else cutoff, **kwargs)

    def fourier_inv(self, data, **kwargs) -> torch.Tensor:
        """Sharded log-polar/USFFT inversion of this rank's slab.  The
        volume's detY must split into slabs of whole slice pairs (the
        two-real-slices-per-complex FFT packing)."""
        from tomobar_tpu_torch.ops.usfft import fourier_inv

        self._require_canonical_axes(kwargs)
        data = self._local(data)
        n_z_shards = self.mesh.shape["z"]
        nz = data.shape[0] * n_z_shards
        if nz % (2 * n_z_shards):
            raise ValueError(
                f"sharded FOURIER_INV needs detY ({nz}) divisible by "
                f"2 * z-shards ({n_z_shards}) so every shard packs whole "
                f"slice pairs; pad detY or change the mesh"
            )
        return fourier_inv(self.model, data, **kwargs)
