"""tomobar_tpu_torch — the tomobar_tpu reconstruction framework on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A second package beside the JAX package ``tomobar_tpu``, which stays the
reference it is tested against.  It imports neither jax nor ``tomobar_tpu``.
Ported so far:

* the iterative path: ``RecToolsIRCuPy`` (power method, Landweber, SIRT,
  CGLS, FISTA, ADMM, OSEM) with LS/PWLS/SWLS/KL fidelity, ordered subsets
  and every prox of the JAX package (ROF-TV, PD-TV and the legacy FGP-TV,
  SB-TV, LLT-ROF, TGV, NDF, Diff4th, NLTV, Haar wavelets), on the two-pass
  shear/resample projector pair (its packed nz = 1 kernels for one slice)
  or, under ``set_projector_backend("xla")``, the one-pass Joseph pair;
* the direct path: ``RecToolsDIR``/``RecToolsDIRCuPy`` 2D and 3D ``FBP``,
  ``FORWPROJ``/``BACKPROJ``, 2D ``FOURIER`` and ``FOURIER_INV`` (the USFFT
  gridding and the fused axis-(-2) FFT pass);
* preprocessing and memory planning: ``utils.tools.normaliser`` and
  ``autocropper`` (numpy on the host with the C++/OpenMP pass of
  ``native/``, or tensors on their device), ``utils.dffc`` (dynamic flat
  fields), ``utils.center`` (centre of rotation), ``utils.memest``
  (``DeviceMemStack``, a model of ``FOURIER_INV``'s memory from the shapes,
  which its shape-tuple dry run records);
* several devices: ``tomobar_tpu_torch.parallel`` (a ("z", "angles") mesh
  of ``torch.distributed`` ranks; ``ShardedProjector`` under the solvers,
  ``ShardedDirect``).

CUDA tensors run the kernels of ``csrc/`` (built with nvcc at first use);
CPU tensors run their plain PyTorch versions.

>>> from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy
"""

from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.models.direct import RecToolsDIR, RecToolsDIRTPU
from tomobar_tpu_torch.models.iterative import RecToolsIRTPU

# drop-in aliases matching the reference class names
RecToolsDIRCuPy = RecToolsDIRTPU
RecToolsIRCuPy = RecToolsIRTPU

__version__ = "0.1.0"

__all__ = [
    "Geometry",
    "RecToolsDIR",
    "RecToolsDIRTPU",
    "RecToolsDIRCuPy",
    "RecToolsIRTPU",
    "RecToolsIRCuPy",
]
