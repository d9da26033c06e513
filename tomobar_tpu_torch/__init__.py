"""tomobar_tpu_torch — the tomobar_tpu reconstruction framework on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A second package beside the JAX package ``tomobar_tpu``, which stays the
reference it is tested against.  It imports neither jax nor ``tomobar_tpu``.
The ported slice is the iterative main path: ``RecToolsIRCuPy.FISTA`` with
LS/PWLS/SWLS/KL fidelity, ordered subsets and a PD-TV prox, on the
two-pass shear/resample projector pair.  CUDA tensors run the kernels of
``csrc/`` (built with nvcc at first use); CPU tensors run their plain
PyTorch versions.

>>> from tomobar_tpu_torch import RecToolsIRCuPy
"""

from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.models.iterative import RecToolsIRTPU

# drop-in alias matching the reference class name
RecToolsIRCuPy = RecToolsIRTPU

__all__ = ["Geometry", "RecToolsIRTPU", "RecToolsIRCuPy"]
