"""The iterative solvers on a projector object (:mod:`.core`): power
method, Landweber, SIRT, CGLS, FISTA, ADMM and OSEM."""

from tomobar_tpu_torch.solvers.core import fista, power_method

__all__ = ["power_method", "fista"]
