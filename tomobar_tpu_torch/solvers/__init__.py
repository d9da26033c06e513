from tomobar_tpu_torch.solvers.core import fista, power_method

__all__ = ["power_method", "fista"]
