"""Iterative solver cores on PyTorch tensors: power method and FISTA.

Counterpart of ``tomobar_tpu/solvers/core.py`` (reference
``tomobar/methodsIR_CuPy.py``: powermethod:311, FISTA:401).  PyTorch runs
eagerly, so the outer and the ordered-subset loops are plain Python loops
and nothing is compiled or cached per call.  Landweber, SIRT, CGLS, ADMM
and OSEM are not ported yet (ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tomobar_tpu_torch.fidelity import grad_data_term, swls_weights
from tomobar_tpu_torch.ops.projector import Projector

__all__ = ["power_method", "fista"]


def _subset_slices(projector: Projector, sino, w=None):
    """Slice the sinogram (and optional weights) once per OS subset."""
    n_sub = len(projector.subset_indices)
    subs = [projector.sino_subset(sino, s) for s in range(n_sub)]
    w_subs = (
        [projector.sino_subset(w, s) for s in range(n_sub)]
        if w is not None
        else [None] * n_sub
    )
    return subs, w_subs


def power_method(
    projector: Projector,
    vol_shape,
    iterations: int = 15,
    use_pwls: bool = False,
    seed: int = 0,
    device=None,
    x0: Optional[torch.Tensor] = None,
) -> float:
    """Spectral norm of A^T A via power iterations (reference
    ``methodsIR_CuPy.py:311-354``): with OS only subset 0 is used, and the
    PWLS weights are ones, so the value matches LS.

    The start vector is ``x0`` when given, else standard normal numbers
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    del use_pwls  # weights are ones in the reference's power method
    use_os = len(projector.subset_indices) > 1

    def Ax(v):
        return projector.fp_sub(v, 0) if use_os else projector.fp(v)

    def Atb(r):
        return projector.bp_sub(r, 0) if use_os else projector.bp(r)

    if x0 is None:
        device = torch.device("cpu" if device is None else device)
        gen = torch.Generator(device=device).manual_seed(seed)
        x0 = torch.randn(
            tuple(vol_shape), generator=gen, dtype=torch.float32, device=device
        )
    y = Ax(x0.to(torch.float32))
    s = torch.ones((), dtype=torch.float32, device=y.device)
    for _ in range(iterations):
        x1 = Atb(y)
        s = torch.linalg.vector_norm(x1)
        y = Ax(x1 / s)
    return float(s)


def _prepare_pwls_weights(sino: torch.Tensor) -> torch.Tensor:
    """PWLS weights from the (padded, post-log) data
    (``methodsIR_CuPy.py:392-397``)."""
    w = torch.clamp(sino, min=1e-6)
    return w / torch.max(w)


def _prepare_weights(sino, fidelity: str, fid_kwargs: dict):
    if fidelity == "PWLS":
        return _prepare_pwls_weights(sino)
    if fidelity == "SWLS":
        return swls_weights(sino, fid_kwargs.get("beta_SWLS", 0.1))
    return None


def _rel_update(x_new: torch.Tensor, x_prev: torch.Tensor) -> float:
    num = torch.linalg.vector_norm(x_new - x_prev)
    den = torch.clamp(torch.linalg.vector_norm(x_new), min=1e-12)
    return float(num / den)


def fista(
    projector: Projector,
    sino: torch.Tensor,
    iterations: int,
    lipschitz_const: float,
    nonnegativity: bool = False,
    fidelity: str = "LS",
    regul_fn: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    fid_kwargs: Optional[dict] = None,
    tolerance: float = 0.0,
    verbose: bool = False,
) -> torch.Tensor:
    """FISTA with optional ordered subsets and proximal regularisation
    (``methodsIR_CuPy.py:401-484``).

    ``tolerance > 0`` stops early once the relative update norm of an
    outer iteration falls below it; ``verbose`` prints that norm after
    every outer iteration.  The momentum scalar ``t`` is kept in float32 on
    the host, as the JAX package keeps it in float32."""
    nz = sino.shape[0]
    n = projector.geom.recon_size
    n_sub = len(projector.subset_indices)
    use_os = n_sub > 1
    fid_kwargs = fid_kwargs or {}
    L_inv = float(np.float32(1.0 / lipschitz_const))

    w = _prepare_weights(sino, fidelity, fid_kwargs)
    subs, w_subs = _subset_slices(projector, sino, w)

    if x0 is None:
        x0 = torch.zeros((nz, n, n), dtype=torch.float32, device=sino.device)
    x = x_t = x0
    t = np.float32(1.0)
    one, four, half = np.float32(1.0), np.float32(4.0), np.float32(0.5)
    for it in range(iterations):
        x_prev = x
        for s in range(n_sub):
            x_old, t_old = x, t
            grad = grad_data_term(
                projector,
                x_t,
                subs[s],
                sub_ind=s if use_os else None,
                w=w_subs[s],
                fidelity=fidelity,
                huber_threshold=fid_kwargs.get("huber_threshold"),
                studentst_threshold=fid_kwargs.get("studentst_threshold"),
            )
            x = x_t - L_inv * grad
            if nonnegativity:
                x = torch.clamp(x, min=0.0)
            if regul_fn is not None:
                x = regul_fn(x)
            t = np.float32((one + np.sqrt(one + four * t * t)) * half)
            x_t = x + float(np.float32((t_old - one) / t)) * (x - x_old)
        if verbose or (tolerance and tolerance > 0.0):
            rel = _rel_update(x, x_prev)
            if verbose:
                print(f"FISTA iteration ({it + 1}) relative update: {rel:.3e}")
            if tolerance and tolerance > 0.0 and rel < tolerance:
                if verbose:
                    print(f"FISTA stopped at iteration ({it + 1}): tolerance reached")
                break
    return x
