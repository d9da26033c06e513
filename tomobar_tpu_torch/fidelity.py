"""Data-fidelity gradients for FISTA (LS, PWLS, SWLS, KL + robust residual
modifiers), on PyTorch tensors.

Counterpart of ``tomobar_tpu/fidelity.py``; see its module notes for the
SWLS stripe weights and the Huber / Student's-t thresholds.  ``b`` is
post-log data for LS/PWLS/SWLS and pre-log raw counts for KL.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tomobar_tpu_torch.trace import span

__all__ = ["grad_data_term", "swls_weights"]


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median that averages the two middle values of an even count, as
    ``jnp.median`` does (``torch.median`` returns the lower one)."""
    n = x.shape[dim]
    srt = torch.sort(x, dim=dim).values
    hi = srt.narrow(dim, n // 2, 1)
    if n % 2:
        return hi.squeeze(dim)
    lo = srt.narrow(dim, n // 2 - 1, 1)
    return ((lo + hi) * 0.5).squeeze(dim)


def swls_weights(b: torch.Tensor, beta: float = 0.1, window: int = 9,
                 global_max: Optional[Callable] = None) -> torch.Tensor:
    """Stripe weights from post-log data ``b`` (detY, angles, detX):
    ``w = beta^2 / (beta^2 + d^2)``, max-normalised, with ``d`` the
    per-element angle-median minus its sliding detX median.  ``global_max``
    turns the maximum of ``b``'s weights into that of the whole stack (a
    z-slab's projector passes its own)."""
    med = _median(b, -2)  # (detY, detX)
    half = window // 2
    padded = torch.nn.functional.pad(med[None], (half, half), mode="reflect")[0]
    stack = torch.stack(
        [padded[:, i : i + med.shape[-1]] for i in range(window)], dim=0
    )
    d = med - _median(stack, 0)
    beta2 = float(np.float32(beta * beta))
    w = beta2 / (beta2 + d * d)
    w_max = torch.max(w)
    if global_max is not None:
        w_max = global_max(w_max)
    w = (w / w_max)[:, None, :]
    return w.expand(b.shape).to(torch.float32)


def _apply_robust(res, huber: Optional[float], studentst: Optional[float]):
    if huber is not None and huber > 0.0:
        d = float(np.float32(huber))
        res = torch.clamp(res, -d, d)
    if studentst is not None and studentst > 0.0:
        d = float(np.float32(studentst))
        res = res / (1.0 + (res / d) ** 2)
    return res


def grad_data_term(
    projector,
    x: torch.Tensor,
    b: torch.Tensor,
    sub_ind: Optional[int] = None,
    w: Optional[torch.Tensor] = None,
    fidelity: str = "LS",
    huber_threshold: Optional[float] = None,
    studentst_threshold: Optional[float] = None,
) -> torch.Tensor:
    """Gradient of the data-fidelity term: A^T r with r = (Ax - b)
    [* w] for LS/PWLS/SWLS, or r = 1 - b / clip(Ax) for KL; robust
    modifiers reshape r before the backprojection.  ``b`` and ``w`` are
    already subset-sliced when ``sub_ind`` is given."""
    use_os = sub_ind is not None

    def Ax(v):
        return projector.fp_sub(v, sub_ind) if use_os else projector.fp(v)

    def Atb(r):
        return projector.bp_sub(r, sub_ind) if use_os else projector.bp(r)

    with span("tomobar::fidelity.grad"):
        if fidelity in ("LS", "PWLS", "SWLS"):
            res = Ax(x) - b
            if w is not None:
                res = res * w
            res = _apply_robust(res, huber_threshold, studentst_threshold)
        elif fidelity == "KL":
            res = 1.0 - b / torch.clamp(Ax(x), min=1e-8)
        else:
            raise ValueError(f"Unsupported data fidelity: {fidelity}")
        return Atb(res)
