"""Plain reference of ``RecToolsIRCuPy(...).FISTA`` with ordered subsets,
PWLS, non-negativity and the PD-TV prox, from ToMoBAR's definitions.

* Subsets interleave the angles: subset s takes s, s + OS, s + 2 OS, ...
* The Lipschitz constant is the power method's: 15 iterations of A^T A on
  subset 0 (weights ones) from standard normal numbers of a generator
  seeded with 0 on the device, y = A x0; x1 = A^T y, L = ||x1||, y = A (x1 / L).
* PWLS weights: w = max(b, 1e-6) / max of that.
* Per subset: x = max(x_t - (1/L) A_s^T (w_s (A_s x_t - b_s)), 0), the prox,
  t' = (1 + sqrt(1 + 4 t^2)) / 2, x_t = x + ((t - 1) / t') (x - x_old), the
  momentum in float32 on the host.
* The result is masked to the inscribed circle (radius 1.0).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import rounder
from benchmark.reference.pd_tv import pd_tv
from benchmark.reference.projector import Operator


def circle_mask(n: int, radius: float, device) -> torch.Tensor:
    """ToMoBAR's circular mask on an n x n slice (radius <= 1 shrinks it)."""
    half = n // 2
    limit = half - abs(half - half / radius) if radius <= 1.0 else half + abs(half - half / radius)
    c = torch.arange(n, dtype=torch.float64, device=device) - half
    return (torch.sqrt(c[None, :] ** 2 + c[:, None] ** 2) <= limit).to(torch.float32)


def power_method(op: Operator, vol_shape, device, iterations: int = 15) -> float:
    gen = torch.Generator(device=device).manual_seed(0)
    x0 = torch.randn(tuple(vol_shape), generator=gen, dtype=torch.float32, device=device)
    y = op.fp(x0)
    s = None
    for _ in range(iterations):
        x1 = op.bp(y)
        s = torch.linalg.vector_norm(x1)
        y = op.fp(x1 / s)
    return float(s)


def fista(sino: torch.Tensor, theta: np.ndarray, cor: float, n: int, os_number: int,
          iterations: int, regul: dict, prec: str = "fp32") -> torch.Tensor:
    """The reconstruction of ``sino`` [detY, angles, detX] as the cell's
    FISTA call makes it (PWLS, non-negativity, iso PD-TV with
    ``regul["regul_param"]``, ``regul["iterations"]``, Lipschitz 12)."""
    q = rounder(prec)
    dev = sino.device
    nz, n_ang, det_x = sino.shape
    subsets = [np.arange(s, n_ang, os_number) for s in range(min(os_number, n_ang))]

    def op(s):
        return Operator(theta[subsets[s]], cor, det_x, n, dev, prec, cache_w=True)

    ops = {0: op(0)}
    L = power_method(ops[0], (nz, n, n), dev)
    L_inv = float(np.float32(1.0 / L))
    w = torch.clamp(sino, min=1e-6)
    w = w / torch.max(w)
    b_sub = [sino[:, torch.as_tensor(ix, device=dev)] for ix in subsets]
    w_sub = [w[:, torch.as_tensor(ix, device=dev)] for ix in subsets]
    x = x_t = torch.zeros((nz, n, n), dtype=torch.float32, device=dev)
    t = np.float32(1.0)
    one, four, half = np.float32(1.0), np.float32(4.0), np.float32(0.5)
    lam, tv_iters = float(regul["regul_param"]), int(regul["iterations"])
    for _ in range(iterations):
        for s in range(len(subsets)):
            A = ops.pop(s) if s in ops else op(s)
            x_old, t_old = x, t
            grad = A.bp(q((A.fp(x_t) - b_sub[s]) * w_sub[s]))
            del A
            x = q(torch.clamp(x_t - L_inv * grad, min=0.0))
            x = pd_tv(x, lam, tv_iters, 12.0, True, prec)
            t = np.float32((one + np.sqrt(one + four * t * t)) * half)
            x_t = q(x + float(np.float32((t_old - one) / t)) * (x - x_old))
    return x * circle_mask(n, 1.0, dev)
