"""Plain reference of the PD-TV prox (Chambolle-Pock), from its definition.

Forward differences reflect at the far edge (d[-1] = u[-2] - u[-1]), the
divergence takes the neighbour before index 0 as zero, and tau = 0.1
lambda, sigma = 1 / (L tau), lt = tau / lambda, theta = 1, in float32.  Per
iteration, from u = data and zero duals:

    p_k   += sigma D_k u                      (x, y and, in 3D, z)
    p     *= 1 / max(1, |p|)                  (iso)
    uc     = max(u, 0)                        (non-negativity)
    u_new  = (uc + tau div p + lt data) / (1 + lt)
    u      = u_new + theta (u_new - uc)
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import rounder


def constants(lam: float, lipschitz: float):
    tau = np.float32(lam * 0.1)
    sigma = np.float32(np.float32(1.0) / (np.float32(lipschitz) * tau))
    lt = np.float32(tau / np.float32(lam))
    return float(sigma), float(tau), float(lt)


def pd_tv(data: torch.Tensor, lam: float, iterations: int, lipschitz: float = 12.0,
          nonneg: bool = True, prec: str = "fp32") -> torch.Tensor:
    """Iso PD-TV of a (nz, ny, nx) float32 volume; nz == 1 has no z term."""
    q = rounder(prec)
    sigma, tau, lt = constants(lam, lipschitz)
    dims = [2, 1] + ([0] if data.shape[0] > 1 else [])
    u = data.clone()
    ps = [torch.zeros_like(data) for _ in dims]
    tmp = torch.empty_like(data)
    for _ in range(iterations):
        for p, d in zip(ps, dims):
            n = u.shape[d]
            torch.sub(u.narrow(d, 1, n - 1), u.narrow(d, 0, n - 1), out=tmp.narrow(d, 0, n - 1))
            torch.sub(u.narrow(d, n - 2, 1), u.narrow(d, n - 1, 1), out=tmp.narrow(d, n - 1, 1))
            p.add_(tmp, alpha=sigma)
        norm2 = ps[0] * ps[0]
        for p in ps[1:]:
            norm2.addcmul_(p, p)
        scale = torch.rsqrt_(norm2.clamp_(min=1.0))
        for i, p in enumerate(ps):
            ps[i] = q(p.mul_(scale))
        div = ps[0].clone()
        for p, d in zip(ps, dims):
            if p is not ps[0]:
                div.add_(p)
            n = p.shape[d]
            div.narrow(d, 1, n - 1).sub_(p.narrow(d, 0, n - 1))
        uc = torch.clamp(u, min=0.0) if nonneg else u
        u_new = torch.add(uc, div, alpha=tau).add_(data, alpha=lt).div_(1.0 + lt)
        u = q(u_new.mul_(2.0).sub_(uc))
    return u
