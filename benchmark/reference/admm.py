"""Plain reference of ToMoBAR's real-data recipe (``Demos/RealData.py:228-235``)
as the ADMM cell runs it, from the definitions:

* normalisation (``suppTools.py:187-264``, method "mean"): the flats and
  darks averaged over their stacks; denominators flat - dark <= 0 and
  numerators frame - dark < 0 both replaced by 1 before the division;
  -log of the strictly positive ratios, and what is not positive, or
  comes out negative, set to 0.  The result, in attenuation units of
  4 / n per pixel, is scaled back to pixel units (times n / 4);
* the detector edge-padded by ``pad`` on each side (``suppTools.py:425-459``);
* the warm start: FBP (the sinc filter, ``benchmark.reference.direct.fbp``)
  on the padded detector and the (n + 2 pad)^2 grid;
* ADMM (``methodsIR_CuPy.py:486-585``), linearised and relaxed, with
  ordered subsets interleaving the angles: the Lipschitz constant L of the
  power method on subset 0 (``benchmark.reference.fista.power_method``),
  tau = 0.9 / (L + rho) in float32, the PWLS weights w = max(b, 1e-6) /
  max of that on the padded data, and per subset s, from x = z = the warm
  start and z_old = u = 0:

      z = z - tau (A_s^T (w_s (A_s z - b_s)) + rho (z - x + u))
      z = (1 - relax) z_old + relax z        (outer iteration index >= 2)
      z_old = z;  x = prox(z + u)

  with u = u + (z - x) after each outer iteration, and the prox PD-TV
  (``benchmark.reference.pd_tv.pd_tv``) with regul_param / rho, without
  non-negativity;
* the result cropped to the centre n x n (with no padding: masked by
  ``recon_mask_radius`` instead).

Departures from the published description: none in the mathematics.  The
relaxation from outer iteration index 2 and the dual update once per
outer iteration are the reference implementation's own rules, kept as it
has them; the power method's start vector is the port's (standard normal
numbers of a generator seeded with 0), since the published code draws
its own.  The operator is ``benchmark.reference.projector.Operator``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import rounder
from benchmark.reference.direct import fbp
from benchmark.reference.fista import circle_mask, power_method
from benchmark.reference.pd_tv import pd_tv
from benchmark.reference.projector import Operator


def normalise(frames: torch.Tensor, flats: torch.Tensor, darks: torch.Tensor) -> torch.Tensor:
    """-log((frames - dark) / (flat - dark)) with ToMoBAR's guards; the
    stacks of ``flats`` and ``darks`` lie along axis 0, as the frames'
    angles do."""
    flat, dark = flats.mean(dim=0), darks.mean(dim=0)
    denom = flat - dark
    denom = torch.where(denom <= 0.0, torch.ones_like(denom), denom)
    numer = frames - dark
    numer = torch.where(numer < 0.0, torch.ones_like(numer), numer)
    ratio = numer / denom
    positive = ratio > 0.0
    out = torch.where(positive, -torch.log(torch.where(positive, ratio, torch.ones_like(ratio))),
                      torch.zeros_like(ratio))
    return torch.where(out < 0.0, torch.zeros_like(out), out)


def admm(sino: torch.Tensor, theta: np.ndarray, cor: float, pad: int, os_number: int,
         cutoff: float, iterations: int, rho: float, relax: float, regul: dict,
         prec: str = "fp32") -> torch.Tensor:
    """ADMM of ``sino`` [detY, angles, detX] in pixel units, warm-started
    by the padded-detector FBP; returns the (detY, N, N) volume on the
    padded grid, N = detX + 2 pad."""
    q = rounder(prec)
    dev = sino.device
    nz, n_ang, _ = sino.shape
    b = q(torch.nn.functional.pad(sino, (pad, pad), mode="replicate"))
    N = b.shape[-1]
    x = z = fbp(b, theta, cor, N, cutoff, prec)
    subsets = [np.arange(s, n_ang, os_number) for s in range(min(os_number, n_ang))]

    def op(s):
        return Operator(theta[subsets[s]], cor, N, N, dev, prec, cache_w=True)

    ops = {0: op(0)}
    L = power_method(ops[0], (nz, N, N), dev)
    tau = float(np.float32(0.9 / (L + rho)))
    w = torch.clamp(b, min=1e-6)
    w = w / torch.max(w)
    b_sub = [b[:, torch.as_tensor(ix, device=dev)] for ix in subsets]
    w_sub = [w[:, torch.as_tensor(ix, device=dev)] for ix in subsets]
    z_old = u = torch.zeros_like(z)
    lam, tv_iters = float(regul["regul_param"]) / rho, int(regul["iterations"])
    for it in range(iterations):
        for s in range(len(subsets)):
            A = ops.pop(s) if s in ops else op(s)
            grad = A.bp(q((A.fp(z) - b_sub[s]) * w_sub[s]))
            del A
            z = q(z - tau * (grad + rho * (z - x + u)))
            if it > 1:
                z = q((1.0 - relax) * z_old + relax * z)
            z_old = z
            x = pd_tv(q(z + u), lam, tv_iters, 12.0, False, prec)
        u = q(u + (z - x))
    return x


def admm_counts(frames: torch.Tensor, flats: torch.Tensor, darks: torch.Tensor,
                theta: np.ndarray, cor: float, n: int, pad: int, os_number: int, cutoff: float,
                iterations: int, rho: float, relax: float, regul: dict, mask_radius: float = 2.0,
                prec: str = "fp32") -> torch.Tensor:
    """The recipe from raw ``frames`` (angles, rows, det_x), ``flats`` and
    ``darks`` to the (rows, n, n) reconstruction."""
    q = rounder(prec)
    sino = q(normalise(frames, flats, darks) * (n / 4.0)).transpose(0, 1)
    x = admm(sino, theta, cor, pad, os_number, cutoff, iterations, rho, relax, regul, prec)
    if pad > 0:
        c = (x.shape[-1] - n) // 2
        return x[:, c:c + n, c:c + n]
    return x * circle_mask(n, mask_radius, x.device)
