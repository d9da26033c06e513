"""Iterative solver cores on PyTorch tensors: power method, Landweber,
SIRT, CGLS, FISTA, ADMM and OSEM.

Counterpart of ``tomobar_tpu/solvers/core.py`` (reference
``tomobar/methodsIR_CuPy.py``: Landweber:128, SIRT:174, CGLS:233,
powermethod:311, FISTA:401, ADMM:486, OSEM:587).  PyTorch runs eagerly, so
the outer and the ordered-subset loops are plain Python loops and nothing
is compiled or cached per call.  Every sum, norm and maximum of a whole
volume or sinogram goes through the projector's ``global_sum``,
``global_norm`` and ``global_max``: the identity on one device, a
reduction over the z-slabs under
:class:`~tomobar_tpu_torch.parallel.sharding.ShardedProjector`, where a
rank holds one slab of each.  The reference's solver quirks that the JAX
package keeps for parity are kept too, and noted where they occur (CGLS's
in-loop clamp, ADMM's late relaxation and once-per-outer-iteration dual
update, OSEM's multiplication by the clipped subset-0 sensitivity).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tomobar_tpu_torch.fidelity import grad_data_term, swls_weights
from tomobar_tpu_torch.ops.projector import Projector
from tomobar_tpu_torch.trace import span

__all__ = ["power_method", "landweber", "sirt", "cgls", "fista", "admm", "osem"]


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
    from a ``torch.Generator`` seeded with ``seed`` on ``device``: by
    default the projector's device where it has one (a
    :class:`~tomobar_tpu_torch.parallel.sharding.ShardedProjector`'s
    mesh), else the current CUDA device; without CUDA that raises, and
    ``device="cpu"`` runs on the host.  Under a ``ShardedProjector``
    ``vol_shape`` is this rank's slab and the start is that slab of the
    whole volume's draw (the whole drawn, the rest freed), so a mesh
    starts where one device starts."""
    del use_pwls  # weights are ones in the reference's power method
    use_os = len(projector.subset_indices) > 1

    def Ax(v):
        return projector.fp_sub(v, 0) if use_os else projector.fp(v)

    def Atb(r):
        return projector.bp_sub(r, 0) if use_os else projector.bp(r)

    if x0 is None:
        device = device if device is not None else getattr(projector, "device", None)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "power_method: CUDA is not available (pass device='cpu' to run "
                    "on the CPU)")
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        mesh = getattr(projector, "mesh", None)
        shape = tuple(vol_shape)
        if mesh is not None:
            z0, z1 = mesh.z_slab(projector.geom.detectors_y)
            shape = (projector.geom.detectors_y, *shape[1:])
        x0 = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        if mesh is not None:
            x0 = x0[z0:z1].clone()
    y = Ax(x0.to(torch.float32))
    s = torch.ones((), dtype=torch.float32, device=y.device)
    for _ in range(iterations):
        x1 = Atb(y)
        s = projector.global_norm(x1)
        y = Ax(x1 / s)
    return float(s)


def _volume(sino: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    """A (detY, n, n) volume filled with ``value`` beside ``sino``."""
    return torch.full((sino.shape[0], n, n), value, dtype=torch.float32, device=sino.device)


def landweber(
    projector: Projector,
    sino: torch.Tensor,
    iterations: int = 1500,
    tau_step: float = 1e-5,
    nonnegativity: bool = False,
) -> torch.Tensor:
    """Landweber iterations x <- x - tau A^T (A x - b) from zero."""
    x = _volume(sino, projector.geom.recon_size)
    for _ in range(iterations):
        x = x - tau_step * projector.bp(projector.fp(x) - sino)
        if nonnegativity:
            x = torch.clamp(x, min=0.0)
    return x


def _safe_reciprocal(v: torch.Tensor) -> torch.Tensor:
    """1 / v with NaN and +-inf replaced by 1 (SIRT's row/column sums)."""
    return torch.nan_to_num(1.0 / v, nan=1.0, posinf=1.0, neginf=1.0)


def sirt(
    projector: Projector,
    sino: torch.Tensor,
    iterations: int = 200,
    nonnegativity: bool = False,
) -> torch.Tensor:
    """SIRT x <- x + C A^T (R (b - A x)) from ones, R and C the inverse
    row and column sums of A."""
    x = _volume(sino, projector.geom.recon_size, 1.0)
    R = _safe_reciprocal(projector.fp(x))
    C = _safe_reciprocal(projector.bp(torch.ones_like(sino)))
    for _ in range(iterations):
        x = x + C * projector.bp(R * (sino - projector.fp(x)))
        if nonnegativity:
            x = torch.clamp(x, min=0.0)
    return x


def _dot(projector: Projector, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return projector.global_sum(torch.dot(a.reshape(-1), b.reshape(-1)))


def cgls(
    projector: Projector,
    sino: torch.Tensor,
    iterations: int = 30,
    nonnegativity: bool = False,
) -> torch.Tensor:
    """Conjugate gradients on the normal equations, from zero."""
    x = _volume(sino, projector.geom.recon_size)
    d = projector.bp(sino)
    normr2 = _dot(projector, d, d)
    r = sino
    for _ in range(iterations):
        Ad = projector.fp(d)
        alpha = normr2 / _dot(projector, Ad, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        s = projector.bp(r)
        normr2_new = _dot(projector, s, s)
        d = s + (normr2_new / normr2) * d
        normr2 = normr2_new
        if nonnegativity:
            # the reference clamps x inside the CG loop
            # (methodsIR_CuPy.py:296-297); kept for parity
            x = torch.clamp(x, min=0.0)
    return x


def _prepare_pwls_weights(projector: Projector, sino: torch.Tensor) -> torch.Tensor:
    """PWLS weights from the (padded, post-log) data
    (``methodsIR_CuPy.py:392-397``)."""
    w = torch.clamp(sino, min=1e-6)
    return w / projector.global_max(torch.max(w))


def _prepare_weights(projector: Projector, sino, fidelity: str, fid_kwargs: dict):
    if fidelity == "PWLS":
        return _prepare_pwls_weights(projector, sino)
    if fidelity == "SWLS":
        return swls_weights(sino, fid_kwargs.get("beta_SWLS", 0.1),
                            global_max=projector.global_max)
    return None


def _rel_update(projector: Projector, x_new: torch.Tensor, x_prev: torch.Tensor) -> float:
    num = projector.global_norm(x_new - x_prev)
    den = torch.clamp(projector.global_norm(x_new), min=1e-12)
    return float(num / den)


def _stop(projector: Projector, name: str, it: int, x, x_prev, tolerance: float,
          verbose: bool) -> bool:
    """Progress print and early stop after outer iteration ``it``: the
    relative update norm is printed when ``verbose`` and ends the solve once
    below ``tolerance > 0``."""
    if not (verbose or (tolerance and tolerance > 0.0)):
        return False
    rel = _rel_update(projector, x, x_prev)
    if verbose:
        print(f"{name} iteration ({it + 1}) relative update: {rel:.3e}")
    if tolerance and tolerance > 0.0 and rel < tolerance:
        if verbose:
            print(f"{name} stopped at iteration ({it + 1}): tolerance reached")
        return True
    return False


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
    n_sub = len(projector.subset_indices)
    use_os = n_sub > 1
    fid_kwargs = fid_kwargs or {}
    L_inv = float(np.float32(1.0 / lipschitz_const))

    w = _prepare_weights(projector, sino, fidelity, fid_kwargs)
    subs, w_subs = _subset_slices(projector, sino, w)

    if x0 is None:
        x0 = _volume(sino, projector.geom.recon_size)
    x = x_t = x0
    t = np.float32(1.0)
    one, four, half = np.float32(1.0), np.float32(4.0), np.float32(0.5)
    nz, n = x0.shape[0], x0.shape[-1]
    for it in range(iterations):
        x_prev = x
        for s in range(n_sub):
            with span("tomobar::solver.subset", nz=nz, n=n):
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
        if _stop(projector, "FISTA", it, x, x_prev, tolerance, verbose):
            break
    return x


def admm(
    projector: Projector,
    sino: torch.Tensor,
    iterations: int,
    lipschitz_const: float,
    rho_const: float = 1.0,
    relax_par: float = 1.6,
    nonnegativity: bool = False,
    fidelity: str = "LS",
    regul_fn: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    fid_kwargs: Optional[dict] = None,
    tolerance: float = 0.0,
    verbose: bool = False,
) -> torch.Tensor:
    """Linearised and relaxed ADMM with ordered subsets
    (``methodsIR_CuPy.py:486-585``).  As in the reference, relaxation
    starts at outer iteration index 2 and the dual ``u`` is updated once per
    outer iteration.  ``tolerance``/``verbose`` as in :func:`fista`."""
    n_sub = len(projector.subset_indices)
    use_os = n_sub > 1
    fid_kwargs = fid_kwargs or {}
    tau = float(np.float32(0.9 / (lipschitz_const + rho_const)))

    w = _prepare_weights(projector, sino, fidelity, fid_kwargs)
    subs, w_subs = _subset_slices(projector, sino, w)

    if x0 is None:
        x0 = _volume(sino, projector.geom.recon_size)
    x = z = x0
    z_old = u = torch.zeros_like(x0)
    nz, n = x0.shape[0], x0.shape[-1]
    for it in range(iterations):
        x_prev = x
        for s in range(n_sub):
            with span("tomobar::solver.admm_subset", nz=nz, n=n):
                grad = grad_data_term(
                    projector,
                    z,
                    subs[s],
                    sub_ind=s if use_os else None,
                    w=w_subs[s],
                    fidelity=fidelity,
                    huber_threshold=fid_kwargs.get("huber_threshold"),
                    studentst_threshold=fid_kwargs.get("studentst_threshold"),
                )
                z = z - tau * (grad + rho_const * (z - x + u))
                if nonnegativity:
                    z = torch.clamp(z, min=0.0)
                if it > 1:
                    z = (1.0 - relax_par) * z_old + relax_par * z
                z_old = z
                x = z + u
                if regul_fn is not None:
                    x = regul_fn(x)
        u = u + (z - x)
        if _stop(projector, "ADMM", it, x, x_prev, tolerance, verbose):
            break
    return x


def osem(
    projector: Projector,
    sino: torch.Tensor,
    iterations: int,
    regul_fn: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    normalisation_mode: str = "reference",
) -> torch.Tensor:
    """OSEM (MLEM with one subset), multiplicative EM updates
    (``methodsIR_CuPy.py:587-667``).

    ``normalisation_mode`` "reference" multiplies by the clipped
    sensitivity volume of subset 0, ``x *= backproj * normalisation``, as
    the reference does (``methodsIR_CuPy.py:654``); "divide" is the
    textbook update ``x *= backproj / A_s^T 1`` with each subset's own
    sensitivity."""
    if normalisation_mode not in ("reference", "divide"):
        raise ValueError(
            "osem_normalisation must be 'reference' or 'divide', got "
            f"{normalisation_mode!r}"
        )
    n_sub = len(projector.subset_indices)
    use_os = n_sub > 1
    eps = 1e-8

    def Ax(v, s):
        return projector.fp_sub(v, s) if use_os else projector.fp(v)

    def Atb(r, s):
        return projector.bp_sub(r, s) if use_os else projector.bp(r)

    subs, _ = _subset_slices(projector, sino)
    if normalisation_mode == "reference":
        # one volume from subset 0, used for every subset (reference quirk)
        norms = [torch.clamp(Atb(torch.ones_like(subs[0]), 0), min=eps)] * n_sub
    else:
        norms = [
            torch.clamp(Atb(torch.ones_like(subs[s]), s), min=eps)
            for s in range(n_sub)
        ]
    x = _volume(sino, projector.geom.recon_size, 1.0) if x0 is None else x0
    for _ in range(iterations):
        for s in range(n_sub):
            backproj = Atb(subs[s] / torch.clamp(Ax(x, s), min=eps), s)
            if normalisation_mode == "reference":
                x = x * (backproj * norms[s])
            else:
                x = x * (backproj / norms[s])
            if regul_fn is not None:
                x = regul_fn(x)
    return x
