"""Parallel-beam Radon transform pair (FP / BP) on PyTorch tensors.

Counterpart of ``tomobar_tpu/ops/projector.py`` on its Pallas backend: the
operator is the two-pass shear/resample pair of
:mod:`tomobar_tpu_torch.ops.projector_kernels` (K1-K4, and K1p/K4p in place
of K1/K4 for one slice whose driven rows come in groups of 8, under the
JAX package's conditions), an exact numerical adjoint pair.  Public layouts are the JAX package's canonical ones:
volumes ``(nz, ny, nx)`` and sinograms ``(detY, angles, detX)``; 2D inputs
``(ny, nx)`` / ``(angles, detX)`` are accepted and returned as 2D.

A detector cell ``t`` at angle ``theta`` sees the line
``x cos(theta) + y sin(theta) = t - (det_x-1)/2 + cor``
(conventions in :mod:`tomobar_tpu_torch.geometry`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops.projector_kernels import (
    DrivenParams,
    _partition,
    driven_params,
    resample_bp,
    resample_fp,
    shear_fp,
    shear_fp_packed,
    unshear_bp,
    unshear_bp_packed,
)

__all__ = [
    "CHUNK_BYTES",
    "MAX_ELEMENTS",
    "radon_fp",
    "radon_bp",
    "forward_project",
    "back_project",
    "Projector",
]


# A stack of any depth goes through the kernels in z-chunks (slices are
# independent in FP and BP, so the chunks change no bit of the result).  A
# chunk keeps a group's u-lines ``s``/``q`` (A x chunk x LU floats, the
# largest intermediate) under CHUNK_BYTES, which bounds the memory of a call
# beside its input and output, and every tensor a kernel sees under
# MAX_ELEMENTS, the kernels' element cap.
CHUNK_BYTES = 2 * 2**30
MAX_ELEMENTS = 2**31 - 1


def _angle_partition(angles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x-driven (|cos| >= |sin|, ties included) and y-driven angle indices."""
    cos_v = np.cos(angles)
    sin_v = np.sin(angles)
    xdrive = np.abs(cos_v) >= np.abs(sin_v)
    return np.where(xdrive)[0], np.where(~xdrive)[0]


# ---------------------------------------------------------------------------
# vertical per-angle CoR: detector-centre z shift, applied as a per-angle
# linear-interp shift along detY around the kernels; zero fill outside keeps
# the FP/BP pair an exact adjoint (shift by +dz transposes to shift by -dz)
# ---------------------------------------------------------------------------


def _vshift_sino(sino: torch.Tensor, dz: np.ndarray) -> torch.Tensor:
    """out[v, a, t] = lin-interp of sino at (v + dz[a], a, t), zero outside.
    Angles are independent, so they go by in runs that keep the gather and
    its temporaries under ``CHUNK_BYTES`` and ``MAX_ELEMENTS`` each; the
    result does not depend on the runs."""
    nz, A, det_x = sino.shape
    dzt = torch.as_tensor(np.asarray(dz), dtype=sino.dtype, device=sino.device)
    kf = torch.floor(dzt)
    f = (dzt - kf)[None, :, None]
    i0 = torch.arange(nz, device=sino.device)[:, None] + kf.to(torch.int64)[None, :]
    per_angle = max(nz * det_x, 1)
    step = max(min(CHUNK_BYTES // (4 * per_angle), MAX_ELEMENTS // per_angle), 1)
    out = torch.empty_like(sino)
    for a0 in range(0, A, step):
        a1 = min(a0 + step, A)
        part = sino[:, a0:a1]
        acc = None
        for i, w in ((i0[:, a0:a1], 1.0 - f[:, a0:a1]), (i0[:, a0:a1] + 1, f[:, a0:a1])):
            valid = ((i >= 0) & (i < nz))[:, :, None]
            g = torch.gather(
                part, 0, torch.clamp(i, 0, nz - 1)[:, :, None].expand(nz, a1 - a0, det_x)
            )
            term = w * torch.where(valid, g, 0.0)
            acc = term if acc is None else acc + term
        out[:, a0:a1] = acc
    return out


class _Group(NamedTuple):
    """One driven-angle group with its parameters on the device."""

    idx: torch.Tensor  # angle indices of the group in the geometry
    prm: DrivenParams
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    swap: bool  # y-driven: the kernels see the volume's y and x swapped


class _Plan:
    """A geometry with its per-group kernel parameters, uploaded once per
    (volume shape, device)."""

    def __init__(self, geom: Geometry):
        self.geom = geom
        self._groups = {}

    def groups(self, ny: int, nx: int, device: torch.device,
               single_slice: bool = False) -> List[_Group]:
        """The driven-angle groups of a (ny, nx) slice; with
        ``single_slice`` (nz == 1) a group whose driven rows number a
        multiple of 8 is packed (``radon_fp_pallas``/``radon_bp_pallas``'
        conditions: ny % 8 for the x-driven group, nx % 8 for the y-driven
        one, n % 8 for both in BP, where ny == nx == n)."""
        key = (ny, nx, device, single_slice)
        if key not in self._groups:
            g = self.geom
            cos_v, sin_v, idx_x, idx_y = _partition(g.angles)
            cor = g.cor_horizontal
            det_x = g.detectors_x_total
            out = []
            # x-driven rows are image rows (y); y-driven rows are columns (x)
            for idx, c, s, shape, swap in (
                (idx_x, cos_v, sin_v, (ny, nx), False),
                (idx_y, sin_v, cos_v, (nx, ny), True),
            ):
                if idx.size == 0:
                    continue
                packed = single_slice and shape[0] % 8 == 0
                prm = driven_params(
                    c[idx], s[idx], cor[idx], det_x, *shape, packed=packed
                )

                def put(a, dtype=torch.float32):
                    return torch.as_tensor(a, dtype=dtype, device=device)

                out.append(
                    _Group(
                        put(idx, torch.int64), prm, put(prm.alpha),
                        put(prm.beta), put(prm.gamma), swap,
                    )
                )
            self._groups[key] = out
        return self._groups[key]

    def fp(self, vol: torch.Tensor) -> torch.Tensor:
        dzv = self.geom.cor_vertical
        if dzv is not None and vol.dim() == 3 and np.any(dzv):
            return _vshift_sino(self._fp_core(vol), dzv)
        return self._fp_core(vol)

    def bp(self, sino: torch.Tensor) -> torch.Tensor:
        dzv = self.geom.cor_vertical
        if dzv is not None and sino.dim() == 3 and np.any(dzv):
            sino = _vshift_sino(sino, -np.asarray(dzv))
        return self._bp_core(sino)

    def _z_chunks(self, nz: int, groups: List[_Group], *per_slice: int):
        """(z0, z1) runs of slices: each keeps the largest group's u-lines
        under CHUNK_BYTES and these, and the other per-slice element counts
        of the caller, under MAX_ELEMENTS.  Runs of more than one slice are
        even where nz allows it (K4 takes two slices per block)."""
        lines = max((g.prm.A * g.prm.LU for g in groups), default=1)
        widest = max(lines, *per_slice, 1)
        zc = max(min(CHUNK_BYTES // (4 * lines), MAX_ELEMENTS // widest, nz), 1)
        if 1 < zc < nz:
            zc -= zc % 2
        return [(z0, min(z0 + zc, nz)) for z0 in range(0, nz, zc)]

    def _fp_core(self, vol: torch.Tensor) -> torch.Tensor:
        squeeze = vol.dim() == 2
        if squeeze:
            vol = vol[None]
        vol = vol.to(torch.float32).contiguous()
        nz, ny, nx = vol.shape
        det_x = self.geom.detectors_x_total
        n_angles = self.geom.n_angles
        groups = self.groups(ny, nx, vol.device, nz == 1)
        if not groups:
            out = torch.zeros((nz, 0, det_x), dtype=torch.float32, device=vol.device)
            return out[0] if squeeze else out
        chunks = self._z_chunks(nz, groups, ny * nx, n_angles * det_x)
        out = None
        for z0, z1 in chunks:
            part = vol[z0:z1]
            for g in groups:
                if g.prm.packed:
                    # the y-driven group reads one explicit transpose of the slice
                    rows = part.transpose(1, 2).contiguous() if g.swap else part
                    s = shear_fp_packed(rows, g.beta, g.prm.U0, g.prm.LU)
                else:
                    s = shear_fp(part, g.beta, g.prm.U0, g.prm.LU, g.swap)
                p = resample_fp(s, g.alpha, g.gamma, g.prm.U0, det_x)
                del s
                if len(groups) == 1 and len(chunks) == 1:
                    out = p
                    break
                if out is None:
                    out = torch.empty(
                        (nz, n_angles, det_x), dtype=torch.float32, device=vol.device,
                    )
                if len(groups) == 1:
                    out[z0:z1] = p
                else:
                    out[z0:z1, g.idx] = p
        return out[0] if squeeze else out

    def _bp_core(self, sino: torch.Tensor) -> torch.Tensor:
        squeeze = sino.dim() == 2
        if squeeze:
            sino = sino[None]
        sino = sino.to(torch.float32).contiguous()
        nz, n_angles, det_x = sino.shape
        n = self.geom.recon_size
        groups = self.groups(n, n, sino.device, nz == 1)
        if not groups:
            vol = torch.zeros((nz, n, n), dtype=torch.float32, device=sino.device)
            return vol[0] if squeeze else vol
        vol = torch.empty((nz, n, n), dtype=torch.float32, device=sino.device)
        for z0, z1 in self._z_chunks(nz, groups, n * n, n_angles * det_x):
            part = sino[z0:z1]
            for k, g in enumerate(groups):
                p = part if len(groups) == 1 else part[:, g.idx]
                q = resample_bp(p, g.alpha, g.gamma, g.prm.U0, g.prm.LU)
                # the first group writes the chunk's slices, the others add
                if g.prm.packed:
                    unshear_bp_packed(q, g.beta, g.prm.U0, n, g.swap, out=vol[z0:z1],
                                      accumulate=k > 0)
                else:
                    unshear_bp(q, g.beta, g.prm.U0, n, n, g.swap, out=vol[z0:z1],
                               accumulate=k > 0)
                del q
        return vol[0] if squeeze else vol


def radon_fp(vol: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Forward-project a volume.  vol (nz, n, n) or (n, n) -> sino
    (nz, n_angles, det_x_total) or (n_angles, det_x_total)."""
    return _Plan(geom).fp(vol)


def radon_bp(sino: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Back-project a sinogram (exact adjoint of :func:`radon_fp`); the
    output slice size is ``geom.recon_size``."""
    return _Plan(geom).bp(sino)


# ---------------------------------------------------------------------------
# differentiable pair: FP and BP are each other's backward
# ---------------------------------------------------------------------------


class _ForwardProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vol, plan):
        ctx.plan = plan
        return plan.fp(vol)

    @staticmethod
    def backward(ctx, ct):
        return ctx.plan.bp(ct), None


class _BackProject(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sino, plan):
        ctx.plan = plan
        return plan.bp(sino)

    @staticmethod
    def backward(ctx, ct):
        return ctx.plan.fp(ct), None


def forward_project(vol: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """:func:`radon_fp` with :func:`radon_bp` as its backward."""
    return _ForwardProject.apply(vol, _Plan(geom))


def back_project(sino: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """:func:`radon_bp` with :func:`radon_fp` as its backward."""
    return _BackProject.apply(sino, _Plan(geom))


# ---------------------------------------------------------------------------
# Projector: per-geometry operator pair with OS subset support
# ---------------------------------------------------------------------------


class Projector:
    """Operator pair A / A^T for a fixed geometry, with OS subsets.  Kernel
    parameters are uploaded once per subset and device."""

    def __init__(self, geom: Geometry):
        self.geom = geom
        self.subset_indices = geom.os_indices()
        self._sub_geoms = [geom.subset(ind) for ind in self.subset_indices]
        self._plan = _Plan(geom)
        self._sub_plans = [_Plan(g) for g in self._sub_geoms]

    def fp(self, vol: torch.Tensor) -> torch.Tensor:
        return _ForwardProject.apply(vol, self._plan)

    def bp(self, sino: torch.Tensor) -> torch.Tensor:
        return _BackProject.apply(sino, self._plan)

    def fp_sub(self, vol: torch.Tensor, sub: int) -> torch.Tensor:
        return _ForwardProject.apply(vol, self._sub_plans[sub])

    def bp_sub(self, sino: torch.Tensor, sub: int) -> torch.Tensor:
        return _BackProject.apply(sino, self._sub_plans[sub])

    def sino_subset(self, sino: torch.Tensor, sub: int) -> torch.Tensor:
        ind = torch.as_tensor(self.subset_indices[sub], device=sino.device)
        if sino.dim() == 2:
            return sino[ind, :]
        return sino[:, ind, :]
