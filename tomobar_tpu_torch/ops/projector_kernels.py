"""Host side of the projector kernels K1-K4, their plain PyTorch versions
and the wrappers that launch the CUDA kernels of ``csrc/projector.cu``.

Counterpart of the host side of ``tomobar_tpu/ops/projector_pallas.py``.
Per driven-angle group (x-driven when |cos| >= |sin|, y-driven otherwise,
with the volume's y and x axes swapped: K1 on a transposed copy, K4 by
index mapping) the forward projector is

    K1  shear_fp     vol (nz, ny, nx)    -> s (A, nz, LU)
    K2  resample_fp  s (A, nz, LU)       -> p (nz, A, det_x)
    K3  resample_bp  p (nz, A, det_x)    -> q (A, nz, LU)
    K4  unshear_bp   q (A, nz, LU)       -> vol (nz, ny, nx)

and K3/K4 are the exact transposes of K2/K1.  A single slice (nz == 1)
whose driven rows come in groups of 8 takes the packed pair instead, as
in the JAX package:

    K1p shear_fp_packed    rows (1, n_rows, row_len) -> s (A, 1, LU)
    K4p unshear_bp_packed  q (A, 1, LU)              -> vol (1, n, n)

the same sums as K1/K4 at nz == 1 with kernels designed for one slice
(K1p cuts the driven rows into runs that are summed side by side and then
added in order, see :func:`packed_splits`).
``U0``, ``NXP`` and ``LU`` are the JAX package's own (``packed`` widens
NXP, hence LU, by 128 as there), so ``s`` and ``q`` line up index for
index with the Pallas stages; the TPU-only glue (angle padding to block
multiples, z-chunking, 128-lane row rounding, the d-rolled ``qs`` copies
of K4p) has no counterpart.

Each ``*_plain`` function is the plain PyTorch version of its kernel.  A
wrapper runs the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tomobar_tpu_torch import _build

__all__ = [
    "DrivenParams",
    "driven_params",
    "shear_fp",
    "resample_fp",
    "resample_bp",
    "unshear_bp",
    "shear_fp_packed",
    "unshear_bp_packed",
    "packed_splits",
    "shear_fp_plain",
    "resample_fp_plain",
    "resample_bp_plain",
    "unshear_bp_plain",
    "shear_fp_packed_plain",
    "unshear_bp_packed_plain",
]

_INT32_MAX = 2**31 - 1

# K1p sums the driven rows in up to K1P_SPLITS runs (K1P_SPLITS_FEW for at
# most K1P_FEW_ANGLES angles, an OS subset's group) of at least
# K1P_MIN_BANDS bands of K1P_BAND rows each (the kernel's band)
K1P_SPLITS = 4
K1P_SPLITS_FEW = 8
K1P_FEW_ANGLES = 256
K1P_MIN_BANDS = 32
K1P_BAND = 8


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class DrivenParams(NamedTuple):
    """Per-angle parameters of one driven-axis group (A real angles)."""

    alpha: np.ndarray  # 1/cos for x-driven (signed), float32
    beta: np.ndarray  # -tan, float32
    gamma: np.ndarray  # alpha*(cor - (det_x-1)/2) + (row_len-1)/2, float32
    A: int
    det_x: int
    U0: int  # u of the row centre: headroom for the largest row shift
    NXP: int  # row width with the Pallas roll headroom; sizes LU
    LU: int  # length of the u-lines s and q
    packed: bool  # the nz == 1 pair K1p/K4p runs this group


def driven_params(
    cos_v: np.ndarray,
    sin_v: np.ndarray,
    cor_v: np.ndarray,
    det_x: int,
    n_rows: int,
    row_len: int,
    packed: bool = False,
) -> DrivenParams:
    """Port of ``projector_pallas._driven_params`` without angle padding:
    float64 math, float32 results, the same U0/NXP/LU (``packed`` widens
    NXP by 128, the Pallas K1p's per-sublane roll headroom)."""
    alpha = 1.0 / cos_v
    beta = -sin_v / cos_v
    gamma = alpha * (cor_v - (det_x - 1) / 2.0) + (row_len - 1) / 2.0
    NXP = _round_up(row_len + 2, 128) + 128
    if packed:
        NXP += 128
    U0 = _round_up(n_rows // 2 + 2, 128)
    LU = _round_up(U0 + n_rows // 2 + 2 + NXP, 128) + 128
    return DrivenParams(
        alpha.astype(np.float32),
        beta.astype(np.float32),
        gamma.astype(np.float32),
        int(alpha.shape[0]),
        int(det_x),
        U0,
        NXP,
        LU,
        bool(packed),
    )


def _partition(angles: np.ndarray):
    from tomobar_tpu_torch.ops.projector import _angle_partition

    idx_x, idx_y = _angle_partition(angles)
    return np.cos(angles), np.sin(angles), idx_x, idx_y


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _row_shifts(beta: torch.Tensor, n_rows: int, U0: int):
    """o[a, r] = U0 - floor(beta_a (r - cy)) and its fraction f, in fp32
    exactly as the kernels compute them."""
    rc = torch.arange(n_rows, dtype=torch.float32, device=beta.device) - (
        n_rows - 1
    ) / 2.0
    shift = beta[:, None] * rc[None, :]
    kf = torch.floor(shift)
    return U0 - kf.to(torch.int64), shift - kf


def _det_taps(alpha: torch.Tensor, gamma: torch.Tensor, U0: int, det_x: int):
    """Detector sample positions pos[a, t] = (U0 + gamma) + alpha t, the
    lower tap i = floor(pos) and the |alpha|-scaled hat weights of taps i
    and i + 1."""
    t = torch.arange(det_x, dtype=torch.float32, device=alpha.device)
    pos = (U0 + gamma)[:, None] + alpha[:, None] * t[None, :]
    i = torch.floor(pos)
    aa = torch.abs(alpha)[:, None]
    w0 = aa * torch.clamp(1.0 - torch.abs(pos - i), min=0.0)
    w1 = aa * torch.clamp(1.0 - torch.abs(pos - (i + 1.0)), min=0.0)
    return i.to(torch.int64), w0, w1


def shear_fp_plain(vol, beta, U0: int, LU: int, swap: bool = False):
    """K1: s[a, z, u] = sum_r (1-f) row_r[u-o] + f row_r[u-o+1]."""
    rows = vol.transpose(1, 2) if swap else vol  # (nz, n_rows, row_len)
    o, f = _row_shifts(beta, rows.shape[1], U0)
    return _shear_rows(rows, o, f, 0, rows.shape[1], LU)


def _shear_rows(rows, o, f, r0: int, r1: int, LU: int):
    """The shear sum over rows [r0, r1) of (nz, n_rows, row_len) ``rows``, in
    ascending order from zero, with the shifts ``o``/``f`` of
    :func:`_row_shifts`: (A, nz, LU)."""
    nz, _, row_len = rows.shape
    A = o.shape[0]
    rowp = torch.nn.functional.pad(rows, (1, 1))  # rowp[.., 1 + j] = row[j]
    u = torch.arange(LU, device=rows.device)
    s = torch.zeros((nz, A, LU), dtype=torch.float32, device=rows.device)
    for r in range(r0, r1):
        j = u[None, :] - o[:, r : r + 1]  # (A, LU)
        i0 = torch.clamp(j + 1, 0, row_len + 1).reshape(-1)
        i1 = torch.clamp(j + 2, 0, row_len + 1).reshape(-1)
        row = rowp[:, r, :]
        fr = f[:, r : r + 1]
        s += (1.0 - fr) * row[:, i0].view(nz, A, LU) + fr * row[:, i1].view(
            nz, A, LU
        )
    return s.transpose(0, 1).contiguous()


def resample_fp_plain(s, alpha, gamma, U0: int, det_x: int):
    """K2: p[z, a, t] = |alpha| sum_u s[a, z, u] hat(pos_t - u)."""
    A, nz, LU = s.shape
    i, w0, w1 = _det_taps(alpha, gamma, U0, det_x)
    sp = torch.nn.functional.pad(s, (1, 1))  # sp[.., 1 + u] = s[u]
    i0 = torch.clamp(i + 1, 0, LU + 1)
    i1 = torch.clamp(i + 2, 0, LU + 1)
    g0 = torch.gather(sp, 2, i0[:, None, :].expand(A, nz, det_x))
    g1 = torch.gather(sp, 2, i1[:, None, :].expand(A, nz, det_x))
    p = w0[:, None, :] * g0 + w1[:, None, :] * g1
    return p.transpose(0, 1).contiguous()


def resample_bp_plain(p, alpha, gamma, U0: int, LU: int,
                      index: Optional[torch.Tensor] = None):
    """K3, as the scatter that is plainly the transpose of K2:
    q[a, z, i] += w0 p[z, a, t] and q[a, z, i + 1] += w1 p[z, a, t].  With
    ``index`` (the positions of the A angles in ``p``), ``p`` is the whole
    (nz, n_angles, det_x) sinogram and angle a reads ``p[:, index[a]]``; an
    entry outside [0, n_angles) raises (the kernel does not count from the
    end either: it fails its launch)."""
    if index is not None:
        if index.numel() and not 0 <= int(index.min()) <= int(index.max()) < p.shape[1]:
            raise IndexError(f"K3: index must lie in [0, {p.shape[1]})")
        p = p[:, index]
    nz, A, det_x = p.shape
    i, w0, w1 = _det_taps(alpha, gamma, U0, det_x)
    q = torch.zeros((A, nz, LU + 2), dtype=torch.float32, device=p.device)
    pa = p.transpose(0, 1)  # (A, nz, det_x)
    for tap, w in ((i, w0), (i + 1, w1)):
        valid = (tap >= 0) & (tap < LU)
        idx = torch.where(valid, tap + 1, 0)[:, None, :].expand(A, nz, det_x)
        q.scatter_add_(2, idx, torch.where(valid, w, 0.0)[:, None, :] * pa)
    return q[:, :, 1 : LU + 1].contiguous()


def unshear_bp_plain(q, beta, U0: int, ny: int, nx: int, swap: bool = False,
                     out: Optional[torch.Tensor] = None, accumulate: bool = True):
    """K4: vol_row[j] = sum_a (1-f) q[a, o+j] + f q[a, o+j-1]; returns a new
    volume, or adds into ``out`` (overwrites it with ``accumulate=False``)."""
    A, nz, LU = q.shape
    n_rows, row_len = (nx, ny) if swap else (ny, nx)
    o, f = _row_shifts(beta, n_rows, U0)
    qp = torch.nn.functional.pad(q, (1, 1))  # qp[.., 1 + u] = q[u]
    j = torch.arange(row_len, device=q.device)
    acc = torch.zeros((nz, n_rows, row_len), dtype=torch.float32, device=q.device)
    for a in range(A):
        u = o[a][:, None] + j[None, :]  # (n_rows, row_len)
        i0 = torch.clamp(u + 1, 0, LU + 1).reshape(-1)
        i1 = torch.clamp(u, 0, LU + 1).reshape(-1)
        fa = f[a][:, None]
        acc += (1.0 - fa) * qp[a][:, i0].view(nz, n_rows, row_len) + fa * qp[
            a
        ][:, i1].view(nz, n_rows, row_len)
    vol = acc.transpose(1, 2) if swap else acc
    if out is None:
        return vol.contiguous()
    if accumulate:
        out += vol
    else:
        out.copy_(vol)
    return out


def packed_splits(n_rows: int, n_angles: int) -> int:
    """Runs into which K1p cuts ``n_rows`` driven rows: one slice gives the
    card too few blocks, so the rows are summed in runs side by side and the
    partial sums added in order.  The fewer the angles (hence blocks), the
    more runs pay; a small slice takes one run."""
    n_bands = -(-n_rows // K1P_BAND)
    most = K1P_SPLITS_FEW if n_angles <= K1P_FEW_ANGLES else K1P_SPLITS
    return max(1, min(most, n_bands // K1P_MIN_BANDS))


def shear_fp_packed_plain(rows, beta, U0: int, LU: int, splits: Optional[int] = None):
    """K1p: K1 on one slice whose rows are the driven rows (the y-driven
    group passes the transposed slice), summed as the kernel sums them: the
    rows in ``splits`` runs of ceil(bands / splits) bands (default
    :func:`packed_splits`), each run in ascending order from zero, then the
    runs' sums added in ascending order.  One run is K1's sum bit for bit;
    more runs differ from it in the last bits only."""
    _, n_rows, row_len = rows.shape
    splits = packed_splits(n_rows, beta.shape[0]) if splits is None else int(splits)
    if splits < 1:
        raise ValueError(f"K1p: splits must be >= 1, got {splits}")
    if splits == 1:
        return shear_fp_plain(rows, beta, U0, LU)
    per = -(-(-(-n_rows // K1P_BAND)) // splits) * K1P_BAND  # rows of a run
    o, f = _row_shifts(beta, n_rows, U0)
    s = None
    for r0 in range(0, per * splits, per):
        r1 = min(r0 + per, n_rows)
        if r0 >= r1:
            part = torch.zeros((beta.shape[0], 1, LU), dtype=torch.float32, device=rows.device)
        else:
            # the run's rows with their shifts: row r of the slice keeps its r
            part = _shear_rows(rows, o, f, r0, r1, LU)
        s = part if s is None else s + part
    return s


def unshear_bp_packed_plain(q, beta, U0: int, n: int, swap: bool = False,
                            out: Optional[torch.Tensor] = None, accumulate: bool = True):
    """K4p: K4 on one n x n slice."""
    return unshear_bp_plain(q, beta, U0, n, n, swap, out, accumulate)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """CUDA tensors for the kernel, or meta tensors for a memory plan: the
    wrappers make their outputs and workspaces on ``meta`` as on the card,
    and launch nothing (``utils/memest.py`` ``estimate_memory``)."""
    dev = tensors[0].device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: tensors on {dev}; the kernel takes CUDA tensors")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        # the projector's z-chunks keep every tensor below the cap
        assert t.numel() <= _INT32_MAX, f"{name}: a tensor of {t.numel()} elements"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _params_ok(name: str, A: int, *vecs: torch.Tensor) -> None:
    for v in vecs:
        if v.dim() != 1 or v.shape[0] != A:
            raise ValueError(f"{name}: per-angle vectors must have shape ({A},)")


def shear_fp(vol, beta, U0: int, LU: int, swap: bool = False):
    """K1 (see :func:`shear_fp_plain`).  vol (nz, ny, nx) float32.  The
    kernel reads driven rows that lie along memory, so the y-driven group
    (``swap``) is given one transposed copy of the volume, as the JAX
    package gives it."""
    if vol.device.type == "cpu":
        return shear_fp_plain(vol, beta, U0, LU, swap)
    _check_cuda("K1", vol, beta)
    if vol.dim() != 3:
        raise ValueError("K1: vol must be (nz, ny, nx)")
    rows = vol.transpose(1, 2).contiguous() if swap else vol
    nz, n_rows, row_len = rows.shape
    A = beta.shape[0]
    _params_ok("K1", A, beta)
    s = torch.empty((A, nz, LU), dtype=torch.float32, device=vol.device)
    _check_cuda("K1", s)
    if s.is_meta:
        return s
    lib = _build.library()
    with torch.cuda.device(vol.device):
        err = lib.tt_shear_fp(
            rows.data_ptr(), beta.data_ptr(), s.data_ptr(), A, nz, n_rows,
            row_len, U0, LU, _stream(vol),
        )
    _build.check("K1", err)
    _build.launch_counts["K1"] += 1
    return s


def resample_fp(s, alpha, gamma, U0: int, det_x: int):
    """K2 (see :func:`resample_fp_plain`).  s (A, nz, LU) -> (nz, A, det_x)."""
    if s.device.type == "cpu":
        return resample_fp_plain(s, alpha, gamma, U0, det_x)
    _check_cuda("K2", s, alpha, gamma)
    if s.dim() != 3:
        raise ValueError("K2: s must be (A, nz, LU)")
    A, nz, LU = s.shape
    _params_ok("K2", A, alpha, gamma)
    p = torch.empty((nz, A, det_x), dtype=torch.float32, device=s.device)
    _check_cuda("K2", p)
    if p.is_meta:
        return p
    lib = _build.library()
    with torch.cuda.device(s.device):
        err = lib.tt_resample_fp(
            s.data_ptr(), alpha.data_ptr(), gamma.data_ptr(), p.data_ptr(),
            A, nz, LU, det_x, U0, _stream(s),
        )
    _build.check("K2", err)
    _build.launch_counts["K2"] += 1
    return p


def resample_bp(p, alpha, gamma, U0: int, LU: int,
                index: Optional[torch.Tensor] = None):
    """K3 (see :func:`resample_bp_plain`).  p (nz, A, det_x) -> (A, nz, LU);
    with ``index`` (int64, one position per angle) p is (nz, n_angles, det_x)
    and the kernel gathers row ``index[a]`` itself."""
    if p.device.type == "cpu":
        return resample_bp_plain(p, alpha, gamma, U0, LU, index)
    _check_cuda("K3", p, alpha, gamma)
    if p.dim() != 3:
        raise ValueError("K3: p must be (nz, A, det_x)")
    nz, n_rows, det_x = p.shape
    A = n_rows
    if index is not None:
        if index.dtype != torch.int64 or index.dim() != 1 or not index.is_contiguous():
            raise TypeError("K3: index must be a contiguous 1D int64 tensor")
        if index.device != p.device:
            raise ValueError(f"K3: index on {index.device}, p on {p.device}")
        # every entry must lie in [0, n_rows): the kernel checks that and
        # fails its launch (reading them back here would hold the host up)
        A = index.shape[0]
    _params_ok("K3", A, alpha, gamma)
    q = torch.empty((A, nz, LU), dtype=torch.float32, device=p.device)
    _check_cuda("K3", q)
    if q.is_meta:
        return q
    lib = _build.library()
    with torch.cuda.device(p.device):
        err = lib.tt_resample_bp(
            p.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
            None if index is None else index.data_ptr(), q.data_ptr(),
            A, nz, n_rows, LU, det_x, U0, _stream(p),
        )
    _build.check("K3", err)
    _build.launch_counts["K3"] += 1
    return q


def unshear_bp(q, beta, U0: int, ny: int, nx: int, swap: bool = False,
               out: Optional[torch.Tensor] = None, accumulate: bool = True):
    """K4 (see :func:`unshear_bp_plain`).  q (A, nz, LU) -> vol (nz, ny, nx),
    added into ``out`` when given (written over it with
    ``accumulate=False``)."""
    if q.device.type == "cpu":
        return unshear_bp_plain(q, beta, U0, ny, nx, swap, out, accumulate)
    _check_cuda("K4", q, beta)
    if q.dim() != 3:
        raise ValueError("K4: q must be (A, nz, LU)")
    A, nz, LU = q.shape
    _params_ok("K4", A, beta)
    if out is None:
        vol = torch.empty((nz, ny, nx), dtype=torch.float32, device=q.device)
    else:
        vol = out
        if tuple(vol.shape) != (nz, ny, nx):
            raise ValueError(f"K4: out must have shape {(nz, ny, nx)}")
    _check_cuda("K4", q, vol)
    if vol.is_meta:
        return vol
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.tt_unshear_bp(
            q.data_ptr(), beta.data_ptr(), vol.data_ptr(), A, nz, ny, nx, LU,
            U0, int(swap), int(out is not None and accumulate), _stream(q),
        )
    _build.check("K4", err)
    _build.launch_counts["K4"] += 1
    return vol


def _packed_ok(name: str, n_rows: int) -> None:
    if n_rows % 8:
        raise ValueError(f"{name}: {n_rows} driven rows, not a multiple of 8")


def shear_fp_packed(rows, beta, U0: int, LU: int, splits: Optional[int] = None):
    """K1p (see :func:`shear_fp_packed_plain`).  rows (1, n_rows, row_len)
    float32 with n_rows % 8 == 0 -> s (A, 1, LU)."""
    if rows.device.type == "cpu":
        return shear_fp_packed_plain(rows, beta, U0, LU, splits)
    _check_cuda("K1p", rows, beta)
    if rows.dim() != 3 or rows.shape[0] != 1:
        raise ValueError("K1p: rows must be (1, n_rows, row_len)")
    _, n_rows, row_len = rows.shape
    _packed_ok("K1p", n_rows)
    A = beta.shape[0]
    _params_ok("K1p", A, beta)
    splits = packed_splits(n_rows, A) if splits is None else int(splits)
    if splits < 1:
        raise ValueError(f"K1p: splits must be >= 1, got {splits}")
    s = torch.empty((A, 1, LU), dtype=torch.float32, device=rows.device)
    # the runs' partial sums; one run writes s itself
    part = s if splits == 1 else torch.empty(
        (splits, A, LU), dtype=torch.float32, device=rows.device)
    _check_cuda("K1p", s, part)
    if s.is_meta:
        return s
    lib = _build.library()
    if lib.tt_shear_fp_packed_band() != K1P_BAND:
        raise RuntimeError("K1p: the kernel's band differs from K1P_BAND")
    with torch.cuda.device(rows.device):
        err = lib.tt_shear_fp_packed(
            rows.data_ptr(), beta.data_ptr(), s.data_ptr(), part.data_ptr(), A,
            n_rows, row_len, U0, LU, splits, _stream(rows),
        )
    _build.check("K1p", err)
    _build.launch_counts["K1p"] += 1
    return s


def unshear_bp_packed(q, beta, U0: int, n: int, swap: bool = False,
                      out: Optional[torch.Tensor] = None, accumulate: bool = True):
    """K4p (see :func:`unshear_bp_packed_plain`).  q (A, 1, LU) -> vol
    (1, n, n) with n % 8 == 0, added into ``out`` when given (written over
    it with ``accumulate=False``)."""
    if q.device.type == "cpu":
        return unshear_bp_packed_plain(q, beta, U0, n, swap, out, accumulate)
    _check_cuda("K4p", q, beta)
    if q.dim() != 3 or q.shape[1] != 1:
        raise ValueError("K4p: q must be (A, 1, LU)")
    _packed_ok("K4p", n)
    A, _, LU = q.shape
    _params_ok("K4p", A, beta)
    if out is None:
        vol = torch.empty((1, n, n), dtype=torch.float32, device=q.device)
    else:
        vol = out
        if tuple(vol.shape) != (1, n, n):
            raise ValueError(f"K4p: out must have shape {(1, n, n)}")
    _check_cuda("K4p", q, vol)
    if vol.is_meta:
        return vol
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.tt_unshear_bp_packed(
            q.data_ptr(), beta.data_ptr(), vol.data_ptr(), A, n, LU, U0,
            int(swap), int(out is not None and accumulate), _stream(q),
        )
    _build.check("K4p", err)
    _build.launch_counts["K4p"] += 1
    return vol
