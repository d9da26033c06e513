"""Plain reference of the port's parallel-beam operator pair: the two-pass
shear / resample projector, from its definition.

Angles split into an x-driven group (|cos| >= |sin|) and a y-driven one,
whose volume is seen with y and x swapped and (sin, cos) for (cos, sin).
Per group, with alpha = 1/c, beta = -s/c, gamma = alpha (cor - (det_x -
1)/2) + (row_len - 1)/2 (float64, then float32):

    shear     s[a, z, u] = sum_r (1 - f) row_r[u - o] + f row_r[u - o + 1]
    resample  p[z, a, t] = w0 s[a, z, i] + w1 s[a, z, i + 1]

with shift = beta_a (r - (n_rows - 1)/2), o = U0 - floor(shift), f = shift -
floor(shift), pos = U0 + gamma + alpha t, i = floor(pos) and the hat
weights w0 = |alpha| max(0, 1 - |pos - i|), w1 = |alpha| max(0, 1 - |pos - i
- 1|), all in float32; the back-projection is the exact transpose of both.

The shear is computed here as what it is, a sum of shifted rows: in the
Fourier domain along u a row shifted by o and interpolated with f is the
row's transform times W = ((1 - f) + f e^{i w}) e^{-i w o}, so for each
frequency the sum over rows is a matrix product (angles x rows) @ (rows x
slices), and the transpose uses the conjugate of W.  The products run in
float32 (TF32 off).  Nothing in this file is shared with the port.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from benchmark.reference.common import rounder

# frequencies per block of the matrix products: bounds the memory of W
_W_BYTES = 2**29


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _smooth_length(n: int) -> int:
    """The smallest length >= n whose only prime factors are 2, 3 and 5."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


class Group(NamedTuple):
    idx: np.ndarray  # the group's angles in the (subset's) sinogram
    swap: bool  # y-driven: the volume's y and x swapped
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    U0: int
    L: int  # length of the u axis (and of its transforms)


def groups(theta: np.ndarray, cor: float, det_x: int, n: int, device) -> List[Group]:
    """The driven groups of the angles ``theta`` on an n x n slice."""
    theta = np.asarray(theta, np.float64)
    cos_v, sin_v = np.cos(theta), np.sin(theta)
    xdrive = np.abs(cos_v) >= np.abs(sin_v)
    out = []
    for mask, c, s, swap in ((xdrive, cos_v, sin_v, False), (~xdrive, sin_v, cos_v, True)):
        idx = np.where(mask)[0]
        if idx.size == 0:
            continue
        c, s = c[idx], s[idx]
        alpha = 1.0 / c
        beta = -s / c
        gamma = alpha * (cor - (det_x - 1) / 2.0) + (n - 1) / 2.0
        U0 = _round_up(n // 2 + 2, 128)
        half_span = int(math.ceil(np.max(np.abs(beta)) * (n - 1) / 2.0)) + 2
        L = _smooth_length(U0 + half_span + n + 2)

        def put(a):
            return torch.as_tensor(a.astype(np.float32), device=device)

        out.append(Group(idx, swap, put(alpha), put(beta), put(gamma), U0, L))
    return out


def _shifts(g: Group, n_rows: int):
    """o[a, r] and f[a, r], float32 arithmetic as the definition."""
    rc = torch.arange(n_rows, dtype=torch.float32, device=g.beta.device) - (n_rows - 1) / 2.0
    shift = g.beta[:, None] * rc[None, :]
    kf = torch.floor(shift)
    return (g.U0 - kf).to(torch.int64), shift - kf


def _taps(g: Group, det_x: int):
    """Lower tap i[a, t] and the weights w0, w1 of the resampling."""
    t = torch.arange(det_x, dtype=torch.float32, device=g.alpha.device)
    pos = (g.U0 + g.gamma)[:, None] + g.alpha[:, None] * t[None, :]
    i = torch.floor(pos)
    aa = torch.abs(g.alpha)[:, None]
    w0 = aa * torch.clamp(1.0 - torch.abs(pos - i), min=0.0)
    w1 = aa * torch.clamp(1.0 - torch.abs(pos - (i + 1.0)), min=0.0)
    return i.to(torch.int64), w0, w1


def shear_spectrum(g: Group, n_rows: int, k0: int, k1: int) -> torch.Tensor:
    """W[k, a, r] for frequencies k0 <= k < k1: the transform of row r's
    kernel at angle a, complex64."""
    dev = g.beta.device
    o, f = _shifts(g, n_rows)
    L = g.L
    k = torch.arange(k0, k1, dtype=torch.int64, device=dev)[:, None, None]
    table = torch.exp(2j * math.pi * torch.arange(L, dtype=torch.float64, device=dev) / L).to(torch.complex64)
    e0 = table[torch.remainder(-k * o[None], L)]
    e1 = table[torch.remainder(-k * (o[None] - 1), L)]
    f = f[None].to(torch.complex64)
    return e0 * (1.0 - f) + e1 * f


def _full_spectrum(g: Group, n_rows: int) -> torch.Tensor:
    """W[k, a, r] at every frequency, made block by block."""
    K = g.L // 2 + 1
    W = torch.empty((K, g.alpha.shape[0], n_rows), dtype=torch.complex64, device=g.beta.device)
    for k0, k1 in _blocks(g, n_rows):
        W[k0:k1] = shear_spectrum(g, n_rows, k0, k1)
    return W


def _blocks(g: Group, n_rows: int):
    K = g.L // 2 + 1
    per = max(1, _W_BYTES // (8 * g.alpha.shape[0] * n_rows))
    return [(k0, min(k0 + per, K)) for k0 in range(0, K, per)]


def fp_group(vol: torch.Tensor, g: Group, det_x: int, prec: str = "fp32", W=None) -> torch.Tensor:
    """The group's forward projection of vol (nz, n, n): (nz, A, det_x)."""
    q = rounder(prec)
    rows = vol.transpose(1, 2) if g.swap else vol
    nz, n_rows, _ = rows.shape
    A = g.alpha.shape[0]
    R = torch.fft.rfft(rows, n=g.L, dim=-1).permute(2, 1, 0).contiguous()  # (K, r, z)
    S = torch.empty((R.shape[0], A, nz), dtype=torch.complex64, device=vol.device)
    for k0, k1 in _blocks(g, n_rows):
        Wk = W[k0:k1] if W is not None else shear_spectrum(g, n_rows, k0, k1)
        S[k0:k1] = torch.bmm(Wk, R[k0:k1])
    s = q(torch.fft.irfft(S.permute(1, 2, 0), n=g.L, dim=-1))  # (A, nz, L)
    i, w0, w1 = _taps(g, det_x)
    sp = torch.nn.functional.pad(s, (1, 1))  # sp[..., 1 + u] = s[u]
    g0 = torch.gather(sp, 2, torch.clamp(i + 1, 0, g.L + 1)[:, None, :].expand(A, nz, det_x))
    g1 = torch.gather(sp, 2, torch.clamp(i + 2, 0, g.L + 1)[:, None, :].expand(A, nz, det_x))
    return q((w0[:, None, :] * g0 + w1[:, None, :] * g1).transpose(0, 1))


def bp_group(p: torch.Tensor, g: Group, n: int, prec: str = "fp32", W=None) -> torch.Tensor:
    """The transpose of :func:`fp_group`: p (nz, A, det_x) -> (nz, n, n)."""
    q = rounder(prec)
    nz, A, det_x = p.shape
    i, w0, w1 = _taps(g, det_x)
    u = torch.zeros((A, nz, g.L + 2), dtype=torch.float32, device=p.device)
    pa = p.transpose(0, 1)
    for tap, w in ((i, w0), (i + 1, w1)):
        valid = (tap >= 0) & (tap < g.L)
        idx = torch.where(valid, tap + 1, 0)[:, None, :].expand(A, nz, det_x)
        u.scatter_add_(2, idx, torch.where(valid, w, 0.0)[:, None, :] * pa)
    u = q(u[:, :, 1:g.L + 1])
    Q = torch.fft.rfft(u, dim=-1).permute(2, 0, 1).contiguous()  # (K, a, z)
    Y = torch.empty((Q.shape[0], n, nz), dtype=torch.complex64, device=p.device)
    for k0, k1 in _blocks(g, n):
        Wk = W[k0:k1] if W is not None else shear_spectrum(g, n, k0, k1)
        Y[k0:k1] = torch.bmm(Wk.conj().transpose(1, 2), Q[k0:k1])
    rows = torch.fft.irfft(Y.permute(2, 1, 0), n=g.L, dim=-1)[..., :n]  # (nz, r, j)
    return q(rows.transpose(1, 2) if g.swap else rows)


class Operator:
    """A = FP and A^T = BP of the angles ``theta`` (one OS subset or all)
    on n x n slices; ``cache_w`` keeps each group's W between calls (for a
    subset's FP and BP in one gradient)."""

    def __init__(self, theta, cor: float, det_x: int, n: int, device, prec: str = "fp32",
                 cache_w: bool = False):
        self.n_angles, self.det_x, self.n, self.prec = len(theta), det_x, n, prec
        self.groups = groups(theta, cor, det_x, n, device)
        self.W = [_full_spectrum(g, n) if cache_w else None for g in self.groups]

    def fp(self, vol: torch.Tensor) -> torch.Tensor:
        squeeze = vol.dim() == 2
        vol = vol[None] if squeeze else vol
        out = torch.zeros((vol.shape[0], self.n_angles, self.det_x), dtype=torch.float32,
                          device=vol.device)
        for g, W in zip(self.groups, self.W):
            out[:, torch.as_tensor(g.idx, device=vol.device)] = fp_group(vol, g, self.det_x, self.prec, W)
        return out[0] if squeeze else out

    def bp(self, sino: torch.Tensor) -> torch.Tensor:
        squeeze = sino.dim() == 2
        sino = sino[None] if squeeze else sino
        vol = None
        for g, W in zip(self.groups, self.W):
            part = bp_group(sino[:, torch.as_tensor(g.idx, device=sino.device)], g, self.n, self.prec, W)
            vol = part if vol is None else vol + part
        return vol[0] if squeeze else vol
