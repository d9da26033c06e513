"""Index arithmetic of the K1, K4, PD and F CUDA kernels, emulated in numpy.

The kernels of ``tomobar_tpu_torch/csrc`` run only on a GPU.  What can go
wrong in them apart from the compiler is their index arithmetic: windows,
zero fill, skipped bands, buffer parity, tiles, halos and levels, digit
order, twiddle indices, the shared-memory swizzle.  The emulations below
walk the same blocks, bands, batches, stages and thread items as
``shear_fp_kernel`` and ``unshear_bp_kernel`` (csrc/projector.cu),
``pd_tv_kernel`` (csrc/pd_tv.cu) and ``fft_axis2_kernel``
(csrc/fft_axis2.cu), formula for formula, on the CPU:

* K1 and K4 must equal ``shear_fp_plain`` and ``unshear_bp_plain`` bit for
  bit (float32, every product and sum rounded on its own, rows or angles
  summed in ascending order);
* PD must agree with ``pd_tv_plain`` within 1e-6 of the maximum (1e-3 with
  bfloat16 duals), for every launch plan;
* F must agree with ``numpy.fft`` within 1e-5 of the maximum (float32
  tables and arithmetic in another order).

Unstaged or unwritten shared memory is NaN in the emulation, so a tap read
outside the staged window, or a halo value that reaches an inner tile,
shows up in the result.
"""

import numpy as np
import pytest
import torch

from tomobar_tpu_torch.geometry import Geometry
from tomobar_tpu_torch.ops import fft_kernels as FK
from tomobar_tpu_torch.ops import projector_kernels as PK
from tomobar_tpu_torch.ops.projector import _Plan

f32 = np.float32

# ---------------------------------------------------------------------------
# K1: csrc/projector.cu, shear_fp_kernel
# ---------------------------------------------------------------------------

K1_U, K1_A, K1_R, K1_W = 8, 8, 8, 768  # kK1U, kK1A, kK1R, kK1W
K1_TILE = 32 * K1_U
K1_JUMP, K1_SPLITS = f32(0.5), 8  # kK1Jump, kK1Splits


def row_shift(beta, r, cy, U0):
    """row_shift() of projector.cu on float32 scalars or arrays."""
    shift = f32(beta) * (np.asarray(r, dtype=f32) - cy)
    kf = np.floor(shift)
    return U0 - kf.astype(np.int64), (shift - kf).astype(f32)


def k1_angle_tile(beta, tile):
    """k1_angle_tile(): angle range [a0, a1) of an angle tile; tiles do not
    span the first K1_SPLITS jumps of beta."""
    A = beta.shape[0]
    start = tiles_before = splits = 0
    for base in range(0, A, 32):  # one ballot of 32 lanes per step
        if splits >= K1_SPLITS:
            break
        a = base + np.arange(32)
        ok = (a > 0) & (a < A)
        jump = np.zeros(32, dtype=bool)
        jump[ok] = np.abs(beta[a[ok]] - beta[a[ok] - 1]) > K1_JUMP
        for j in base + np.flatnonzero(jump):
            if splits >= K1_SPLITS:
                break
            splits += 1
            n_tiles = (j - start + K1_A - 1) // K1_A
            if tile < tiles_before + n_tiles:
                a0 = start + (tile - tiles_before) * K1_A
                return a0, min(a0 + K1_A, j)
            tiles_before += n_tiles
            start = j
    a0 = min(start + (tile - tiles_before) * K1_A, A)
    return a0, min(a0 + K1_A, A)


def k1_band_bounds(beta, a_base, a_end, b, u0, cy, U0, row_len, aligned):
    """(lo4, w4) of band b for one block: w4 0 = skipped, -1 = from global."""
    os_ = []
    for k in range(a_base, a_end):
        for r in (b * K1_R, b * K1_R + K1_R - 1):
            os_.append(int(row_shift(beta[k], r, cy, U0)[0]))
    lo, hi = u0 - max(os_), u0 + K1_TILE - min(os_)
    lo4 = lo & ~3
    w4 = (hi - lo4 + 4) & ~3
    if hi < 0 or lo >= row_len:
        return lo4, 0
    if not aligned or w4 > K1_W:
        return lo4, -1
    return lo4, w4


def k1_stage(slice_, dst, lo4, w4, b):
    """k1_stage(): 16-byte chunks, zero-filled outside the rows."""
    n_rows, row_len = slice_.shape
    if w4 <= 0:
        return
    for i in range(K1_R):
        r = b * K1_R + i
        for c in range(w4 >> 2):
            j = lo4 + 4 * c
            if r < n_rows and 0 <= j < row_len:
                dst[i, 4 * c : 4 * c + 4] = slice_[r, j : j + 4]
            else:
                dst[i, 4 * c : 4 * c + 4] = 0.0


def k1_block(rows, beta, s, bx, by, z, U0, LU, aligned, stats, bands=None):
    """shear_fp_block(): one block of K1 (every band of slice z into
    s[:, z]) or of K1p (the bands [bands[0], bands[1]) of the one slice
    into the run's partial u-lines ``s``)."""
    slice_ = rows[z]
    n_rows, row_len = slice_.shape
    u0 = bx * K1_TILE
    a_base, a_end = k1_angle_tile(beta, by)
    if a_base >= a_end:
        return  # a spare tile
    cy = f32(0.5) * f32(n_rows - 1)
    n_bands = (n_rows + K1_R - 1) // K1_R
    band_lo, band_hi = bands or (0, n_bands)
    bounds = {b: k1_band_bounds(beta, a_base, a_end, b, u0, cy, U0, row_len, aligned)
              for b in range(band_lo, band_hi)}
    alive = [b for b in range(band_lo, band_hi) if bounds[b][1] != 0]
    lanes = np.arange(32)[None, :] + 32 * np.arange(K1_U)[:, None]  # [k, x]
    acc = np.zeros((K1_A, K1_U, 32), dtype=f32)
    stats["skipped"] += band_hi - band_lo  # bands before the first and after the last live one
    if alive:
        b_first, b_last = alive[0], alive[-1]
        stats["skipped"] -= b_last - b_first + 1
        buf = np.full((2, K1_R, K1_W), np.nan, dtype=f32)
        k1_stage(slice_, buf[0], *bounds[b_first], b_first)
        for b in range(b_first, b_last + 1):
            parity = (b - b_first) & 1
            if b < b_last:
                k1_stage(slice_, buf[parity ^ 1], *bounds[b + 1], b + 1)
            lo4, w4 = bounds[b]
            stats["skipped" if w4 == 0 else "global" if w4 < 0 else "staged"] += 1
            if w4 == 0:
                continue
            r0 = b * K1_R
            for y in range(a_end - a_base):
                for i in range(K1_R):
                    o, f = row_shift(beta[a_base + y], r0 + i, cy, U0)
                    o, f = int(o), f32(f)
                    g = f32(1.0) - f
                    if w4 > 0:
                        idx = u0 + lanes - o - lo4
                        assert idx.min() >= 0 and idx.max() + 1 < w4
                        win = buf[parity, i]
                        acc[y] += g * win[idx] + f * win[idx + 1]
                    elif r0 + i < n_rows:
                        j = u0 + lanes - o
                        row = slice_[r0 + i]
                        v0 = np.where((j >= 0) & (j < row_len),
                                      row[np.clip(j, 0, row_len - 1)], f32(0))
                        v1 = np.where((j + 1 >= 0) & (j + 1 < row_len),
                                      row[np.clip(j + 1, 0, row_len - 1)], f32(0))
                        acc[y] += g * v0 + f * v1
    u = u0 + lanes.ravel()
    ok = u < LU
    for y in range(a_end - a_base):
        s[a_base + y, z, u[ok]] = acc[y].ravel()[ok]


def k1_emulated(vol, beta, U0, LU, swap):
    """shear_fp() on a CUDA tensor, block by block."""
    rows = np.ascontiguousarray(vol.transpose(0, 2, 1) if swap else vol)
    nz, n_rows, row_len = rows.shape
    A = beta.shape[0]
    aligned = row_len % 4 == 0  # numpy rows start 16-byte aligned, as torch's do
    s = np.full((A, nz, LU), np.nan, dtype=f32)
    stats = {"skipped": 0, "global": 0, "staged": 0}
    tiles = [k1_angle_tile(beta, by) for by in range((A + K1_A - 1) // K1_A + K1_SPLITS)]
    covered = [a for a0, a1 in tiles for a in range(a0, a1)]
    assert covered == list(range(A))  # every angle in exactly one tile
    for z in range(nz):
        for by in range(len(tiles)):
            for bx in range((LU + K1_TILE - 1) // K1_TILE):
                k1_block(rows, beta, s, bx, by, z, U0, LU, aligned, stats)
    return s, stats


def k1_case(nz, ny, nx, n_angles, cor, seed):
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((nz, ny, nx)).astype(f32)
    angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)
    if cor == "per-angle":
        cor = 1.5 + np.sin(3.0 * angles)
    geom = Geometry(max(ny, nx), nz, angles, cor, max(ny, nx))
    return vol, _Plan(geom).groups(ny, nx, torch.device("cpu"))


@pytest.mark.parametrize("group", ["x-driven", "y-driven"])
@pytest.mark.parametrize("cor", [2.5, "per-angle"], ids=["scalar-cor", "per-angle-cor"])
@pytest.mark.parametrize("ny,nx", [(40, 40), (38, 44), (42, 38)],
                         ids=["rows%8==0", "rows%8!=0", "unaligned-rows"])
@pytest.mark.parametrize("nz", [1, 3, 8])
def test_k1_emulation_bit_exact(nz, ny, nx, cor, group):
    """K1's block arithmetic equals shear_fp_plain bit for bit: bands of 8
    rows with n_rows a multiple of 8 or not (a ragged last band), row
    lengths that allow 16-byte chunks or not, one and several slices, both
    driven groups."""
    vol, groups = k1_case(nz, ny, nx, 24, cor, seed=nz + ny)
    g = groups[0 if group == "x-driven" else 1]
    assert g.swap == (group == "y-driven")
    beta = g.prm.beta
    ref = PK.shear_fp_plain(torch.as_tensor(vol), g.beta, g.prm.U0, g.prm.LU, g.swap).numpy()
    got, stats = k1_emulated(vol, beta, g.prm.U0, g.prm.LU, g.swap)
    assert np.array_equal(got, ref)
    row_len = ny if g.swap else nx
    assert stats["skipped"] > 0
    assert stats["staged" if row_len % 4 == 0 else "global"] > 0
    assert stats["global" if row_len % 4 == 0 else "staged"] == 0


@pytest.mark.parametrize("nz", [1, 3])
def test_k1_emulation_window_too_wide(nz):
    """Angle tiles end at the jumps of beta between the two ends of a group.
    A tile of sparse angles still needs a window wider than the staged one
    on the outer bands: those bands take the same arithmetic from global
    memory, the middle bands are staged."""
    rng = np.random.default_rng(5)
    n_rows, row_len = 800, 64
    rows = rng.standard_normal((nz, n_rows, row_len)).astype(f32)
    beta = np.array([-0.9, -0.95, 0.9, 0.85, -1.0, -0.6, -0.2, 0.2, 0.6, 1.0])
    theta = -np.arctan(beta)
    assert [k1_angle_tile(beta.astype(f32), t) for t in range(4)] == [
        (0, 2), (2, 4), (4, 10), (10, 10)]
    prm = PK.driven_params(np.cos(theta), np.sin(theta), np.zeros_like(theta),
                           row_len, n_rows, row_len)
    ref = PK.shear_fp_plain(torch.as_tensor(rows), torch.as_tensor(prm.beta),
                            prm.U0, prm.LU).numpy()
    got, stats = k1_emulated(rows, prm.beta, prm.U0, prm.LU, swap=False)
    assert np.array_equal(got, ref)
    assert stats["global"] > 0 and stats["staged"] > 0 and stats["skipped"] > 0


@pytest.mark.parametrize("A", [1, 7, 8, 9, 33, 91, 300])
@pytest.mark.parametrize("kind", ["sorted-180", "sorted-360", "shuffled"])
def test_k1_angle_tiles_cover_every_angle_once(A, kind):
    """The grid's ceil(A / 8) + 8 angle tiles hold every angle exactly once,
    in order, whatever the jumps of beta (more than 8 are not honoured)."""
    theta = np.linspace(0.0, np.pi if kind == "sorted-180" else 2 * np.pi, A, endpoint=False)
    if kind == "shuffled":
        theta = np.random.default_rng(A).permutation(theta)
    xdrive = np.abs(np.cos(theta)) >= np.abs(np.sin(theta))
    beta = (-np.sin(theta[xdrive]) / np.cos(theta[xdrive])).astype(f32)
    n = beta.shape[0]
    tiles = [k1_angle_tile(beta, t) for t in range((n + K1_A - 1) // K1_A + K1_SPLITS)]
    assert [a for a0, a1 in tiles for a in range(a0, a1)] == list(range(n))
    assert all(0 <= a1 - a0 <= K1_A for a0, a1 in tiles)
    if kind != "shuffled":
        assert all(np.abs(np.diff(beta[a0:a1])).max(initial=0) <= K1_JUMP for a0, a1 in tiles)


def test_k1_wrapper_on_cpu_is_the_plain_version():
    vol, groups = k1_case(2, 24, 24, 12, 0.0, seed=1)
    for g in groups:
        t = torch.as_tensor(vol)
        assert torch.equal(PK.shear_fp(t, g.beta, g.prm.U0, g.prm.LU, g.swap),
                           PK.shear_fp_plain(t, g.beta, g.prm.U0, g.prm.LU, g.swap))


# ---------------------------------------------------------------------------
# K1p: csrc/projector.cu, shear_fp_packed_kernel + shear_fp_packed_sum_kernel
# ---------------------------------------------------------------------------


def k1p_emulated(rows, beta, U0, LU, splits):
    """shear_fp_packed() on a CUDA tensor: K1's block on runs of whole bands
    (blockIdx.z), then the runs' partial sums added in ascending order."""
    _, n_rows, row_len = rows.shape
    A = beta.shape[0]
    aligned = row_len % 4 == 0
    n_bands = (n_rows + K1_R - 1) // K1_R
    per = (n_bands + splits - 1) // splits
    part = np.full((splits, A, 1, LU), np.nan, dtype=f32)
    stats = {"skipped": 0, "global": 0, "staged": 0}
    for z in range(splits):
        band_lo = min(z * per, n_bands)
        bands = (band_lo, min(band_lo + per, n_bands))
        for by in range((A + K1_A - 1) // K1_A + K1_SPLITS):
            for bx in range((LU + K1_TILE - 1) // K1_TILE):
                k1_block(rows, beta, part[z], bx, by, 0, U0, LU, aligned, stats, bands)
    if splits == 1:
        return part[0], stats
    acc = part[0].copy()
    for z in range(1, splits):
        acc = acc + part[z]
    return acc, stats


def test_k1p_shares_k1s_block_shape():
    """The emulation walks K1p with K1's constants: they must be equal."""
    assert [cu_const("projector.cu", n) for n in ("kP1U", "kP1A", "kP1R", "kP1W")] == [
        K1_U, K1_A, K1_R, K1_W]
    assert cu_const("projector.cu", "kP1R") == PK.K1P_BAND


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("group", ["x-driven", "y-driven"])
@pytest.mark.parametrize("cor", [2.5, "per-angle"], ids=["scalar-cor", "per-angle-cor"])
@pytest.mark.parametrize("ny,nx", [(40, 40), (38, 44), (42, 38)],
                         ids=["rows%8==0", "rows%8!=0", "unaligned-rows"])
def test_k1p_emulation_bit_exact(ny, nx, cor, group, splits):
    """K1p's blocks and its second pass equal ``shear_fp_packed_plain`` with
    the same number of runs bit for bit, over the cases of
    ``test_k1_emulation_bit_exact`` at one slice; one run is K1's sum."""
    vol, groups = k1_case(1, ny, nx, 24, cor, seed=ny + splits)
    g = groups[0 if group == "x-driven" else 1]
    rows = np.ascontiguousarray(vol.transpose(0, 2, 1) if g.swap else vol)
    ref = PK.shear_fp_packed_plain(torch.as_tensor(rows), g.beta, g.prm.U0, g.prm.LU, splits).numpy()
    got, stats = k1p_emulated(rows, g.prm.beta, g.prm.U0, g.prm.LU, splits)
    assert np.array_equal(got, ref)
    assert stats["skipped"] > 0
    k1 = PK.shear_fp_plain(torch.as_tensor(vol), g.beta, g.prm.U0, g.prm.LU, g.swap).numpy()
    if splits == 1:
        assert np.array_equal(got, k1)
    else:
        assert np.abs(got - k1).max() <= 1e-6 * np.abs(k1).max()


@pytest.mark.parametrize("splits", [1, 4])
def test_k1p_emulation_beta_jump_and_window_too_wide(splits):
    """A driven group whose beta jumps between its two ends (angle tiles end
    there) and a tile of sparse angles whose outer bands need a window wider
    than the staged one (read from global memory), in runs."""
    rng = np.random.default_rng(6)
    n_rows, row_len = 800, 64
    rows = rng.standard_normal((1, n_rows, row_len)).astype(f32)
    beta = np.array([-0.9, -0.95, 0.9, 0.85, -1.0, -0.6, -0.2, 0.2, 0.6, 1.0])
    theta = -np.arctan(beta)
    prm = PK.driven_params(np.cos(theta), np.sin(theta), np.zeros_like(theta),
                           row_len, n_rows, row_len, packed=True)
    ref = PK.shear_fp_packed_plain(torch.as_tensor(rows), torch.as_tensor(prm.beta),
                                   prm.U0, prm.LU, splits).numpy()
    got, stats = k1p_emulated(rows, prm.beta, prm.U0, prm.LU, splits)
    assert np.array_equal(got, ref)
    assert stats["global"] > 0 and stats["staged"] > 0 and stats["skipped"] > 0


@pytest.mark.parametrize("n_rows,n_angles,splits", [
    (64, 90, 1), (248, 90, 1), (256, 90, 1), (512, 90, 2), (1024, 90, 4), (2560, 91, 8),
    (2560, 256, 8), (2560, 257, 4), (2560, 901, 4), (4096, 900, 4), (512, 900, 2)])
def test_k1p_splits_rule(n_rows, n_angles, splits):
    assert PK.packed_splits(n_rows, n_angles) == splits


def test_k1p_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.standard_normal((1, 512, 40)).astype(f32))
    theta = np.linspace(-0.7, 0.7, 5)
    prm = PK.driven_params(np.cos(theta), np.sin(theta), np.zeros(5), 40, 512, 40, packed=True)
    beta = torch.as_tensor(prm.beta)
    assert PK.packed_splits(512, 5) == 2
    got = PK.shear_fp_packed(rows, beta, prm.U0, prm.LU)
    assert torch.equal(got, PK.shear_fp_packed_plain(rows, beta, prm.U0, prm.LU, 2))
    one = PK.shear_fp_packed(rows, beta, prm.U0, prm.LU, splits=1)
    assert torch.equal(one, PK.shear_fp_plain(rows, beta, prm.U0, prm.LU))
    assert not torch.equal(got, one)
    assert (got - one).abs().max() <= 1e-6 * one.abs().max()


# ---------------------------------------------------------------------------
# F: csrc/fft_axis2.cu, fft_axis2_kernel
# ---------------------------------------------------------------------------

F_COLS, F_MAX_ITEMS, F_PLAN_THREADS = 8, 16, 512  # kCols, kMaxItems, kPlanThreads
BUTTERFLIES = (16, 8, 5, 4, 3, 2)  # radices with a register butterfly


def slot(pos):
    pos = np.asarray(pos)
    parity = np.zeros_like(pos)
    upper = pos >> 1
    for bit in range(12):
        parity ^= (upper >> bit) & 1
    return pos ^ parity


def C(re, im):
    return (np.asarray(re) + 1j * np.asarray(im)).astype(np.complex64)


def mul_mi(a):
    return C(a.imag, -a.real)


ROOT16 = [
    (1.0, 0.0), (0.92387953251128674, -0.38268343236508977),
    (0.70710678118654752, -0.70710678118654752),
    (0.38268343236508977, -0.92387953251128674), (0.0, -1.0),
    (-0.38268343236508977, -0.92387953251128674),
    (-0.70710678118654752, -0.70710678118654752),
    (-0.92387953251128674, -0.38268343236508977),
]


def dft_regs(x):
    """Dft<R>::run of fft_axis2.cu on a list of R complex64 arrays."""
    R = len(x)
    if R == 2:
        return [x[0] + x[1], x[0] - x[1]]
    if R == 3:
        c = f32(0.86602540378443865)
        s, d = x[1] + x[2], x[1] - x[2]
        m = C(x[0].real - f32(0.5) * s.real, x[0].imag - f32(0.5) * s.imag)
        return [x[0] + s, C(m.real + c * d.imag, m.imag - c * d.real),
                C(m.real - c * d.imag, m.imag + c * d.real)]
    if R == 4:
        t0, t1 = x[0] + x[2], x[0] - x[2]
        t2, t3 = x[1] + x[3], mul_mi(x[1] - x[3])
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    if R == 5:
        c1, c2 = f32(0.30901699437494742), f32(-0.80901699437494742)
        s1, s2 = f32(0.95105651629515357), f32(0.58778525229247313)
        a1, a2, b1, b2 = x[1] + x[4], x[2] + x[3], x[1] - x[4], x[2] - x[3]
        p1 = C(x[0].real + c1 * a1.real + c2 * a2.real, x[0].imag + c1 * a1.imag + c2 * a2.imag)
        p2 = C(x[0].real + c2 * a1.real + c1 * a2.real, x[0].imag + c2 * a1.imag + c1 * a2.imag)
        q1 = C(s1 * b1.real + s2 * b2.real, s1 * b1.imag + s2 * b2.imag)
        q2 = C(s2 * b1.real - s1 * b2.real, s2 * b1.imag - s1 * b2.imag)
        return [x[0] + (a1 + a2),
                C(p1.real + q1.imag, p1.imag - q1.real),
                C(p2.real + q2.imag, p2.imag - q2.real),
                C(p2.real - q2.imag, p2.imag + q2.real),
                C(p1.real - q1.imag, p1.imag + q1.real)]
    assert R in (8, 16)
    H = R // 2
    e, o = dft_regs(x[0::2]), dft_regs(x[1::2])
    out = [None] * R
    for k in range(H):
        k16 = k * (16 // R)
        t = o[k] if k16 == 0 else mul_mi(o[k]) if k16 == 4 else o[k] * np.complex64(complex(*ROOT16[k16]))
        out[k], out[k + H] = e[k] + t, e[k] - t
    return out


@pytest.mark.parametrize("R", BUTTERFLIES)
def test_f_register_butterflies(R):
    rng = np.random.default_rng(R)
    x = (rng.standard_normal((R, 7)) + 1j * rng.standard_normal((R, 7))).astype(np.complex64)
    got = np.stack(dft_regs(list(x)))
    ref = np.fft.fft(x.astype(np.complex128), axis=0)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_f_slot_is_a_bijection_on_aligned_pairs():
    pos = np.arange(1024)
    s = slot(pos)
    assert np.array_equal(np.sort(s), pos)
    assert np.array_equal(s >> 1, pos >> 1)
    # the two positions of a half-warp differ in one bit: different bank halves
    for bit in range(10):
        assert np.all((slot(pos) ^ slot(pos ^ (1 << bit))) & 1 == 1)


def stage_butterflies(s, w, Cn, Ls, R):
    M, step = Ls // R, Cn // Ls
    b = np.arange(Cn // R * F_COLS)
    col, t = b % F_COLS, b // F_COLS
    blk = t // M
    j = t - blk * M
    base = blk * Ls + j
    x = [s[slot(base + M * q), col] for q in range(R)]
    y = dft_regs(x)
    if M > 1:
        for p in range(1, R):
            assert (j * p * step).max() < Cn  # the twiddle index needs no remainder
            y[p] = y[p] * w[j * p * step]
    for p in range(R):
        s[slot(base + M * p), col] = y[p]


def stage_outputs(s, w, Cn, Ls, r):
    M, step, root_step = Ls // r, Cn // Ls, Cn // r
    assert Cn * F_COLS <= F_MAX_ITEMS * F_PLAN_THREADS  # the register array holds them
    it = np.arange(Cn * F_COLS)
    col, pos = it % F_COLS, it // F_COLS
    blk = pos // Ls
    rem = pos - blk * Ls
    p = rem // M
    j = rem - p * M
    base = blk * Ls + j
    acc = np.zeros(it.shape, dtype=np.complex64)
    for q in range(r):
        acc = acc + s[slot(base + M * q), col] * w[((p * q) % r) * root_step]
    out = acc * w[j * p * step]
    s[slot(pos), col] = out  # after the barrier: every read came first


def k2_of_position(pos, plan, Cn):
    """The run-time digit reversal of the store."""
    k2, rem, M, weight = 0, pos, Cn, 1
    for r in plan:
        M //= r
        k2 = k2 + (rem // M) * weight
        rem = rem % M
        weight *= r
    return k2


def k2_of_position_compile_time(pos, plan, Cn):
    R1, R2, R3, R4 = (tuple(plan) + (1, 1, 1))[:4]
    M1 = Cn // R1
    M2 = M1 // R2
    M3 = M2 // R3
    p1, r1 = pos // M1, pos % M1
    p2, r2 = r1 // M2, r1 % M2
    p3, p4 = r2 // M3, r2 % M3
    return p1 + R1 * (p2 + R2 * (p3 + R3 * p4))


def f_emulated(re, im, sign, B, Cn, plan):
    """fft_axis2() on CUDA tensors: one cluster of B blocks per 8 columns."""
    if sign > 0:  # the wrapper's pointer swap, in and out
        oim, ore = f_emulated(im, re, -1, B, Cn, plan)
        return ore, oim
    Z, n, L = re.shape
    assert n == B * Cn
    tables = FK._device_tables(n, B, Cn, torch.device("cpu")).numpy().reshape(-1, 2)
    tables = C(tables[:, 0], tables[:, 1])
    wb, tt, w = tables[: B * B], tables[B * B : B * B + B * Cn], tables[B * B + B * Cn :]
    assert w.shape == (Cn,)
    ore, oim = np.full_like(re, np.nan), np.full_like(im, np.nan)
    n_tiles = (L + F_COLS - 1) // F_COLS
    c_pad = (Cn + 1) & ~1
    for z in range(Z):
        for tile in range(n_tiles):
            l0 = tile * F_COLS
            cols = np.arange(F_COLS)
            live = l0 + cols < L
            # 1. block k1 loads the slab n1 = k1
            slabs = np.full((B, c_pad, F_COLS), np.nan, dtype=np.complex64)
            n2 = np.arange(Cn)
            for k1 in range(B):
                v = np.zeros((Cn, F_COLS), dtype=np.complex64)
                v[:, live] = C(re[z, k1 * Cn : (k1 + 1) * Cn, l0 : l0 + F_COLS],
                               im[z, k1 * Cn : (k1 + 1) * Cn, l0 : l0 + F_COLS])
                slabs[k1][slot(n2)] = v
            # 2. the B step: block `rank` owns the n2 of its chunk, all k1
            chunk = (Cn + B - 1) // B
            for rank in range(B):
                mine = rank * chunk + np.arange(chunk)
                mine = mine[mine < Cn]
                x = [slabs[n1][slot(mine)].copy() for n1 in range(B)]
                for k1 in range(B):
                    y = x[0]
                    for n1 in range(1, B):
                        y = y + x[n1] * wb[k1 * B + n1]
                    slabs[k1][slot(mine)] = y if k1 == 0 else y * tt[k1 * Cn + mine][:, None]
            # 3. the C stages of block k1, in place; 4. the store
            for k1 in range(B):
                s = slabs[k1]
                Ls = Cn
                for r in plan:
                    if r in BUTTERFLIES:
                        stage_butterflies(s, w, Cn, Ls, r)
                    else:
                        stage_outputs(s, w, Cn, Ls, r)
                    Ls //= r
                pos = np.arange(Cn)
                k2 = k2_of_position(pos, plan, Cn)
                if len(plan) <= 4:
                    assert np.array_equal(k2, k2_of_position_compile_time(pos, plan, Cn))
                assert np.array_equal(np.sort(k2), pos)
                out = s[slot(pos)][:, live]
                ore[z, k1 + B * k2, l0 : l0 + F_COLS] = out.real
                oim[z, k1 + B * k2, l0 : l0 + F_COLS] = out.imag
    return ore, oim


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize(
    "n", [8192, 5120, 2560, 256, 12, 84, 2 * 37, 1000 * 3],
    ids=lambda n: "n%d-B%d-C%d" % ((n,) + FK.best_split(n)))
def test_f_emulation_against_numpy_fft(n, sign):
    """The cluster's load, the in-place B step, the in-place stages (register
    butterflies and the one-output fallback), the twiddle indices, the
    swizzle and the digit-reversed store give the DFT of both signs: the
    flagship splits (8, 1024), (5, 1024), (4, 640) and small ones, with a
    ragged last column tile."""
    B, Cn = FK.best_split(n)
    plan = FK.stage_plan(Cn)
    assert int(np.prod(plan)) == Cn
    if n == 8192:
        assert (B, Cn, plan) == (8, 1024, (16, 8, 8))
    if n == 5120:
        assert (B, Cn, plan) == (5, 1024, (16, 8, 8))
    if n == 2560:
        assert (B, Cn, plan) == (4, 640, (5, 16, 8))
    rng = np.random.default_rng(n)
    Z, L = (1, 3) if n > 1024 else (2, 11)
    re = rng.standard_normal((Z, n, L)).astype(f32)
    im = rng.standard_normal((Z, n, L)).astype(f32)
    got_re, got_im = f_emulated(re, im, sign, B, Cn, plan)
    x = re.astype(np.float64) + 1j * im
    ref = np.fft.fft(x, axis=-2) if sign < 0 else np.fft.ifft(x, axis=-2) * n
    err = max(np.abs(got_re - ref.real).max(), np.abs(got_im - ref.imag).max())
    assert err <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("Cn", [2, 3, 6, 7, 37, 120, 509, 640, 999, 1000, 1024])
def test_f_stage_plan(Cn):
    plan = FK.stage_plan(Cn)
    assert int(np.prod(plan)) == Cn
    assert len(plan) <= 10
    odd = [r for r in plan if r % 2]
    assert list(plan[: len(odd)]) == sorted(odd)  # odd radices first, ascending
    assert all(r in (16, 8, 4, 2) for r in plan[len(odd):])


# ---------------------------------------------------------------------------
# constants of the CUDA sources that the emulations below share
# ---------------------------------------------------------------------------


def cu_const(source, name):
    """Value of ``constexpr int <name> = <integer>;`` in csrc/<source>."""
    import os
    import re

    import tomobar_tpu_torch

    path = os.path.join(os.path.dirname(tomobar_tpu_torch.__file__), "csrc", source)
    with open(path) as fh:
        found = re.findall(rf"constexpr int {name} = (\d+);", fh.read())
    assert len(found) == 1, (source, name, found)
    return int(found[0])


# ---------------------------------------------------------------------------
# K4: csrc/projector.cu, unshear_bp_kernel
# ---------------------------------------------------------------------------

K4_R, K4_J, K4_AZ = (cu_const("projector.cu", n) for n in ("kK4R", "kK4J", "kK4AZ"))
K4_C = 32 * K4_J
K4_W = K4_C + 16  # kK4W
K4_GLOBAL = None  # kK4Global


def k4_stage(q, beta, dst, sbeta, sbase, b, Z, z0, r0, c0, cy, U0, aligned, stats):
    """k4_stage(): the windows of angle batch b, 16-byte chunks, zero-filled
    outside [0, LU); an angle whose window does not fit is marked."""
    A, nz, LU = q.shape
    K4_A = K4_AZ // Z
    for i in range(K4_A):
        a = b * K4_A + i
        if a >= A:
            continue
        o_first = int(row_shift(beta[a], r0, cy, U0)[0])
        o_last = int(row_shift(beta[a], r0 + K4_R - 1, cy, U0)[0])
        lo4 = (min(o_first, o_last) + c0 - 1) & ~3
        fits = aligned and max(o_first, o_last) + c0 + K4_C - 1 - lo4 < K4_W
        sbeta[i] = beta[a]
        sbase[i] = lo4 if fits else K4_GLOBAL
        stats["staged" if fits else "global"] += 1
        if not fits:
            continue
        for zz in range(Z):
            for c in range(K4_W // 4):
                u = lo4 + 4 * c
                dst[zz, i, 4 * c : 4 * c + 4] = q[a, z0 + zz, u : u + 4] if 0 <= u < LU else 0.0


def k4_block(q, beta, vol, bx, by, bz, Z, U0, ny, nx, swap, accumulate, aligned, stats):
    A, nz, LU = q.shape
    K4_A = K4_AZ // Z
    n_rows, row_len = (nx, ny) if swap else (ny, nx)
    c0, r0, z0 = bx * K4_C, by * K4_R, bz * Z
    cy = f32(0.5) * f32(n_rows - 1)
    n_batches = (A + K4_A - 1) // K4_A
    cols = np.arange(32)[None, :] + 32 * np.arange(K4_J)[:, None]  # [k, x]
    acc = np.zeros((Z, K4_R, K4_J, 32), dtype=f32)
    buf = np.full((2, Z, K4_A, K4_W), np.nan, dtype=f32)
    sbeta = np.full((2, K4_A), np.nan, dtype=f32)
    sbase = [[None] * K4_A, [None] * K4_A]
    if n_batches:
        k4_stage(q, beta, buf[0], sbeta[0], sbase[0], 0, Z, z0, r0, c0, cy, U0, aligned, stats)
    for b in range(n_batches):
        parity = b & 1
        if b + 1 < n_batches:
            k4_stage(q, beta, buf[parity ^ 1], sbeta[parity ^ 1], sbase[parity ^ 1],
                     b + 1, Z, z0, r0, c0, cy, U0, aligned, stats)
        for i in range(min(K4_A, A - b * K4_A)):
            for y in range(K4_R):  # rows past n_rows are summed too, and never stored
                o, f = row_shift(sbeta[parity, i], r0 + y, cy, U0)
                o, f = int(o), f32(f)
                g = f32(1.0) - f
                u = o + c0 + cols
                lo4 = sbase[parity][i]
                for zz in range(Z):
                    if lo4 is not K4_GLOBAL:
                        idx = u - lo4
                        assert idx.min() >= 1 and idx.max() < K4_W
                        w = buf[parity, zz, i]
                        acc[zz, y] += g * w[idx] + f * w[idx - 1]
                    else:
                        line = q[b * K4_A + i, z0 + zz]
                        q0 = np.where((u >= 0) & (u < LU), line[np.clip(u, 0, LU - 1)], f32(0))
                        q1 = np.where((u >= 1) & (u - 1 < LU), line[np.clip(u - 1, 0, LU - 1)], f32(0))
                        acc[zz, y] += g * q0 + f * q1
    for zz in range(Z):
        for y in range(K4_R):
            row = r0 + y
            if row >= n_rows:
                continue
            col = c0 + cols
            ok = col < row_len
            target = vol[z0 + zz, :, row] if swap else vol[z0 + zz, row, :]
            v = acc[zz, y][ok]
            target[col[ok]] = target[col[ok]] + v if accumulate else v


def k4_emulated(q, beta, U0, ny, nx, swap, out=None):
    """unshear_bp() on a CUDA tensor, block by block."""
    A, nz, LU = q.shape
    n_rows, row_len = (nx, ny) if swap else (ny, nx)
    aligned = LU % 4 == 0  # numpy lines start 16-byte aligned, as torch's do
    vol = np.full((nz, ny, nx), np.nan, dtype=f32) if out is None else out.copy()
    stats = {"staged": 0, "global": 0}
    Z = 2 if nz % 2 == 0 else 1  # slices per block
    for bz in range(nz // Z):
        for by in range((n_rows + K4_R - 1) // K4_R):
            for bx in range((row_len + K4_C - 1) // K4_C):
                k4_block(q, beta, vol, bx, by, bz, Z, U0, ny, nx, swap, out is not None,
                         aligned, stats)
    return vol, stats


@pytest.mark.parametrize("accumulate", [False, True], ids=["new", "accumulate"])
@pytest.mark.parametrize("group", ["x-driven", "y-driven"])
@pytest.mark.parametrize("cor", [2.5, "per-angle"], ids=["scalar-cor", "per-angle-cor"])
@pytest.mark.parametrize("nz,ny,nx", [(1, 40, 40), (3, 38, 44), (8, 16, 24), (2, 20, 300)],
                         ids=["nz1", "nz3-rows%8!=0", "nz8", "ny!=nx-two-column-tiles"])
def test_k4_emulation_bit_exact(nz, ny, nx, cor, group, accumulate):
    """K4's block arithmetic equals unshear_bp_plain bit for bit: angle
    batches in two buffers (40 angles per group: full batches and a ragged
    one, of 32 angles for one slice per block or of 16 for two),
    16-byte zero-filled windows, rows that are no multiple of 8, ny != nx
    with more than one column tile, one and several slices, both driven
    groups, adding into a volume."""
    _, groups = k1_case(nz, ny, nx, 80, cor, seed=nz + ny)
    g = groups[0 if group == "x-driven" else 1]
    assert g.swap == (group == "y-driven") and g.prm.A > K4_AZ
    rng = np.random.default_rng(nx + nz)
    q = rng.standard_normal((g.prm.A, nz, g.prm.LU)).astype(f32)
    base = rng.standard_normal((nz, ny, nx)).astype(f32) if accumulate else None
    ref = PK.unshear_bp_plain(
        torch.as_tensor(q), g.beta, g.prm.U0, ny, nx, g.swap,
        out=None if base is None else torch.as_tensor(base.copy())).numpy()
    got, stats = k4_emulated(q, g.prm.beta, g.prm.U0, ny, nx, g.swap, out=base)
    assert np.array_equal(got, ref)
    assert stats["staged"] > 0 and stats["global"] == 0


@pytest.mark.parametrize("case", ["steep-angles", "unaligned-lines"])
def test_k4_emulation_from_global_memory(case):
    """An angle whose 8 rows shift by more than the window allows (|beta| >
    1) is summed from global memory, the others of its batch from their
    windows; lines of q that are not 16-byte aligned (LU % 4 != 0) are all
    read from global memory.  Same arithmetic, same bits."""
    rng = np.random.default_rng(11)
    ny, nx = 24, 40
    beta = np.array([-0.9, 2.5, 0.3, -3.0, 1.0, 0.0] if case == "steep-angles"
                    else [-0.9, 0.3, 1.0], dtype=f32)
    U0 = 128
    LU = 512 if case == "steep-angles" else 510
    for nz, swap in ((2, False), (2, True), (3, False), (3, True)):
        q = rng.standard_normal((beta.shape[0], nz, LU)).astype(f32)
        ref = PK.unshear_bp_plain(torch.as_tensor(q), torch.as_tensor(beta), U0, ny, nx, swap).numpy()
        got, stats = k4_emulated(q, beta, U0, ny, nx, swap)
        assert np.array_equal(got, ref)
        assert stats["global"] > 0
        assert (stats["staged"] > 0) == (case == "steep-angles")


def test_k4_wrapper_on_cpu_is_the_plain_version():
    _, groups = k1_case(2, 24, 24, 12, 0.0, seed=1)
    rng = np.random.default_rng(2)
    for g in groups:
        q = torch.as_tensor(rng.standard_normal((g.prm.A, 2, g.prm.LU)).astype(f32))
        assert torch.equal(PK.unshear_bp(q, g.beta, g.prm.U0, 24, 24, g.swap),
                           PK.unshear_bp_plain(q, g.beta, g.prm.U0, 24, 24, g.swap))


# ---------------------------------------------------------------------------
# PD: csrc/pd_tv.cu, pd_tv_kernel
# ---------------------------------------------------------------------------

from tomobar_tpu_torch.ops import pd_tv as PDT  # noqa: E402

PD_K, PD_KZ, PD_V, PD_TY, PD_ZMAX, PD_PAD = (
    cu_const("pd_tv.cu", n) for n in ("kPDK", "kPDKz", "kPDV", "kPDThreadsY", "kPDZMax", "kPDPad"))


def pd_fuse(nz):
    """fuse() of pd_tv.cu: iterations per launch."""
    return PD_K if nz <= PD_ZMAX else PD_KZ


def pd_tile(nz):
    """launch() of pd_tv.cu: (ZC, CY, TYT, slices a z-chunk stores)."""
    for zc in (1, 2, 4, 8):
        if nz <= zc:
            return zc, PD_V // zc, PD_TY, nz
    return PD_ZMAX, PD_V // PD_ZMAX, PD_TY, nz if nz <= PD_ZMAX else PD_ZMAX - 2 * pd_fuse(nz)


def bf16_round(x):
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def pd_block(data, u_in, p_in, u_out, p_out, stored, bx, by, bz, K, first, last, consts,
             iso, nonneg, bf16):
    sigma, tau, lt, theta = (f32(c) for c in consts)
    nz, ny, nx = data.shape
    ZC, CY, TYT, zi = pd_tile(nz)
    HY = TYT * CY
    plane = (HY + 1) * 32
    array = ZC * plane + PD_PAD
    three = ZC > 1
    smem = np.full(3 * array + PD_PAD, np.nan, dtype=f32)  # unwritten shared memory
    su, sp1, sp2 = (PD_PAD + i * array for i in range(3))  # offsets into smem
    # every (z, ly, lx) of the tile belongs to one thread: ly = y + TYT j
    z = np.arange(ZC)[:, None, None]
    ly = np.arange(HY)[None, :, None]
    lx = np.arange(32)[None, None, :]
    s = z * plane + ly * 32 + lx
    gx = bx * (32 - 2 * K) - K + lx
    gy = by * (HY - 2 * K) - K + ly
    zi0 = bz * zi
    zs = max(0, zi0 - K) if zi < nz else 0
    zc = min(nz, zi0 + zi + K) - zs if zi < nz else nz
    z_lo, z_hi = zi0 - zs, min(nz, zi0 + zi) - zs
    assert zc <= ZC
    inside = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny) & (z < zc)
    gz, gy_c, gx_c = (np.broadcast_to(np.clip(v, 0, n - 1), inside.shape)
                      for v, n in ((zs + z, nz), (gy, ny), (gx, nx)))

    def fetch(arr):
        return np.where(inside, arr[gz, gy_c, gx_c], f32(0)).astype(f32)

    def duals_as_stored(c):
        return bf16_round(c) if bf16 else c

    # registers: data and the third dual; shared memory: u and the first two
    dat = fetch(data)
    p3 = (np.zeros(inside.shape, dtype=f32) if first or not three
          else fetch(p_in[2].astype(f32)))
    smem[su + s] = dat if first else fetch(u_in)
    for off, i in ((sp1, 0), (sp2, 1)):
        smem[off + s] = f32(0) if first else fetch(p_in[i].astype(f32))
    x_last, y_last, x_first, y_first = gx == nx - 1, gy == ny - 1, gx == 0, gy == 0
    z_first, z_last = zs + z == 0, zs + z == nz - 1
    den = f32(1.0) + lt
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for _ in range(K):
            # step 1
            u = smem[su + s]
            dx = np.where(x_last, smem[su + s - 1], smem[su + s + 1]) - u
            dy = np.where(y_last, smem[su + s - 32], smem[su + s + 32]) - u
            q = [duals_as_stored(smem[sp1 + s]) + sigma * dx,
                 duals_as_stored(smem[sp2 + s]) + sigma * dy, np.zeros_like(u)]
            if three:
                below = np.concatenate([u[:1], u[:-1]])  # z > 0 ? u[z - 1] : u
                above = np.concatenate([u[1:], u[-1:]])  # z + 1 < ZC ? u[z + 1] : u
                q[2] = p3 + sigma * (np.where(z_last, below, above) - u)
            if iso:
                denom = q[0] * q[0] + q[1] * q[1]
                if three:
                    denom = denom + q[2] * q[2]
                rs = torch.rsqrt(torch.from_numpy(np.maximum(denom, f32(1e-30)))).numpy()
                scale = np.where(denom > 1, rs, f32(1))
                q = [c * scale for c in q]
            else:
                q = [c / np.maximum(np.abs(c), f32(1)) for c in q]
            smem[sp1 + s] = q[0]
            smem[sp2 + s] = q[1]
            p3 = q[2]
            # step 2
            div = np.where(x_first, smem[sp1 + s], smem[sp1 + s] - smem[sp1 + s - 1])
            div = div + np.where(y_first, smem[sp2 + s], smem[sp2 + s] - smem[sp2 + s - 32])
            if three:
                below = np.concatenate([np.zeros_like(p3[:1]), p3[:-1]])
                div = div + np.where(z_first, p3, p3 - below)
            uc = np.maximum(smem[su + s], f32(0)) if nonneg else smem[su + s]
            un = ((uc + tau * div) + lt * dat) / den
            smem[su + s] = (un + theta * (un - uc)).astype(f32)
            p3 = duals_as_stored(p3)
    keep = (inside & (lx >= K) & (lx < 32 - K) & (ly >= K) & (ly < HY - K)
            & (z >= z_lo) & (z < z_hi))
    where = (gz[keep], gy_c[keep], gx_c[keep])
    u_out[where] = smem[su + s][keep]
    stored[where] += 1
    if not last:
        for i, c in enumerate((smem[sp1 + s], smem[sp2 + s], p3)[: 3 if three else 2]):
            p_out[i][where] = duals_as_stored(c)[keep]


def pd_emulated(data, lam, iterations, mtv, nonneg, lc, bf16=False):
    """pd_tv() on a CUDA tensor: the wrapper's launches, each block by block."""
    nz, ny, nx = data.shape
    consts = PDT.pd_tv_constants(lam, lc)
    ZC, CY, TYT, zi = pd_tile(nz)
    HY = TYT * CY
    u_prev, p_prev = None, None
    n_launches = 0
    for K, first, last in PDT.launch_plan(iterations, pd_fuse(nz)):
        assert 2 * K < 32 and 2 * K < HY and (zi == nz or zi + 2 * K <= ZC)
        u_out = np.full(data.shape, np.nan, dtype=f32)
        p_out = [np.full(data.shape, np.nan, dtype=f32) for _ in range(3)]
        stored = np.zeros(data.shape, dtype=np.int64)
        for bz in range((nz + zi - 1) // zi):
            for by in range((ny + HY - 2 * K - 1) // (HY - 2 * K)):
                for bx in range((nx + 32 - 2 * K - 1) // (32 - 2 * K)):
                    pd_block(data, u_prev, p_prev, u_out, p_out, stored, bx, by, bz, K,
                             first, last, consts, mtv == 0, nonneg, bf16)
        assert np.all(stored == 1)  # every voxel belongs to one inner tile
        u_prev, p_prev = u_out, p_out
        n_launches += 1
    return (data.copy() if u_prev is None else u_prev), n_launches


def pd_case(nz, ny, nx, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ny, 0:nx]
    disc = ((yy - ny / 2) ** 2 + (xx - nx / 2) ** 2 < (min(ny, nx) / 3) ** 2).astype(f32)
    return (disc[None] * np.linspace(0.5, 1.5, nz, dtype=f32)[:, None, None]
            + f32(0.2) * rng.standard_normal((nz, ny, nx)).astype(f32))


def pd_check(data, iterations, mtv, nonneg, bf16=False, tol=1e-6):
    got, n_launches = pd_emulated(data, 0.05, iterations, mtv, nonneg, 12.0, bf16)
    ref = PDT.pd_tv_plain(torch.as_tensor(data), 0.05, iterations, mtv, nonneg, 12.0, bf16).numpy()
    assert np.isfinite(got).all()  # nothing unwritten reached an inner tile
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    assert n_launches == -(-iterations // pd_fuse(data.shape[0]))


@pytest.mark.parametrize("mtv,nonneg", [(0, 0), (0, 1), (1, 0), (1, 1)],
                         ids=["iso", "iso-nonneg", "aniso", "aniso-nonneg"])
@pytest.mark.parametrize("nz,ny,nx", [(1, 300, 40), (3, 70, 50), (8, 50, 70), (2, 130, 30)],
                         ids=["nz1", "nz3", "nz8", "nz2"])
def test_pd_emulation_against_plain(nz, ny, nx, mtv, nonneg):
    """PD's tiles, halos, levels and boundary rules, with NaN in every
    shared-memory word a block did not write: 20 iterations (five launches
    of 4) on volumes that the inner tiles do not divide, with more than one
    tile along x and y, within 1e-6 of the maximum of the plain version."""
    pd_check(pd_case(nz, ny, nx, seed=nz + nx), 20, mtv, nonneg)


@pytest.mark.parametrize("iterations", [1, PD_K - 1, PD_K, PD_K + 1, 2 * PD_K + 1])
@pytest.mark.parametrize("nz", [1, 8])
def test_pd_emulation_any_iteration_count(nz, iterations):
    """Counts that K does not divide end with a shorter launch, whose halo
    and inner tile follow its own count; one launch is first and last."""
    pd_check(pd_case(nz, 60, 60, seed=iterations), iterations, 0, 1)


@pytest.mark.parametrize("nz", [9, 16, 20, 41])
def test_pd_emulation_many_slices(nz):
    """Up to 16 slices are one chunk, a column of 16 per thread; more are
    cut into chunks with a halo in z, fewer iterations per launch."""
    pd_check(pd_case(nz, 20, 30, seed=nz), 5, 0, 1)
    if nz > PD_ZMAX:
        assert pd_fuse(nz) == PD_KZ and pd_tile(nz)[3] == PD_ZMAX - 2 * PD_KZ


@pytest.mark.parametrize("nz", [1, 3, 8])
def test_pd_emulation_bf16_duals(nz):
    """bfloat16 duals are rounded after every iteration, inside a launch
    too.  The rounding amplifies one-ulp differences, hence 1e-3."""
    data = pd_case(nz, 40, 40, seed=nz)
    pd_check(data, 9, 0, 1, bf16=True, tol=1e-3)
    full = PDT.pd_tv_plain(torch.as_tensor(data), 0.05, 9, 0, 1, 12.0).numpy()
    half, _ = pd_emulated(data, 0.05, 9, 0, 1, 12.0, True)
    assert np.abs(half - full).max() > 1e-5 * np.abs(full).max()  # the rounding is there


@pytest.mark.parametrize("iterations,fuse,counts", [
    (0, 4, []), (1, 4, [1]), (4, 4, [4]), (5, 4, [4, 1]), (20, 4, [4] * 5),
    (20, 7, [7, 7, 6]), (3, 2, [2, 1])])
def test_pd_launch_plan(iterations, fuse, counts):
    plan = PDT.launch_plan(iterations, fuse)
    assert [k for k, _, _ in plan] == counts
    assert [first for _, first, _ in plan] == [i == 0 for i in range(len(counts))]
    assert [last for _, _, last in plan] == [i == len(counts) - 1 for i in range(len(counts))]


# ---------------------------------------------------------------------------
# G: csrc/usfft_grid.cu, usfft_grid_kernel (the grid cell owns the sum)
# ---------------------------------------------------------------------------

from tomobar_tpu_torch.ops import usfft_kernels as UK  # noqa: E402

G_TX, G_TY, G_PAIRS = (cu_const("usfft_grid.cu", n) for n in ("kTileX", "kTileY", "kPairs"))
G_THREADS = G_TX * G_TY  # samples per batch, angles per round


def g_rho_interval(c2, xa, xb):
    """rho_interval() on float32 arrays of c2."""
    with np.errstate(divide="ignore", invalid="ignore"):
        a, b = f32(xa) / c2, f32(xb) / c2
    lo, hi = np.fmin(a, b), np.fmax(a, b)
    zero = c2 == 0
    every = xa <= 0 <= xb
    lo = np.where(zero, f32(-3.0e38) if every else f32(3.0e38), lo).astype(f32)
    hi = np.where(zero, f32(3.0e38) if every else f32(-3.0e38), hi).astype(f32)
    return lo, hi


def g_sample_runs(cs, sn, n, m, cl, ch, rl, rh):
    """sample_run() for an array of angles: (r_lo, count)."""
    lo0, hi0 = g_rho_interval(f32(2) * cs, cl - m - 1, ch + m + 2)
    lo1, hi1 = g_rho_interval(f32(-2) * sn, rl - m - 1, rh + m + 2)
    half = f32(0.5) * f32(n)
    lo = np.maximum(np.maximum(lo0, lo1), -half - f32(1))
    hi = np.minimum(np.minimum(hi0, hi1), half + f32(1))
    ok = lo <= hi
    lo, hi = np.where(ok, lo, f32(0)), np.where(ok, hi, f32(0))
    r_lo = np.maximum(np.floor(lo + half).astype(np.int64) - 1, 0)
    r_hi = np.minimum(np.floor(hi + half).astype(np.int64) + 2, n)
    return np.where(ok, r_lo, 0), np.where(ok, np.maximum(r_hi - r_lo, 0), 0)


def g_tile(g_re, g_im, cos_t, sin_t, fre, fim, ty, tx, p0, n, prm, R, stats):
    """grid_tile(): one block.  Sums in float64 (the index arithmetic is
    what is emulated; the order of the float32 sum has its own test)."""
    nz2, nproj, _ = g_re.shape
    two_n, m = 2 * n, prm.m
    i0 = tx * G_TX + np.arange(G_TX)
    i1 = ty * G_TY + np.arange(G_TY)
    valid = (i1 < two_n)[:, None] & (i0 < two_n)[None, :]
    cl, ch = tx * G_TX - n, min(tx * G_TX + G_TX, two_n) - 1 - n
    rl, rh = ty * G_TY - n, min(ty * G_TY + G_TY, two_n) - 1 - n
    centre = cl < R and cl + G_TX > -R and rl < R and rl + G_TY > -R
    stats["compensated" if centre else "plain"] += 1
    live = [p0 + j < nz2 for j in range(G_PAIRS)]
    acc = np.zeros((2 * G_PAIRS, G_TY, G_TX))
    # two batch buffers; what was never staged is NaN / a huge corner
    e0b = np.full((2, G_THREADS), 2**40, dtype=np.int64)
    e1b = np.full((2, G_THREADS), 2**40, dtype=np.int64)
    x0b = np.full((2, G_THREADS), np.nan, dtype=f32)
    y0b = np.full((2, G_THREADS), np.nan, dtype=f32)
    gb = np.full((2, 2 * G_PAIRS, G_THREADS), np.nan, dtype=f32)

    def stage(buf, b, a_base, total, r_lo, offs):
        i = b * G_THREADS + np.arange(G_THREADS)
        ok = i < total
        i = i[ok]
        ang_l = np.searchsorted(offs, i, side="right") - 1  # last angle with offs <= i
        assert (ang_l >= 0).all() and (ang_l < G_THREADS).all()
        r = r_lo[ang_l] + (i - offs[ang_l])
        ang = a_base + ang_l
        assert (ang < nproj).all() and (r >= 0).all() and (r < n).all()
        c = (r.astype(f32) - f32(0.5) * f32(n)) / f32(n)
        x0 = np.minimum(c * cos_t[ang], prm.clamp)
        y0 = np.minimum(-c * sin_t[ang], prm.clamp)
        k = int(ok.sum())
        e0b[buf, :k] = np.floor(f32(two_n) * x0).astype(np.int64) - m
        e1b[buf, :k] = np.floor(f32(two_n) * y0).astype(np.int64) - m
        x0b[buf, :k], y0b[buf, :k] = x0, y0
        for j in range(G_PAIRS):
            gb[buf, j, :k] = g_re[p0 + j, ang, r] if live[j] else 0
            gb[buf, G_PAIRS + j, :k] = g_im[p0 + j, ang, r] if live[j] else 0
        e0b[buf, k:], e1b[buf, k:] = -2**40, -2**40  # the dummy a late thread stages

    for s1 in (0, 1, -1):
        if (s1 > 0 and rl > -n + m - 1) or (s1 < 0 and rh < n - m):
            continue
        for s0 in (0, 1, -1):
            if (s0 > 0 and cl > -n + m - 1) or (s0 < 0 and ch < n - m):
                continue
            stats["copies"] += (s0, s1) != (0, 0)
            L0 = np.where(valid, (i0 - n + s0 * two_n)[None, :], 2**30)
            L1 = np.where(valid, (i1 - n + s1 * two_n)[:, None], 2**30)
            q0 = L0.astype(f32) / f32(two_n)
            q1 = L1.astype(f32) / f32(two_n)
            for a_base in range(0, nproj, G_THREADS):
                na = min(G_THREADS, nproj - a_base)
                r_lo = np.zeros(G_THREADS, dtype=np.int64)
                count = np.zeros(G_THREADS, dtype=np.int64)
                r_lo[:na], count[:na] = g_sample_runs(
                    cos_t[a_base : a_base + na], sin_t[a_base : a_base + na], n, m,
                    cl + s0 * two_n, ch + s0 * two_n, rl + s1 * two_n, rh + s1 * two_n)
                offs = np.concatenate([[0], np.cumsum(count)])
                total = int(offs[-1])
                stats["staged"] += total
                n_batches = -(-total // G_THREADS)
                if n_batches:
                    stage(0, 0, a_base, total, r_lo, offs)
                for b in range(n_batches):
                    if b + 1 < n_batches:
                        stage((b + 1) & 1, b + 1, a_base, total, r_lo, offs)
                    buf = b & 1
                    cnt = min(G_THREADS, total - b * G_THREADS)
                    e0, e1 = e0b[buf, :cnt], e1b[buf, :cnt]
                    hit = ((L1[..., None] - e1 >= 0) & (L1[..., None] - e1 <= 2 * m)
                           & (L0[..., None] - e0 >= 0) & (L0[..., None] - e0 <= 2 * m))
                    stats["taps"] += int(hit.sum())
                    w0 = q0[..., None] - x0b[buf, :cnt]
                    w1 = q1[..., None] - y0b[buf, :cnt]
                    w = prm.coeff0 * np.exp(prm.coeff1 * (w0 * w0 + w1 * w1))
                    for j in range(2 * G_PAIRS):
                        term = w.astype(np.float64) * gb[buf, j, :cnt]
                        acc[j] += np.where(hit, term, 0.0).sum(axis=-1)
    ys, xs = np.nonzero(valid)
    for j in range(G_PAIRS):
        if live[j]:
            fre[p0 + j, i1[ys], i0[xs]] = acc[j][ys, xs]
            fim[p0 + j, i1[ys], i0[xs]] = acc[G_PAIRS + j][ys, xs]


def g_emulated(g_re, g_im, n, theta, R=UK.CENTRE_HALF_WIDTH):
    """grid() on CUDA tensors, block by block, in the wrapper's tile order."""
    prm = UK.grid_params(n)
    nz2 = g_re.shape[0]
    cos_t, sin_t = np.cos(theta).astype(f32), np.sin(theta).astype(f32)
    fre = np.full((nz2, 2 * n, 2 * n), np.nan)
    fim = np.full_like(fre, np.nan)
    stats = {"taps": 0, "staged": 0, "copies": 0, "compensated": 0, "plain": 0}
    order = UK.tile_order(n, G_TY, G_TX)
    nt_x = -(-2 * n // G_TX)
    assert sorted(order) == list(range(nt_x * -(-2 * n // G_TY)))
    for p0 in range(0, nz2, G_PAIRS):
        for tile in order:
            g_tile(g_re, g_im, cos_t, sin_t, fre, fim, tile // nt_x, tile % nt_x, p0, n,
                   prm, R, stats)
    return fre, fim, stats


G_ANGLES = {
    "180": lambda: -np.linspace(0.0, np.pi, 36, endpoint=False),  # 0 and -pi/2 included
    "360": lambda: -np.linspace(0.0, 2 * np.pi, 40, endpoint=False),
    "one": lambda: np.array([-0.3]),
    "over-360": lambda: np.linspace(-0.2, 7.5, 23),
}


@pytest.mark.parametrize("nz2", [1, 4, 5])
@pytest.mark.parametrize("angles", list(G_ANGLES))
@pytest.mark.parametrize("n", [32, 50, 64])
def test_g_emulation_against_plain(n, angles, nz2):
    """The tile-owner gridding equals the scatter ``grid_plain`` in float64
    (1e-6 of max: the weights are float32 on both sides, the sums float64):
    tiles that the grid does not fill (n = 50), footprints that wrap round
    the rim (every n: a sample at c = -0.5 sits on the border), one angle,
    angles beyond 360 degrees, more z-pairs than one block takes.  Every
    sample's (2m+1)^2 taps are counted exactly once, so the per-angle runs
    are supersets and no wrap-around copy counts twice."""
    theta = G_ANGLES[angles]()
    rng = np.random.default_rng(n + nz2)
    g_re = rng.standard_normal((nz2, theta.shape[0], n)).astype(f32)
    g_im = rng.standard_normal((nz2, theta.shape[0], n)).astype(f32)
    want = UK.grid_plain(torch.from_numpy(g_re).double(), torch.from_numpy(g_im).double(), n, theta)
    fre, fim, stats = g_emulated(g_re, g_im, n, theta, R=8)
    m = UK.grid_params(n).m
    assert stats["taps"] == -(-nz2 // G_PAIRS) * theta.shape[0] * n * (2 * m + 1) ** 2
    assert stats["copies"] > 0 and stats["compensated"] > 0
    assert stats["plain"] > 0 or 2 * n <= 2 * G_TX
    scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
    for got, ref in ((fre, want[0]), (fim, want[1])):
        assert np.isfinite(got).all()  # every cell stored, nothing unstaged read
        assert np.abs(got - ref.numpy()).max() <= 1e-6 * scale


def test_g_runs_are_tight():
    """Far from the centre a tile stages a small multiple of the samples
    whose footprints meet it, not whole lines."""
    n = 64
    theta = -np.linspace(0.0, np.pi, 90, endpoint=False)
    g = np.ones((1, 90, n), dtype=f32)
    _, _, stats = g_emulated(g, g, n, theta)
    m = UK.grid_params(n).m
    tiles = (2 * n // G_TX) * (2 * n // G_TY)
    assert stats["staged"] < 0.6 * tiles * 90 * n
    assert stats["taps"] == 90 * n * (2 * m + 1) ** 2


def test_g_centre_sum_needs_compensation():
    """The centre cell's sum in the kernel's order (ascending angle, then
    r), in float32: Kahan's compensation stays within 1e-6 of the float64
    sum where the plain running sum of same-signed terms drifts."""
    n, nproj = 64, 1801
    prm = UK.grid_params(n)
    theta = -np.linspace(0.0, np.pi, nproj, endpoint=False)
    x0, y0, ell0, ell1 = UK._sample_positions(n, theta, prm.clamp)
    hit = (np.abs(ell0) <= prm.m) & (np.abs(ell1) <= prm.m)  # footprints over cell l = (0, 0)
    w = prm.coeff0 * np.exp(prm.coeff1 * ((f32(0) - x0) ** 2 + (f32(0) - y0) ** 2))
    g = (1.0 + 0.1 * np.random.default_rng(0).standard_normal(w.shape)).astype(f32)
    terms = (g * w)[hit].astype(f32)  # row-major: ascending angle, then r
    assert terms.shape[0] > 4 * nproj
    exact = terms.astype(np.float64).sum()
    s = c = f32(0)
    for t in terms:
        y = f32(t - c)
        tot = f32(s + y)
        c = f32(f32(tot - s) - y)
        s = tot
    assert abs(float(s) - exact) <= 1e-6 * abs(exact)


def test_g_wrapper_on_cpu_is_the_plain_version():
    theta = -np.linspace(0.0, np.pi, 12, endpoint=False)
    rng = np.random.default_rng(2)
    g_re, g_im = (torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(f32)) for _ in range(2))
    for got, ref in zip(UK.grid(g_re, g_im, 32, theta), UK.grid_plain(g_re, g_im, 32, theta)):
        assert torch.equal(got, ref)


def test_g_source_has_no_atomics():
    import os

    import tomobar_tpu_torch

    path = os.path.join(os.path.dirname(tomobar_tpu_torch.__file__), "csrc", "usfft_grid.cu")
    with open(path) as fh:
        code = [ln.split("//")[0] for ln in fh]
    assert not any("atomic" in ln for ln in code)
