"""Index arithmetic of the K1, K1p, K3, K4, K4p, PD, G, F, Fc and Ff CUDA
kernels, emulated in numpy.

The kernels of ``tomobar_tpu_torch/csrc`` run only on a GPU.  What can go
wrong in them apart from the compiler is their index arithmetic: windows,
zero fill, skipped bands, buffer parity, tiles, halos and levels, digit
order, twiddle indices, the shared-memory swizzle.  The emulations below
walk the same blocks, bands, batches, stages and thread items as
``shear_fp_kernel`` and ``unshear_bp_kernel`` (csrc/projector.cu),
``pd_tv_kernel`` (csrc/pd_tv.cu) and ``fft_axis2_kernel``
(csrc/fft_axis2.cu), formula for formula, on the CPU:

* K1, K3, K4 and K4p must equal ``shear_fp_plain``, ``resample_bp_plain``,
  ``unshear_bp_plain`` and ``unshear_bp_packed_plain`` bit for
  bit (float32, every product and sum rounded on its own, rows or angles
  summed in ascending order);
* PD must agree with ``pd_tv_plain`` within 1e-6 of the maximum (1e-3 with
  bfloat16 duals), for every launch plan;
* F must agree with ``numpy.fft`` within 1e-5 of the maximum (float32
  tables and arithmetic in another order), its centred variant Fc
  (``fft_axis2_centred_kernel``: the factors on its loads and stores, the
  transposed load of its second pass) with the chain of passes it
  replaces, ``usfft._ifft2_chain``, and its filter variant Ff
  (``fft_axis2_filter_kernel``: the clamped load of paired rows, the
  filter inside the last stage, the transposed inverse, the cropped split
  store) with the filter stage's definition within 1e-12 in float64 and
  with its plain version, ``usfft._fbp_filter_plain``, within 1e-5 in
  float32.

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


def test_k4p_shares_k4s_block():
    """K4 and K4p are two instantiations of one block, unshear_bp_block, each
    at a shape of its own; the source holds one sum loop for both."""
    import os
    import re

    import tomobar_tpu_torch

    path = os.path.join(os.path.dirname(tomobar_tpu_torch.__file__), "csrc", "projector.cu")
    with open(path) as fh:
        src = fh.read()
    assert len(re.findall(r"void unshear_bp_block\(", src)) == 1
    assert re.findall(r"unshear_bp_block<(\w+), (\w+)>\(", src) == [
        ("K4Shape", "Z"), ("K4pShape", "1")]
    assert "using K4Shape = UnshearShape<kK4R, kK4J, kK4AZ>;" in src
    assert "using K4pShape = UnshearShape<kP4R, kP4J, kP4A>;" in src
    assert K4.W == K4.C + 16 and K4P.R == 8 and K4P.J % 8 == 0


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


def dft_exact(x):
    """An R-point DFT of R complex128 arrays, for the float64 emulations."""
    R = len(x)
    m = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
    return [sum(m[p, q] * x[q] for q in range(R)) for p in range(R)]


def stage_butterflies(s, w, Cn, Ls, R, transposed=False, dft=dft_regs):
    """stage_butterflies<R, kTransposed>: the DIF stage, or its transpose
    (the twiddles on the inputs, before the DFT) at the same places."""
    M, step = Ls // R, Cn // Ls
    b = np.arange(Cn // R * F_COLS)
    col, t = b % F_COLS, b // F_COLS
    blk = t // M
    j = t - blk * M
    base = blk * Ls + j
    x = [s[slot(base + M * q), col] for q in range(R)]
    if transposed and M > 1:
        for p in range(1, R):
            x[p] = x[p] * w[j * p * step]
    y = dft(x)
    if not transposed and M > 1:
        for p in range(1, R):
            assert (j * p * step).max() < Cn  # the twiddle index needs no remainder
            y[p] = y[p] * w[j * p * step]
    for p in range(R):
        s[slot(base + M * p), col] = y[p]


def stage_outputs(s, w, Cn, Ls, r, transposed=False):
    M, step, root_step = Ls // r, Cn // Ls, Cn // r
    assert Cn * F_COLS <= F_MAX_ITEMS * F_PLAN_THREADS  # the register array holds them
    it = np.arange(Cn * F_COLS)
    col, pos = it % F_COLS, it // F_COLS
    blk = pos // Ls
    rem = pos - blk * Ls
    p = rem // M
    j = rem - p * M
    base = blk * Ls + j
    acc = np.zeros(it.shape, dtype=s.dtype)
    for q in range(r):
        v = s[slot(base + M * q), col]
        if transposed:
            v = v * w[j * q * step]
        acc = acc + v * w[((p * q) % r) * root_step]
    out = acc if transposed else acc * w[j * p * step]
    s[slot(pos), col] = out  # after the barrier: every read came first


def b_step(slabs, wb, tt, B, Cn):
    """b_step<B>: block ``rank`` owns the n2 of its chunk, all k1."""
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


def load_transposed(re, im, base, first, n, Cn, l0, L, vector):
    """load_transposed of fft_axis2.cu: the slab (Cn, 8) of rows first + n2
    of the columns l0 + col, read from flat (Z, L, n) arrays; ``vector``:
    four floats a thread item (the compile-time plans), else one."""
    slab = np.full(((Cn + 1) & ~1, F_COLS), np.nan, dtype=np.complex64)
    if vector:
        assert Cn % 4 == 0 and n % 4 == 0
        it = np.arange(Cn // 4 * F_COLS)
        col, n2 = it % F_COLS, it // F_COLS * 4
        live = l0 + col < L
        off = base + (l0 + col) * n + first + n2
        assert np.all(off[live] % 4 == 0)  # 16-byte loads from an aligned base
        for e in range(4):
            v = np.where(live, C(re[np.where(live, off + e, 0)], im[np.where(live, off + e, 0)]), 0)
            slab[slot(n2 + e), col] = v
    else:
        it = np.arange((Cn + 3) // 4 * 4 * F_COLS)
        n2 = it // (4 * F_COLS) * 4 + it % 4
        col = it // 4 % F_COLS
        keep = n2 < Cn
        n2, col = n2[keep], col[keep]
        live = l0 + col < L
        off = np.where(live, base + (l0 + col) * n + first + n2, 0)
        slab[slot(n2), col] = np.where(live, C(re[off], im[off]), 0)
    return slab


def f_emulated(re, im, sign, B, Cn, plan, mode=0, centre=None, scale=None):
    """fft_axis2() on CUDA tensors: one cluster of B blocks per 8 columns.
    ``mode`` 1 and 2 are the two passes of Fc: ``centre`` holds c(k) as
    the kernel reads it (complex64), ``scale`` the store's factor."""
    if sign > 0:  # the wrapper's pointer swap, in and out
        oim, ore = f_emulated(im, re, -1, B, Cn, plan, mode, centre, scale)
        return ore, oim
    if mode == 2:  # the input is (Z, L, n), the output (Z, n, L)
        Z, L, n = re.shape
    else:
        Z, n, L = re.shape
    assert n == B * Cn
    tables = FK._device_tables(n, B, Cn, torch.device("cpu")).numpy().reshape(-1, 2)
    tables = C(tables[:, 0], tables[:, 1])
    wb, tt, w = tables[: B * B], tables[B * B : B * B + B * Cn], tables[B * B + B * Cn :]
    assert w.shape == (Cn,)
    ore, oim = np.full((Z, n, L), np.nan, dtype=f32), np.full((Z, n, L), np.nan, dtype=f32)
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
                if mode == 2:
                    args = (re.ravel(), im.ravel(), z * n * L, k1 * Cn, n, Cn, l0, L)
                    slabs[k1] = load_transposed(*args, vector=False)
                    if Cn % 4 == 0:  # the 16-byte mapping reads the same slab
                        vec = load_transposed(*args, vector=True)
                        assert np.array_equal(vec[:Cn], slabs[k1][:Cn])
                    continue
                v = np.zeros((Cn, F_COLS), dtype=np.complex64)
                v[:, live] = C(re[z, k1 * Cn : (k1 + 1) * Cn, l0 : l0 + F_COLS],
                               im[z, k1 * Cn : (k1 + 1) * Cn, l0 : l0 + F_COLS])
                if mode == 1:  # cmul_conj(v, cmul(c(i), c(l)))
                    v[:, live] = v[:, live] * np.conj(
                        centre[k1 * Cn + n2][:, None] * centre[l0 + cols[live]][None, :])
                slabs[k1][slot(n2)] = v
            # 2. the B step
            b_step(slabs, wb, tt, B, Cn)
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
                if mode == 2:  # (-1)^(row + l) * scale
                    odd = (k1 + B * k2[:, None] + l0 + cols[live][None, :]) & 1
                    f = np.where(odd == 1, -scale, scale).astype(f32)
                    out = C(out.real * f, out.imag * f)
                ore[z, k1 + B * k2, l0 : l0 + F_COLS] = out.real
                oim[z, k1 + B * k2, l0 : l0 + F_COLS] = out.imag
    return ore, oim


def fc_emulated(fre, fim, half_pixel_shift):
    """ifft2_centred() on CUDA tensors: its two launches."""
    two_n = fre.shape[-1]
    B, Cn = FK.best_split(two_n)
    plan = FK.stage_plan(Cn)
    cre, cim = FK.centred_factors(two_n // 2, half_pixel_shift)
    centre, scale = C(cre, cim), f32(1.0 / (two_n * two_n))
    mid = f_emulated(fre, fim, 1, B, Cn, plan, mode=1, centre=centre)
    return f_emulated(*mid, 1, B, Cn, plan, mode=2, scale=scale)


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


@pytest.mark.parametrize("shift", [True, False], ids=["half-pixel", "no-shift"])
@pytest.mark.parametrize("two_n", [24, 40, 74, 256],
                         ids=lambda n: "2n%d-B%d-C%d" % ((n,) + FK.best_split(n)))
def test_fc_emulation_against_the_chain(two_n, shift):
    """Fc's two launches (the factors on pass 1's load, pass 2's transposed
    load by either mapping, the signed scale on its store) give what the
    chain of passes gives, transposed image and all: splits with a C that
    is a multiple of 4 and one that is not (37)."""
    from tomobar_tpu_torch.ops import usfft as U

    rng = np.random.default_rng(two_n)
    fre = rng.standard_normal((2, two_n, two_n)).astype(f32)
    fim = rng.standard_normal((2, two_n, two_n)).astype(f32)
    got = fc_emulated(fre, fim, shift)
    ref = U._ifft2_chain(torch.from_numpy(fre), torch.from_numpy(fim), two_n // 2, shift)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert not np.isnan(g).any()
        assert np.abs(g - r.numpy()).max() <= 1e-5 * scale


@pytest.mark.parametrize("two_n", [1280, 2048, 5120])
def test_fc_passes_at_the_flagship_splits(two_n):
    """Each pass of Fc on a thin strip at the splits FOURIER_INV meets
    (1280: 2 x 640; 2048: 2 x 1024; 5120: 5 x 1024), against numpy: pass 1
    along axis -2 of (x * c(i) c(l)), pass 2 along the last axis of its
    (3, 2n) input with the signed scale, stored transposed."""
    B, Cn = FK.best_split(two_n)
    plan = FK.stage_plan(Cn)
    cre, cim = FK.centred_factors(two_n // 2)
    c = cre.astype(np.float64) + 1j * cim
    rng = np.random.default_rng(two_n)
    L = 3
    x = rng.standard_normal((2, 1, two_n, L)).astype(f32)
    got = f_emulated(x[0], x[1], 1, B, Cn, plan, mode=1, centre=C(cre, cim))
    ref = np.fft.ifft((x[0] + 1j * x[1]) * (c[:, None] * c[None, :L]), axis=-2) * two_n
    for g, r in zip(got, (ref.real, ref.imag)):
        assert np.abs(g - r).max() <= 1e-5 * np.abs(ref).max()
    y = rng.standard_normal((2, 1, L, two_n)).astype(f32)
    scale = f32(1.0 / (two_n * two_n))
    got = f_emulated(y[0], y[1], 1, B, Cn, plan, mode=2, scale=scale)
    m = np.arange(two_n)[:, None] + np.arange(L)[None, :]
    ref = (np.fft.ifft(y[0] + 1j * y[1], axis=-1) * two_n).transpose(0, 2, 1)
    ref = ref * np.where(m % 2 == 1, -1.0, 1.0) * float(scale)
    for g, r in zip(got, (ref.real, ref.imag)):
        assert np.abs(g - r).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("Cn", [2, 3, 6, 7, 37, 120, 509, 640, 999, 1000, 1024])
def test_f_stage_plan(Cn):
    plan = FK.stage_plan(Cn)
    assert int(np.prod(plan)) == Cn
    assert len(plan) <= 10
    odd = [r for r in plan if r % 2]
    assert list(plan[: len(odd)]) == sorted(odd)  # odd radices first, ascending
    assert all(r in (16, 8, 4, 2) for r in plan[len(odd):])


# ---------------------------------------------------------------------------
# Ff: csrc/fft_axis2.cu, fft_axis2_filter_kernel
# ---------------------------------------------------------------------------

FF_COMPILE_TIME = {1024: (16, 8, 8), 640: (5, 16, 8)}  # the plans with their own instances


def swap(v):
    return (v.imag + 1j * v.real).astype(v.dtype)


def f_tables(n, B, Cn, exact):
    """DFT_B, T and the roots w_C: the kernel's float32 tables, or the same
    in complex128 for the float64 emulation."""
    if exact:
        wb = np.exp(-2j * np.pi * np.outer(np.arange(B), np.arange(B)) / B).ravel()
        tt = np.exp(-2j * np.pi * np.outer(np.arange(B), np.arange(Cn)) / n).ravel()
        return wb, tt, np.exp(-2j * np.pi * np.arange(Cn) / Cn)
    tables = FK._device_tables(n, B, Cn, torch.device("cpu")).numpy().reshape(-1, 2)
    tables = C(tables[:, 0], tables[:, 1])
    return tables[: B * B], tables[B * B : B * B + B * Cn], tables[B * B + B * Cn :]


def ff_vector(Cn, raw, pad_m, unpad_m, width):
    """The kernel's choice of 16-byte loads and stores (the wrapper's
    tensors are aligned): every run of 4 of a slab's positions then lies
    wholly inside the raw row or wholly on one clamped side of it, and
    wholly inside or outside the crop."""
    return all(v % 4 == 0 for v in (Cn, raw, pad_m, unpad_m, width))


def ff_rows(l, npairs, A):
    """Pair l's slice, its row 2j, and whether row 2j + 1 exists."""
    z, j = l // npairs, l % npairs
    return z, 2 * j, 2 * j + 1 < A


def ff_load(data, k1, Cn, l0, L, pad_m, vector, dtype):
    """load_rows: block k1's slab of positions k1*C + n2 of 8 pairs of rows,
    each through the clamped index (16-byte runs of 4, 8 columns x 4 runs a
    warp, or one float a thread item, 8 columns x 4 positions a warp)."""
    Z, A, raw = data.shape
    npairs = (A + 1) // 2
    slab = np.full(((Cn + 1) & ~1, F_COLS), np.nan, dtype=dtype)
    if vector:
        it = np.arange(Cn // 4 * F_COLS)
        col, first = it % F_COLS, it // F_COLS * 4
        q = k1 * Cn + first - pad_m
        assert np.all(q % 4 == 0)
        inside = (q >= 0) & (q < raw)
        # a run read whole, or one edge value for all four
        q = np.where(inside[:, None], q[:, None] + np.arange(4), np.where(q < 0, 0, raw - 1)[:, None])
        n2 = first[:, None] + np.arange(4)
        col = np.repeat(col[:, None], 4, axis=1)
    else:
        it = np.arange((Cn + 3) // 4 * 4 * F_COLS)
        n2 = it // (4 * F_COLS) * 4 + it % 4
        col = it // 4 % F_COLS
        keep = n2 < Cn
        n2, col = n2[keep], col[keep]
        q = np.clip(k1 * Cn + n2 - pad_m, 0, raw - 1)
    l = l0 + col
    live = l < L
    z, r0, has_im = ff_rows(np.where(live, l, 0), npairs, A)
    re = np.where(live, data[z, r0, q], 0)
    im = np.where(live & has_im, data[z, np.minimum(r0 + 1, A - 1), q], 0)
    slab[slot(n2), col] = (re + 1j * im).astype(dtype)
    return slab


def ff_store(out, slab, m1, Cn, l0, L, unpad_m, vector):
    """store_rows: block m1 holds positions m1*C + m2; those in the crop go
    to column m - unpad_m, the (swapped) im part to row 2j, the re part to
    row 2j + 1 where it exists (16-byte runs of 4, or one float a thread
    item)."""
    Z, A, width = out.shape
    npairs = (A + 1) // 2
    if vector:
        it = np.arange(Cn // 4 * F_COLS)
        col, first = it % F_COLS, it // F_COLS * 4
        o = m1 * Cn + first - unpad_m
        keep = (l0 + col < L) & (o >= 0) & (o < width)
        assert np.all(o[keep] + 3 < width)  # the run of 4 lies inside the crop
        col = np.repeat(col[keep], 4)
        n2 = (first[keep][:, None] + np.arange(4)).ravel()
    else:
        it = np.arange((Cn + 3) // 4 * 4 * F_COLS)
        n2 = it // (4 * F_COLS) * 4 + it % 4
        col = it // 4 % F_COLS
        o = m1 * Cn + n2 - unpad_m
        keep = (n2 < Cn) & (l0 + col < L) & (o >= 0) & (o < width)
        n2, col = n2[keep], col[keep]
    o = m1 * Cn + n2 - unpad_m
    v = slab[slot(n2), col]
    z, r0, has_im = ff_rows(l0 + col, npairs, A)
    out[z, r0, o] = v.imag
    out[z[has_im], r0[has_im] + 1, o[has_im]] = v.real[has_im]


def ff_filter_butterflies(s, filt, k1, B, Cn, plan, R, dft):
    """filter_butterflies<R>: the last forward stage (M = 1), the filter
    multiply at X[k1 + B*k2] and the swap into the inverse's frame, the
    first transposed stage, one thread's registers throughout."""
    b = np.arange(Cn // R * F_COLS)
    col, base = b % F_COLS, b // F_COLS * R
    y = dft([s[slot(base + q), col] for q in range(R)])
    for p in range(R):
        k2 = k2_of_position(base + p, plan, Cn)
        if FF_COMPILE_TIME.get(Cn) == plan:
            assert np.array_equal(k2, k2_of_position_compile_time(base + p, plan, Cn))
        y[p] = swap(y[p] * filt[k1 + B * k2])
    y = dft(y)
    for q in range(R):
        s[slot(base + q), col] = y[q]


def ff_filter_pass(s, filt, k1, B, Cn, plan):
    """filter_pass: the same multiply and swap on every position, between
    a last stage without a register butterfly and its transpose."""
    pos = np.arange(Cn)
    s[slot(pos)] = swap(s[slot(pos)] * filt[k1 + B * k2_of_position(pos, plan, Cn)][:, None])


def ff_stage(s, w, Cn, Ls, r, transposed, dft):
    if r in BUTTERFLIES:
        stage_butterflies(s, w, Cn, Ls, r, transposed, dft)
    else:
        stage_outputs(s, w, Cn, Ls, r, transposed)


def ff_emulated(data, filt, B, Cn, pad_m, unpad_m, width, exact=False):
    """filter_rows() on a CUDA tensor: one cluster of B blocks per 8 pairs
    of rows.  ``filt``: the (ow,) filter table with 1/ow folded in;
    ``exact``: complex128 tables and DFTs (the index arithmetic alone)."""
    Z, A, raw = data.shape
    plan = FK.stage_plan(Cn)
    dtype, dft = (np.complex128, dft_exact) if exact else (np.complex64, dft_regs)
    wb, tt, w = f_tables(B * Cn, B, Cn, exact)
    filt = filt.astype(dtype)
    vector = ff_vector(Cn, raw, pad_m, unpad_m, width)
    L = Z * ((A + 1) // 2)
    m_lo, m_hi = unpad_m // Cn, (unpad_m + width - 1) // Cn
    chunk = (Cn + B - 1) // B
    out = np.full((Z, A, width), np.nan, dtype=np.float64 if exact else f32)
    for l0 in range(0, L, F_COLS):
        # 1. block k1 loads the slab n1 = k1; 2. the B step
        slabs = np.stack([ff_load(data, k1, Cn, l0, L, pad_m, vector, dtype) for k1 in range(B)])
        if vector:  # the one-float mapping reads the same slabs
            scalar = np.stack([ff_load(data, k1, Cn, l0, L, pad_m, False, dtype) for k1 in range(B)])
            assert np.array_equal(scalar[:, :Cn], slabs[:, :Cn])
        b_step(slabs, wb, tt, B, Cn)
        # 3. block k1: the forward stages, the filter inside the last one,
        # the transposed stages in the other order
        for k1 in range(B):
            s, Ls = slabs[k1], Cn
            for r in plan[:-1]:
                ff_stage(s, w, Cn, Ls, r, False, dft)
                Ls //= r
            r = plan[-1]
            assert Ls == r
            if r in BUTTERFLIES:
                ff_filter_butterflies(s, filt, k1, B, Cn, plan, r, dft)
            else:
                stage_outputs(s, w, Cn, r, r)
                ff_filter_pass(s, filt, k1, B, Cn, plan)
                stage_outputs(s, w, Cn, r, r, transposed=True)
            for r in plan[-2::-1]:
                Ls *= r
                ff_stage(s, w, Cn, Ls, r, True, dft)
        # 4. the inverse B step: T on the inputs, DFT_B into the blocks that
        # hold part of the crop only
        for rank in range(B):
            mine = rank * chunk + np.arange(chunk)
            mine = mine[mine < Cn]
            x = [slabs[k1][slot(mine)].copy() for k1 in range(B)]
            x = [x[0]] + [x[k1] * tt[k1 * Cn + mine][:, None] for k1 in range(1, B)]
            for m1 in range(m_lo, m_hi + 1):
                y = x[0]
                for k1 in range(1, B):
                    y = y + x[k1] * wb[m1 * B + k1]
                slabs[m1][slot(mine)] = y
        # 5. the store of the crop
        for m1 in range(m_lo, m_hi + 1):
            ff_store(out, slabs[m1], m1, Cn, l0, L, unpad_m, vector)
            if vector:  # the one-float mapping stores the same
                again = np.full_like(out, np.nan)
                ff_store(again, slabs[m1], m1, Cn, l0, L, unpad_m, False)
                stored = ~np.isnan(again)
                assert np.array_equal(again[stored], out[stored])
    return out


def ff_reference(data, filt, ow, pad_m, unpad_m, width):
    """The filter stage by its definition in float64 (numpy's edge pad and
    FFT): rows paired, transformed, times ``filt`` (1/ow folded in),
    transformed back, split, cropped."""
    Z, A, raw = data.shape
    x = np.pad(data.astype(np.float64), ((0, 0), (0, A % 2), (pad_m, ow - raw - pad_m)), mode="edge")
    if A % 2:
        x[:, -1] = 0.0
    y = np.fft.ifft(np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2], axis=-1) * filt * ow, axis=-1)
    rows = np.stack([y.real, y.imag], axis=2).reshape(Z, -1, ow)
    return rows[:, :A, unpad_m : unpad_m + width]


def ff_case(B, Cn, A, raw, width, ftype="shepp", cor=0.0, Z=3, seed=0):
    """Rows, the filter table of ``_fbp_filter_stage`` (``_device_filter``'s
    values) and the window on a grid of ow = B*C."""
    from tomobar_tpu_torch.ops import usfft as U

    ow = B * Cn
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((Z, A, raw)).astype(f32)
    table = U._device_filter(ow, ftype, 0.8, cor + 0.5, torch.device("cpu")).numpy().reshape(-1, 2)
    pad_m, unpad_m, unpad_p = U._filter_window(ow, raw, width)
    return data, C(table[:, 0], table[:, 1]), pad_m, unpad_m, unpad_p - unpad_m


FF_SPLITS = [(4, 16), (8, 32), (2, 37), (5, 12)]
FF_GEOMETRIES = {  # (raw, width) from ow; the CoR offset
    "plain": (lambda ow: (ow // 4, ow // 4), 0.0),
    "padded-cor": (lambda ow: (ow // 4 - 2, ow // 4 + 3), 3.7),
}


@pytest.mark.parametrize("A", [6, 7], ids=["even-angles", "odd-angles"])
@pytest.mark.parametrize("geometry", list(FF_GEOMETRIES))
@pytest.mark.parametrize("B,Cn", FF_SPLITS, ids=lambda v: str(v))
def test_ff_emulation_against_the_definition(B, Cn, geometry, A):
    """Ff's index arithmetic in float64 (exact DFTs and tables, so only
    the indices can differ): the clamped load of paired rows, the
    digit-reversed filter multiply, the transposed four-step inverse, the
    crop and the split store give the filter stage's definition to 1e-12,
    with an even and an odd angle count, with the detector padded (raw <
    width, an odd width) and a complex filter (the CoR ramp), on plans with
    a register butterfly last and without (37), by both I/O mappings."""
    size, cor = FF_GEOMETRIES[geometry]
    raw, width = size(B * Cn)
    data, filt, pad_m, unpad_m, width = ff_case(B, Cn, A, raw, width, cor=cor)
    got = ff_emulated(data, filt, B, Cn, pad_m, unpad_m, width, exact=True)
    ref = ff_reference(data, filt, B * Cn, pad_m, unpad_m, width)
    assert not np.isnan(got).any()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_ff_emulation_takes_both_io_mappings():
    """The geometries above run the 16-byte and the one-float mapping."""
    taken = set()
    for B, Cn in FF_SPLITS:
        for size, _ in FF_GEOMETRIES.values():
            raw, width = size(B * Cn)
            _, _, pad_m, unpad_m, width = ff_case(B, Cn, 6, raw, width)
            taken.add(ff_vector(Cn, raw, pad_m, unpad_m, width))
    assert taken == {True, False}


@pytest.mark.parametrize(
    "ftype", ["none", "ramp", "shepp", "cosine", "cosine2", "hamming", "hann", "parzen"])
def test_ff_emulation_every_filter(ftype):
    """Every filter type, at the split 8 x 32 with a CoR offset, in float64."""
    data, filt, pad_m, unpad_m, width = ff_case(8, 32, 7, 60, 64, ftype, cor=-2.3)
    got = ff_emulated(data, filt, 8, 32, pad_m, unpad_m, width, exact=True)
    ref = ff_reference(data, filt, 256, pad_m, unpad_m, width)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("A", [6, 7], ids=["even-angles", "odd-angles"])
@pytest.mark.parametrize("B,Cn,raw,width", [(2, 32, 16, 20), (8, 1024, 2560, 2560), (4, 640, 640, 644)],
                         ids=["2x32", "8x1024-cell", "4x640-padded"])
def test_ff_emulation_against_the_plain_route(B, Cn, raw, width, A):
    """In float32 with the kernel's tables and register butterflies, Ff
    against ``usfft._fbp_filter_plain`` (the CPU route of the stage) to
    1e-5 of the largest value: the wrapper's split at ow = 64, the cell's
    (ow 8192: the compile-time plan 16 x 8 x 8, 16-byte I/O) on one tile of
    8 pairs or fewer, and the compile-time plan 5 x 16 x 8 with a padded
    detector."""
    from tomobar_tpu_torch.ops import usfft as U

    data, filt, pad_m, unpad_m, width_out = ff_case(B, Cn, A, raw, width, cor=1.3,
                                                    Z=3 if B * Cn <= 256 else 1)
    got = ff_emulated(data, filt, B, Cn, pad_m, unpad_m, width_out)
    ref = U._fbp_filter_plain(torch.from_numpy(data), B * Cn, raw, width, "shepp", 0.8, 1.8).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_ff_routes_only_the_filter_stage(monkeypatch):
    """Ff serves ``_fbp_filter_stage`` on a card's tensor (planned on meta,
    where a card's call launches it) at the oversampled widths F takes,
    and nothing else: not the CPU, not ow = 16384 (B = 16), not the FBP
    filter; FOURIER_INV runs it once a z-block."""
    from tomobar_tpu_torch import RecToolsDIRCuPy
    from tomobar_tpu_torch.ops import usfft as U

    calls = []
    monkeypatch.setattr(U, "filter_rows", lambda *a: (calls.append(a[2]), FK.filter_rows(*a))[1])
    out = U._fbp_filter_stage(torch.zeros((2, 9, 2560), device="meta"), 2560, 2560, "shepp", 1.0, 0.5)
    assert calls == [8192] and out.is_meta and out.shape == (2, 9, 2560)
    calls.clear()
    U._fbp_filter_stage(torch.zeros((1, 3, 3000), device="meta"), 3000, 3000, "shepp", 1.0, 0.5)
    U._fbp_filter_stage(torch.zeros((1, 3, 64)), 64, 64, "shepp", 1.0, 0.5)
    angles = np.linspace(0, np.pi, 30, endpoint=False)
    rd = RecToolsDIRCuPy(640, 0, 4, 0.0, angles, 640, device="meta")
    rd.FBP(torch.zeros((30, 4, 640), device="meta"))
    assert calls == []
    rec = rd.FOURIER_INV(torch.zeros((4, 30, 640), device="meta"), chunk_count=2)
    assert rec.shape == (4, 640, 640) and calls == [2048, 2048]


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
# K4 and K4p: csrc/projector.cu, unshear_bp_block in the shapes of
# unshear_bp_kernel and unshear_bp_packed_kernel
# ---------------------------------------------------------------------------

from types import SimpleNamespace  # noqa: E402


def unshear_shape(R, J, AZ):
    """UnshearShape<R, J, AZ> of projector.cu."""
    C = 32 * J
    W = C + 2 * R
    assert 2 * R >= R + 4 and W % 4 == 0
    assert AZ * W >= C * (R + 1)  # the turned tile fits a window buffer
    assert (32 * R) % AZ == 0 and AZ % 2 == 0 and R % 4 == 0 and J % 4 == 0
    return SimpleNamespace(R=R, J=J, C=C, AZ=AZ, W=W, threads=32 * R, buf=AZ * W)


def unshear_col(S, x, k):
    """UnshearShape::col(): column of the tile that thread x holds in acc[k]."""
    return x + 32 * k


K4 = unshear_shape(*(cu_const("projector.cu", n) for n in ("kK4R", "kK4J", "kK4AZ")))  # K4Shape
K4P = unshear_shape(*(cu_const("projector.cu", n) for n in ("kP4R", "kP4J", "kP4A")))  # K4pShape
K4_GLOBAL = None  # kK4Global


def k4_window(S, bt, r0, c0, cy, U0, aligned):
    """k4_window(): (lo4, fits) of one angle's window for a block's rows."""
    o_first = int(row_shift(bt, r0, cy, U0)[0])
    o_last = int(row_shift(bt, r0 + S.R - 1, cy, U0)[0])
    lo4 = (min(o_first, o_last) + c0 - 1) & ~3
    return lo4, aligned and max(o_first, o_last) + c0 + S.C - 1 - lo4 < S.W


def k4_stage(S, q, beta, dst, sbeta, sbase, b, Z, z0, r0, c0, cy, U0, aligned, stats):
    """k4_stage(): the windows of angle batch b, zero-filled outside [0, LU),
    in 16-byte chunks as they lie in q; an angle whose window does not fit is
    marked."""
    A, nz, LU = q.shape
    kA = S.AZ // Z
    for i in range(kA):
        a = b * kA + i
        if a >= A:
            continue
        lo4, fits = k4_window(S, beta[a], r0, c0, cy, U0, aligned)
        sbeta[i] = beta[a]
        sbase[i] = lo4 if fits else K4_GLOBAL
        stats["staged" if fits else "global"] += 1
        if not fits:
            continue
        for zz in range(Z):
            d = dst[zz, i]
            for c in range(S.W // 4):
                u = lo4 + 4 * c
                d[4 * c : 4 * c + 4] = q[a, z0 + zz, u : u + 4] if 0 <= u < LU else 0.0


def k4_block(S, q, beta, vol, bx, by, bz, Z, U0, ny, nx, swap, accumulate, aligned,
             vol_aligned, stats):
    """unshear_bp_block<S, Z>(): one block of K4 or K4p."""
    A, nz, LU = q.shape
    kA = S.AZ // Z
    n_rows, row_len = (nx, ny) if swap else (ny, nx)
    c0, r0, z0 = bx * S.C, by * S.R, bz * Z
    cy = f32(0.5) * f32(n_rows - 1)
    n_batches = (A + kA - 1) // kA
    lanes = np.arange(32)
    cols = np.array([[unshear_col(S, x, k) for x in range(32)] for k in range(S.J)])  # [k, x]
    acc = np.zeros((Z, S.R, S.J, 32), dtype=f32)
    smem = np.full((2, S.buf), np.nan, dtype=f32)  # the two window buffers
    buf = smem.reshape(2, Z, kA, S.W)
    sbeta = np.full((2, kA), np.nan, dtype=f32)
    sbase = [[None] * kA, [None] * kA]

    def stage(b, parity):
        k4_stage(S, q, beta, buf[parity], sbeta[parity], sbase[parity], b, Z, z0, r0, c0, cy,
                 U0, aligned, stats)

    if n_batches:
        stage(0, 0)
    for b in range(n_batches):
        parity = b & 1
        if b + 1 < n_batches:
            stage(b + 1, parity ^ 1)
        for i in range(min(kA, A - b * kA)):
            for y in range(S.R):  # rows past n_rows are summed too, and never stored
                o, f = row_shift(sbeta[parity, i], r0 + y, cy, U0)
                o, f = int(o), f32(f)
                g = f32(1.0) - f
                lo4 = sbase[parity][i]
                for zz in range(Z):
                    w = buf[parity, zz, i]
                    if lo4 is not K4_GLOBAL:
                        idx = o + c0 + lanes[None, :] + 32 * np.arange(S.J)[:, None] - lo4
                        assert idx.min() >= 1 and idx.max() < S.W
                        stats["loads"] += 2 * S.J
                        acc[zz, y] += g * w[idx] + f * w[idx - 1]
                    else:
                        u = o + c0 + cols
                        line = q[b * kA + i, z0 + zz]
                        q0 = np.where((u >= 0) & (u < LU), line[np.clip(u, 0, LU - 1)], f32(0))
                        q1 = np.where((u >= 1) & (u - 1 < LU), line[np.clip(u - 1, 0, LU - 1)], f32(0))
                        acc[zz, y] += g * q0 + f * q1

    def add(old, v):
        return old + v if accumulate else v

    if not swap:
        for zz in range(Z):
            for y in range(S.R):
                row = r0 + y
                if row >= n_rows:
                    continue
                out = vol[z0 + zz, row]
                for x in range(32):
                    for k in range(S.J):
                        col = c0 + unshear_col(S, x, k)
                        if col < row_len:
                            out[col] = add(out[col], acc[zz, y, k, x])
        return
    # y-driven: the tile is turned in the first window buffer
    turn = smem[0]
    for zz in range(Z):
        turn[:] = np.nan
        for y in range(S.R):
            for k in range(S.J):
                turn[(lanes + 32 * k) * (S.R + 1) + y] = acc[zz, y, k]
        for e in range(S.C):  # thread e % threads, in turns
            col = c0 + unshear_col(S, e % 32, e // 32)
            if col >= row_len:
                continue
            t = turn[e * (S.R + 1) : e * (S.R + 1) + S.R]
            out = vol[z0 + zz, col]
            if vol_aligned and r0 + S.R <= n_rows:
                assert (col * nx + r0) % 4 == 0
                out[r0 : r0 + S.R] = add(out[r0 : r0 + S.R], t)
            else:
                for i in range(min(S.R, n_rows - r0)):
                    out[r0 + i] = add(out[r0 + i], t[i])


def unshear_emulated(S, q, beta, U0, ny, nx, swap, out=None, single=False):
    """unshear_bp() (or, with ``single``, unshear_bp_packed(): one slice per
    block) on a CUDA tensor, block by block."""
    A, nz, LU = q.shape
    n_rows, row_len = (nx, ny) if swap else (ny, nx)
    aligned = LU % 4 == 0  # numpy lines start 16-byte aligned, as torch's do
    vol_aligned = nx % 4 == 0
    vol = np.full((nz, ny, nx), np.nan, dtype=f32) if out is None else out.copy()
    stats = {"staged": 0, "global": 0, "loads": 0}
    Z = 2 if nz % 2 == 0 and not single else 1  # slices per block
    for bz in range(nz // Z):
        for by in range((n_rows + S.R - 1) // S.R):
            for bx in range((row_len + S.C - 1) // S.C):
                k4_block(S, q, beta, vol, bx, by, bz, Z, U0, ny, nx, swap, out is not None,
                         aligned, vol_aligned, stats)
    return vol, stats


def k4_emulated(q, beta, U0, ny, nx, swap, out=None):
    return unshear_emulated(K4, q, beta, U0, ny, nx, swap, out)


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
    assert g.swap == (group == "y-driven") and g.prm.A > K4.AZ
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
# K4p: csrc/projector.cu, unshear_bp_packed_kernel (K4's block on one slice)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accumulate", [False, True], ids=["new", "accumulate"])
@pytest.mark.parametrize("group", ["x-driven", "y-driven"])
@pytest.mark.parametrize("cor", [2.5, "per-angle"], ids=["scalar-cor", "per-angle-cor"])
@pytest.mark.parametrize("n", [40, 520], ids=["one-column-tile", "more-column-tiles"])
def test_k4p_emulation_bit_exact(n, cor, group, accumulate):
    """K4p's block equals unshear_bp_packed_plain bit for bit: 40 angles per
    group (full batches and a ragged one in two buffers; 12 per group at 520
    columns), zero-filled windows with NaN in whatever was not staged, one
    column tile and two, the y-driven tile turned in shared memory, adding
    into a slice; two loads per term."""
    _, groups = k1_case(1, n, n, 80 if n == 40 else 24, cor, seed=n)
    g = groups[0 if group == "x-driven" else 1]
    S = K4P
    assert g.swap == (group == "y-driven") and (g.prm.A > S.AZ or n > 40)
    rng = np.random.default_rng(n + 11)
    q = rng.standard_normal((g.prm.A, 1, g.prm.LU)).astype(f32)
    base = rng.standard_normal((1, n, n)).astype(f32) if accumulate else None
    ref = PK.unshear_bp_packed_plain(
        torch.as_tensor(q), g.beta, g.prm.U0, n, g.swap,
        out=None if base is None else torch.as_tensor(base.copy())).numpy()
    got, stats = unshear_emulated(S, q, g.prm.beta, g.prm.U0, n, n, g.swap, out=base, single=True)
    assert np.array_equal(got, ref)
    assert stats["staged"] > 0 and stats["global"] == 0
    rows = -(-n // S.R) * S.R
    per_term = stats["loads"] / (g.prm.A * rows * -(-n // S.C) * S.J)
    assert per_term == 2


@pytest.mark.parametrize("case", ["steep-angles", "unaligned-lines"])
def test_k4p_emulation_from_global_memory(case):
    """|beta| > 1 (an angle's 8 rows shift by more than the window allows) and
    lines of q that are not 16-byte aligned (LU % 4 != 0) are summed from
    global memory with the same arithmetic, new and added."""
    rng = np.random.default_rng(12)
    n = 40
    beta = np.array([-0.9, 2.5, 0.3, -3.0, 1.0, 0.0] if case == "steep-angles"
                    else [-0.9, 0.3, 1.0], dtype=f32)
    U0 = 128
    LU = 512 if case == "steep-angles" else 510
    for swap in (False, True):
        for accumulate in (False, True):
            q = rng.standard_normal((beta.shape[0], 1, LU)).astype(f32)
            base = rng.standard_normal((1, n, n)).astype(f32) if accumulate else None
            ref = PK.unshear_bp_packed_plain(
                torch.as_tensor(q), torch.as_tensor(beta), U0, n, swap,
                out=None if base is None else torch.as_tensor(base.copy())).numpy()
            got, stats = unshear_emulated(K4P, q, beta, U0, n, n, swap, out=base, single=True)
            assert np.array_equal(got, ref)
            assert stats["global"] > 0
            assert (stats["staged"] > 0) == (case == "steep-angles")


def test_k4p_wrapper_on_cpu_is_the_plain_version():
    _, groups = k1_case(1, 24, 24, 12, 0.0, seed=1)
    rng = np.random.default_rng(3)
    for g in groups:
        q = torch.as_tensor(rng.standard_normal((g.prm.A, 1, g.prm.LU)).astype(f32))
        base = torch.as_tensor(rng.standard_normal((1, 24, 24)).astype(f32))
        assert torch.equal(PK.unshear_bp_packed(q, g.beta, g.prm.U0, 24, g.swap),
                           PK.unshear_bp_plain(q, g.beta, g.prm.U0, 24, 24, g.swap))
        assert torch.equal(
            PK.unshear_bp_packed(q, g.beta, g.prm.U0, 24, g.swap, out=base.clone()),
            PK.unshear_bp_packed_plain(q, g.beta, g.prm.U0, 24, g.swap, out=base.clone()))


# ---------------------------------------------------------------------------
# K3: csrc/projector.cu, resample_bp_kernel
# ---------------------------------------------------------------------------

K3_V = cu_const("projector.cu", "kK3V")
K3_THREADS = cu_const("projector.cu", "kThreads")


def k3_emulated(p, alpha, gamma, U0, LU, index=None):
    """resample_bp() on a CUDA tensor: every thread of every (angle, slice)
    line, the threads of a line side by side in numpy.  A value of p that a
    thread has no business reading is NaN."""
    nz, n_rows, det_x = p.shape
    A = n_rows if index is None else index.shape[0]
    vec = LU % K3_V == 0
    tiles = (LU + K3_THREADS * K3_V - 1) // (K3_THREADS * K3_V)
    u0 = np.arange(tiles * K3_THREADS) * K3_V
    u0 = u0[u0 < LU]
    q = np.full((A, nz, LU), np.nan, dtype=f32)
    stats = {"idle": 0, "working": 0, "steps": 0, "most_steps": 0}
    for a in range(A):
        al = f32(alpha[a])
        aa = np.abs(al)
        base = f32(U0) + f32(gamma[a])
        ends = [base + al * f32(0), base + al * f32(det_x - 1)]
        u_lo, u_hi = int(np.floor(min(ends))), int(np.ceil(max(ends)))
        work = (u0 + K3_V - 1 >= u_lo) & (u0 <= u_hi) & (det_x > 0)
        stats["idle"] += nz * int((~work).sum())
        stats["working"] += nz * int(work.sum())
        row = a if index is None else int(index[a])
        assert 0 <= row < n_rows  # the kernel traps
        up = al > 0
        edge = (u0 - 1 if up else u0 + K3_V).astype(f32)
        t_first = np.maximum(np.floor((edge - base) / al).astype(np.int64) - 1, 0)
        for z in range(nz):
            src = p[z, row]
            acc = np.zeros((K3_V, u0.shape[0]), dtype=f32)
            t = t_first.copy()
            active = work.copy()
            steps = 0
            while True:
                active &= t < det_x
                pos = base + al * t.astype(f32)
                active &= ~(pos >= (u0 + K3_V).astype(f32) if up else pos <= (u0 - 1).astype(f32))
                if not active.any():
                    break
                steps += 1
                d = np.floor(pos).astype(np.int64) - u0
                hit = active & (d >= -1) & (d < K3_V)
                v = np.where(hit, src[np.clip(t, 0, det_x - 1)], f32(np.nan))
                w0 = np.maximum(f32(0), f32(1) - np.abs(pos - (u0 + d).astype(f32)))
                w1 = np.maximum(f32(0), f32(1) - np.abs(pos - (u0 + d + 1).astype(f32)))
                with np.errstate(invalid="ignore"):
                    c0, c1 = (aa * w0) * v, (aa * w1) * v
                for k in range(K3_V):
                    m0 = hit & (d == k) & (w0 > 0)
                    acc[k, m0] = acc[k, m0] + c0[m0]
                    m1 = hit & (d + 1 == k) & (w1 > 0)
                    acc[k, m1] = acc[k, m1] + c1[m1]
                stats["steps"] += int(active.sum())
                t = t + 1
            stats["most_steps"] = max(stats["most_steps"], steps)
            for k in range(K3_V):
                ok = u0 + k < LU
                assert vec <= bool(ok.all())  # a 16-byte store stays inside the line
                q[a, z, u0[ok] + k] = acc[k, ok]
    return q, stats


def k3_case(nz, ny, nx, cor, group, seed, n_angles=80):
    _, groups = k1_case(nz, ny, nx, n_angles, cor, seed=seed)
    g = groups[0 if group == "x-driven" else 1]
    assert g.swap == (group == "y-driven")
    det_x = max(ny, nx)
    p = np.random.default_rng(seed).standard_normal((nz, n_angles, det_x)).astype(f32)
    return g, p


@pytest.mark.parametrize("gather", [False, True], ids=["own-rows", "index"])
@pytest.mark.parametrize("group", ["x-driven", "y-driven"])
@pytest.mark.parametrize("cor", [2.5, "per-angle"], ids=["scalar-cor", "per-angle-cor"])
@pytest.mark.parametrize("nz,ny,nx", [(1, 40, 40), (3, 38, 44), (8, 16, 24), (2, 20, 300)],
                         ids=["nz1", "nz3-rows%8!=0", "nz8", "ny!=nx-two-column-tiles"])
def test_k3_emulation_bit_exact(nz, ny, nx, cor, group, gather):
    """K3's threads equal resample_bp_plain bit for bit: four u per thread
    whose candidates t are one shared run walked in ascending t, zeros outside
    the angle's live range without arithmetic, alpha of both signs (the
    x-driven group of a 180 degree scan has both), and the group's rows
    gathered through ``index`` from the whole sinogram."""
    g, p = k3_case(nz, ny, nx, cor, group, seed=nz + nx)
    prm = g.prm
    idx = g.idx.numpy()
    assert (prm.alpha > 0).any() and ((prm.alpha < 0).any() or g.swap)
    if gather:
        ref = PK.resample_bp_plain(torch.as_tensor(p), g.alpha, g.gamma, prm.U0, prm.LU,
                                   index=g.idx).numpy()
        got, stats = k3_emulated(p, prm.alpha, prm.gamma, prm.U0, prm.LU, index=idx)
    else:
        own = np.ascontiguousarray(p[:, idx])
        ref = PK.resample_bp_plain(torch.as_tensor(own), g.alpha, g.gamma, prm.U0, prm.LU).numpy()
        got, stats = k3_emulated(own, prm.alpha, prm.gamma, prm.U0, prm.LU)
    assert np.array_equal(got, ref)
    assert stats["idle"] > 0 and stats["working"] > 0
    # one shared run: at most 5 / |alpha| + 1 positions lie in a thread's
    # (u0 - 1, u0 + 4), and at most two t before the first of them are walked
    assert stats["most_steps"] <= K3_V + 2 + 2
    assert stats["steps"] / stats["working"] < K3_V + 3


@pytest.mark.parametrize("LU", [510, 513])
def test_k3_emulation_scalar_stores(LU):
    """An LU that is no multiple of 4 takes scalar stores: the last thread of
    a line owns fewer than four u."""
    rng = np.random.default_rng(LU)
    theta = np.array([-0.7, -0.2, 0.0, 0.3, 0.75, np.pi - 0.5, np.pi + 0.1])
    prm = PK.driven_params(np.cos(theta), np.sin(theta), np.linspace(-2.0, 2.0, 7), 200, 180, 200)
    p = rng.standard_normal((2, 7, 200)).astype(f32)
    ref = PK.resample_bp_plain(torch.as_tensor(p), torch.as_tensor(prm.alpha),
                               torch.as_tensor(prm.gamma), prm.U0, LU).numpy()
    got, _ = k3_emulated(p, prm.alpha, prm.gamma, prm.U0, LU)
    assert np.array_equal(got, ref)


def test_k3_emulation_is_the_transpose_of_k2():
    """<K2 s, p> == <s, K3 p> with K3 as emulated (float64 sums of float32
    products of the same weights)."""
    g, p = k3_case(2, 40, 40, 2.5, "x-driven", seed=9)
    prm = g.prm
    own = np.ascontiguousarray(p[:, g.idx.numpy()])
    s = np.random.default_rng(10).standard_normal((prm.A, 2, prm.LU)).astype(f32)
    k2 = PK.resample_fp_plain(torch.as_tensor(s), g.alpha, g.gamma, prm.U0, 40).numpy()
    k3, _ = k3_emulated(own, prm.alpha, prm.gamma, prm.U0, prm.LU)
    lhs = np.sum(k2.astype(np.float64) * own)
    rhs = np.sum(s.astype(np.float64) * k3)
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)


def test_k3_wrapper_on_cpu_is_the_plain_version():
    g, p = k3_case(3, 24, 24, 0.0, "y-driven", seed=4, n_angles=12)
    pt = torch.as_tensor(p)
    own = pt[:, g.idx].contiguous()
    ref = PK.resample_bp_plain(own, g.alpha, g.gamma, g.prm.U0, g.prm.LU)
    assert torch.equal(PK.resample_bp(own, g.alpha, g.gamma, g.prm.U0, g.prm.LU), ref)
    assert torch.equal(PK.resample_bp(pt, g.alpha, g.gamma, g.prm.U0, g.prm.LU, index=g.idx), ref)


# ---------------------------------------------------------------------------
# PD: csrc/pd_tv.cu, pd_tv_kernel
# ---------------------------------------------------------------------------

from tomobar_tpu_torch.ops import pd_tv as PDT  # noqa: E402

PD_K, PD_V, PD_TY, PD_ZMAX, PD_PAD = (
    cu_const("pd_tv.cu", n) for n in ("kPDK", "kPDV", "kPDThreadsY", "kPDZMax", "kPDPad"))


def pd_fuse(nz):
    """fuse() of pd_tv.cu on the tile kernel's volumes: iterations per
    launch."""
    assert nz <= PD_ZMAX
    return PD_K


def pd_tile(nz):
    """launch() of pd_tv.cu: (ZC, CY, TYT).  tt_pd_tv refuses more than
    kPDZMax slices: those go to the wavefront."""
    for zc in (1, 2, 4, 8, PD_ZMAX):
        if nz <= zc:
            return zc, PD_V // zc, PD_TY
    raise ValueError(f"the tile kernel takes at most {PD_ZMAX} slices, not {nz}")


def bf16_round(x):
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def pd_block(data, u_in, p_in, u_out, p_out, stored, bx, by, K, first, last, consts,
             iso, nonneg, bf16):
    sigma, tau, lt, theta = (f32(c) for c in consts)
    nz, ny, nx = data.shape
    ZC, CY, TYT = pd_tile(nz)
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
    inside = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny) & (z < nz)
    gz, gy_c, gx_c = (np.broadcast_to(np.clip(v, 0, n - 1), inside.shape)
                      for v, n in ((z, nz), (gy, ny), (gx, nx)))

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
    z_first, z_last = z == 0, z == nz - 1
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
    keep = inside & (lx >= K) & (lx < 32 - K) & (ly >= K) & (ly < HY - K)
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
    ZC, CY, TYT = pd_tile(nz)
    HY = TYT * CY
    u_prev, p_prev = None, None
    n_launches = 0
    for K, first, last in PDT.launch_plan(iterations, pd_fuse(nz)):
        assert 2 * K < 32 and 2 * K < HY and nz <= ZC
        u_out = np.full(data.shape, np.nan, dtype=f32)
        p_out = [np.full(data.shape, np.nan, dtype=f32) for _ in range(3)]
        stored = np.zeros(data.shape, dtype=np.int64)
        for by in range((ny + HY - 2 * K - 1) // (HY - 2 * K)):
            for bx in range((nx + 32 - 2 * K - 1) // (32 - 2 * K)):
                pd_block(data, u_prev, p_prev, u_out, p_out, stored, bx, by, K,
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
    """The tile kernel holds at most 8 slices a thread and refuses more; the
    wrapper's route for them, the wavefront (one slab up to 32 slices,
    slabs with a halo in z at 41), takes them."""
    data = pd_case(nz, 20, 30, seed=nz)
    if nz <= PD_ZMAX:
        pd_check(data, 5, 0, 1)
    else:
        with pytest.raises(ValueError):
            pd_tile(nz)
        pdw_check(data, 5, 0, 1)


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


@pytest.mark.parametrize("nz", [1, 8, 16, 17, 512])
def test_pd_fuse_mirrors_the_kernel(nz):
    """``pd_tv.fuse``, which a memory plan on meta tensors reads instead of
    ``tt_pd_tv_fuse``, takes the kernels' constants: the tile kernel's up to
    kPDZMax slices, the wavefront's above."""
    want = PD_K if nz <= PD_ZMAX else PDW_K
    assert PDT.fuse(nz) == want


def test_pd_route_mirrors_the_kernel():
    """The wrapper sends a volume to the tile kernel up to kPDZMax slices,
    the most a tile thread holds and the most tt_pd_tv takes, and to the
    wavefront above; one FUSE stands for both kernels' iterations a
    launch."""
    assert PDT.FUSE_Z_MAX == PD_ZMAX
    assert PDT.FUSE == PD_K == PDW_K
    assert pd_tile(PD_ZMAX)[0] == PD_ZMAX


# ---------------------------------------------------------------------------
# PDw: csrc/pd_tv.cu, pd_tv_wave_kernel (the y-streaming wavefront)
# ---------------------------------------------------------------------------

PDW_K, PDW_WARPS1, PDW_WARPS, PDW_X, PDW_SMEM = (
    cu_const("pd_tv.cu", n) for n in ("kPDWK", "kPDWWarps1", "kPDWWarps", "kPDWX", "kPDWSmem"))
SMEM_PER_BLOCK = 232448  # bytes of shared memory a block can use on an H100
H100_SLOTS = 132  # PDw blocks an H100 runs at once: one on each SM


def pdw_fuse(nz):
    """fuse() of pd_tv.cu above kPDZMax slices: iterations per sweep."""
    return PDW_K


def card_plan(slots=H100_SLOTS):
    """The wrapper's cut of a launch, ``wave_plan`` on a card of ``slots``."""
    return lambda nz, ny, nx, k: PDT.wave_plan(nz, ny, nx, k, slots)


def cut(zmax, rows):
    """A cut of emulation size: ``wave_slabs``' rule at slabs of at most
    ``zmax`` slices, y-segments of ``rows`` rows."""
    return lambda nz, ny, nx, k: (rows, *PDT.wave_slabs(nz, k, zmax))


def pdw_slab(bz, n, zs, nz, K):
    """pd_tv_wave_kernel's slab bz of n: (first slice, first and end of the
    kept slices); slab 0 flush with slice 0, the last with slice nz - 1."""
    zk0 = 0 if bz == 0 else zs - K + (bz - 1) * (zs - 2 * K)
    zk1 = nz if bz == n - 1 else zk0 + zs - (K if bz == 0 else 2 * K)
    z0 = 0 if bz == 0 else nz - zs if bz == n - 1 else zk0 - K
    return z0, zk0, zk1


def pdw_smem_bytes(K, zs, W=32 * PDW_X):
    """launch_wave_blocks()'s dynamic shared memory: 3K + 12 planes with
    pads."""
    return 4 * (3 * K + 12) * (zs * W + 2 * (W + 1))


def pdw_block(data, u_in, p_in, u_out, p_out, stored, bx, by, bz, K, first, last, consts,
              iso, nonneg, bf16, W, rows, zs, slabs):
    """One block of pd_tv_wave_kernel, every thread's voxels of a plane at
    once: the sweep's steps, the levels of a step (dual step, barrier,
    primal step), the u planes by row parity, the staged level 0, the
    exchange planes by the parity of the level steps, the ring of data
    rows, the duals of each level and the ones pending for the next."""
    sigma, tau, lt, theta = (f32(c) for c in consts)
    nz, ny, nx = data.shape
    PL = zs * W + 2 * (W + 1)
    smem = np.full((3 * K + 12) * PL, np.nan, dtype=f32)  # the kernel zero-fills
    base = W + 1

    def U(j, par):
        return base + (2 * (j - 1) + par) * PL

    def SU(par):
        return base + (2 * (K - 1) + par) * PL

    def SP(par, c):
        return base + (2 * K + 3 * par + c) * PL

    def X(par, c):
        return base + (2 * K + 6 + 2 * par + c) * PL

    def DR(row):
        return base + (2 * K + 10 + row % (K + 2)) * PL

    lz, lx = np.arange(zs)[:, None], np.arange(W)[None, :]
    off = lz * W + lx
    x0, y0 = bx * (W - 2 * K) - K, by * rows
    y1 = min(ny, y0 + rows)
    z0, zk0, zk1 = pdw_slab(bz, slabs, zs, nz, K)
    gx, gz = x0 + lx, z0 + lz
    inside = (gx >= 0) & (gx < nx) & (gz >= 0) & (gz < nz)
    keep = inside & (lx >= K) & (lx < W - K) & (gz >= zk0) & (gz < zk1)
    gzc, gxc = (np.broadcast_to(np.clip(v, 0, n - 1), inside.shape)
                for v, n in ((gz, nz), (gx, nx)))
    x_first, x_last, z_first, z_last = (np.broadcast_to(c, inside.shape) for c in (
        gx == 0, gx == nx - 1, gz == 0, gz == nz - 1))

    def fetch(arr, row):
        return np.where(inside, arr[gzc, row, gxc], f32(0)).astype(f32)

    def as_stored(c):
        return bf16_round(c) if bf16 else c

    def stage(row):
        par = row & 1
        smem[DR(row) + off] = fetch(data, row)
        if not first:
            smem[SU(par) + off] = fetch(u_in, row)
            for c in range(3):
                smem[SP(par, c) + off] = fetch(p_in[c].astype(f32), row)

    s0, s1 = max(0, y0 - K), y1 - 1 + K
    last_row = min(ny - 1, s1)
    stage(s0)
    P = [np.full((3, zs, W), np.nan, dtype=f32) for _ in range(K)]  # the kernel: zeros
    pend, pend_ok, xpar = None, False, 0
    rden = f32(1.0) / (f32(1.0) + lt)  # the primal step multiplies by it
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for s in range(s0, s1 + 1):
            for j in range(1, K + 1):
                r = s - j
                act = s0 <= r < ny
                if act:
                    rn = r + 1 if r + 1 < ny else r - 1
                    if j > 1:
                        uc, un = U(j - 1, r & 1), U(j - 1, rn & 1)
                    else:
                        uc, un = (DR(r), DR(rn)) if first else (SU(r & 1), SU(rn & 1))
                    c = smem[uc + off]
                    dx = np.where(x_last, smem[uc + off - 1], smem[uc + off + 1]) - c
                    dy = smem[un + off] - c
                    dz = np.where(z_last, smem[uc + off - W], smem[uc + off + W]) - c
                    if j == 1:
                        p = ([np.zeros_like(c)] * 3 if first
                             else [smem[SP(r & 1, k) + off] for k in range(3)])
                    else:
                        p = [as_stored(P[j - 2][k]) for k in range(3)]
                    q = [p[0] + sigma * dx, p[1] + sigma * dy, p[2] + sigma * dz]
                    if iso:
                        denom = (q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]
                        rs = torch.rsqrt(torch.from_numpy(np.maximum(denom, f32(1e-30)))).numpy()
                        scale = np.where(denom > 1, rs, f32(1))
                        q = [v * scale for v in q]
                    else:
                        q = [v / np.maximum(np.abs(v), f32(1)) for v in q]
                    T = np.stack(q).astype(f32)
                    smem[X(xpar, 0) + off] = T[0]
                    smem[X(xpar, 1) + off] = T[2]
                if j >= 2 and pend_ok:
                    P[j - 2] = pend
                if act:
                    div = np.where(x_first, T[0], T[0] - smem[X(xpar, 0) + off - 1])
                    div = div + (T[1] if r == 0 else T[1] - P[j - 1][1])
                    div = div + np.where(z_first, T[2], T[2] - smem[X(xpar, 1) + off - W])
                    ucl = np.maximum(c, f32(0)) if nonneg else c
                    unew = ((ucl + tau * div) + lt * smem[DR(r) + off]) * rden
                    u_next = (unew + theta * (unew - ucl)).astype(f32)
                    if j < K:
                        smem[U(j, r & 1) + off] = u_next
                    elif y0 <= r < y1:
                        where = (gzc[keep], r, gxc[keep])
                        u_out[where] = u_next[keep]
                        stored[where] += 1
                        if not last:
                            for k in range(3):
                                p_out[k][where] = as_stored(T[k])[keep]
                    xpar ^= 1
                if j == K:
                    if act:
                        P[j - 1] = T
                else:
                    if act:
                        pend = T
                    pend_ok = act
                if j == 1 and s + 1 <= last_row:
                    stage(s + 1)


def pdw_emulated(data, lam, iterations, mtv, nonneg, lc, bf16=False, K=None,
                 W=32 * PDW_X, plan=None):
    """pd_tv() on a deep CUDA volume: the wrapper's launches of the
    wavefront, each block by block, at the kernel's constants or at the
    given sweep depth K and strip width W, each launch of k iterations cut
    into ``plan(nz, ny, nx, k) = (R, zs, n)``, by default the wrapper's
    on an H100."""
    nz, ny, nx = data.shape
    consts = PDT.pd_tv_constants(lam, lc)
    plan = plan or card_plan()
    u_prev, p_prev, n_launches = None, None, 0
    for k, first, last in PDT.launch_plan(iterations, K or pdw_fuse(nz)):
        rows, zs, slabs = plan(nz, ny, nx, k)
        assert 2 * k < W and (slabs == 1 or 2 * k < zs)
        u_out = np.full(data.shape, np.nan, dtype=f32)
        p_out = [np.full(data.shape, np.nan, dtype=f32) for _ in range(3)]
        stored = np.zeros(data.shape, dtype=np.int64)
        for bz in range(slabs):
            for by in range(-(-ny // rows)):
                for bx in range(-(-nx // (W - 2 * k))):
                    pdw_block(data, u_prev, p_prev, u_out, p_out, stored, bx, by, bz, k,
                              first, last, consts, mtv == 0, nonneg, bf16, W, rows, zs,
                              slabs)
        assert np.all(stored == 1)  # every voxel belongs to one kept block
        u_prev, p_prev = u_out, p_out
        n_launches += 1
    return (data.copy() if u_prev is None else u_prev), n_launches


def pdw_check(data, iterations, mtv, nonneg, bf16=False, tol=1e-6, **geometry):
    got, n_launches = pdw_emulated(data, 0.05, iterations, mtv, nonneg, 12.0, bf16, **geometry)
    ref = PDT.pd_tv_plain(torch.as_tensor(data), 0.05, iterations, mtv, nonneg, 12.0, bf16).numpy()
    assert np.isfinite(got).all()  # nothing unwritten reached a kept voxel
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    K = geometry.get("K") or pdw_fuse(data.shape[0])
    assert n_launches == -(-iterations // K)
    return got


@pytest.mark.parametrize("K", [3, 4])
@pytest.mark.parametrize("zmax", [32, 16], ids=["one-slab", "slabs"])
@pytest.mark.parametrize("mtv,nonneg", [(0, 1), (1, 0)], ids=["iso-nonneg", "aniso"])
def test_pdw_emulation_against_plain(K, zmax, mtv, nonneg):
    """The wavefront's levels, row planes by parity, staged level 0, strips
    with an x halo, y-segments that start K rows early and, with slabs of
    16, z-slabs with a halo of K, at 24 x 40 x 64 with segments of 16 rows:
    9 iterations (sweeps of K and a shorter last one) within 1e-6 of the
    maximum of the plain version, NaN in every shared-memory word and
    dual register the block did not write."""
    pdw_check(pd_case(24, 40, 64, seed=K + zmax), 9, mtv, nonneg, K=K, plan=cut(zmax, 16))


@pytest.mark.parametrize("nz", [17, 20, 40])
def test_pdw_emulation_kernel_constants(nz):
    """At the kernel's own sweep depth and strip, cut as the wrapper cuts
    them on an H100: one slab up to 32 slices, two slabs flush with the
    volume's faces beyond."""
    pdw_check(pd_case(nz, 30, 70, seed=nz), 8, 0, 1)


def test_pdw_emulation_bf16_duals():
    """bfloat16 duals are rounded after every iteration, inside a sweep too
    (the next level reads them rounded, the divergence unrounded)."""
    data = pd_case(24, 40, 64, seed=5)
    half = pdw_check(data, 9, 0, 1, bf16=True, tol=1e-3, K=4, plan=cut(16, 16))
    full = PDT.pd_tv_plain(torch.as_tensor(data), 0.05, 9, 0, 1, 12.0).numpy()
    assert np.abs(half - full).max() > 1e-5 * np.abs(full).max()  # the rounding is there


def test_pdw_emulation_against_jax():
    """The emulation against the JAX package's PD_TV on the CPU: its XLA
    path at 24 x 40 x 64 and its interpret-mode Pallas wavefront at 24 x 40
    x 128 (nx a multiple of 128), at the tolerance that
    tests/test_torch_pd_tv.py holds the port to (rtol 2e-5, atol 2e-6)."""
    import jax.numpy as jnp

    from tomobar_tpu.ops.pd_tv_pallas import pd_tv_pallas
    from tomobar_tpu.regularisers import PD_TV as jax_PD_TV

    for nx, jax_fn in ((64, jax_PD_TV), (128, lambda *a: pd_tv_pallas(*a, interpret=True))):
        data = pd_case(24, 40, nx, seed=nx)
        got, _ = pdw_emulated(data, 0.05, 9, 0, 1, 12.0, K=4, plan=cut(16, 16))
        ref = np.asarray(jax_fn(jnp.asarray(data), 0.05, 9, 0, 1, 12.0))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


def test_pdw_launch_fits_the_card():
    """Every launch the wrapper makes fits one block's shared memory and
    threads (a warp row a slice, at most kPDWWarps), with a halo narrower
    than the strip and the slab; up to kPDWWarps1 slices in the blocks of
    fewer warps."""
    W = 32 * PDW_X
    assert PDW_WARPS1 <= PDW_WARPS <= 32 and PDW_SMEM == SMEM_PER_BLOCK
    for nz in (PD_ZMAX + 1, 17, PDW_WARPS1, PDW_WARPS1 + 1, PDW_WARPS, PDW_WARPS + 1, 64, 512):
        K = pdw_fuse(nz)
        rows, zs, slabs = PDT.wave_plan(nz, 2560, 2560, K, H100_SLOTS)
        assert pdw_smem_bytes(K, zs) <= SMEM_PER_BLOCK and zs <= PDW_WARPS
        assert 2 * K < W and rows >= 1 and (slabs == 1 or zs - 2 * K >= 1)


@pytest.mark.parametrize("K", [1, 4])
def test_pdw_emulation_flush_slabs_at_an_odd_depth(K):
    """41 slices in slabs of at most 16: five slabs of 15 (K 4) or three
    (K 1), the first flush with slice 0 and the last with slice 40, a halo
    only on their inner faces, within 1e-6 of the plain version; 5
    iterations, so K 4 ends with a launch of 1 and its own cut."""
    assert cut(16, 16)(41, 24, 64, 4) == (16, 15, 5)
    pdw_check(pd_case(41, 24, 64, seed=41), 5 if K == 4 else 2, 0, 1, K=K, plan=cut(16, 16))


def test_pdw_emulation_ragged_last_segment():
    """45 rows in segments of 16: the last one 13 rows, its sweep ending
    at the volume's last row."""
    pdw_check(pd_case(20, 45, 64, seed=45), 6, 1, 1, plan=cut(32, 16))


def test_pdw_emulation_plans_agree_bit_for_bit():
    """One input through the wrapper's cut on an H100 (two slabs of 25,
    one-row segments) and through slabs of at most 16 in 7-row segments:
    every kept voxel does the same operations on the same values, so the
    outputs are equal bit for bit."""
    data = pd_case(41, 23, 70, seed=7)
    assert card_plan()(41, 23, 70, 4) == (1, 25, 2)
    a, _ = pdw_emulated(data, 0.05, 5, 0, 1, 12.0)
    b, _ = pdw_emulated(data, 0.05, 5, 0, 1, 12.0, plan=cut(16, 7))
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


# The plan from the shape (ops/pd_tv.py wave_plan), against the fixed cut
# that the kernel had before: segments of 128 rows, slabs of 32 with K
# slices of halo on both faces (the volume's own too).

def parent_plan(nz, ny, k):
    """(R, zs, n) of the fixed cut."""
    if nz <= PDW_WARPS:
        return min(128, ny), nz, 1
    return 128, PDW_WARPS, -(-nz // (PDW_WARPS - 2 * k))


def modelled_cost(nz, ny, nx, k, slots, plan):
    """A launch's modelled time: waves x (R + 2k) x zs."""
    rows, zs, n = plan
    blocks = -(-nx // (32 * PDW_X - 2 * k)) * -(-ny // rows) * n
    return -(-blocks // slots) * (rows + 2 * k) * zs


SWEEP = (64, 100, 127, 128, 129, 300, 1000, 2048, 2560, 2608, 4096)


@pytest.mark.parametrize("slots", [132, 264])
def test_wave_plan_sweep(slots):
    """nz 9-200, ny and nx 64-4096: every slice kept once, inner halos of
    K at least, slabs of at most 32 slices within 227 KB, segments that
    cover the rows once, and a modelled time no longer than the fixed
    cut's."""
    for nz in range(PD_ZMAX + 1, 201):
        for k in range(1, PDW_K + 1):
            zs, n = PDT.wave_slabs(nz, k)
            assert zs <= PDW_WARPS and pdw_smem_bytes(k, zs) <= SMEM_PER_BLOCK
            kept = np.zeros(nz, np.int64)
            for bz in range(n):
                z0, zk0, zk1 = pdw_slab(bz, n, zs, nz, k)
                assert 0 <= z0 and z0 + zs <= nz and zk0 < zk1
                assert zk0 - z0 >= (k if bz > 0 else 0)
                assert z0 + zs - zk1 >= (k if bz < n - 1 else 0)
                kept[zk0:zk1] += 1
            assert np.all(kept == 1), (nz, k)
        k = PDW_K
        for ny in SWEEP:
            for nx in SWEEP:
                plan = PDT.wave_plan(nz, ny, nx, k, slots)
                rows = plan[0]
                assert plan[1:] == PDT.wave_slabs(nz, k) and 1 <= rows <= ny
                assert (-(-ny // rows) - 1) * rows < ny  # no empty segment
                assert (modelled_cost(nz, ny, nx, k, slots, plan)
                        <= modelled_cost(nz, ny, nx, k, slots, parent_plan(nz, ny, k)))


@pytest.mark.parametrize("shape,plan,waves,share", [
    ((20, 2560, 2560), (128, 20, 1), 7, 0.937),
    ((20, 2608, 2608), (187, 20, 1), 5, 0.952),
    ((64, 2560, 2560), (128, 27, 3), 21, 0.740),
], ids=["chunk20", "admm-2608", "chunk64"])
def test_wave_plan_at_the_cells(shape, plan, waves, share):
    """The benchmark's PDw shapes on 132 SMs: 2560^2 keeps 20 segments of
    128 (no cheaper cut), 2608^2 takes 14 of 187 in 5 waves (8 before), 64
    slices 3 slabs of 27 (of 32 before); the kept share of the launched
    block-rows, the counters' ratio."""
    nz, ny, nx = shape
    assert PDT.wave_plan(nz, ny, nx, PDW_K, H100_SLOTS) == plan
    launched, kept = PDT.wave_rows(nz, ny, nx, PDW_K, H100_SLOTS, plan)
    assert launched % (H100_SLOTS * plan[1] * (plan[0] + 2 * PDW_K)) == 0
    assert launched // (H100_SLOTS * plan[1] * (plan[0] + 2 * PDW_K)) == waves
    assert round(kept / launched, 3) == share
    fixed = parent_plan(nz, ny, PDW_K)
    assert (modelled_cost(nz, ny, nx, PDW_K, H100_SLOTS, plan)
            < modelled_cost(nz, ny, nx, PDW_K, H100_SLOTS, fixed)) == (shape[1] == 2608 or nz > 32)


def test_wave_plan_mirrors_the_kernel():
    """The planner's strip and slab depth are the kernel's constants."""
    assert PDT.WAVE_X == 32 * PDW_X and PDT.WAVE_Z_MAX == PDW_WARPS


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
