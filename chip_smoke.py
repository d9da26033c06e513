#!/usr/bin/env python3
"""Smoke run of tomobar_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels, checks each against its plain PyTorch version, and drives the
ported paths at the flagship shape: the iterative main path
(``RecToolsIRCuPy.FISTA``, PWLS, ordered subsets, PD-TV), the direct
path (``RecToolsDIRCuPy.FOURIER_INV`` and 3D ``FBP``) and the 2D path
(2D ``FORWPROJ``/``FBP`` and every solver on one slice).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device: CUDA must be available; prints the device and the
   ``nvidia-smi`` name and power limit.
2. build: compiles ``tomobar_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
   one process per source, all started together.
3. kernels: K1-K4 at N=512, nz=8, 180 angles (scalar CoR 3.5 and a
   per-angle CoR vector, both driven groups), K1 and K4 also at nz = 1 and
   3, at 500 driven rows (not a multiple of 8), at rows of 510 (not 16-byte
   aligned) and K4 at ny != nx and adding into a volume, and PD-TV
   (iso/aniso x nonneg, nz 1 and 8, plus bf16 duals; iteration counts 1,
   K - 1, K + 1 and 20 for K iterations per launch; 3 x 500 x 510, which
   its tiles do not divide, and 20 slices, which it cuts into z-chunks),
   each against its plain version on the same inputs; K1 and K4 must equal
   their plain versions bit for bit.
4. adjointness of the kernel pair.
5. the slice on the CPU (plain versions) and on the GPU (kernels),
   256^2 x 4 slices x 90 angles, OS5, PWLS, nonneg, PD-TV 20.
6. the flagship: 1801 angles x 8 slices x 2560, OS10, PWLS, nonneg,
   PD-TV (lambda 5e-4, 20 iterations), Lipschitz constant from the power
   method, 1, 2 and 3 outer iterations; launch counts, times, RMSE
   against the phantom, peak memory, then each kernel's time beside its
   plain version's at that shape (K1-K4 on both driven groups of OS
   subset 0, PD-TV for one prox of 20 iterations on the whole volume, and
   for one iteration), and one OS subset of the FISTA step by stage.
7. the direct path: G (USFFT gridding) against its plain version at
   n=512, 2 z-pairs, 360 angles with 0 and pi/2 (both driven groups), at
   n=500 (tiles that the grid does not fill) with 5 z-pairs (an odd count
   above one block's four), for one angle and for angles beyond 360
   degrees, two calls on the same input bit for bit equal; F
   (axis-(-2) FFT) at n = 2560, 5120, 8192 (its compile-time stage plans)
   and n = 3000 (the run-time plan) and both signs; FOURIER_INV and
   3D FBP at 256^2 x 4 x 90 on the CPU and on the GPU; then on phase 6's
   clean 1801 x 8 x 2560 sinogram: FOURIER_INV and FBP times after a
   warm-up call, G/F launch counts per path, both paths' time by stage,
   its correlation with a Ram-Lak FBP inside the inscribed circle, peak
   memory, and G and F beside their plain versions at the flagship shapes
   (G against a float64 plain sum, and twice for bit-equal grids).
8. the 2D path: K1p/K4p (the packed nz = 1 pair) against their plain
   versions at N=512, 2D, 180 angles (scalar CoR 3.5 and a per-angle CoR
   vector, both driven groups; K1p bit for bit against the plain sum in the
   same runs of rows), K1p also at rows of 510 (not 16-byte aligned), at
   200 x 520 and for 10 sparse angles, and the pair's adjointness; 2D FBP and 2D
   FISTA (OS5, LS, PD-TV 20) at 256^2 x 90 on the CPU and on the GPU; then
   one 2560^2 slice x 1801 angles: 2D FORWPROJ and FBP times, FISTA (OS10,
   LS, nonneg, PD-TV) for 1, 2 and 3 outer iterations with RMSE against
   the phantom, ADMM, SIRT, CGLS, Landweber and OSEM (residuals must
   fall), launch counts per path, peak memory, and K1p/K4p beside their
   plain versions and beside K1/K4 on the same input.
9. the big stack: phase 6's clean sinogram repeated along z to 512 slices
   on the device (9.4 GB): 3D FBP (every block of 8 slices must equal phase
   7's 8-slice result bit for bit) and FOURIER_INV with default kwargs
   (first 8 slices against phase 7's within 1e-6 rel L2), then one PD-TV
   prox of 20 iterations on a 512 x 2560^2 volume that is constant along z
   (13.4 GB) against the one-slice prox of the same slice (1e-5 of max); the
   times, chunk counts and peak memory of each.

The last three lines are the nvidia-smi line, a JSON object with one
entry per kernel, and ``{"ok": true, "device": {...}}``.  A kernel's entry
holds its launches on the main paths (``launches``) and per call of its
path (``launches_per_call`` of ``per_call_of``), its worst error, and, summed
over the calls timed at the flagship shapes (PD: one prox of 20 iterations,
which is several launches), its time, its plain version's,
the time of one PyTorch call for the same function where there is one
(``library_ms``: ``torch.fft`` on an already complex tensor for F) and its
bound: the larger of its operations over 67 TFLOP/s (float32 outside the
tensor cores) and its bytes, each input read once and each output written
once, over 3.35 TB/s, the published peaks of an H100 SXM at 700 W.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

TOL_KERNEL = 1e-5  # max|kernel - plain| / max|plain|, fp32 sums in another order
TOL_PD_BF16 = 1e-3  # bf16 duals: a one-ulp fp32 difference can flip a rounding
TOL_ADJOINT = 1e-5  # |<Ax,y> - <x,A^T y>| / |<Ax,y>|
TOL_SLICE = 1e-4  # rel L2 between the CPU and the GPU reconstruction
MIN_CORR = 0.99  # FOURIER_INV vs Ram-Lak FBP inside the inscribed circle
PEAK_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
PEAK_BYTES = 3.35e12  # HBM3 bytes per second, H100 SXM data sheet

KERNELS = {
    "K1": ("shear_fp", "tomobar_tpu_torch/csrc/projector.cu",
           "tomobar_tpu/ops/projector_pallas.py:289"),
    "K1p": ("shear_fp_packed", "tomobar_tpu_torch/csrc/projector.cu",
            "tomobar_tpu/ops/projector_pallas.py:347"),
    "K2": ("resample_fp", "tomobar_tpu_torch/csrc/projector.cu",
           "tomobar_tpu/ops/projector_pallas.py:415"),
    "K3": ("resample_bp", "tomobar_tpu_torch/csrc/projector.cu",
           "tomobar_tpu/ops/projector_pallas.py:452"),
    "K4": ("unshear_bp", "tomobar_tpu_torch/csrc/projector.cu",
           "tomobar_tpu/ops/projector_pallas.py:511"),
    "K4p": ("unshear_bp_packed", "tomobar_tpu_torch/csrc/projector.cu",
            "tomobar_tpu/ops/projector_pallas.py:588"),
    "PD": ("pd_tv", "tomobar_tpu_torch/csrc/pd_tv.cu",
           "tomobar_tpu/ops/pd_tv_pallas.py:144"),
    "G": ("usfft_grid", "tomobar_tpu_torch/csrc/usfft_grid.cu",
          "tomobar_tpu/ops/usfft_pallas.py:236 (G1 _grid_kernel_astack) "
          "and tomobar_tpu/ops/usfft_pallas.py:91 (G0 _grid_kernel)"),
    "F": ("fft_axis2", "tomobar_tpu_torch/csrc/fft_axis2.cu",
          "tomobar_tpu/ops/fft_real.py:208"),
}
ITERATIVE = ("K1", "K2", "K3", "K4", "PD")  # the kernels of phase 6's path
TWO_D = ("K1p", "K4p")  # measured in phase 8


# (operations, bytes) of one call: what the function must do on these
# inputs, each input read once and each output written once
def work_shear(A, nz, n_rows, row_len, LU):
    """K1/K1p: a (angle, slice, row) reaches row_len + 1 values of u with two
    products and two sums each."""
    return 4 * A * nz * n_rows * (row_len + 1), 4 * (nz * n_rows * row_len + A + A * nz * LU)


def work_unshear(A, nz, n, LU):
    """K4/K4p: two products and two sums per voxel and angle."""
    return 4 * A * nz * n * n, 4 * (A * nz * LU + A + nz * n * n)


def work_resample(A, nz, LU, det_x, per_output):
    """K2 (13 operations per sinogram sample: position, two hats, two
    weighted taps) and K3 (26 per u: four candidate positions and hats, two
    weighted taps)."""
    n_out = nz * A * det_x if per_output == 13 else A * nz * LU
    return per_output * n_out, 4 * (A * nz * LU + nz * A * det_x + 2 * A)


def work_pd(nz, n, iterations):
    """PD, one prox: data read and u written once, whatever the iteration
    count.  Per voxel and iteration (iso, nonneg) 36 operations, 28 for one
    slice: the differences (3), the dual ascent (6), the norm (5), compare,
    clamp, rsqrt, select and scaling (7), the divergence (5), the clamp of u
    (1) and the primal step with its relaxation (9); one slice has no z
    term."""
    return (36 if nz > 1 else 28) * iterations * nz * n * n, 8 * nz * n * n


def work_grid(nz2, n_angles, n, m=5):
    """G: per polar sample and tap 8 operations for the weight and a product
    and a sum per z-pair and channel; spectra read, the (2n)^2 grids written."""
    taps = n_angles * n * (2 * m + 1) ** 2
    return taps * (8 + 4 * nz2), 8 * nz2 * n_angles * n + 8 * nz2 * 4 * n * n + 8 * n_angles


def work_fft(shape):
    """F: 5 n log2 n operations per column; re and im read and written."""
    n, count = shape[-2], int(np.prod(shape))
    return 5 * count * np.log2(n), 16 * count


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def shepp_logan(n: int) -> np.ndarray:
    """Shepp-Logan-like slice (the ellipses of tests/conftest.py)."""
    ellipses = [
        (1.0, 0.69, 0.92, 0.0, 0.0, 0.0),
        (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0.0),
        (-0.2, 0.11, 0.31, 0.22, 0.0, -18.0),
        (-0.2, 0.16, 0.41, -0.22, 0.0, 18.0),
        (0.1, 0.21, 0.25, 0.0, 0.35, 0.0),
        (0.1, 0.046, 0.046, 0.0, 0.1, 0.0),
        (0.1, 0.046, 0.023, -0.08, -0.605, 0.0),
        (0.1, 0.023, 0.046, 0.06, -0.605, 0.0),
    ]
    y, x = np.mgrid[-1 : 1 : n * 1j, -1 : 1 : n * 1j]
    img = np.zeros((n, n), dtype=np.float32)
    for val, a, b, x0, y0, phi in ellipses:
        phi = np.deg2rad(phi)
        xr = (x - x0) * np.cos(phi) + (y - y0) * np.sin(phi)
        yr = -(x - x0) * np.sin(phi) + (y - y0) * np.cos(phi)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += val
    return img


def phantom(n: int, nz: int) -> np.ndarray:
    scale = np.linspace(0.8, 1.2, nz, dtype=np.float32)
    return shepp_logan(n)[None] * scale[:, None, None]


class Errors:
    """Worst kernel-vs-plain error per kernel over every comparison."""

    def __init__(self, torch):
        self.torch = torch
        self.abs = {k: 0.0 for k in KERNELS}

    def compare(self, key: str, label: str, got, ref, tol: float = TOL_KERNEL,
                record: bool = True):
        """got/ref are tensors, or (re, im) pairs of tensors; tol 0 asks for
        bit-for-bit equality.  ``record=False``: ``ref`` is not the kernel's
        plain version, the error is checked but not kept."""
        self.torch.cuda.synchronize()
        if isinstance(got, tuple):
            got, ref = self.torch.stack(got), self.torch.stack(ref)
        require(got.shape == ref.shape, f"{label}: shape {got.shape} != {ref.shape}")
        require(bool(self.torch.isfinite(got).all()), f"{label}: non-finite output")
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        rel = err / scale if scale > 0 else err
        print(f"  {key} {label}: max|kernel-plain| {err:.3e}, relative {rel:.3e} (tol {tol:g})")
        require(rel <= tol, f"{key} {label}: kernel disagrees with plain ({rel:.3e} > {tol:g})")
        if record:
            self.abs[key] = max(self.abs[key], err)


def check_projector_kernels(torch, K, errs, geom, dev, seed: int) -> None:
    from tomobar_tpu_torch.ops.projector import Projector

    n, nz, det = geom.recon_size, geom.detectors_y, geom.detectors_x_total
    gen = torch.Generator(device=dev).manual_seed(seed)
    vol = torch.randn((nz, n, n), generator=gen, device=dev)
    for g in Projector(geom)._plan.groups(n, n, dev):
        U0, LU, A = g.prm.U0, g.prm.LU, g.prm.A
        tag = f"{'y' if g.swap else 'x'}-driven, {A} angles"
        s_p = K.shear_fp_plain(vol, g.beta, U0, LU, g.swap)
        errs.compare("K1", tag, K.shear_fp(vol, g.beta, U0, LU, g.swap), s_p, tol=0.0)
        errs.compare(
            "K2", tag, K.resample_fp(s_p, g.alpha, g.gamma, U0, det),
            K.resample_fp_plain(s_p, g.alpha, g.gamma, U0, det),
        )
        p = torch.randn((nz, A, det), generator=gen, device=dev)
        q_p = K.resample_bp_plain(p, g.alpha, g.gamma, U0, LU)
        errs.compare("K3", tag, K.resample_bp(p, g.alpha, g.gamma, U0, LU), q_p)
        errs.compare(
            "K4", tag, K.unshear_bp(q_p, g.beta, U0, n, n, g.swap),
            K.unshear_bp_plain(q_p, g.beta, U0, n, n, g.swap), tol=0.0,
        )
        base = torch.randn((nz, n, n), generator=gen, device=dev)
        errs.compare(
            "K4", tag + ", accumulate",
            K.unshear_bp(q_p, g.beta, U0, n, n, g.swap, out=base.clone()),
            K.unshear_bp_plain(q_p, g.beta, U0, n, n, g.swap, out=base.clone()), tol=0.0,
        )


def check_k1_shapes(torch, K, errs, dev) -> None:
    """K1 against its plain version, bit for bit, at one and three slices,
    with driven rows that are no multiple of the band's 8 and with rows that
    are not 16-byte aligned (read from global memory)."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector

    angles = np.linspace(0.0, np.pi, 90, endpoint=False)
    gen = torch.Generator(device=dev).manual_seed(30)
    for n, nz in ((512, 1), (512, 3), (500, 8), (510, 3)):
        vol = torch.randn((nz, n, n), generator=gen, device=dev)
        for g in Projector(Geometry(n, nz, angles, 3.5, n))._plan.groups(n, n, dev):
            errs.compare(
                "K1", f"{n}^2 x {nz}, {'y' if g.swap else 'x'}-driven, {g.prm.A} angles",
                K.shear_fp(vol, g.beta, g.prm.U0, g.prm.LU, g.swap),
                K.shear_fp_plain(vol, g.beta, g.prm.U0, g.prm.LU, g.swap), tol=0.0,
            )


def check_k4_shapes(torch, K, errs, dev) -> None:
    """K4 against its plain version, bit for bit, at one and three slices
    (one slice per block; an even count takes two), with driven rows that
    are no multiple of the block's 8, ny != nx (more than one column tile
    in one group), volumes whose rows are not 16-byte aligned, and adding
    into a volume."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector

    angles = np.linspace(0.0, np.pi, 90, endpoint=False)
    gen = torch.Generator(device=dev).manual_seed(31)
    for ny, nx, nz in ((512, 512, 1), (512, 512, 3), (500, 500, 8), (510, 510, 3), (200, 520, 2)):
        n = max(ny, nx)
        for g in Projector(Geometry(n, nz, angles, 3.5, n))._plan.groups(ny, nx, dev):
            q = torch.randn((g.prm.A, nz, g.prm.LU), generator=gen, device=dev)
            base = torch.randn((nz, ny, nx), generator=gen, device=dev)
            tag = f"{ny}x{nx} x {nz}, {'y' if g.swap else 'x'}-driven, {g.prm.A} angles"
            errs.compare("K4", tag, K.unshear_bp(q, g.beta, g.prm.U0, ny, nx, g.swap),
                         K.unshear_bp_plain(q, g.beta, g.prm.U0, ny, nx, g.swap), tol=0.0)
            errs.compare(
                "K4", tag + ", accumulate",
                K.unshear_bp(q, g.beta, g.prm.U0, ny, nx, g.swap, out=base.clone()),
                K.unshear_bp_plain(q, g.beta, g.prm.U0, ny, nx, g.swap, out=base.clone()), tol=0.0)


def check_pd_shapes(torch, PDT, errs, dev) -> None:
    """PD against its plain version at iteration counts around the K that
    one launch fuses (a single launch, a shorter last launch), on a volume
    its tiles do not divide, on one slice, and on 20 slices (z-chunks with a
    halo in z, fewer iterations per launch)."""
    from tomobar_tpu_torch import _build

    rng = np.random.default_rng(32)
    for shape in ((3, 500, 510), (1, 500, 510), (20, 100, 120)):
        k = _build.library().tt_pd_tv_fuse(shape[0])
        clean = phantom(512, shape[0])[:, : shape[1], : shape[2]]
        data = torch.as_tensor(
            clean + 0.1 * rng.standard_normal(shape).astype(np.float32), device=dev)
        for iters in (1, k - 1, k + 1, 20):
            for mtv, nn in ((0, 1), (1, 0)):
                args = (data, 0.05, iters, mtv, nn, 12.0)
                errs.compare(
                    "PD", f"{'x'.join(map(str, shape))}, {iters} iterations ({k} per launch), "
                          f"methodTV={mtv} nonneg={nn}",
                    PDT.pd_tv(*args), PDT.pd_tv_plain(*args))
        args = (data, 0.05, k + 1, 0, 1, 12.0, True)
        errs.compare("PD", f"{'x'.join(map(str, shape))}, {k + 1} iterations, bf16 duals",
                     PDT.pd_tv(*args), PDT.pd_tv_plain(*args), tol=TOL_PD_BF16)


def time_cuda(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def outer_iteration_launches(counts_after, keys, path: str) -> dict:
    """Launches of one outer iteration: those of the 2-iteration FISTA call
    less those of the 1-iteration call, from the counters read before the
    first call and after each (``counts_after``)."""
    one, two = (
        {k: counts_after[i + 1][k] - counts_after[i][k] for k in keys} for i in (0, 1)
    )
    return {k: (two[k] - one[k], path) for k in keys}


def rel_l2(torch, got, ref) -> float:
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def timed_calls(torch, dev, launches, label, title, fn, shape, reps=3):
    """fn() reps times between CUDA events, with the launch counters and the
    peak-memory statistic reset first; prints the times, the launches per
    call and the peak after ``title``, checks the result's shape and that it
    is finite, keeps the launches in ``launches[label]`` and returns the
    last result and the mean ms."""
    from tomobar_tpu_torch import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    counts = {k: v // reps for k, v in _build.launch_counts.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"{title}: " + ", ".join(f"{t:.2f}" for t in ms)
          + f" ms; launches per call {json.dumps(counts)}; peak {peak:.1f} MiB")
    require(tuple(res.shape) == shape, f"{title}: shape {tuple(res.shape)}")
    require(bool(torch.isfinite(res).all()), f"{title}: non-finite result")
    launches[label] = counts
    return res, float(np.mean(ms))


def check_direct_kernels(torch, errs, dev) -> None:
    """7a: G and F against their plain versions on random inputs."""
    from tomobar_tpu_torch.ops import fft_kernels as FK
    from tomobar_tpu_torch.ops import usfft_kernels as UK

    gen = torch.Generator(device=dev).manual_seed(70)
    # angles 0 .. -pi in 360 steps: 0 and -pi/2 included, both driven groups
    theta = -np.linspace(0.0, np.pi, 360, endpoint=False)
    g_re = torch.randn((2, 360, 512), generator=gen, device=dev)
    g_im = torch.randn((2, 360, 512), generator=gen, device=dev)
    errs.compare(
        "G", "n=512, 2 z-pairs, 360 angles",
        UK.grid(g_re, g_im, 512, theta), UK.grid_plain(g_re, g_im, 512, theta),
    )
    # tiles that the grid does not fill and an odd count of z-pairs above one
    # block's four; one angle; angles beyond 360 degrees.  The plain sum is
    # taken in float64 (index_add_ in float32 has an order of its own)
    for n, pairs, th, label in (
        (500, 5, -np.linspace(0.0, np.pi, 180, endpoint=False), "180 angles"),
        (500, 1, np.array([-0.3]), "one angle"),
        (256, 3, np.linspace(-0.2, 7.5, 100), "100 angles over 441 degrees"),
    ):
        g_re = torch.randn((pairs, th.shape[0], n), generator=gen, device=dev)
        g_im = torch.randn((pairs, th.shape[0], n), generator=gen, device=dev)
        got = UK.grid(g_re, g_im, n, th)
        errs.compare("G", f"n={n}, {pairs} z-pairs, {label}, float64 plain", got,
                     tuple(g.float() for g in UK.grid_plain(g_re.double(), g_im.double(), n, th)))
        again = UK.grid(g_re, g_im, n, th)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"G n={n}, {label}: two calls differ")
    print("  G: two calls on the same input gave bit-equal grids at each shape")
    for n in (2560, 5120, 8192, 3000):
        B, C = FK.best_split(n)
        re = torch.randn((2, n, 300), generator=gen, device=dev)
        im = torch.randn((2, n, 300), generator=gen, device=dev)
        for sign in (-1, 1):
            errs.compare(
                "F", f"n={n} (B={B}, C={C}, stages {'x'.join(map(str, FK.stage_plan(C)))}), "
                     f"2 x {n} x 300, sign {sign:+d}",
                FK.fft_axis2(re, im, sign), FK.fft_axis2_plain(re, im, sign),
            )


def fourier_inv_by_stage(torch, rt, data):
    """FOURIER_INV on 3D data with no odd axis and default kwargs, stage by
    stage with CUDA events around each stage; returns the ms per stage, the
    recon and the gridding input (the spectra the path gives G)."""
    from tomobar_tpu_torch.ops import fft_real as FR
    from tomobar_tpu_torch.ops import usfft as US
    from tomobar_tpu_torch.ops import usfft_kernels as UK

    nz, nproj, n = data.shape
    theta = -np.asarray(rt.geom.angles, dtype=np.float64)
    rot = float(np.mean(rt.geom.cor_horizontal)) + 0.5
    mu = -np.log(1e-4) / (2 * n * n)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    events[0].record()
    filtered = US._fbp_filter_stage(data, n, n, "shepp", 1.0, rot)
    events[1].record()
    dre, dim = US._pack_pairs(filtered)
    sre, sim = FR.fft_pairs(dre, dim)
    scale = US._sign_vector(n, data.device) * (4.0 / n)
    sre, sim = sre * scale, sim * scale
    events[2].record()
    fre, fim = UK.grid(sre, sim, n, theta)
    events[3].record()
    fre, fim = US._ifft2_centered(fre, fim, n)
    events[4].record()
    rec = US._unpad_mul_phi(fre, fim, n, nproj, nz, False, False, rt.recon_size, mu)
    events[5].record()
    torch.cuda.synchronize()
    names = ("filter (F n=8192 x2)", "pack + STEP1 FFT", "G gridding",
             "ifft2 (F n=5120 x2)", "unpad x phi")
    ms = {k: events[i].elapsed_time(events[i + 1]) for i, k in enumerate(names)}
    return ms, rec, (sre, sim)


def fbp_by_stage(torch, rt, by_angle):
    """3D FBP with the default sinc filter, with CUDA events around the
    filter and the back-projection; returns (ms per stage, recon)."""
    from tomobar_tpu_torch.ops.filters import filter_sino_sinc

    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    filtered = filter_sino_sinc(by_angle.transpose(0, 1), 0.35)
    events[1].record()
    rec = rt.Atools.bp(filtered)
    events[2].record()
    torch.cuda.synchronize()
    names = ("sinc filter (F n=2560 x2)", "back-projection (K3/K4)")
    return {k: events[i].elapsed_time(events[i + 1]) for i, k in enumerate(names)}, rec


def direct_path(torch, errs, measure, dev, clean, angles) -> dict:
    """7: the direct path; returns the G and F launches of its main run,
    their launches per FOURIER_INV call, and the FOURIER_INV and FBP
    results (what the big stack of phase 9 is held against)."""
    from tomobar_tpu_torch import RecToolsDIRCuPy
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops import fft_kernels as FK
    from tomobar_tpu_torch.ops import usfft_kernels as UK
    from tomobar_tpu_torch.ops.projector import radon_fp

    print("[7] G and F kernels against their plain versions:")
    check_direct_kernels(torch, errs, dev)

    # ---- 7b. FOURIER_INV and 3D FBP on the CPU and on the card -------------
    angles90 = np.linspace(0.0, np.pi, 90, endpoint=False)
    sino = radon_fp(torch.as_tensor(phantom(256, 4), device=dev),
                    Geometry(256, 4, angles90, 0.0, 256))
    out = {}
    for name, device, data in (("cpu", "cpu", sino.cpu()), ("gpu", dev, sino)):
        rt = RecToolsDIRCuPy(256, 0, 4, 0.0, angles90, 256, device=device)
        out[name] = (rt.FOURIER_INV(data).cpu(), rt.FBP(data.transpose(0, 1)).cpu())
    for i, label in enumerate(("FOURIER_INV", "FBP (sinc)")):
        got, ref = out["gpu"][i], out["cpu"][i]
        require(bool(torch.isfinite(got).all()), f"{label} 256^2: non-finite GPU result")
        rel = rel_l2(torch, got, ref)
        print(f"[7] {label} 256^2x4x90: rel L2 GPU vs CPU = {rel:.3e} (tol {TOL_SLICE:g})")
        require(rel <= TOL_SLICE, f"{label}: GPU vs CPU {rel:.3e} > {TOL_SLICE:g}")

    # ---- 7c. the flagship direct path: 1801 x 8 x 2560 ---------------------
    NZ, NA, N = clean.shape
    rt = RecToolsDIRCuPy(N, 0, NZ, 0.0, angles, N, device=dev)
    by_angle = clean.transpose(0, 1)  # FBP takes [angles, detY, detX]
    rt.FOURIER_INV(clean)  # warm-up: the G/F tables, the cuFFT plans
    rt.FBP(by_angle)
    torch.cuda.synchronize()
    launches = {}

    def timed(label, fn):
        return timed_calls(torch, dev, launches, label, f"[7] {label} {NA}x{NZ}x{N}",
                           fn, (NZ, N, N))

    fi, ms_fi = timed("FOURIER_INV", lambda: rt.FOURIER_INV(clean))
    require(launches["FOURIER_INV"].get("G", 0) > 0, "FOURIER_INV did not launch G")
    require(launches["FOURIER_INV"].get("F", 0) > 0, "FOURIER_INV did not launch F")
    fbp, ms_fbp = timed("FBP (sinc)", lambda: rt.FBP(by_angle))
    require(launches["FBP (sinc)"].get("F", 0) > 0, "FBP did not launch F")
    print(f"[7] FBP / FOURIER_INV time ratio: {ms_fbp / ms_fi:.3f}")

    stages, fi_staged, spectra = fourier_inv_by_stage(torch, rt, clean)
    print("[7] FOURIER_INV by stage (ms): " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    rel = rel_l2(torch, fi_staged, fi)
    require(rel <= TOL_KERNEL, f"staged FOURIER_INV differs from the call: {rel:.3e}")
    stages, fbp_staged = fbp_by_stage(torch, rt, by_angle)
    print("[7] FBP (sinc) by stage (ms): " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    rel = rel_l2(torch, fbp_staged, fbp)
    require(rel <= TOL_KERNEL, f"staged FBP differs from the call: {rel:.3e}")
    del fbp_staged

    ramlak = rt.FBP(by_angle, filter_type="ram-lak")
    yy, xx = np.mgrid[0:N, 0:N]
    inside = torch.as_tensor(np.hypot(yy - (N - 1) / 2, xx - (N - 1) / 2) < N / 2 - 2, device=dev)
    corr = [float(torch.corrcoef(torch.stack([fi[z][inside], ramlak[z][inside]]))[0, 1])
            for z in range(NZ)]
    print(f"[7] FOURIER_INV vs FBP(ram-lak) correlation inside the inscribed circle, "
          f"per slice: min {min(corr):.6f}, max {max(corr):.6f} (min {MIN_CORR})")
    require(min(corr) >= MIN_CORR, f"FOURIER_INV vs FBP correlation {min(corr):.4f} < {MIN_CORR}")
    del ramlak, fi_staged

    # ---- 7d. G and F beside their plain versions at the flagship shapes -----
    # G: one call on the spectra FOURIER_INV gives it.  About 1e4 polar
    # samples reach one grid cell near the centre; G sums them in float64,
    # but the plain version's float32 index_add_ loses ~1e-5 of the max
    # there in run-dependent order, so here G is held against the plain
    # version accumulating in float64, and timed against it in float32.
    # F: one pass at each of its three flagship shapes ("ms" sums them): the
    # ifft2 pass (4 x 5120 x 5120), the FOURIER_INV filter stage (8192 x
    # 7208 rows) and the FBP sinc filter (2560 x 7208 rows)
    theta = -np.asarray(angles, dtype=np.float64)
    sre, sim = spectra
    del spectra
    got = UK.grid(sre, sim, N, theta)
    errs.compare("G", f"flagship, {NZ // 2} z-pairs x {NA} x {N}, float64 plain", got,
                 tuple(g.float() for g in UK.grid_plain(sre.double(), sim.double(), N, theta)))
    require(all(torch.equal(a, b) for a, b in zip(got, UK.grid(sre, sim, N, theta))),
            "G flagship: two calls differ")
    print("[7] G flagship: two calls gave bit-equal grids")
    del got
    measure("G", f"{NZ // 2} z-pairs x {NA} x {N}", lambda: UK.grid(sre, sim, N, theta),
            lambda: UK.grid_plain(sre, sim, N, theta), work_grid(NZ // 2, NA, N),
            reps=3, plain_reps=1, check=False)
    del sre, sim
    gen = torch.Generator(device=dev).manual_seed(71)
    rows = NZ * (NA + 1) // 2
    for shape, sign in (((4, 2 * N, 2 * N), 1), ((8192, rows), -1), ((N, rows), -1)):
        re = torch.randn(shape, generator=gen, device=dev)
        im = torch.randn(shape, generator=gen, device=dev)
        # the library call: torch.fft alone, on an already complex tensor
        # (the plain version also packs re/im and splits the result)
        xc = torch.complex(re, im)
        measure("F", f"{'x'.join(map(str, shape))}, sign {sign:+d}",
                lambda: FK.fft_axis2(re, im, sign),
                lambda: FK.fft_axis2_plain(re, im, sign), work_fft(shape),
                reps=5, plain_reps=5,
                library=(lambda: torch.fft.fft(xc, dim=-2)) if sign < 0
                else (lambda: torch.fft.ifft(xc, dim=-2, norm="forward")))
        del re, im, xc
    per_call = {k: (launches["FOURIER_INV"].get(k, 0), "FOURIER_INV call") for k in ("G", "F")}
    return {
        "G": launches["FOURIER_INV"].get("G", 0),
        "F": launches["FOURIER_INV"].get("F", 0) + launches["FBP (sinc)"].get("F", 0),
    }, per_call, {"FOURIER_INV": fi, "FBP": fbp}


def check_packed_kernels(torch, K, errs, geom, dev, seed: int) -> None:
    """8a: K1p/K4p against their plain versions on one slice."""
    from tomobar_tpu_torch.ops.projector import Projector

    n = geom.recon_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    vol = torch.randn((1, n, n), generator=gen, device=dev)
    for g in Projector(geom)._plan.groups(n, n, dev, True):
        require(g.prm.packed, "a 512^2 slice must take the packed pair")
        U0, LU, A = g.prm.U0, g.prm.LU, g.prm.A
        tag = f"{'y' if g.swap else 'x'}-driven, {A} angles"
        rows = vol.transpose(1, 2).contiguous() if g.swap else vol
        errs.compare("K1p", tag + f", {K.packed_splits(rows.shape[1], A)} runs of rows",
                     K.shear_fp_packed(rows, g.beta, U0, LU),
                     K.shear_fp_packed_plain(rows, g.beta, U0, LU), tol=0.0)
        q = torch.randn((A, 1, LU), generator=gen, device=dev)
        errs.compare("K4p", tag, K.unshear_bp_packed(q, g.beta, U0, n, g.swap),
                     K.unshear_bp_packed_plain(q, g.beta, U0, n, g.swap))
        base = torch.randn((1, n, n), generator=gen, device=dev)
        errs.compare(
            "K4p", tag + ", accumulate",
            K.unshear_bp_packed(q, g.beta, U0, n, g.swap, out=base.clone()),
            K.unshear_bp_packed_plain(q, g.beta, U0, n, g.swap, out=base.clone()),
        )


def check_k1p_shapes(torch, K, errs, dev) -> None:
    """K1p against its plain version (the same runs of rows), bit for bit:
    rows that are not 16-byte aligned (read from global memory), ny != nx,
    1, 2 and 5 runs, and 10 sparse angles (windows too wide to stage)."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector

    gen = torch.Generator(device=dev).manual_seed(83)
    for ny, nx, n_angles in ((512, 510, 90), (200, 520, 90), (512, 512, 10), (1024, 1024, 10)):
        n = max(ny, nx)
        angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)
        vol = torch.randn((1, ny, nx), generator=gen, device=dev)
        for g in Projector(Geometry(n, 1, angles, 3.5, n))._plan.groups(ny, nx, dev, True):
            if not g.prm.packed:
                continue
            rows = vol.transpose(1, 2).contiguous() if g.swap else vol
            for splits in (None, 1, 5):
                runs = K.packed_splits(rows.shape[1], g.prm.A) if splits is None else splits
                errs.compare(
                    "K1p", f"{ny}x{nx}, {'y' if g.swap else 'x'}-driven, {g.prm.A} of "
                           f"{n_angles} angles, {runs} runs of rows",
                    K.shear_fp_packed(rows, g.beta, g.prm.U0, g.prm.LU, splits),
                    K.shear_fp_packed_plain(rows, g.beta, g.prm.U0, g.prm.LU, splits), tol=0.0)


def residual(torch, rt, x, b) -> float:
    return float(torch.linalg.vector_norm(rt.Atools.fp(x) - b))


def two_d_path(torch, K, errs, measure, dev) -> dict:
    """8: the 2D path; returns the K1p/K4p launches of its main runs (2D
    FORWPROJ, FBP and FISTA) and their launches per outer FISTA iteration."""
    from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy, _build
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector, radon_bp, radon_fp

    # ---- 8a. K1p/K4p against their plain versions, adjointness ------------
    angles180 = np.linspace(0.0, np.pi, 180, endpoint=False)
    geoms = {
        "cor 3.5": Geometry(512, 1, angles180, 3.5, 512),
        "per-angle cor": Geometry(512, 1, angles180, 3.5 + 2.0 * np.sin(3.0 * angles180), 512),
    }
    gen = torch.Generator(device=dev).manual_seed(80)
    for i, (label, geom) in enumerate(geoms.items()):
        print(f"[8] packed kernels, 512^2 x 180 angles, {label}:")
        check_packed_kernels(torch, K, errs, geom, dev, seed=81 + i)
        x = torch.randn((512, 512), generator=gen, device=dev)
        y = torch.randn((180, 512), generator=gen, device=dev)
        lhs = float(torch.sum(radon_fp(x, geom).double() * y.double()))
        rhs = float(torch.sum(x.double() * radon_bp(y, geom).double()))
        rel = abs(lhs - rhs) / abs(lhs)
        print(f"[8] adjointness of the nz=1 pair, {label}: {rel:.3e} (tol {TOL_ADJOINT:g})")
        require(rel <= TOL_ADJOINT, f"2D adjointness {rel:.3e} > {TOL_ADJOINT:g}")
    print("[8] K1p at other row lengths, ny != nx, run counts and sparse angles, cor 3.5:")
    check_k1p_shapes(torch, K, errs, dev)

    # ---- 8b. 2D FBP and FISTA on the CPU and on the card -------------------
    angles90 = np.linspace(0.0, np.pi, 90, endpoint=False)
    ph = torch.as_tensor(shepp_logan(256), device=dev)
    sino = radon_fp(ph, Geometry(256, 1, angles90, 0.0, 256))
    lc = RecToolsIRCuPy(256, 0, None, 0.0, angles90, 256, OS_number=5, device=dev).powermethod(
        {"projection_data": sino})
    alg = {"iterations": 3, "nonnegativity": True, "lipschitz_const": lc}
    reg = {"method": "PD_TV", "regul_param": 5e-4, "iterations": 20}
    out = {}
    for name, device, data in (("cpu", "cpu", sino.cpu()), ("gpu", dev, sino)):
        fbp = RecToolsDIRCuPy(256, 0, None, 0.0, angles90, 256, device=device).FBP(data)
        rec = RecToolsIRCuPy(256, 0, None, 0.0, angles90, 256, OS_number=5, device=device).FISTA(
            {"projection_data": data}, dict(alg), dict(reg))
        out[name] = (fbp.cpu(), rec.cpu())
    for i, label in enumerate(("FBP (sinc 1.1)", "FISTA OS5 LS PD-TV20")):
        got, ref = out["gpu"][i], out["cpu"][i]
        require(bool(torch.isfinite(got).all()), f"2D {label}: non-finite GPU result")
        rel = rel_l2(torch, got, ref)
        print(f"[8] 2D {label} 256^2x90: rel L2 GPU vs CPU = {rel:.3e} (tol {TOL_SLICE:g})")
        require(rel <= TOL_SLICE, f"2D {label}: GPU vs CPU {rel:.3e} > {TOL_SLICE:g}")

    # ---- 8c. the 2D flagship: one 2560^2 slice x 1801 angles ---------------
    N, NA, OS = 2560, 1801, 10
    angles = np.linspace(0.0, np.pi, NA, endpoint=False)
    truth = torch.as_tensor(shepp_logan(N), device=dev)
    rd = RecToolsDIRCuPy(N, 0, None, 0.0, angles, N, device=dev)
    clean = rd.FORWPROJ(truth)
    px, i0 = 2.0 / N, 1.0e4  # as phase 6
    gen = torch.Generator(device=dev).manual_seed(8)
    counts = torch.poisson(i0 * torch.exp(-clean * px), generator=gen)
    data = -torch.log(torch.clamp(counts, min=1.0) / i0) / px
    del counts
    launches = {}
    for label, fn, shape in (("FORWPROJ", lambda: rd.FORWPROJ(truth), (NA, N)),
                             ("FBP (sinc 1.1)", lambda: rd.FBP(data), (N, N))):
        fn()  # warm-up
        timed_calls(torch, dev, launches, label, f"[8] 2D {label} {NA}x{N}", fn, shape)
    require(launches["FORWPROJ"].get("K1p", 0) > 0, "2D FORWPROJ did not launch K1p")
    require(launches["FBP (sinc 1.1)"].get("K4p", 0) > 0, "2D FBP did not launch K4p")

    rt = RecToolsIRCuPy(N, 0, None, 0.0, angles, N, OS_number=OS, device=dev)
    reg = {"method": "PD_TV", "regul_param": 5e-4, "iterations": 20}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    lc = rt.powermethod({"projection_data": data})
    torch.cuda.synchronize()
    t_power = time.perf_counter() - t0
    recs, ms, counts_after = [], [], [dict(_build.launch_counts)]
    for iters in (1, 2, 3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        recs.append(rt.FISTA({"projection_data": data},
                             {"iterations": iters, "nonnegativity": True, "lipschitz_const": lc},
                             dict(reg)))
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        counts_after.append(dict(_build.launch_counts))
    launches["FISTA"] = dict(_build.launch_counts)
    per_call = outer_iteration_launches(counts_after, TWO_D, "2D FISTA outer iteration")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[8] 2D power method (OS10): L = {lc:.6g} in {t_power:.2f} s wall")
    print(f"[8] 2D launch counts, power method + FISTA 1+2+3: {json.dumps(launches['FISTA'])}")
    for k in TWO_D + ("K2", "K3", "PD"):
        require(launches["FISTA"][k] > 0, f"kernel {k} was not launched by 2D FISTA")
    rmse = []
    for iters, rec, t in zip((1, 2, 3), recs, ms):
        require(tuple(rec.shape) == (1, N, N), f"2D FISTA shape {tuple(rec.shape)}")
        require(bool(torch.isfinite(rec).all()), f"2D FISTA: non-finite after {iters}")
        rmse.append(float(torch.sqrt(torch.mean((rec[0] - truth) ** 2))))
        print(f"[8] 2D FISTA {iters} outer iteration(s): {t:.2f} ms, RMSE vs phantom {rmse[-1]:.6f}")
    print(f"[8] 2D FISTA peak device memory: {peak / 2**20:.1f} MiB")
    require(rmse[0] > rmse[1] > rmse[2], f"2D FISTA RMSE does not fall: {rmse}")
    x_last = recs[-1]
    del recs

    # one FISTA subset step and one FBP call by stage (CUDA events)
    from tomobar_tpu_torch.ops.filters import filter_sino_sinc
    from tomobar_tpu_torch.regularisers import PD_TV

    b0 = rt.Atools.sino_subset(data[None], 0)
    stages = {
        "fp_sub (K1p x2, K2 x2)": lambda: rt.Atools.fp_sub(x_last, 0),
        "bp_sub (K3 x2, K4p x2)": lambda: rt.Atools.bp_sub(b0, 0),
        "PD-TV prox, 20 iterations": lambda: PD_TV(x_last, 5e-4, 20, 0, 1, 12.0),
        "FBP sinc filter": lambda: filter_sino_sinc(data, 1.1),
        "FBP back-projection (K3 x2, K4p x2)": lambda: rd.Atools.bp(data),
    }
    print("[8] 2D by stage (ms): " + json.dumps(
        {k: round(time_cuda(torch, fn, 5), 3) for k, fn in stages.items()}))
    del b0

    # the other solvers at the flagship: finite, residuals fall
    t0 = time.perf_counter()
    x = rt.ADMM({"projection_data": data},
                {"iterations": 2, "nonnegativity": True, "lipschitz_const": lc}, dict(reg))
    torch.cuda.synchronize()
    require(bool(torch.isfinite(x).all()), "2D ADMM: non-finite result")
    print(f"[8] 2D ADMM OS10, 2 outer, PD-TV20: {time.perf_counter() - t0:.2f} s wall, "
          f"RMSE vs phantom {float(torch.sqrt(torch.mean((x[0] - truth) ** 2))):.6f}")
    rn = RecToolsIRCuPy(N, 0, None, 0.0, angles, N, device=dev)
    lc_full = rn.powermethod({"projection_data": data})
    b = data[None]
    start_res = {"SIRT": residual(torch, rn, torch.ones((1, N, N), device=dev), b),
                 "CGLS": float(torch.linalg.vector_norm(b)),
                 "Landweber": float(torch.linalg.vector_norm(b))}
    for method, its, alg in (("SIRT", (5, 10), {}), ("CGLS", (5, 10), {}),
                             ("Landweber", (10, 20), {"tau_step_lanweber": 1.0 / lc_full})):
        res = [start_res[method]]
        for it in its:
            t0 = time.perf_counter()
            x = getattr(rn, method)({"projection_data": data}, dict(alg, iterations=it))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            require(bool(torch.isfinite(x).all()), f"2D {method}: non-finite result")
            res.append(residual(torch, rn, x, b))
            print(f"[8] 2D {method} {it} iterations: {wall:.3f} s wall, ||Ax-b|| {res[-1]:.6g}")
        print(f"[8] 2D {method} residual: start {res[0]:.6g} -> {res[1]:.6g} -> {res[2]:.6g}")
        require(res[0] > res[1] > res[2], f"2D {method}: residual does not fall: {res}")
    t0 = time.perf_counter()
    x = rt.OSEM({"projection_data": torch.clamp(data, min=0.0)},
                {"iterations": 3, "osem_normalisation": "divide"})
    torch.cuda.synchronize()
    require(bool(torch.isfinite(x).all()), "2D OSEM: non-finite result")
    print(f"[8] 2D OSEM OS10 divide, 3 iterations: {time.perf_counter() - t0:.2f} s wall, "
          f"RMSE vs phantom {float(torch.sqrt(torch.mean((x[0] - truth) ** 2))):.6f}")
    del x

    # ---- 8d. K1p/K4p beside their plain versions and K1/K4 ------------------
    # the JSON line's "ms" sums both driven groups of OS subset 0 (2D
    # FISTA's fp_sub/bp_sub); then the full 1801-angle groups (FORWPROJ,
    # FBP).  K1/K4 at nz = 1, on the same inputs, are what the 2D path ran
    # before K1p/K4p.
    vol = x_last.contiguous()
    sub0 = Projector(rt.Atools._sub_geoms[0])
    for tag, proj in (("OS subset 0", sub0), ("all 1801 angles", rt.Atools)):
        for g in proj._plan.groups(N, N, dev, True):
            U0, LU, A = g.prm.U0, g.prm.LU, g.prm.A
            label = f"{'y' if g.swap else 'x'}-driven {A} angles, LU {LU} ({tag})"
            rows = vol.transpose(1, 2).contiguous() if g.swap else vol
            s = K.shear_fp_packed(rows, g.beta, U0, LU)
            q = K.resample_bp(K.resample_fp(s, g.alpha, g.gamma, U0, N), g.alpha, g.gamma, U0, LU)
            del s

            def k1p():
                return K.shear_fp_packed(rows, g.beta, U0, LU)

            def k1p_plain():
                return K.shear_fp_packed_plain(rows, g.beta, U0, LU)

            def k4p():
                return K.unshear_bp_packed(q, g.beta, U0, N, g.swap)

            def k4p_plain():
                return K.unshear_bp_packed_plain(q, g.beta, U0, N, g.swap)

            def k1():
                return K.shear_fp(vol, g.beta, U0, LU, g.swap)

            def k4():
                return K.unshear_bp(q, g.beta, U0, N, N, g.swap)

            # K1 sums the rows in one ascending run, K1p in runs added in
            # order: two float32 sums of 2560 mostly same-signed terms, each
            # within ~2560 eps / 2 = 7.6e-5 of the exact sum
            errs.compare("K1p", f"flagship, {label}, against K1", k1p(), k1(), tol=1e-4,
                         record=False)
            errs.compare("K4p", f"flagship, {label}, against K4", k4p(), k4())
            if tag == "OS subset 0":
                measure("K1p", label, k1p, k1p_plain, work_shear(A, 1, N, N, LU), tol=0.0)
                measure("K4p", label, k4p, k4p_plain, work_unshear(A, 1, N, LU), tol=0.0)
            else:
                errs.compare("K1p", f"flagship, {label}", k1p(), k1p_plain(), tol=0.0)
                errs.compare("K4p", f"flagship, {label}", k4p(), k4p_plain())
                print(f"[8] K1p shear_fp_packed, {label}: kernel {time_cuda(torch, k1p, 5):.3f} ms, "
                      f"plain {time_cuda(torch, k1p_plain, 1):.3f} ms")
                print(f"[8] K4p unshear_bp_packed, {label}: kernel {time_cuda(torch, k4p, 5):.3f} ms, "
                      f"plain {time_cuda(torch, k4p_plain, 1):.3f} ms")
            print(f"[8] K1 at nz=1, {label}: {time_cuda(torch, k1, 5):.3f} ms; "
                  f"K4 at nz=1: {time_cuda(torch, k4, 5):.3f} ms")
    return {k: sum(launches[p].get(k, 0) for p in ("FORWPROJ", "FBP (sinc 1.1)", "FISTA"))
            for k in TWO_D}, per_call


def big_stack(torch, dev, clean, angles, small) -> dict:
    """9: a stack deeper than one launch can take (512 slices: the 2560^2
    volume has 3.4e9 voxels, the sinogram 2.4e9 samples), through the public
    entry points.  ``clean`` is phase 6's (8, angles, detX) sinogram, ``small``
    phase 7's 8-slice FOURIER_INV and FBP results.  Returns the launches."""
    from tomobar_tpu_torch import RecToolsDIRCuPy, _build
    from tomobar_tpu_torch.ops import pd_tv as PDT
    from tomobar_tpu_torch.ops import projector as P
    from tomobar_tpu_torch.ops import usfft as US
    from tomobar_tpu_torch.regularisers import PD_TV

    NZ8, NA, N = clean.shape
    REP = 64
    NZ = NZ8 * REP
    sino = clean.repeat(REP, 1, 1)  # made on the device, never on the host
    rt = RecToolsDIRCuPy(N, 0, NZ, 0.0, angles, N, device=dev)
    groups = rt.Atools._plan.groups(N, N, dev)
    chunks = rt.Atools._plan._z_chunks(NZ, groups, N * N, NA * N)
    print(f"[9] sinogram {NZ}x{NA}x{N}: {sino.numel() * 4 / 2**30:.2f} GiB, "
          f"{sino.numel()} samples; volume {NZ * N * N} voxels (2^31 = {2**31}); "
          f"projector z-chunks: {len(chunks)} of at most {chunks[0][1]} slices "
          f"({P.CHUNK_BYTES / 2**30:.0f} GiB of u-lines)")
    require(sino.numel() > 2**31 and NZ * N * N > 2**31, "the stack fits one launch")

    def run(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[9] {label}: {start.elapsed_time(end):.1f} ms; peak device memory "
              f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above the "
              f"{held / 2**30:.2f} GiB held before the call")
        require(tuple(out.shape) == (NZ, N, N), f"{label}: shape {tuple(out.shape)}")
        return out

    _build.reset_launch_counts()
    rec = run(f"3D FBP (sinc) {NA}x{NZ}x{N}", lambda: rt.FBP(sino.transpose(0, 1)))
    for z0 in range(0, NZ, NZ8):
        require(torch.equal(rec[z0 : z0 + NZ8], small["FBP"]),
                f"FBP on {NZ} slices: slices {z0}..{z0 + NZ8 - 1} differ from the 8-slice result")
    print(f"[9] FBP: every block of {NZ8} slices equals phase 7's {NZ8}-slice result bit for bit")
    del rec
    n_chunks = US._fourier_inv_memory_chunks(NZ, N, {}, dev)
    rec = run(f"FOURIER_INV {NA}x{NZ}x{N}, default kwargs ({n_chunks} z-chunks from the free memory)",
              lambda: rt.FOURIER_INV(sino))
    require(bool(torch.isfinite(rec).all()), "FOURIER_INV on the big stack: non-finite result")
    rel = rel_l2(torch, rec[:NZ8], small["FOURIER_INV"])
    rel_last = rel_l2(torch, rec[-NZ8:], small["FOURIER_INV"])
    print(f"[9] FOURIER_INV: first and last {NZ8} slices against phase 7's result, rel L2 "
          f"{rel:.3e}, {rel_last:.3e} (tol 1e-6)")
    require(max(rel, rel_last) <= 1e-6, f"FOURIER_INV on {NZ} slices differs: {rel:.3e}, {rel_last:.3e}")
    del rec, sino

    # PD-TV: a volume constant along z, so the z term vanishes and every
    # slice must be the 2D prox of that slice
    one = small["FBP"][:1].contiguous()
    vol = one.expand(NZ, N, N).contiguous()
    args = (5e-4, 20, 0, 1, 12.0)
    from tomobar_tpu_torch.utils.tools import free_device_bytes

    zc = PDT.z_chunks(NZ, N, N, 20, free_device_bytes(dev) // 2)
    print(f"[9] PD-TV volume {NZ}x{N}x{N}: {vol.numel() * 4 / 2**30:.2f} GiB; {len(zc)} z-chunks of "
          f"up to {max(h1 - h0 for _, _, h0, h1 in zc)} slices with their halo of 20")
    out = run(f"PD-TV prox, 20 iterations, {NZ}x{N}x{N}", lambda: PD_TV(vol, *args))
    ref = PD_TV(one, *args)
    scale = float(ref.abs().max())
    err = max(float((out[z0 : z0 + 32] - ref).abs().max()) for z0 in range(0, NZ, 32))
    print(f"[9] PD-TV: max|slice - one-slice prox| {err:.3e}, relative {err / scale:.3e} (tol {TOL_KERNEL:g})")
    require(bool(torch.isfinite(out).all()), "PD-TV on the big stack: non-finite result")
    require(err <= TOL_KERNEL * scale, f"PD-TV on {NZ} slices differs from the one-slice prox")
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    print(f"[9] launch counts of the phase: {json.dumps(launches)}")
    for k in ("K3", "K4", "F", "G", "PD"):
        require(launches.get(k, 0) > 0, f"kernel {k} was not launched by the big stack")
    return launches


def main() -> int:
    pkg = os.path.join(REPO, "tomobar_tpu_torch")
    require(os.path.isdir(pkg), f"{pkg} not found: run chip_smoke.py from a checkout")
    sys.path.insert(0, REPO)
    import torch

    # ---- 1. device ---------------------------------------------------------
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[1] nvidia-smi name, power.limit: {smi}")

    import tomobar_tpu_torch
    from tomobar_tpu_torch import RecToolsIRCuPy, _build
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops import pd_tv as PDT
    from tomobar_tpu_torch.ops import projector_kernels as K
    from tomobar_tpu_torch.ops.projector import Projector, radon_bp, radon_fp

    require(
        os.path.dirname(os.path.abspath(tomobar_tpu_torch.__file__)) == pkg,
        "tomobar_tpu_torch was not imported from this checkout",
    )
    require("jax" not in sys.modules, "jax was imported")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] nvcc build + load of the kernel library: {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels against their plain versions (N=512, nz=8, 180 angles)
    errs = Errors(torch)
    angles180 = np.linspace(0.0, np.pi, 180, endpoint=False)
    geoms = {
        "cor 3.5": Geometry(512, 8, angles180, 3.5, 512),
        "per-angle cor": Geometry(
            512, 8, angles180, 3.5 + 2.0 * np.sin(3.0 * angles180), 512
        ),
    }
    for i, (label, geom) in enumerate(geoms.items()):
        print(f"[3] projector kernels, {label}:")
        check_projector_kernels(torch, K, errs, geom, dev, seed=10 + i)
    print("[3] K1 at other slice counts and row counts, cor 3.5, 90 angles:")
    check_k1_shapes(torch, K, errs, dev)
    print("[3] K4 at other slice counts, row counts and ny != nx, cor 3.5, 90 angles:")
    check_k4_shapes(torch, K, errs, dev)
    print("[3] PD-TV kernel, 20 iterations, lambda 0.05, L 12:")
    rng = np.random.default_rng(3)
    for nz in (1, 8):
        clean = phantom(512, nz)
        data = torch.as_tensor(
            clean + 0.1 * rng.standard_normal(clean.shape).astype(np.float32),
            device=dev,
        )
        for mtv in (0, 1):
            for nn in (0, 1):
                args = (data, 0.05, 20, mtv, nn, 12.0)
                errs.compare(
                    "PD", f"nz={nz} methodTV={mtv} nonneg={nn}",
                    PDT.pd_tv(*args), PDT.pd_tv_plain(*args),
                )
        if nz == 8:
            args = (data, 0.05, 20, 0, 1, 12.0, True)
            errs.compare(
                "PD", "nz=8 iso nonneg, bf16 duals",
                PDT.pd_tv(*args), PDT.pd_tv_plain(*args), tol=TOL_PD_BF16,
            )
    print("[3] PD-TV at other iteration counts and shapes, lambda 0.05, L 12:")
    check_pd_shapes(torch, PDT, errs, dev)

    # ---- 4. adjointness on the card ----------------------------------------
    gen = torch.Generator(device=dev).manual_seed(4)
    for label, geom in geoms.items():
        x = torch.randn((8, 512, 512), generator=gen, device=dev)
        y = torch.randn((8, 180, 512), generator=gen, device=dev)
        lhs = float(torch.sum(radon_fp(x, geom).double() * y.double()))
        rhs = float(torch.sum(x.double() * radon_bp(y, geom).double()))
        rel = abs(lhs - rhs) / abs(lhs)
        print(f"[4] adjointness, {label}: |<Ax,y>-<x,A^T y>|/|<Ax,y>| = {rel:.3e} (tol {TOL_ADJOINT:g})")
        require(rel <= TOL_ADJOINT, f"adjointness {rel:.3e} > {TOL_ADJOINT:g}")

    # ---- 5. the slice on the CPU and on the card ---------------------------
    angles90 = np.linspace(0.0, np.pi, 90, endpoint=False)
    ph = torch.as_tensor(phantom(256, 4), device=dev)
    sino = radon_fp(ph, Geometry(256, 4, angles90, 0.0, 256))
    rt_gpu = RecToolsIRCuPy(256, 0, 4, 0.0, angles90, 256, OS_number=5)
    lc = rt_gpu.powermethod({"projection_data": sino})
    alg = {"iterations": 3, "nonnegativity": True, "lipschitz_const": lc}
    reg = {"method": "PD_TV", "regul_param": 5e-4, "iterations": 20}
    rec = {}
    for name, rt, data in (
        ("cpu", RecToolsIRCuPy(256, 0, 4, 0.0, angles90, 256, OS_number=5, device="cpu"),
         sino.cpu()),
        ("gpu", rt_gpu, sino),
    ):
        t0 = time.perf_counter()
        rec[name] = rt.FISTA(
            {"projection_data": data, "data_fidelity": "PWLS"}, dict(alg), dict(reg)
        ).cpu()
        print(f"[5] slice on {name}: {time.perf_counter() - t0:.2f} s wall")
    require(bool(torch.isfinite(rec["gpu"]).all()), "slice: non-finite GPU result")
    rel = float(
        torch.linalg.vector_norm(rec["gpu"] - rec["cpu"])
        / torch.linalg.vector_norm(rec["cpu"])
    )
    print(f"[5] slice 256^2x4x90 OS5 PWLS PD-TV20, L={lc:.6g}: rel L2 GPU vs CPU = {rel:.3e} (tol {TOL_SLICE:g})")
    require(rel <= TOL_SLICE, f"slice: GPU vs CPU {rel:.3e} > {TOL_SLICE:g}")

    # ---- 6. the flagship: 1801 x 8 x 2560, OS10 ----------------------------
    N, NZ, NA, OS = 2560, 8, 1801, 10
    angles = np.linspace(0.0, np.pi, NA, endpoint=False)
    t0 = time.perf_counter()
    truth = torch.as_tensor(phantom(N, NZ), device=dev)
    clean = radon_fp(truth, Geometry(N, NZ, angles, 0.0, N))
    # Poisson noise at 1e4 incident photons, pixel size 2/N on a unit-radius
    # field of view, then back to post-log pixel units
    px = 2.0 / N
    i0 = 1.0e4
    gen = torch.Generator(device=dev).manual_seed(6)
    counts = torch.poisson(i0 * torch.exp(-clean * px), generator=gen)
    data = -torch.log(torch.clamp(counts, min=1.0) / i0) / px
    del counts
    torch.cuda.synchronize()
    print(f"[6] data: phantom, FP and Poisson noise in {time.perf_counter() - t0:.2f} s")

    rt = RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N, OS_number=OS)
    reg = {"method": "PD_TV", "regul_param": 5e-4, "iterations": 20}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    lc = rt.powermethod({"projection_data": data, "data_fidelity": "PWLS"})
    torch.cuda.synchronize()
    t_power = time.perf_counter() - t0
    recs, ms, counts_after = [], [], [dict(_build.launch_counts)]
    for iters in (1, 2, 3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = rt.FISTA(
            {"projection_data": data, "data_fidelity": "PWLS"},
            {"iterations": iters, "nonnegativity": True, "lipschitz_const": lc},
            dict(reg),
        )
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        recs.append(out)
        counts_after.append(dict(_build.launch_counts))
    launches = dict(_build.launch_counts)
    per_call = outer_iteration_launches(counts_after, ITERATIVE, "3D FISTA outer iteration")
    print("[6] launches per outer iteration: "
          + json.dumps({k: v[0] for k, v in per_call.items()}))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[6] power method: L = {lc:.6g} in {t_power:.2f} s wall")
    print(f"[6] launch counts during the main path: {json.dumps(launches)}")
    for k in ITERATIVE:
        require(launches[k] > 0, f"kernel {k} was not launched by the main path")
    # 10 subsets x 20 PD-TV iterations: fewer launches than iterations
    require(per_call["PD"][0] < 200, "PD did not fuse iterations: "
            f"{per_call['PD'][0]} launches per outer iteration")
    rmse = []
    for iters, out, t in zip((1, 2, 3), recs, ms):
        require(tuple(out.shape) == (NZ, N, N), f"recon shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), f"non-finite recon after {iters} iterations")
        rmse.append(float(torch.sqrt(torch.mean((out - truth) ** 2))))
        print(f"[6] FISTA {iters} outer iteration(s): {t:.1f} ms, RMSE vs phantom {rmse[-1]:.6f}")
    per_iter = [ms[0], ms[1] - ms[0], ms[2] - ms[1]]
    print(
        "[6] per-outer-iteration ms (call 1, then differences of calls): "
        + ", ".join(f"{t:.1f}" for t in per_iter)
    )
    print(f"[6] peak device memory: {peak / 2**20:.1f} MiB")
    require(rmse[0] > rmse[1] > rmse[2], f"RMSE does not fall: {rmse}")

    # ---- 6b. kernel vs plain times at the flagship shape --------------------
    # K1-K4 on both driven groups of OS subset 0, the shapes fp_sub/bp_sub
    # give them; "ms" is the sum over the two groups (one fp_sub or bp_sub
    # call), PD is one prox of 20 iterations on the full volume
    x = recs[-1].contiguous()
    times = {k: {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                 "bound_ms": 0.0, "library_ms": None} for k in KERNELS}

    def measure(key, label, kern, plain, work, reps=10, plain_reps=2, check=True,
                tol=TOL_KERNEL, library=None):
        """Time kern() beside plain() (and library(), one PyTorch call for the
        same function) and add them, and the bound of `work` = (operations,
        bytes), to the kernel's sums."""
        phase = "6" if key in ITERATIVE else "8" if key in TWO_D else "7"
        if check:
            errs.compare(key, f"flagship, {label}", kern(), plain(), tol=tol)
        t = times[key]
        t_kern = time_cuda(torch, kern, reps)
        t_plain = time_cuda(torch, plain, plain_reps)
        ops_ms, bytes_ms = work[0] / PEAK_FLOPS * 1e3, work[1] / PEAK_BYTES * 1e3
        t["ms"] += t_kern
        t["plain_ms"] += t_plain
        t["ops_ms"] += ops_ms
        t["bytes_ms"] += bytes_ms
        t["bound_ms"] += max(ops_ms, bytes_ms)
        line = (f"[{phase}] {key} {KERNELS[key][0]}, {label}: kernel {t_kern:.3f} ms, "
                f"plain {t_plain:.3f} ms, bound {max(ops_ms, bytes_ms):.3f} ms "
                f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        if library is not None:
            t_lib = time_cuda(torch, library, reps)
            t["library_ms"] = (t["library_ms"] or 0.0) + t_lib
            line += f", library call {t_lib:.3f} ms"
        print(line)

    t_copy = time_cuda(torch, lambda: x.transpose(1, 2).contiguous(), 10)
    print(f"[6] transposed copy of the volume, inside K1's y-driven time: {t_copy:.3f} ms")
    sub0 = Projector(rt.Atools._sub_geoms[0])
    for g in sub0._plan.groups(N, N, dev):
        U0, LU, A = g.prm.U0, g.prm.LU, g.prm.A
        label = f"{'y' if g.swap else 'x'}-driven {A} angles x {NZ} x LU {LU}"
        s = K.shear_fp_plain(x, g.beta, U0, LU, g.swap)
        p = K.resample_fp_plain(s, g.alpha, g.gamma, U0, N)
        q = K.resample_bp_plain(p, g.alpha, g.gamma, U0, LU)
        measure("K1", label, lambda: K.shear_fp(x, g.beta, U0, LU, g.swap),
                lambda: K.shear_fp_plain(x, g.beta, U0, LU, g.swap),
                work_shear(A, NZ, N, N, LU), tol=0.0)
        measure("K2", label, lambda: K.resample_fp(s, g.alpha, g.gamma, U0, N),
                lambda: K.resample_fp_plain(s, g.alpha, g.gamma, U0, N),
                work_resample(A, NZ, LU, N, 13))
        measure("K3", label, lambda: K.resample_bp(p, g.alpha, g.gamma, U0, LU),
                lambda: K.resample_bp_plain(p, g.alpha, g.gamma, U0, LU),
                work_resample(A, NZ, LU, N, 26))
        measure("K4", label, lambda: K.unshear_bp(q, g.beta, U0, N, N, g.swap),
                lambda: K.unshear_bp_plain(q, g.beta, U0, N, N, g.swap),
                work_unshear(A, NZ, N, LU), tol=0.0)
    pd_args = (x, 5e-4, 20, 0, 1, 12.0)
    errs.compare("PD", "flagship, 20 iterations", PDT.pd_tv(*pd_args), PDT.pd_tv_plain(*pd_args))
    one = (*pd_args[:2], 1, *pd_args[3:])
    print(f"[6] PD pd_tv, one iteration on {NZ}x{N}x{N}: "
          f"kernel {time_cuda(torch, lambda: PDT.pd_tv(*one), 10):.3f} ms, "
          f"plain {time_cuda(torch, lambda: PDT.pd_tv_plain(*one), 2):.3f} ms")
    measure("PD", f"one prox of 20 iterations on {NZ}x{N}x{N}",
            lambda: PDT.pd_tv(*pd_args), lambda: PDT.pd_tv_plain(*pd_args),
            work_pd(NZ, N, 20), reps=5, plain_reps=1, check=False)
    # one OS subset of the FISTA step by stage (CUDA events), as phase 8 does
    from tomobar_tpu_torch.regularisers import PD_TV

    b0 = rt.Atools.sino_subset(data, 0)
    stages = {
        "fp_sub (K1 x2, K2 x2)": lambda: rt.Atools.fp_sub(x, 0),
        "bp_sub (K3 x2, K4 x2)": lambda: rt.Atools.bp_sub(b0, 0),
        "PD-TV prox, 20 iterations": lambda: PD_TV(x, 5e-4, 20, 0, 1, 12.0),
    }
    print("[6] one OS subset by stage (ms): " + json.dumps(
        {k: round(time_cuda(torch, fn, 5), 3) for k, fn in stages.items()}))
    del b0
    del x, recs, data, truth

    # ---- 7. the direct path ------------------------------------------------
    *parts, small = direct_path(torch, errs, measure, dev, clean, angles)
    for part, whole in zip(parts, (launches, per_call)):
        whole.update(part)

    # ---- 8. the 2D path ----------------------------------------------------
    for part, whole in zip(two_d_path(torch, K, errs, measure, dev), (launches, per_call)):
        whole.update(part)

    # ---- 9. the big stack -------------------------------------------------
    for k, v in big_stack(torch, dev, clean, angles, small).items():
        launches[k] += v
    del clean, small

    summary = {
        "kernels": [
            {
                "name": f"{k} {KERNELS[k][0]}",
                "route": "cuda",
                "source": KERNELS[k][1],
                "replaces": KERNELS[k][2],
                "launches": launches[k],
                "launches_per_call": per_call[k][0],
                "per_call_of": per_call[k][1],
                "max_abs_err": errs.abs[k],
                "ms": times[k]["ms"],
                "plain_ms": times[k]["plain_ms"],
                "bound_ms": times[k]["bound_ms"],
                "bound_by": "operations" if times[k]["ops_ms"] >= times[k]["bytes_ms"] else "bytes",
                "library_ms": times[k]["library_ms"],
            }
            for k in KERNELS
        ]
    }
    print(smi)
    print(json.dumps(summary))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": kind,
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
