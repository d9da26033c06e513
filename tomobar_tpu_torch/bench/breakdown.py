"""Per-stage timing and roofline breakdown of the flagship FISTA config on
the card.

Times ``fp_sub``, ``bp_sub`` and one PD-TV prox separately and reports,
for each, the achieved operation rate and the effective memory bandwidth
against the card's bounds, so that "fast" is auditable rather than
asserted.  Run on a machine with the card::

    python -m tomobar_tpu_torch.bench.breakdown

(``TOMOBAR_BENCH_N``, ``_NZ``, ``_NPROJ``, ``_OS``, ``_TV_ITERS`` set the
shape; 2560, 8, 1801, 10 and 20 by default.)

Counterpart of ``tomobar_tpu/bench/breakdown.py``, with the bounds of an
H100 SXM and the work models of the port's kernels:

* FP/BP (:func:`projector_flops`): every (slice, angle, row) pair does one
  2-tap interpolation (2 products, 1 sum) and one accumulating sum per
  driven column, 4 operations x nz x A x ny x nx, the JAX package's count;
  the bytes are the input read and the output written once;
* PD-TV (:func:`work_pd`): 36 operations per voxel and iteration (28 for
  one slice) and one pass of the data in and the result out, counted from
  the kernel's arithmetic.  The JAX package's 42 operations and 9 moves per
  voxel and sweep (its ``pd_tv_flops``/``pd_tv_bytes``) overcounted the
  arithmetic and counted the fused sweeps' state traffic as the function's
  work; :func:`work_pd` replaces both;
* the kernels' work models (:func:`work_shear`, :func:`work_unshear`,
  :func:`work_resample`, :func:`work_pd`, :func:`work_grid`,
  :func:`work_fft`): (operations, bytes) of one call, each input read once
  and each output written once, which ``chip_smoke.py`` holds each kernel's
  time against.

A utilisation is achieved / bound, clamped to 1 with the raw value kept
(``*_raw``); no rate is given for a stage below ``_MIN_RATE_DT``.
"""

from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import torch

__all__ = [
    "H100_SXM_FP32_FLOPS", "H100_SXM_HBM_BYTES", "stage_report", "projector_flops",
    "work_shear", "work_unshear", "work_resample", "work_pd", "work_grid", "work_fft",
    "flagship_breakdown", "card_line",
]

# the published peaks of an H100 SXM at 700 W: float32 operations outside
# the tensor cores, and HBM3 bytes per second
H100_SXM_FP32_FLOPS = 67e12
H100_SXM_HBM_BYTES = 3.35e12

# Below this, a stage's time is the timer's noise and a rate from it means
# nothing (the JAX package's r4 bench reported petabytes per second from a
# ~0 ms stage).
_MIN_RATE_DT = 5e-5  # 50 us


def projector_flops(nz, n_ang, ny, nx):
    """Operations of one FP or BP application (see the module docstring)."""
    return 4.0 * nz * n_ang * ny * nx


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
    weighted taps) and K3 (26 per u, as a thread per u spends them: four
    candidate positions and hats, two weighted taps; the rows of p that the
    group reads are counted once, whether they were copied out or are read
    through an index)."""
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


def _bounded_util(rec, key, achieved, peak):
    """Record achieved/peak, clamped into (0, 1].  A utilisation above 1 is
    impossible: the raw value stays visible under ``*_raw`` so that a wrong
    model is loud rather than silently normalised."""
    util = achieved / peak
    if util > 1.0:
        rec[f"{key}_raw"] = round(util, 3)
        util = 1.0
    rec[key] = round(util, 3)
    return util


def stage_report(name, dt, flops=None, bytes_moved=None, peak=None, peak_name="FP32"):
    """Print and record one stage: ms, achieved GF/s against ``peak`` (the
    card's float32 rate by default) and effective GB/s against its HBM
    bandwidth when ``bytes_moved`` is given.

    Rates and utilisations are only derived when the time is above
    ``_MIN_RATE_DT``; reported utilisations are bounded to (0, 1]."""
    dt = max(dt, 1e-9)
    parts = [f"{name:26s} {dt * 1e3:9.3f} ms"]
    rec = {"ms": round(dt * 1e3, 3)}
    if dt < _MIN_RATE_DT:
        if flops or bytes_moved:
            rec["below_timer_resolution"] = True
            parts.append("(too fast to rate)")
        print("  ".join(parts))
        return rec
    if peak is None:
        peak = H100_SXM_FP32_FLOPS
    if flops:
        gfs = flops / dt
        rec["gflops"] = round(gfs / 1e9, 1)
        util = _bounded_util(rec, f"{peak_name.lower()}_util", gfs, peak)
        parts.append(f"{gfs / 1e9:8.0f} GF/s ({100 * util:5.1f}% {peak_name})")
    if bytes_moved:
        bw = bytes_moved / dt
        rec["hbm_gbs"] = round(bw / 1e9, 1)
        util = _bounded_util(rec, "hbm_util", bw, H100_SXM_HBM_BYTES)
        parts.append(f"{bw / 1e9:7.0f} GB/s ({100 * util:5.1f}% HBM)")
    print("  ".join(parts))
    return rec


def _device(device) -> torch.device:
    """``device``, else the current card; without CUDA that raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (pass device='cpu' to run on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def flagship_breakdown(N, nz, nproj, os_number, tv_iters, reps=10, device=None):
    """Time FP/BP of OS subset 0 and one PD-TV prox (lambda 1e-4, iso,
    nonneg, L 12) of the flagship config on ``device`` (the card by
    default); returns their stage records (ms, rates, utilisations) and
    ``outer_estimate_ms``, the OS subsets' sum of the three."""
    from tomobar_tpu_torch.bench.harness import time_fn
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector
    from tomobar_tpu_torch.regularisers import PD_TV

    dev = _device(device)
    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    P = Projector(Geometry(N, nz, angles, 0.0, N, os_number=os_number))
    n_sub_ang = len(P.subset_indices[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((nz, N, N), generator=gen, device=dev)
    sub0 = torch.rand((nz, n_sub_ang, N), generator=gen, device=dev)
    vol_bytes, sub_bytes = 4 * nz * N * N, 4 * nz * n_sub_ang * N

    out = {}
    t_fp = time_fn(lambda v: P.fp_sub(v, 0), x, reps=reps)
    out["fp_sub"] = stage_report(
        f"FP subset ({n_sub_ang} ang)", t_fp,
        flops=projector_flops(nz, n_sub_ang, N, N), bytes_moved=vol_bytes + sub_bytes,
    )
    t_bp = time_fn(lambda s: P.bp_sub(s, 0), sub0, reps=reps)
    out["bp_sub"] = stage_report(
        f"BP subset ({n_sub_ang} ang)", t_bp,
        flops=projector_flops(nz, n_sub_ang, N, N), bytes_moved=vol_bytes + sub_bytes,
    )
    ops, moved = work_pd(nz, N, tv_iters)
    t_tv = time_fn(lambda v: PD_TV(v, 1e-4, tv_iters, 0, 1, 12.0), x, reps=reps)
    out["pd_tv"] = stage_report(f"PD-TV x{tv_iters}", t_tv, flops=ops, bytes_moved=moved)
    est = os_number * (t_fp + t_bp + t_tv)
    out["outer_estimate_ms"] = round(est * 1e3, 3)
    print(f"{'outer estimate (' + str(os_number) + ' subsets)':26s} "
          f"{est * 1e3:9.3f} ms  -> {1.0 / est:0.3f} iter/s upper bound")
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    dev = _device(None)
    print(f"device: {torch.cuda.get_device_name(dev)}; nvidia-smi name, power.limit: "
          f"{card_line()}")
    print(f"bounds (H100 SXM): {H100_SXM_FP32_FLOPS / 1e12:.0f} TFLOP/s float32, "
          f"{H100_SXM_HBM_BYTES / 1e12:.2f} TB/s HBM3")
    N = int(os.environ.get("TOMOBAR_BENCH_N", 2560))
    nz = int(os.environ.get("TOMOBAR_BENCH_NZ", 8))
    nproj = int(os.environ.get("TOMOBAR_BENCH_NPROJ", 1801))
    os_number = int(os.environ.get("TOMOBAR_BENCH_OS", 10))
    tv_iters = int(os.environ.get("TOMOBAR_BENCH_TV_ITERS", 20))
    out = flagship_breakdown(N, nz, nproj, os_number, tv_iters)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
