"""Work models and the published peaks of one H100 SXM: the operations and
bytes that a layer's call must do, counted from its shapes.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* ``H100_SXM_FP32_FLOPS``, ``H100_SXM_HBM_BYTES``, ``projector_flops``,
  ``work_pd``, ``work_grid``, ``work_fft``: from
  ``tomobar_tpu_torch/bench/breakdown.py`` at commit 4cba618f362617c7;
* ``stage_work``: from ``tomobar_tpu_torch/bench/fourier_breakdown.py`` at
  the same commit, with the gridding footprint ``m`` worked out here
  (``grid_m``) instead of asked of the program.

Each count reads every input once and writes every output once, so a
layer's time can only be at or above ``bound_s``: a share above 100% is a
counting fault and is reported as it is, never clamped.
"""

from __future__ import annotations

import math

import numpy as np

# the published peaks of an H100 SXM at 700 W: float32 operations outside
# the tensor cores, and HBM3 bytes per second (NVIDIA's data sheet)
H100_SXM_FP32_FLOPS = 67e12
H100_SXM_HBM_BYTES = 3.35e12


def bound_s(ops, nbytes) -> float:
    """The least time the card could take: the larger of the operations over
    the float32 peak and the bytes over the HBM bandwidth."""
    return max((ops or 0.0) / H100_SXM_FP32_FLOPS, (nbytes or 0.0) / H100_SXM_HBM_BYTES)


def projector_flops(nz, n_ang, ny, nx):
    """Operations of one FP or BP application: every (slice, angle, row)
    pair does one 2-tap interpolation (2 products, 1 sum) and one
    accumulating sum per driven column."""
    return 4.0 * nz * n_ang * ny * nx


def projector_work(nz, n_ang, n, det_x):
    """(operations, bytes) of one FP or BP: the volume and the sinogram,
    one read and the other written, once each."""
    return projector_flops(nz, n_ang, n, n), 4.0 * (nz * n * n + nz * n_ang * det_x)


def work_pd(nz, n, iterations):
    """PD-TV, one prox: data read and u written once, whatever the
    iteration count.  Per voxel and iteration (iso, nonneg) 36 operations,
    28 for one slice: the differences (3), the dual ascent (6), the norm
    (5), compare, clamp, rsqrt, select and scaling (7), the divergence (5),
    the clamp of u (1) and the primal step with its relaxation (9); one
    slice has no z term."""
    return (36 if nz > 1 else 28) * iterations * nz * n * n, 8 * nz * n * n


def work_grid(nz2, n_angles, n, m=5):
    """The gridding: per polar sample and tap 8 operations for the weight and
    a product and a sum per z-pair and channel; spectra read, the (2n)^2
    grids written."""
    taps = n_angles * n * (2 * m + 1) ** 2
    return taps * (8 + 4 * nz2), 8 * nz2 * n_angles * n + 8 * nz2 * 4 * n * n + 8 * n_angles


def work_fft(shape):
    """A transform along axis -2: 5 n log2 n operations per column; re and
    im read and written."""
    n, count = shape[-2], int(np.prod(shape))
    return 5 * count * np.log2(n), 16 * count


def grid_m(n: int, eps: float = 1e-4) -> int:
    """Half-width of the Gaussian gridding footprint for a size-n transform
    (Nikitin's USFFT, as TomoCuPy sizes it)."""
    mu = -np.log(eps) / (2 * n * n)
    return int(np.ceil(2 * n / np.pi * np.sqrt(-mu * np.log(eps) + (mu * n) * (mu * n) / 4)))


def oversampled_width(width: int) -> int:
    """FOURIER_INV's filter width with its default power-of-2 oversampling."""
    ow = 2 ** math.ceil(math.log2(width * 3))
    return max(ow, 2 ** math.ceil(math.log2(width)))


def stage_work(N: int, nz: int, nproj: int, ow: int) -> dict:
    """(operations, bytes) of each FOURIER_INV stage at nz x nproj x N (even,
    no padding; ``ow`` the filter's oversampled width): the transforms' and
    the gridding's arithmetic, each stage's input read and output written
    once."""
    pairs, f32 = nz // 2, 4
    data_bytes = f32 * nz * nproj * N
    rows = nz * ((nproj + 1) // 2)  # pairs of rows packed to complex
    spectra = 2 * f32 * pairs * nproj * N
    grids = 2 * f32 * pairs * (2 * N) ** 2
    return {
        "filter": (2 * work_fft((ow, rows))[0], 2 * data_bytes),
        "fft1d": (5 * pairs * nproj * N * np.log2(N), data_bytes + spectra),
        "grid": work_grid(pairs, nproj, N, grid_m(N)),
        "ifft2": (2 * work_fft((pairs, 2 * N, 2 * N))[0], 2 * grids),
        "unpad": (None, 2 * f32 * nz * N * N),
    }


def fourier_inv_bound_s(N: int, nz: int, nproj: int) -> float:
    """The least time of one FOURIER_INV call: the sum of its stages'
    bounds (each stage must finish before the next starts)."""
    return sum(bound_s(o, b) for o, b in stage_work(N, nz, nproj, oversampled_width(N)).values())
