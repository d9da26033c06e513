"""Per-stage timing and roofline audit of FOURIER_INV (the USFFT path) on
the card.

The reference works this path hardest (its centre gather and angle-range
pruning exist for speed; its changelog claims "significantly faster than
FBP"), so "fast" needs per-stage evidence, as :mod:`.breakdown` gives it
for FISTA.  Counterpart of ``tomobar_tpu/bench/fourier_breakdown.py``.

Stages (``ops/usfft.py``, shape nz x nproj x N, default kwargs):

* ``filter``: STEP0, the oversampled FBP filter (a forward and an inverse
  transform at ow = 2^ceil(log2(3N)) per pair of rows: F twice);
* ``fft1d``: STEP1, pack the z-pairs, ``torch.fft`` along detX, the
  fftshift sign and scale;
* ``grid``: STEP2, the Gaussian gridding onto (2n, 2n) (G);
* ``ifft2``: STEP3, the checkerboard-signed inverse 2D transform (F twice
  with a transpose between);
* ``unpad``: STEP4, crop, phi and the pair unpacking.

The work models (:func:`stage_work`) count what each stage's function must
do on the card, the F and G kernels' arithmetic (:func:`.breakdown.work_fft`,
:func:`.breakdown.work_grid`) and each stage's input read and output
written once, against the H100 bounds of :mod:`.breakdown`; there is no
matrix-unit peak here.

Run on a machine with the card::

    python -m tomobar_tpu_torch.bench.fourier_breakdown
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tomobar_tpu_torch.bench.breakdown import _device, stage_report, work_fft, work_grid

__all__ = ["STAGES", "fourier_inv_by_stage", "stage_work", "fourier_breakdown"]

STAGES = ("filter", "fft1d", "grid", "ifft2", "unpad")


def fourier_inv_by_stage(rt, data: torch.Tensor):
    """FOURIER_INV of ``rt`` (a ``RecToolsDIRCuPy``) on 3D ``data``
    [detY, angles, detX] with even axes and default kwargs, stage by stage
    with a mark between stages (CUDA events on a card); returns the ms per
    stage (:data:`STAGES`), the reconstruction (equal to ``rt.FOURIER_INV
    (data)``) and the gridding input (the spectra the path gives G)."""
    from tomobar_tpu_torch.bench.harness import Marks
    from tomobar_tpu_torch.ops import fft_real as FR
    from tomobar_tpu_torch.ops import usfft as US
    from tomobar_tpu_torch.ops import usfft_kernels as UK

    p = US._pipeline(rt, tuple(data.shape), {})
    if p.odd_vert or p.odd_horiz or p.n != p.data_n:
        raise ValueError(f"fourier_inv_by_stage takes even axes and no padding, got {tuple(data.shape)}")
    n = p.n
    theta = -np.asarray(rt.geom.angles, dtype=np.float64)
    rot = float(np.mean(rt.geom.cor_horizontal)) + 0.5
    mu = -np.log(1e-4) / (2 * n * n)
    marks = Marks(data.device)
    marks.mark()
    filtered = US._fbp_filter_stage(data, p.data_n, n, p.filter_type, p.cutoff_freq, rot,
                                    p.power_of_2_oversampling, p.oversampling_level)
    marks.mark()
    dre, dim = US._pack_pairs(filtered)
    sre, sim = FR.fft_pairs(dre, dim)
    scale = US._sign_vector(n, data.device) * (4.0 / n)
    sre, sim = sre * scale, sim * scale
    marks.mark()
    fre, fim = UK.grid(sre, sim, n, theta)
    marks.mark()
    fre, fim = US._ifft2_centered(fre, fim, n)
    marks.mark()
    rec = US._unpad_mul_phi(fre, fim, n, p.nproj, p.nz, False, False, rt.recon_size, mu)
    marks.mark()
    return dict(zip(STAGES, marks.elapsed_ms())), rec, (sre, sim)


def stage_work(N: int, nz: int, nproj: int, ow: int) -> dict:
    """(operations, bytes) of each stage at nz x nproj x N (even, no
    padding; ``ow`` the filter's oversampled width): the transforms' and
    the gridding's arithmetic, each stage's input read and output written
    once."""
    from tomobar_tpu_torch.ops.usfft_kernels import grid_params

    pairs, f32 = nz // 2, 4
    data_bytes = f32 * nz * nproj * N
    rows = nz * ((nproj + 1) // 2)  # pairs of rows packed to complex
    spectra = 2 * f32 * pairs * nproj * N
    grids = 2 * f32 * pairs * (2 * N) ** 2
    return {
        "filter": (2 * work_fft((ow, rows))[0], 2 * data_bytes),
        "fft1d": (5 * pairs * nproj * N * np.log2(N), data_bytes + spectra),
        "grid": work_grid(pairs, nproj, N, grid_params(N).m),
        "ifft2": (2 * work_fft((pairs, 2 * N, 2 * N))[0], 2 * grids),
        "unpad": (None, 2 * f32 * nz * N * N),
    }


def fourier_breakdown(N, nz, nproj, reps=5, device=None, data=None):
    """Time FOURIER_INV's stages (the mean of ``reps`` staged calls after a
    warm-up) and the whole call on ``data`` [nz, nproj, N], random data by
    default, on ``device`` (the card by default, else ``data``'s); returns
    the shape, the oversampled width and each stage's record
    (:func:`.breakdown.stage_report`) with ``total_ms`` and
    ``stage_sum_ms``."""
    from tomobar_tpu_torch import RecToolsDIRCuPy
    from tomobar_tpu_torch.bench.harness import time_fn
    from tomobar_tpu_torch.ops import usfft as US

    dev = _device(device if data is None or device is not None else data.device)
    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    rt = RecToolsDIRCuPy(N, 0, nz, 0.0, angles, N, device=dev)
    if data is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        data = torch.randn((nz, nproj, N), generator=gen, device=dev)
    elif tuple(data.shape) != (nz, nproj, N):
        raise ValueError(f"data {tuple(data.shape)}, not ({nz}, {nproj}, {N})")
    ow = US._pipeline(rt, tuple(data.shape), {}).ow
    out = {"shape": f"{nproj}x{nz}x{N}", "oversampled_width": ow}
    fourier_inv_by_stage(rt, data)  # warm-up: tables, plans
    runs = [fourier_inv_by_stage(rt, data)[0] for _ in range(reps)]
    work = stage_work(N, nz, nproj, ow)
    labels = {"filter": f"filter (ow={ow})", "fft1d": "pack + fft1d", "grid": "usfft gridding",
              "ifft2": f"ifft2 ({2 * N}^2)", "unpad": "unpad * phi"}
    res = {}
    for k in STAGES:
        ops, moved = work[k]
        res[k] = stage_report(labels[k], float(np.mean([r[k] for r in runs])) / 1e3,
                              flops=ops, bytes_moved=moved)
    res["total_ms"] = round(time_fn(rt.FOURIER_INV, data, reps=reps) * 1e3, 3)
    res["stage_sum_ms"] = round(sum(res[k]["ms"] for k in STAGES), 3)
    print(f"{'total':26s} {res['total_ms']:9.3f} ms   (stage sum {res['stage_sum_ms']:.3f})")
    out["stages"] = res
    return out


def main():
    from tomobar_tpu_torch.bench.breakdown import card_line

    print(f"device: {torch.cuda.get_device_name(_device(None))}; nvidia-smi name, "
          f"power.limit: {card_line()}")
    N = int(os.environ.get("TOMOBAR_BENCH_N", 2560))
    nz = int(os.environ.get("TOMOBAR_BENCH_NZ", 8))
    nproj = int(os.environ.get("TOMOBAR_BENCH_NPROJ", 1801))
    print(json.dumps(fourier_breakdown(N, nz, nproj)))


if __name__ == "__main__":
    main()
