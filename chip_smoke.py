#!/usr/bin/env python3
"""Smoke run of tomobar_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels (and the native preprocessing library), checks each kernel against
its plain PyTorch version, and drives the ported paths at the flagship
shape: the iterative main path (``RecToolsIRCuPy.FISTA``, PWLS, ordered
subsets, PD-TV), the direct path (``RecToolsDIRCuPy.FOURIER_INV`` and 3D
``FBP``), the 2D path (2D ``FORWPROJ``/``FBP`` and every solver on one
slice) and raw projections through normalisation, centre finding and the
memory plan to a reconstruction, then the sharded layer and the bench
modules, the examples, and the direct entry points against the
closed-form Radon transform of ellipses.

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
   aligned) and K4 at ny != nx and adding into a volume, K3 gathering each
   group's rows from the whole sinogram through ``index`` (1, 3 and 8
   slices, shuffled angles, an LU that is no multiple of 4; an index
   outside the sinogram must fail the launch, in a process of its own),
   and PD-TV
   (iso/aniso x nonneg, nz 1, 3 and 8, plus bf16 duals; iteration counts
   1, K - 1, K + 1 and 20 for K iterations per launch; 3 x 500 x 510, which
   its tiles do not divide; 9 slices refused) and PDw, its y-wavefront for
   more than 8 slices (12, 17 and 20 slices, one slab; 300 rows, three
   y-segments; 33 and 70 slices, slabs of 32 with a halo in z), each
   against its plain
   version on the same inputs; K1, K3 and K4 must equal their plain
   versions bit for bit.
4. adjointness of the kernel pair.
5. the slice on the CPU (plain versions) and on the GPU (kernels),
   256^2 x 4 slices x 90 angles, OS5, PWLS, nonneg, PD-TV 20.
6. the flagship: 1801 angles x 8 slices x 2560, OS10, PWLS, nonneg,
   PD-TV (lambda 5e-4, 20 iterations), Lipschitz constant from the power
   method, 1, 2 and 3 outer iterations; launch counts, times, RMSE
   against the phantom, peak memory, then each kernel's time beside its
   plain version's at that shape (K1-K4 on both driven groups of OS
   subset 0, PD-TV for one prox of 20 iterations on the whole volume, and
   for one iteration), and one OS subset of the FISTA step by stage
   (``bench.breakdown.flagship_breakdown``: fp_sub, bp_sub, one PD-TV prox,
   ms and utilisation of the H100 bounds).
7. the direct path: G (USFFT gridding) against its plain version at
   n=512, 2 z-pairs, 360 angles with 0 and pi/2 (both driven groups), at
   n=500 (tiles that the grid does not fill) with 5 z-pairs (an odd count
   above one block's four), for one angle and for angles beyond 360
   degrees, two calls on the same input bit for bit equal; F
   (axis-(-2) FFT) at n = 2560, 5120, 8192 (its compile-time stage plans)
   and n = 3000 (the run-time plan) and both signs; FOURIER_INV and
   3D FBP at 256^2 x 4 x 90 on the CPU and on the GPU; then on phase 6's
   clean 1801 x 8 x 2560 sinogram: FOURIER_INV and FBP times after a
   warm-up call, G/F launch counts per path, both paths' time by stage
   (FOURIER_INV's through ``bench.fourier_breakdown``),
   its correlation with a Ram-Lak FBP inside the inscribed circle, peak
   memory, and G and F beside their plain versions at the flagship shapes
   (G against a float64 plain sum, and twice for bit-equal grids).
8. the 2D path: K1p/K4p (the packed nz = 1 pair) against their plain
   versions at N=512, 2D, 180 angles (scalar CoR 3.5 and a per-angle CoR
   vector, both driven groups; K1p bit for bit against the plain sum in the
   same runs of rows, K4p bit for bit, new and adding into a slice), K1p
   also at rows of 510 (not 16-byte aligned), at 200 x 520 and for 10 sparse
   angles, K4p at 520 and 200 columns, with lines of q that are not 16-byte
   aligned and for 10 sparse angles, and the pair's adjointness; 2D FBP and 2D
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
   prox of 20 iterations (PDw) on a 512 x 2560^2 volume that is constant
   along z (13.4 GB) against the one-slice prox of the same slice (1e-5 of
   max), and one on that volume times 1 + sin(0.7 z) / 2 against the plain
   version on three windows of 40 slices (with their halo of 20); the
   times, chunk counts and peak memory of each; right before FOURIER_INV,
   its shape-tuple estimate (held in phase 13).
10. the regularisers: every method that ``prox_regul`` dispatches (ROF_TV,
   PD_TV, FGP_TV iso/aniso x nonneg, SB_TV, LLT_ROF, TGV, NDF x3, Diff4th,
   WAVELETS, PD_TV_WAVELETS, NLTV on ``patch_select``'s tables) on the GPU
   and on the CPU on the same 4 x 64^2 phantom with noise, 2D and 3D (rel
   L2 1e-4); one prox of 20 iterations of each but NLTV on 8 x 2560^2
   (time after a warm-up call, peak memory); ``patch_select`` + NLTV on one
   2560^2 slice (or the largest square that fits).
11. a legacy prox on the main path: ``RecToolsIRCuPy.FISTA`` with FGP_TV
   (lambda 5e-4, 20 iterations) on phase 6's data (OS10, PWLS, nonneg),
   1, 2 and 3 outer iterations (the RMSE must fall), launch counts, one
   FGP_TV prox on the last iterate (it must lower the iterate's total
   variation and move it by more than rounding), one OS subset by stage; then the 2D flagship (OS10, LS) with FGP_TV, calls of
   1 and 3 outer iterations.
12. the Joseph pair (``set_projector_backend("xla")``): adjointness at
   256^2 x 4 x 90, GPU against CPU FP/BP (rel L2 1e-4), its distance from
   the two-pass pair, no kernel launched, one FP and one BP timed at the 2D
   flagship; FOURIER_INV at 64^2 x 4 x 60, below the JAX package's n >= 128
   rule, under ``set_usfft_backend`` "auto" and "xla": each must launch G
   and agree with the CPU (rel L2 1e-4).
13. raw projections to a reconstruction: phase 6's phantom projected at
   CoR offset 4.25 px, made into raw counts (1801 x 8 x 2560, 147 MB:
   flat x exp(-p) with Poisson noise at 1e4 photons and a dark frame; 20
   flats with a fixed pattern, 10 darks); ``normaliser`` (mean, median) on
   the host (the native pass) and on the card, which must agree within
   1e-6 rel L2, both timed, the normalised stack against the clean
   sinogram at the noise level the counts predict (0.8-1.25 of it);
   ``autocropper`` (addbox 20, strips 20), whose box must hold every
   column where the clean sinogram exceeds 1% of its max; the centre from
   ``find_center_correlation(stack=True)`` (rows as they are, all slices;
   the JAX package's estimator printed beside it) within 0.25 px; the shape-tuple
   plan of ``FOURIER_INV`` at 8 slices (and, taken in phase 9 right before
   its call, at 512) with no launch and no allocation, its estimate 1.0-1.3
   of the measured peak (above what was held, plus the input); FOURIER_INV
   and FBP at the found centre, timed, with the launches of G, F, K3 and
   K4; binned 4 x 4 (at 1e4 photons a direct reconstruction's noise
   exceeds the phantom's contrast pixel by pixel), each must correlate with
   the phantom at >= 0.9 inside the inscribed circle and, on the clean
   sinogram, differ from the call at the true centre by no more than a
   0.25 px shift of the true centre makes (the centre tolerance; unbinned
   and noisy comparisons printed beside); the dynamic flat fields (host)
   on a cut of 180 projections x 8 x 640, timed.
14. the sharded layer (``tomobar_tpu_torch.parallel``) on phase 6's
   flagship: worlds of ranks on the meshes (z, angles) = (2, 1), (1, 2)
   and (2, 2), one subprocess per rank (NCCL with one rank per card where
   the machine has as many cards as ranks, else gloo with every rank on
   card 0, its CUDA tensors staged through pinned host memory).  Each rank
   loads its z-slab of phase 6's noisy sinogram and runs ``fp_sub`` /
   ``bp_sub`` of subset 0 on phase 6's result, ``solvers.core.fista``
   (OS10, PWLS, nonneg, the halo PD-TV prox, phase 6's Lipschitz constant)
   for 1, 2 and 3 outer iterations and, on mesh (2, 1),
   ``ShardedDirect.fbp`` and ``.fourier_inv`` on phase 7's clean sinogram
   and one PD-TV prox (20 iterations) on 64 x 2560^2 of noise, where the
   halo (20 slices) is shorter than the other slab (32); rank 0 gathers
   the results.  Held: on z-only meshes every result equal
   to phases 6 and 7 bit for bit; where angles are dealt ``fp_sub`` bit
   for bit, ``bp_sub`` within 1e-6 and FISTA after 3 iterations within
   1e-5 rel L2; the RMSE against the phantom falls from iteration 1 to 3
   on every mesh; the 64-slice prox equal to the single card's bit for
   bit on each slab, its z_halo moving fewer slices than a slab holds;
   every rank launched K1-K4 and PD (and G and F on the direct path, PDw
   in the 64-slice prox).  Each rank prints its launches, outer-iteration ms,
   peak memory and the bytes each collective moved and staged, and counts
   the collectives of one more outer iteration
   (``bench.scaling.count_collectives_in_step``).  A rank that fails or
   times out fails the run.
15. the bench modules (``tomobar_tpu_torch/bench``) at BASELINE's shapes:
   phase 6's ``flagship_breakdown`` read (every utilisation in (0, 1] and
   none clamped, that is no ``*_raw`` key; its outer estimate beside phase
   6's measured iteration); phase 7's ``fourier_breakdown`` read, whose
   stages must sum to within 15% of phase 7's FOURIER_INV call;
   ``estimate_memory`` on meta tensors: a FORWPROJ plan
   for 4096 x 2560^2 (more than the card holds) with no launch and no
   allocation, and at 8 slices the plans of ``fp`` and a PD-TV prox within
   0.98-1.05 of the card's peak; ``run_northstar`` at 2560^2 x 20 slices x
   1801 angles (OS10, TV20, 20 FISTA-PWLS and 3 warm-started ADMM-OS24
   iterations): first its kernels against their plain versions on its own
   inputs (K1-K4 on both driven groups of OS subset 0 at 20 slices, one
   PD-TV prox of 20 iterations on its FBP at 20 x 2560^2, which is PDw's
   time in the kernels line, and on 64 slices of it, F on the FBP filter's
   packed rows, both signs), then the run, with the counters reset before
   it and read after it (K1-K4, PDw and F must be launched) and PDw's
   counter read after each FISTA step (the same count in every outer
   iteration: PDw's launches per call in the kernels line), FISTA's
   rel-RMSE falling at every step and
   reaching FBP's, ADMM's ending below FBP's (the TPU run's quality
   printed beside); and ``comm_model`` equal, call for call and byte for
   byte, to the collectives each rank of phase 14 counted.
16. the examples of ``examples/torch/``: each at its own default size
   through ``main(device="cuda")`` (N 256, the tour 160, the sharded one
   128 on a world of one rank), its asserts holding, every rel-RMSE it
   returns finite, the kernels of its path launched; then the three paths
   that no earlier phase drives at the flagship width, 1801 angles x 8
   slices x 2560, with the examples' own dictionaries: raw counts through
   ``normaliser`` to the padded-detector FBP warm start (pad 24, a 2608^2
   grid) and ADMM-OS24 with PD-TV 40 (BASELINE config 4), which must end
   below its warm start; FISTA-OS10 with PWLS, PWLS + Huber and SWLS +
   Huber on data with stripes and zingers (the example's artifacts and
   Huber threshold times N / 256, the sinogram's growth from the example's
   N), SWLS + Huber beating PWLS; OSEM (OS 8), MLEM over all 1801 angles
   and FISTA with KL warm-started from OSEM on Poisson counts.  Each: the
   outer iteration by CUDA events (FISTA the 3- less the 2-iteration call,
   ADMM the 2- less the 1-iteration call), peak memory, launches.  Then
   the sharded example on worlds of gloo ranks sharing the card, mesh
   (2, 1) on 4 slices and (2, 2) on 8, against a world of one rank (this
   process) at the same sizes: FBP and FISTA bit for bit on the z-only
   mesh, within 1e-5 rel L2 where angles are dealt.  Ranks sharing one
   card through the host measure the host, not scaling.
17. the closed-form Radon cross-check at the flagship's 1801 angles x 8
   slices x 2560 (``bench.analytic``: its ellipses scaled x 10, slice k's
   values x (1 + k/8); phantom and transforms in float64 on the host):
   3D ``FORWPROJ`` (K1, K2) within 2e-3 rel L2 of the continuous transform
   on every slice and more than 5% from it at negated angles and with a
   mirrored detector; at centre offset 4.25 px within 2e-3 of the
   transform at 4.25 and more than 1% from it at -4.25 (at 2560 px the two
   transforms differ by only 2.0%); one-slice ``FORWPROJ`` (K1p, K2)
   within 2e-3; 3D FBP (ram-lak: F, K3, K4) and 2D FBP of slice 0 (K4p)
   of the exact transform with the flat interior of the big ellipse within
   3% of its value and a rel RMSE under 0.10 inside 0.45 N; FOURIER_INV (G,
   F) over its 8/pi convention within 6% of the value, and on slice 0
   beating each of its four 1-pixel shifts.  Each of K1-K4, K1p, K4p, F
   and G must launch in the phase.

``python3 chip_smoke.py --sharded-rank <dir> <n_z> <n_angles> <backend>``
is one rank of phase 14 (the rendezvous in the environment); the phase
starts it, nobody else needs to.

The last three lines are the nvidia-smi line, a JSON object with one
entry per kernel, and ``{"ok": true, "device": {...}}``.  A kernel's entry
holds its launches on the main paths (``launches``) and per call of its
path (``launches_per_call`` of ``per_call_of``), its worst error, and, summed
over the calls timed at the flagship shapes (PD: one prox of 20 iterations
on 8 x 2560^2, PDw: one on the north star's 20 x 2560^2, each several
launches), its time, its plain version's,
the time of one PyTorch call for the same function where there is one
(``library_ms``: ``torch.fft`` on an already complex tensor for F) and its
bound: the larger of its operations over 67 TFLOP/s (float32 outside the
tensor cores) and its bytes, each input read once and each output written
once, over 3.35 TB/s, the published peaks of an H100 SXM at 700 W.  ``ms``
is the time of calls enqueued one by one, as the paths enqueue them.  K2 and
K3 take less time than the host needs to enqueue a call, so their entries
also hold ``device_ms``, the time on the device alone, of calls replayed
from a CUDA graph (null for the other kernels).
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from tomobar_tpu_torch.bench.breakdown import (  # noqa: E402
    H100_SXM_FP32_FLOPS as PEAK_FLOPS,
    H100_SXM_HBM_BYTES as PEAK_BYTES,
    card_line,
    work_fft,
    work_grid,
    work_pd,
    work_resample,
    work_shear,
    work_unshear,
)
from tomobar_tpu_torch.bench.breakdown import flagship_breakdown  # noqa: E402
from tomobar_tpu_torch.bench.fourier_breakdown import (  # noqa: E402
    STAGES,
    fourier_breakdown,
    fourier_inv_by_stage,
)
from tomobar_tpu_torch.bench.harness import time_cuda, time_device  # noqa: E402

TOL_KERNEL = 1e-5  # max|kernel - plain| / max|plain|, fp32 sums in another order
TOL_PD_BF16 = 1e-3  # bf16 duals: a one-ulp fp32 difference can flip a rounding
TOL_ADJOINT = 1e-5  # |<Ax,y> - <x,A^T y>| / |<Ax,y>|
TOL_SLICE = 1e-4  # rel L2 between the CPU and the GPU reconstruction
MIN_CORR = 0.99  # FOURIER_INV vs Ram-Lak FBP inside the inscribed circle
# phase 13: the raw stack, and what its path is held to
C_TRUE = 4.25  # CoR offset of the raw stack, px
I0_RAW = 1.0e4  # photons per pixel in the flat field
DARK_LEVEL, DARK_NOISE = 100.0, 2.0  # dark counts and their read noise
N_FLATS, N_DARKS = 20, 10
TOL_NORMALISE = 1e-6  # rel L2 of the card's normalisation against the host's
TOL_CENTRE = 0.25  # px
MIN_CORR_PHANTOM = 0.9  # recon of the noisy stack vs phantom, binned, inscribed circle
BIN = 4  # phase 13 compares images binned BIN x BIN

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
    "PDw": ("pd_tv_wave", "tomobar_tpu_torch/csrc/pd_tv.cu",
            "tomobar_tpu/ops/pd_tv_pallas.py:144 (_pd_tv_stream_kernel, its y-wavefront)"),
    "G": ("usfft_grid", "tomobar_tpu_torch/csrc/usfft_grid.cu",
          "tomobar_tpu/ops/usfft_pallas.py:236 (G1 _grid_kernel_astack) "
          "and tomobar_tpu/ops/usfft_pallas.py:91 (G0 _grid_kernel)"),
    "F": ("fft_axis2", "tomobar_tpu_torch/csrc/fft_axis2.cu",
          "tomobar_tpu/ops/fft_real.py:208"),
}
ITERATIVE = ("K1", "K2", "K3", "K4", "PD")  # the kernels of phase 6's path
PROJECTOR_3D = ("K1", "K2", "K3", "K4")  # phase 11's path, 3D
PROJECTOR_2D = ("K1p", "K2", "K3", "K4p")  # phase 11's path, 2D

# phase 10: every method that prox_regul dispatches, as (label, method,
# extra keys of the dict, nonnegativity of the owner)
PROX_CASES = (
    ("ROF_TV", "ROF_TV", {}, 0),
    ("PD_TV", "PD_TV", {}, 1),
    ("FGP_TV iso", "FGP_TV", {}, 0),
    ("FGP_TV iso nonneg", "FGP_TV", {}, 1),
    ("FGP_TV aniso", "FGP_TV", {"methodTV": 1}, 0),
    ("FGP_TV aniso nonneg", "FGP_TV", {"methodTV": 1}, 1),
    ("SB_TV", "SB_TV", {}, 0),
    ("LLT_ROF", "LLT_ROF", {}, 0),
    ("TGV", "TGV", {}, 0),
    ("NDF Huber", "NDF", {"NDF_penalty": 1}, 0),
    ("NDF rational", "NDF", {"NDF_penalty": 2}, 0),
    ("NDF exponential", "NDF", {"NDF_penalty": 3}, 0),
    ("Diff4th", "Diff4th", {}, 0),
    ("WAVELETS", "WAVELETS", {}, 0),
    ("PD_TV_WAVELETS", "PD_TV_WAVELETS", {}, 1),
)
TWO_D = ("K1p", "K4p")  # measured in phase 8
# the 3D flagship (phases 6, 7 and 14): N, NZ, angles, OS subsets; its prox
FLAGSHIP = (2560, 8, 1801, 10)
FLAGSHIP_REG = {"method": "PD_TV", "regul_param": 5e-4, "iterations": 20}
# phase 14: the meshes (n_z, n_angles), and what a rank's path launches
SHARDED_MESHES = ((2, 1), (1, 2), (2, 2))
SHARDED_PATH = ("K1", "K2", "K3", "K4", "PD")
SHARDED_DIRECT = ("G", "F", "K3", "K4")  # mesh (2, 1) also runs FBP and FOURIER_INV
TOL_SHARD_BP = 1e-6  # rel L2: partial volumes summed over the angle group
TOL_SHARD_FISTA = 1e-5  # rel L2 after 3 outer iterations, angles dealt
# mesh (2, 1) also runs one PD-TV prox (FLAGSHIP_REG) on a volume of
# HALO_DEPTH slices at full width: its halo (20) is shorter than a slab (32)
HALO_DEPTH = 64
RANK_TIMEOUT = 420  # seconds for one world of ranks
# phase 15: the north-star run (BASELINE's 2560^2 x 20 shape), what it
# launches, and the TPU run's quality (NORTHSTAR_r04.json; rel-RMSE only)
NORTHSTAR = dict(N=2560, nz=20, nproj=1801, os_number=10, tv_iters=20, fista_outer=20,
                 admm_outer=3, regul_param=2e-4, i0=8000.0)
NORTHSTAR_PATH = ("K1", "K2", "K3", "K4", "PDw", "F")  # 20 slices: PD's wavefront
NORTHSTAR_TPU = {"fbp": 0.5097, "fista": 0.3247, "admm": 0.2403}
TOL_STAGE_SUM = 0.15  # FOURIER_INV's staged sum against phase 7's call
MEMPLAN_DEPTH = 4096  # slices of a 2560^2 volume larger than the card (107 GB)
TOL_PLAN = (0.98, 1.05)  # a meta plan against the card's measured peak
# phase 16: the examples of examples/torch/, the kernels each must launch
# at its default size, and the sharded example's worlds as (mesh, slices)
EXAMPLES = {
    "quickstart_2d": ("K1p", "K2", "K3", "K4p", "PD"),
    "phantom3d_fista_os_tv": ("K1", "K2", "K3", "K4", "PD", "G"),
    "artifacts3d_swls_huber": ("K1", "K2", "K3", "K4", "PD"),
    "osem_kl_counts": ("K1", "K2", "K3", "K4", "PD"),
    "realdata_warmstart_admm": ("K1", "K2", "K3", "K4", "PD"),
    "legacy_regularisers_tour": ("K1p", "K2", "K3", "K4p", "PD"),
    "multichip_sharded_recon": ("K1", "K2", "K3", "K4", "PD"),
}
EXAMPLE_WORLDS = (((2, 1), 4), ((2, 2), 8))
TOL_EXAMPLE_SHARD = 1e-5  # rel L2 of FBP and FISTA where angles are dealt
# phase 17: the closed-form Radon transform of bench.analytic's ellipses
# (scaled to the width, slice k's values times 1 + k/8), what its path must
# launch, and what each measure must meet
ANALYTIC_PATH = ("K1", "K2", "K3", "K4", "K1p", "K4p", "F", "G")
TOL_ANALYTIC_FP = 2e-3  # rel L2 of a projection against the transform, per slice
MIN_FLIP = 0.05  # rel L2 against negated angles or a mirrored detector
# rel L2 against the centre offset's wrong sign: at 2560 px the two
# transforms of +-4.25 px differ by only 2.0%, so 5% cannot be asked there
MIN_ANALYTIC_COR = 1e-2
TOL_FLAT_FBP = 0.03  # |flat interior / value - 1| of FBP (ram-lak)
MAX_RMSE_FBP = 0.10  # FBP's rel RMSE inside 0.45 N
TOL_FLAT_FI = 0.06  # |flat interior / (8/pi) / value - 1| of FOURIER_INV


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
        errs.compare("K3", tag, K.resample_bp(p, g.alpha, g.gamma, U0, LU), q_p, tol=0.0)
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


def check_k3_shapes(torch, K, errs, dev) -> None:
    """K3 against its plain version, bit for bit, gathering each group's
    angles from the whole sinogram through ``index`` (and on a copy of those
    rows, which must give the same), at 1, 3 and 8 slices, on both driven
    groups of a scan whose angles are shuffled (an unsorted index), and with
    an LU that is no multiple of 4 (scalar stores)."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector

    angles = np.random.default_rng(33).permutation(np.linspace(0.0, np.pi, 90, endpoint=False))
    gen = torch.Generator(device=dev).manual_seed(33)
    for n, nz in ((512, 1), (512, 3), (512, 8), (500, 3)):
        sino = torch.randn((nz, 90, n), generator=gen, device=dev)
        for g in Projector(Geometry(n, nz, angles, 3.5, n))._plan.groups(n, n, dev, nz == 1):
            for LU in (g.prm.LU, g.prm.LU - 2):
                args = (g.alpha, g.gamma, g.prm.U0, LU)
                tag = (f"{n}^2 x {nz}, {'y' if g.swap else 'x'}-driven, {g.prm.A} of 90 angles "
                       f"by index, LU {LU}")
                ref = K.resample_bp_plain(sino, *args, index=g.idx)
                errs.compare("K3", tag, K.resample_bp(sino, *args, index=g.idx), ref, tol=0.0)
                errs.compare("K3", tag + ", rows copied first",
                             K.resample_bp(sino[:, g.idx].contiguous(), *args), ref, tol=0.0)


K3_GUARD_CHILD = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from tomobar_tpu_torch.ops import projector_kernels as K
dev = torch.device("cuda")
p = torch.randn((2, 6, 64), device=dev)
alpha = torch.full((3,), 1.5, device=dev)
gamma = torch.full((3,), 10.0, device=dev)
def run(rows):
    q = K.resample_bp(p, alpha, gamma, 0, 128, index=torch.tensor(rows, device=dev))
    torch.cuda.synchronize()
    return q
assert torch.equal(run([5, 0, 3]), K.resample_bp_plain(p, alpha, gamma, 0, 128, index=torch.tensor([5, 0, 3], device=dev)))
print("VALID", flush=True)
try:
    run([5, int(sys.argv[2]), 3])
except RuntimeError as e:
    print("REFUSED", type(e).__name__, flush=True)
"""


def check_k3_index_guard() -> None:
    """K3 refuses an ``index`` entry outside the sinogram's angles: the kernel
    traps, so the launch fails instead of reading beside ``p``.  A trap ends
    the process's use of the card, so each case runs in a process of its own
    (after a valid index there, which must give the plain version's result)."""
    procs = [
        subprocess.Popen([sys.executable, "-c", K3_GUARD_CHILD, REPO, str(bad)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for bad in (6, -1)
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for bad, out in zip((6, -1), outs):
        require("VALID" in out and "REFUSED" in out,
                f"K3 did not refuse index {bad} of 6 angles:\n{out[-2000:]}")
        print(f"[3] K3 resample_bp, index {bad} of 6 angles: launch refused")


def check_adjointness(torch, geoms: dict, dev, seed: int, phase: str) -> None:
    """|<Ax,y> - <x,A^T y>| / |<Ax,y>| of the kernel pair on each of
    ``geoms`` (512^2, 180 angles; one slice as 2D arrays), x and y drawn
    from a generator seeded ``seed``: phase 4 at 8 slices (seed 4), phase 8
    at one (seed 80)."""
    from tomobar_tpu_torch.ops.projector import radon_bp, radon_fp

    gen = torch.Generator(device=dev).manual_seed(seed)
    for label, geom in geoms.items():
        lead = (geom.detectors_y,) if geom.detectors_y > 1 else ()
        x = torch.randn(lead + (512, 512), generator=gen, device=dev)
        y = torch.randn(lead + (180, 512), generator=gen, device=dev)
        lhs = float(torch.sum(radon_fp(x, geom).double() * y.double()))
        rhs = float(torch.sum(x.double() * radon_bp(y, geom).double()))
        rel = abs(lhs - rhs) / abs(lhs)
        print(f"[{phase}] adjointness, {geom.detectors_y} slice(s), {label}: "
              f"|<Ax,y>-<x,A^T y>|/|<Ax,y>| = {rel:.3e} (tol {TOL_ADJOINT:g})")
        require(rel <= TOL_ADJOINT, f"adjointness, {label}: {rel:.3e} > {TOL_ADJOINT:g}")


def check_pd_shapes(torch, PDT, errs, dev) -> None:
    """PD against its plain version at iteration counts around the K that
    one launch fuses (a single launch, a shorter last launch), on a volume
    its tiles do not divide, on one slice and on its 8 slices at most
    (``tt_pd_tv`` refuses 9); and PDw, the wavefront of more than 8 slices,
    on one slab (12, 17 and 20 slices) and on slabs with a halo in z (33 and
    70 slices, fewer iterations a sweep), on more than one y-segment (300
    rows)."""
    from tomobar_tpu_torch import _build

    deep = PDT.FUSE_Z_MAX + 1
    err = _build.library().tt_pd_tv(*[None] * 9, deep, 64, 64, 1.0, 0.1, 0.1, 1.0, 1, 1, 0, 1,
                                     1, 1, None)
    print(f"[3] tt_pd_tv on {deep} slices: error {err} (refused, no launch)")
    require(err != 0, f"tt_pd_tv took {deep} slices")
    rng = np.random.default_rng(32)
    for shape in ((3, 500, 510), (1, 500, 510), (8, 100, 120), (12, 100, 120),
                  (20, 100, 120), (17, 300, 130), (33, 100, 120), (70, 60, 200)):
        k = PDT.fuse(shape[0])
        key = "PDw" if shape[0] > PDT.FUSE_Z_MAX else "PD"
        clean = phantom(512, shape[0])[:, : shape[1], : shape[2]]
        data = torch.as_tensor(
            clean + 0.1 * rng.standard_normal(shape).astype(np.float32), device=dev)
        for iters in (1, k - 1, k + 1, 20):
            for mtv, nn in ((0, 1), (1, 0)):
                args = (data, 0.05, iters, mtv, nn, 12.0)
                errs.compare(
                    key, f"{'x'.join(map(str, shape))}, {iters} iterations ({k} per launch), "
                         f"methodTV={mtv} nonneg={nn}",
                    PDT.pd_tv(*args), PDT.pd_tv_plain(*args))
        args = (data, 0.05, k + 1, 0, 1, 12.0, True)
        errs.compare(key, f"{'x'.join(map(str, shape))}, {k + 1} iterations, bf16 duals",
                     PDT.pd_tv(*args), PDT.pd_tv_plain(*args), tol=TOL_PD_BF16)


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
    last result and the median ms (a call slowed by the host, 49.5 ms
    beside 26.0 and 26.7 ms on an NVIDIA H100 80GB HBM3 at 700 W, moves
    the mean of three calls by a third and the median not at all)."""
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
    return res, float(np.median(ms))


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
    their launches per FOURIER_INV call, the FOURIER_INV and FBP results
    (what the big stack of phase 9 is held against), FOURIER_INV's median
    ms and its ``fourier_breakdown`` (whose stages phase 15 holds to it)."""
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

    print(f"[7] FOURIER_INV by stage, fourier_breakdown {NA}x{NZ}x{N} on this sinogram:")
    fb = fourier_breakdown(N, NZ, NA, device=dev, data=clean)
    print(f"[7] fourier_breakdown: {json.dumps(fb)}")
    _, fi_staged, spectra = fourier_inv_by_stage(rt, clean)  # its marks go unread
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
    }, per_call, {"FOURIER_INV": fi, "FBP": fbp}, ms_fi, fb


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
                     K.unshear_bp_packed_plain(q, g.beta, U0, n, g.swap), tol=0.0)
        base = torch.randn((1, n, n), generator=gen, device=dev)
        errs.compare(
            "K4p", tag + ", accumulate",
            K.unshear_bp_packed(q, g.beta, U0, n, g.swap, out=base.clone()),
            K.unshear_bp_packed_plain(q, g.beta, U0, n, g.swap, out=base.clone()), tol=0.0,
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


def check_k4p_shapes(torch, K, errs, dev) -> None:
    """K4p against its plain version, bit for bit, new and adding into a
    slice: 520 columns (more than one column tile), 200 (less than one),
    lines of q that are not 16-byte aligned (an LU that is no multiple of 4:
    read from global memory), and 10 sparse angles."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector

    gen = torch.Generator(device=dev).manual_seed(84)
    for n, n_angles, cut in ((520, 90, 0), (200, 90, 0), (512, 90, 2), (512, 10, 0), (1024, 10, 0)):
        angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)
        for g in Projector(Geometry(n, 1, angles, 3.5, n))._plan.groups(n, n, dev, True):
            require(g.prm.packed, f"a {n}^2 slice must take the packed pair")
            LU = g.prm.LU - cut
            q = torch.randn((g.prm.A, 1, LU), generator=gen, device=dev)
            base = torch.randn((1, n, n), generator=gen, device=dev)
            tag = f"{n}^2, {'y' if g.swap else 'x'}-driven, {g.prm.A} of {n_angles} angles, LU {LU}"
            errs.compare("K4p", tag, K.unshear_bp_packed(q, g.beta, g.prm.U0, n, g.swap),
                         K.unshear_bp_packed_plain(q, g.beta, g.prm.U0, n, g.swap), tol=0.0)
            errs.compare(
                "K4p", tag + ", accumulate",
                K.unshear_bp_packed(q, g.beta, g.prm.U0, n, g.swap, out=base.clone()),
                K.unshear_bp_packed_plain(q, g.beta, g.prm.U0, n, g.swap, out=base.clone()),
                tol=0.0)


def residual(torch, rt, x, b) -> float:
    return float(torch.linalg.vector_norm(rt.Atools.fp(x) - b))


def two_d_path(torch, K, errs, measure, dev) -> dict:
    """8: the 2D path; returns the K1p/K4p launches of its main runs (2D
    FORWPROJ, FBP and FISTA) and their launches per outer FISTA iteration."""
    from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy, _build
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector, radon_fp

    # ---- 8a. K1p/K4p against their plain versions, adjointness ------------
    angles180 = np.linspace(0.0, np.pi, 180, endpoint=False)
    geoms = {
        "cor 3.5": Geometry(512, 1, angles180, 3.5, 512),
        "per-angle cor": Geometry(512, 1, angles180, 3.5 + 2.0 * np.sin(3.0 * angles180), 512),
    }
    for i, (label, geom) in enumerate(geoms.items()):
        print(f"[8] packed kernels, 512^2 x 180 angles, {label}:")
        check_packed_kernels(torch, K, errs, geom, dev, seed=81 + i)
    check_adjointness(torch, geoms, dev, 80, "8")
    print("[8] K1p at other row lengths, ny != nx, run counts and sparse angles, cor 3.5:")
    check_k1p_shapes(torch, K, errs, dev)
    print("[8] K4p at other sizes, unaligned lines of q and sparse angles, cor 3.5:")
    check_k4p_shapes(torch, K, errs, dev)

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
    data = noisy_sinogram(torch, rd.FORWPROJ(truth), 8)
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
        {k: round(time_cuda(fn, 5), 3) for k, fn in stages.items()}))
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
            errs.compare("K4p", f"flagship, {label}, against K4", k4p(), k4(), tol=0.0)
            if tag == "OS subset 0":
                measure("K1p", label, k1p, k1p_plain, work_shear(A, 1, N, N, LU), tol=0.0)
                measure("K4p", label, k4p, k4p_plain, work_unshear(A, 1, N, LU), tol=0.0)
            else:
                errs.compare("K1p", f"flagship, {label}", k1p(), k1p_plain(), tol=0.0)
                errs.compare("K4p", f"flagship, {label}", k4p(), k4p_plain(), tol=0.0)
                print(f"[8] K1p shear_fp_packed, {label}: kernel {time_cuda(k1p, 5):.3f} ms, "
                      f"plain {time_cuda(k1p_plain, 1):.3f} ms")
                print(f"[8] K4p unshear_bp_packed, {label}: kernel {time_cuda(k4p, 5):.3f} ms, "
                      f"plain {time_cuda(k4p_plain, 1):.3f} ms")
            print(f"[8] K1 at nz=1, {label}: {time_cuda(k1, 5):.3f} ms; "
                  f"K4 at nz=1: {time_cuda(k4, 5):.3f} ms")
    return {k: sum(launches[p].get(k, 0) for p in ("FORWPROJ", "FBP (sinc 1.1)", "FISTA"))
            for k in TWO_D}, per_call


def big_stack(torch, errs, dev, clean, angles, small):
    """9: a stack deeper than one launch can take (512 slices: the 2560^2
    volume has 3.4e9 voxels, the sinogram 2.4e9 samples), through the public
    entry points.  ``clean`` is phase 6's (8, angles, detX) sinogram, ``small``
    phase 7's 8-slice FOURIER_INV and FBP results.  Returns the launches and
    the shape-mode estimate of the FOURIER_INV call over its measured peak
    (phase 13 holds it)."""
    from tomobar_tpu_torch import RecToolsDIRCuPy, _build
    from tomobar_tpu_torch.ops import pd_tv as PDT
    from tomobar_tpu_torch.ops import projector as P
    from tomobar_tpu_torch.ops import usfft as US
    from tomobar_tpu_torch.regularisers import PD_TV
    from tomobar_tpu_torch.utils.memest import DeviceMemStack

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

    peaks = {}

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
        peaks[label] = peak - held
        return out

    _build.reset_launch_counts()
    rec = run(f"3D FBP (sinc) {NA}x{NZ}x{N}", lambda: rt.FBP(sino.transpose(0, 1)))
    for z0 in range(0, NZ, NZ8):
        require(torch.equal(rec[z0 : z0 + NZ8], small["FBP"]),
                f"FBP on {NZ} slices: slices {z0}..{z0 + NZ8 - 1} differ from the 8-slice result")
    print(f"[9] FBP: every block of {NZ8} slices equals phase 7's {NZ8}-slice result bit for bit")
    del rec
    n_chunks = US._fourier_inv_memory_chunks(NZ, N, {}, dev)
    # phase 13's plan at 512 slices: the shape-tuple dry run right before the
    # call, so that both see the same free memory (and chunk count)
    torch.cuda.synchronize()
    before, held = dict(_build.launch_counts), torch.cuda.memory_allocated(dev)
    with DeviceMemStack() as mem:
        shape = rt.FOURIER_INV(tuple(sino.shape))
    torch.cuda.synchronize()
    require(dict(_build.launch_counts) == before and torch.cuda.memory_allocated(dev) == held,
            "the shape-tuple dry run at 512 slices launched or allocated")
    label = f"FOURIER_INV {NA}x{NZ}x{N}, default kwargs ({n_chunks} z-chunks from the free memory)"
    rec = run(label, lambda: rt.FOURIER_INV(sino))
    require(tuple(shape) == tuple(rec.shape), f"shape mode gave {shape}")
    measured = peaks[label] + sino.numel() * 4  # the input lay on the card before the call
    plan = mem.highwater / measured
    print(f"[9] shape mode (checked in phase 13): {tuple(shape)}, no launch, no allocation; "
          f"estimate {mem.highwater / 2**30:.4f} GiB, measured peak plus the input "
          f"{measured / 2**30:.4f} GiB: ratio {plan:.4f}")
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
    # PDw against its plain version where the slices differ: the volume
    # times 1 + sin(0.7 z) / 2, the plain version on windows of 40 slices
    # with the wrapper's halo of 20 (its z-chunks equal the whole volume's
    # result bit for bit), across the kernel's slabs of 32
    del out
    vol.mul_((1.0 + 0.5 * torch.sin(0.7 * torch.arange(NZ, device=dev)))[:, None, None])
    out = run(f"PD-TV prox, 20 iterations, {NZ}x{N}x{N} varying along z", lambda: PD_TV(vol, *args))
    for z0 in (0, NZ // 2 - 21, NZ - 40):
        h0, h1 = max(0, z0 - 20), min(NZ, z0 + 60)
        errs.compare("PDw", f"{NZ}x{N}^2 slices {z0}-{z0 + 39}, the plain version on "
                     f"{h0}-{h1 - 1}", out[z0 : z0 + 40],
                     PDT.pd_tv_plain(vol[h0:h1], *args)[z0 - h0 : z0 - h0 + 40])
    del out, vol
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    print(f"[9] launch counts of the phase: {json.dumps(launches)}")
    for k in ("K3", "K4", "F", "G", "PDw"):
        require(launches.get(k, 0) > 0, f"kernel {k} was not launched by the big stack")
    return launches, plan


def noisy_sinogram(torch, clean, seed: int):
    """Poisson noise at 1e4 incident photons on a sinogram of a unit-radius
    field of view (pixel size 2/N), back to post-log pixel units."""
    px, i0 = 2.0 / clean.shape[-1], 1.0e4
    gen = torch.Generator(device=clean.device).manual_seed(seed)
    counts = torch.poisson(i0 * torch.exp(-clean * px), generator=gen)
    return -torch.log(torch.clamp(counts, min=1.0) / i0) / px


def prox_dict(method: str, extra: dict, lam: float, iterations: int) -> dict:
    """A regularisation dict as ``dicts_check`` completes it."""
    return dict({"method": method, "regul_param": lam, "iterations": iterations,
                 "time_marching_step": 0.002, "methodTV": 0, "PD_LipschitzConstant": 12.0,
                 "regul_param2": 0.02, "edge_param": 0.1}, **extra)


def regularisers_on_card(torch, dev) -> None:
    """10: every prox on the GPU against the CPU, then their times at the
    flagship volume and patch_select + NLTV on one flagship slice."""
    from types import SimpleNamespace

    from tomobar_tpu_torch import regularisers_legacy as RL
    from tomobar_tpu_torch.regularisers import prox_regul

    rng = np.random.default_rng(10)
    small = phantom(64, 4) + 0.1 * rng.standard_normal((4, 64, 64)).astype(np.float32)
    cpu3 = torch.as_tensor(small)
    worst = 0.0
    for label, method, extra, nn in PROX_CASES:
        owner = SimpleNamespace(nonneg_regul=nn)
        reg = prox_dict(method, extra, 0.05, 20)
        for dims, x in (("3D", cpu3), ("2D", cpu3[0])):
            ref = prox_regul(owner, x, dict(reg))
            got = prox_regul(owner, x.to(dev), dict(reg))
            require(tuple(got.shape) == tuple(ref.shape), f"{label} {dims}: shape {tuple(got.shape)}")
            require(bool(torch.isfinite(got).all()), f"{label} {dims}: non-finite GPU result")
            rel = rel_l2(torch, got.cpu(), ref)
            worst = max(worst, rel)
            require(rel <= TOL_SLICE, f"{label} {dims}: GPU vs CPU {rel:.3e} > {TOL_SLICE:g}")
    print(f"[10] {len(PROX_CASES)} proxes of 20 iterations, 4x64^2 and 64^2: worst rel L2 GPU vs "
          f"CPU {worst:.3e} (tol {TOL_SLICE:g})")
    # NLTV: patch_select on both devices, then NLTV on the CPU's tables
    img = cpu3[0]
    tables = RL.patch_select(img)
    on_card = RL.patch_select(img.to(dev))
    differ = int(((on_card[0].cpu() != tables[0]) | (on_card[1].cpu() != tables[1])).sum())
    w_err = float((on_card[2].cpu() - tables[2]).abs().max())
    print(f"[10] patch_select 64^2 (search 9, patch 2, 15 neighbours): {differ} of "
          f"{tables[0].numel()} table entries differ GPU vs CPU, weights max|diff| {w_err:.3e}")
    require(differ == 0 and w_err <= 1e-5, "patch_select: GPU vs CPU")
    reg = {"method": "NLTV", "regul_param": 0.03, "NLTV_H_i": tables[0], "NLTV_H_j": tables[1],
           "NLTV_Weights": tables[2], "IterNumb": 5}
    ref = prox_regul(None, img, dict(reg))
    got = prox_regul(None, img.to(dev), dict(reg))
    rel = rel_l2(torch, got.cpu(), ref)
    print(f"[10] NLTV 64^2, 5 iterations: rel L2 GPU vs CPU {rel:.3e} (tol {TOL_SLICE:g})")
    require(rel <= TOL_SLICE, f"NLTV: GPU vs CPU {rel:.3e}")

    # one prox of 20 iterations on the flagship volume
    N, NZ = 2560, 8
    gen = torch.Generator(device=dev).manual_seed(11)
    vol = torch.as_tensor(phantom(N, NZ), device=dev)
    vol = vol + 0.05 * torch.randn(vol.shape, generator=gen, device=dev)
    times = {}
    for label, method, extra, nn in PROX_CASES:
        owner = SimpleNamespace(nonneg_regul=nn)
        reg = prox_dict(method, extra, 5e-4, 20)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = time_cuda(lambda: prox_regul(owner, vol, dict(reg)), 2)
        peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**20
        times[label] = {"ms": round(ms, 3), "peak_mib_above_input": round(peak, 1)}
        print(f"[10] {label}, one prox of 20 iterations on {NZ}x{N}x{N}: {ms:.3f} ms, "
              f"peak {peak:.1f} MiB above the {held / 2**20:.1f} MiB held")
    print("[10] proxes at the flagship (ms, MiB): " + json.dumps(times))
    del vol

    # patch_select + NLTV on one flagship slice, or the largest square that fits
    for n in (2560, 2048, 1536, 1024):
        img = torch.as_tensor(shepp_logan(n), device=dev)
        img = img + 0.05 * torch.randn(img.shape, generator=gen, device=dev)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            tables = RL.patch_select(img)
            torch.cuda.synchronize()
            t_ps = time.perf_counter() - t0
            reg = {"method": "NLTV", "regul_param": 0.03, "NLTV_H_i": tables[0],
                   "NLTV_H_j": tables[1], "NLTV_Weights": tables[2], "IterNumb": 5}
            ms = time_cuda(lambda: prox_regul(None, img, dict(reg)), 2)
        except torch.cuda.OutOfMemoryError:
            print(f"[10] patch_select + NLTV at {n}^2: out of device memory, next size down")
            tables = reg = None
            torch.cuda.empty_cache()
            continue
        peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**30
        out = prox_regul(None, img, dict(reg))
        require(bool(torch.isfinite(out).all()) and tuple(out.shape) == (n, n), "NLTV: bad result")
        print(f"[10] patch_select at {n}^2{' (the flagship slice)' if n == N else ''} "
              f"(search 9, patch 2, 15 neighbours): {t_ps * 1e3:.1f} ms wall; NLTV, 5 "
              f"iterations: {ms:.3f} ms; peak {peak:.2f} GiB above what was held")
        break
    else:
        raise SmokeFailure("patch_select + NLTV fit at no size down to 1024^2")
    del tables, reg, img


def timed_call(torch, fn):
    """fn() between CUDA events; returns its result and ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def fista_calls(torch, rt, data: dict, iters, lc: float, reg: dict, after=None):
    """FISTA calls of ``iters`` outer iterations (nonneg), each between CUDA
    events, ``after()`` run after each; returns the results and their ms."""
    recs, ms = [], []
    for it in iters:
        rec, t = timed_call(torch, lambda: rt.FISTA(
            dict(data), {"iterations": it, "nonnegativity": True, "lipschitz_const": lc},
            dict(reg)))
        recs.append(rec)
        ms.append(t)
        if after is not None:
            after()
    return recs, ms


def total_variation(torch, x) -> float:
    """Isotropic total variation of a (nz, n, n) volume, forward differences
    along every axis, summed in float64."""
    x = x.double()
    d2 = torch.zeros_like(x)
    for ax in range(3):
        d = torch.diff(x, dim=ax)
        d2.narrow(ax, 0, d.shape[ax]).add_(d * d)
    return float(torch.sqrt(d2).sum())


def legacy_main_path(torch, dev, clean, angles, lc: float) -> dict:
    """11: FISTA with the FGP-TV prox on phase 6's data (its Lipschitz
    constant ``lc``) and on the 2D flagship; returns the launches."""
    from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy, _build
    from tomobar_tpu_torch.regularisers_legacy import FGP_TV

    NZ, NA, N = clean.shape
    OS = 10
    reg = {"method": "FGP_TV", "regul_param": 5e-4, "iterations": 20}
    truth = torch.as_tensor(phantom(N, NZ), device=dev)
    data = {"projection_data": noisy_sinogram(torch, clean, 6), "data_fidelity": "PWLS"}
    rt = RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N, OS_number=OS, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    recs, ms = fista_calls(torch, rt, data, (1, 2, 3), lc, reg)
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[11] launch counts, FISTA 1+2+3 with FGP_TV: {json.dumps(launches)}")
    for k in PROJECTOR_3D:
        require(launches.get(k, 0) > 0, f"kernel {k} was not launched by FISTA with FGP_TV")
    rmse = []
    for it, rec, t in zip((1, 2, 3), recs, ms):
        require(tuple(rec.shape) == (NZ, N, N), f"FGP_TV FISTA shape {tuple(rec.shape)}")
        require(bool(torch.isfinite(rec).all()), f"FGP_TV FISTA: non-finite after {it}")
        rmse.append(float(torch.sqrt(torch.mean((rec - truth) ** 2))))
        print(f"[11] FISTA-OS10-PWLS-FGP_TV20 {it} outer iteration(s): {t:.1f} ms, "
              f"RMSE vs phantom {rmse[-1]:.6f}")
    print(f"[11] per-outer-iteration ms (call 1, then differences of calls): "
          f"{ms[0]:.1f}, {ms[1] - ms[0]:.1f}, {ms[2] - ms[1]:.1f}; peak {peak / 2**20:.1f} MiB")
    require(rmse[0] > rmse[1] > rmse[2], f"FGP_TV FISTA RMSE does not fall: {rmse}")
    x = recs[-1].contiguous()
    del recs
    prox = FGP_TV(x, 5e-4, 20, 0, 1)
    moved = rel_l2(torch, prox, x)
    tv_x, tv_prox = total_variation(torch, x), total_variation(torch, prox)
    print(f"[11] one FGP_TV prox on the last iterate: moves it by rel L2 {moved:.3e}, "
          f"total variation {tv_x:.6e} -> {tv_prox:.6e}")
    require(moved > 1e-6, f"the FGP_TV prox moved the iterate by {moved:.3e}, no more than rounding")
    require(tv_prox < tv_x, f"the FGP_TV prox did not lower the total variation: {tv_x} -> {tv_prox}")
    del prox
    b0 = rt.Atools.sino_subset(data["projection_data"], 0)
    stages = {
        "fp_sub (K1 x2, K2 x2)": lambda: rt.Atools.fp_sub(x, 0),
        "bp_sub (K3 x2, K4 x2)": lambda: rt.Atools.bp_sub(b0, 0),
        "FGP_TV prox, 20 iterations": lambda: FGP_TV(x, 5e-4, 20, 0, 1),
    }
    print("[11] one OS subset by stage (ms): " + json.dumps(
        {k: round(time_cuda(fn, 5), 3) for k, fn in stages.items()}))
    del b0, x, data, truth

    # the 2D flagship, OS10, LS
    truth = torch.as_tensor(shepp_logan(N), device=dev)
    rd = RecToolsDIRCuPy(N, 0, None, 0.0, angles, N, device=dev)
    data = {"projection_data": noisy_sinogram(torch, rd.FORWPROJ(truth), 8)}
    rt = RecToolsIRCuPy(N, 0, None, 0.0, angles, N, OS_number=OS, device=dev)
    lc2 = rt.powermethod(dict(data))
    _build.reset_launch_counts()
    recs, ms = fista_calls(torch, rt, data, (1, 3), lc2, reg)
    two_d = {k: v for k, v in _build.launch_counts.items() if v}
    print(f"[11] 2D launch counts, FISTA 1+3 with FGP_TV: {json.dumps(two_d)}")
    for k in PROJECTOR_2D:
        require(two_d.get(k, 0) > 0, f"kernel {k} was not launched by 2D FISTA with FGP_TV")
    rmse = [float(torch.sqrt(torch.mean((rec[0] - truth) ** 2))) for rec in recs]
    for it, rec, t, e in zip((1, 3), recs, ms, rmse):
        require(bool(torch.isfinite(rec).all()), f"2D FGP_TV FISTA: non-finite after {it}")
        print(f"[11] 2D FISTA-OS10-LS-FGP_TV20 {it} outer iteration(s): {t:.2f} ms, "
              f"RMSE vs phantom {e:.6f}")
    require(rmse[0] > rmse[1], f"2D FGP_TV FISTA RMSE does not fall: {rmse}")
    x = recs[-1]
    b0 = rt.Atools.sino_subset(data["projection_data"][None], 0)
    stages = {
        "fp_sub (K1p x2, K2 x2)": lambda: rt.Atools.fp_sub(x, 0),
        "bp_sub (K3 x2, K4p x2)": lambda: rt.Atools.bp_sub(b0, 0),
        "FGP_TV prox, 20 iterations": lambda: FGP_TV(x, 5e-4, 20, 0, 1),
    }
    print("[11] 2D, one OS subset by stage (ms): " + json.dumps(
        {k: round(time_cuda(fn, 5), 3) for k, fn in stages.items()}))
    for k, v in two_d.items():
        launches[k] = launches.get(k, 0) + v
    return launches


def joseph_on_card(torch, dev) -> None:
    """12: the one-pass Joseph pair, chosen by the projector backend switch,
    and FOURIER_INV below n = 128 under the gridding backend names; "auto"
    is put back whatever happens."""
    from tomobar_tpu_torch import RecToolsDIRCuPy, _build
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops import projector as P
    from tomobar_tpu_torch.ops import usfft as US

    angles90 = np.linspace(0.0, np.pi, 90, endpoint=False)
    geom = Geometry(256, 4, angles90, 0.0, 256)
    gen = torch.Generator(device=dev).manual_seed(12)
    vol = torch.as_tensor(phantom(256, 4), device=dev)
    two_pass = P.radon_fp(vol, geom)
    P.set_projector_backend("xla")
    try:
        # positive inputs: a random-signed pair cancels in <Ax, y>
        x = torch.rand((4, 256, 256), generator=gen, device=dev)
        y = torch.rand((4, 90, 256), generator=gen, device=dev)
        _build.reset_launch_counts()
        ax, aty = P.radon_fp(x, geom), P.radon_bp(y, geom)
        lhs = float(torch.sum(ax.double() * y.double()))
        rhs = float(torch.sum(x.double() * aty.double()))
        rel = abs(lhs - rhs) / abs(lhs)
        print(f"[12] Joseph adjointness 256^2x4x90: {rel:.3e} (tol {TOL_ADJOINT:g})")
        require(rel <= TOL_ADJOINT, f"Joseph adjointness {rel:.3e} > {TOL_ADJOINT:g}")
        for label, got, ref in (("FP", ax, P.radon_fp(x.cpu(), geom)),
                                ("BP", aty, P.radon_bp(y.cpu(), geom))):
            rel = rel_l2(torch, got.cpu(), ref)
            print(f"[12] Joseph {label} 256^2x4x90: rel L2 GPU vs CPU {rel:.3e} (tol {TOL_SLICE:g})")
            require(rel <= TOL_SLICE, f"Joseph {label}: GPU vs CPU {rel:.3e}")
        joseph = P.radon_fp(vol, geom)
        require(all(v == 0 for v in _build.launch_counts.values()),
                f"the Joseph pair launched kernels: {dict(_build.launch_counts)}")
        print(f"[12] Joseph FP against the two-pass pair, phantom 256^2x4x90: rel L2 "
              f"{rel_l2(torch, joseph, two_pass):.3e}; no kernel launched")
        # one FP and one BP at the 2D flagship
        N, NA = 2560, 1801
        flag = Geometry(N, 1, np.linspace(0.0, np.pi, NA, endpoint=False), 0.0, N)
        img = torch.as_tensor(shepp_logan(N), device=dev)
        sino = P.radon_fp(img, flag)
        for label, fn in (("FP", lambda: P.radon_fp(img, flag)),
                          ("BP", lambda: P.radon_bp(sino, flag))):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            ms = time_cuda(fn, 2)
            peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**20
            print(f"[12] Joseph {label} at the 2D flagship {N}^2 x {NA}: {ms:.1f} ms; peak "
                  f"{peak:.1f} MiB above what was held")
        del sino, img
    finally:
        P.set_projector_backend("auto")
    # FOURIER_INV below n = 128 grids with G under every backend name
    n, angles60 = 64, np.linspace(0.0, np.pi, 60, endpoint=False)
    sino = P.radon_fp(torch.as_tensor(phantom(n, 4), device=dev), Geometry(n, 4, angles60, 0.0, n))
    ref = RecToolsDIRCuPy(n, 0, 4, 0.0, angles60, n, device="cpu").FOURIER_INV(sino.cpu())
    rt = RecToolsDIRCuPy(n, 0, 4, 0.0, angles60, n, device=dev)
    for name in ("auto", "xla"):
        US.set_usfft_backend(name)
        try:
            _build.reset_launch_counts()
            got = rt.FOURIER_INV(sino)
            g = _build.launch_counts["G"]
        finally:
            US.set_usfft_backend("auto")
        rel = rel_l2(torch, got.cpu(), ref)
        print(f"[12] FOURIER_INV {n}^2x4x60 under set_usfft_backend({name!r}): {g} G launch(es), "
              f"rel L2 GPU vs CPU {rel:.3e} (tol {TOL_SLICE:g})")
        require(g > 0, f"FOURIER_INV at n = {n} under {name!r} did not launch G")
        require(rel <= TOL_SLICE, f"FOURIER_INV at n = {n} under {name!r}: GPU vs CPU {rel:.3e}")


def raw_stack(torch, clean, gen):
    """Raw counts for a (detY, angles, detX) sinogram of unit-radius line
    integrals: ``flat * exp(-p)`` with Poisson noise plus a dark frame (read
    noise), 20 flats (the fixed pattern, Poisson noise, a dark frame each)
    and 10 darks; the stack as [angles, detY, detX].  Returns the raw stack,
    flats, darks and the flat field's pattern (detY, detX)."""
    NZ, _, N = clean.shape
    dev = clean.device
    x = torch.arange(N, device=dev, dtype=torch.float32)
    y = torch.arange(NZ, device=dev, dtype=torch.float32)
    pattern = (1.0 + 0.05 * torch.cos(2 * np.pi * x / 300.0)[None, :] * torch.cos(y / 3.0)[:, None]
               + 0.02 * torch.rand((NZ, N), generator=gen, device=dev))
    flat = I0_RAW * pattern

    def dark_frames(*shape):
        return DARK_LEVEL + DARK_NOISE * torch.randn(shape, generator=gen, device=dev)

    raw = torch.poisson(flat[:, None, :] * torch.exp(-clean), generator=gen) + dark_frames(*clean.shape)
    flats = torch.poisson(flat.expand(N_FLATS, NZ, N).contiguous(), generator=gen) + dark_frames(N_FLATS, NZ, N)
    darks = dark_frames(N_DARKS, NZ, N)
    return raw.transpose(0, 1).contiguous(), flats, darks, flat


def raw_to_reconstruction(torch, dev, angles, plan_512) -> dict:
    """13: raw projections to a reconstruction through the port's
    preprocessing and memory planning, on phase 6's phantom and angles;
    returns the launches of its path.  ``plan_512`` is phase 9's shape-mode
    estimate over its measured peak."""
    from tomobar_tpu_torch import RecToolsDIRCuPy, _build, native
    from tomobar_tpu_torch.utils.center import find_center_correlation
    from tomobar_tpu_torch.utils import memest as ME
    from tomobar_tpu_torch.utils.memest import DeviceMemStack
    from tomobar_tpu_torch.utils.tools import autocropper, normaliser

    N, NZ, NA = 2560, 8, len(angles)
    px = 2.0 / N  # pixel size of the unit-radius field of view
    t_phase = time.perf_counter()
    require(native.available(), "the native preprocessing library did not build")
    truth = torch.as_tensor(phantom(N, NZ), device=dev)
    rt_true = RecToolsDIRCuPy(N, 0, NZ, C_TRUE, angles, N, device=dev)
    clean = rt_true.FORWPROJ(truth) * px  # [detY, angles, detX]
    gen = torch.Generator(device=dev).manual_seed(13)
    raw, flats, darks, flat = raw_stack(torch, clean, gen)
    raw_np, flats_np, darks_np = (a.cpu().numpy() for a in (raw, flats, darks))
    torch.cuda.synchronize()
    print(f"[13] raw stack {tuple(raw.shape)} [angles, detY, detX], {raw.numel() * 4 / 1e6:.1f} MB; "
          f"{N_FLATS} flats, {N_DARKS} darks; CoR offset {C_TRUE} px; made in "
          f"{time.perf_counter() - t_phase:.2f} s")

    # ---- normalise: the host (native fused pass) and the card -------------
    _build.reset_launch_counts()
    norm = {}
    for method in ("mean", "median"):
        t0 = time.perf_counter()
        host = normaliser(raw_np, flats_np, darks_np, method=method)
        t_host = (time.perf_counter() - t0) * 1e3
        normaliser(raw, flats, darks, method=method)  # warm-up
        t_dev = time_cuda(lambda: normaliser(raw, flats, darks, method=method), 5)
        norm[method] = normaliser(raw, flats, darks, method=method)
        rel = rel_l2(torch, norm[method].cpu(), torch.from_numpy(host))
        print(f"[13] normaliser {method}: host (native) {t_host:.1f} ms, card {t_dev:.3f} ms; "
              f"rel L2 card vs host {rel:.3e} (tol {TOL_NORMALISE:g})")
        require(rel <= TOL_NORMALISE, f"normaliser {method}: card vs host {rel:.3e}")
    del raw_np, host
    p = clean.transpose(0, 1)  # [angles, detY, detX], as the normalised stack
    # the noise the stack should carry (delta method): the counts' Poisson
    # and read noise, and the mean flat's, where the ratio is not clamped
    counts = flat[None] * torch.exp(-p)
    var = (counts + DARK_NOISE**2 * (1 + 1 / N_DARKS)) / counts**2 + 1.0 / (N_FLATS * flat[None])
    predicted = float(torch.sqrt(var.sum()) / torch.linalg.vector_norm(p))
    measured = rel_l2(torch, norm["mean"], p)
    print(f"[13] normalised (mean) against the clean sinogram: rel L2 {measured:.4e}, the noise "
          f"predicts {predicted:.4e} (ratio {measured / predicted:.3f}, allowed 0.8-1.25)")
    require(0.8 <= measured / predicted <= 1.25, "the normalised stack is not at the noise level")
    del counts, var

    # ---- crop box ------------------------------------------------------------
    cropped = autocropper(norm["mean"], 20, 20)
    offset = cropped.storage_offset()
    up, lft = offset // N, offset % N
    down, rgt = up + cropped.shape[1], lft + cropped.shape[2]
    cols = torch.nonzero(clean.amax(dim=(0, 1)) > 0.01 * clean.max()).flatten()
    rows = torch.nonzero(clean.amax(dim=(1, 2)) > 0.01 * clean.max()).flatten()
    c0, c1, r0, r1 = (int(v) for v in (cols.min(), cols.max(), rows.min(), rows.max()))
    print(f"[13] autocropper (addbox 20, strips 20): rows {up}:{down}, columns {lft}:{rgt}; the "
          f"clean sinogram exceeds 1% of its max in rows {r0}..{r1}, columns {c0}..{c1}")
    require(up <= r0 and down > r1 and lft <= c0 and rgt > c1, "the crop box cuts the object")

    # ---- centre ------------------------------------------------------------
    stack = norm["mean"].transpose(0, 1)  # [detY, angles, detX]
    c_jax = find_center_correlation(stack, angles)
    c_mid = find_center_correlation(stack[NZ // 2 : NZ // 2 + 1], angles, stack=True)
    c_found = find_center_correlation(stack, angles, stack=True)
    print(f"[13] centre: the JAX package's estimator (middle slice, rows less their mean) "
          f"{c_jax:.4f}; stack=True on the middle slice {c_mid:.4f}, on all {NZ} slices "
          f"{c_found:.4f}; true {C_TRUE} (error {c_found - C_TRUE:+.4f}, tol {TOL_CENTRE})")
    require(abs(c_found - C_TRUE) <= TOL_CENTRE, f"centre {c_found:.4f} is not within {TOL_CENTRE} px")

    # ---- plan: the shape-tuple dry run, then the real call ------------------
    sino = (stack / px).contiguous()  # pixel units, [detY, angles, detX]
    by_angle = norm["mean"] / px
    rt = RecToolsDIRCuPy(N, 0, NZ, c_found, angles, N, device=dev)
    torch.cuda.synchronize()
    before = dict(_build.launch_counts)
    held = torch.cuda.memory_allocated(dev)
    with DeviceMemStack() as mem:
        shape = rt.FOURIER_INV(tuple(sino.shape))
    torch.cuda.synchronize()
    require(dict(_build.launch_counts) == before, "the shape-tuple dry run launched a kernel")
    require(torch.cuda.memory_allocated(dev) == held, "the shape-tuple dry run allocated")
    require(mem.current == 0 and mem.highwater > 0, "DeviceMemStack not balanced")
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fi = rt.FOURIER_INV(sino)
    end.record()
    torch.cuda.synchronize()
    ms_fi = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(dev) - held + sino.numel() * 4
    require(tuple(shape) == tuple(fi.shape), f"shape mode gave {shape}, the call {tuple(fi.shape)}")
    print(f"[13] plan, FOURIER_INV{tuple(sino.shape)}: shape mode {tuple(shape)} with no launch and "
          f"no allocation; estimate {mem.highwater / 2**30:.4f} GiB, measured peak (above what was "
          f"held, plus the input on the card) {peak / 2**30:.4f} GiB: ratio {mem.highwater / peak:.4f}")
    for label, ratio in (("8 slices", mem.highwater / peak), ("512 slices (phase 9)", plan_512)):
        require(1.0 <= ratio <= 1.3, f"memory estimate at {label}: {ratio:.4f} of the measured peak")
    print(f"[13] estimate / measured peak: 8 slices {mem.highwater / peak:.4f}, 512 slices "
          f"{plan_512:.4f} (allowed 1.0-1.3)")
    # cuFFT's work area along the last axis (the STEP1 transform's shape, and
    # a filter-stage row length), which the model counts as CUFFT_WORK
    for fft_shape in ((NZ // 2, NA, N), (NZ // 2, NA, 8192)):
        x = torch.zeros(fft_shape, dtype=torch.complex64, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before_fft = torch.cuda.memory_allocated(dev)
        y = torch.fft.fft(x, dim=-1)
        torch.cuda.synchronize()
        work = torch.cuda.max_memory_allocated(dev) - before_fft - y.numel() * 8
        print(f"[13] cuFFT work area of torch.fft along the last axis of {fft_shape}: {work} bytes "
              f"(the model counts {ME.CUFFT_WORK})")
        require(work <= ME.CUFFT_WORK, "cuFFT's work area exceeds the memory model's")
        del x, y

    # ---- reconstruct at the found centre -----------------------------------
    start.record()
    fbp = rt.FBP(by_angle)
    end.record()
    torch.cuda.synchronize()
    ms_fbp = start.elapsed_time(end)
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    print(f"[13] at the found centre, first calls: FOURIER_INV {ms_fi:.2f} ms, FBP (sinc) "
          f"{ms_fbp:.2f} ms; launches of the path {json.dumps(launches)}")
    for k in ("G", "F", "K3", "K4"):
        require(launches.get(k, 0) > 0, f"kernel {k} was not launched by the raw-to-recon path")
    print(f"[13] the next calls: FOURIER_INV {time_cuda(lambda: rt.FOURIER_INV(sino), 3):.2f} ms, "
          f"FBP (sinc) {time_cuda(lambda: rt.FBP(by_angle), 3):.2f} ms")
    # images are compared binned BIN x BIN: at 1e4 photons the noise of a
    # direct reconstruction is larger than the phantom's contrast pixel by
    # pixel, and moves with the centre (both printed unbinned too)
    M = N // BIN
    yy, xx = np.mgrid[0:M, 0:M]
    inside = torch.as_tensor(np.hypot(yy - (M - 1) / 2, xx - (M - 1) / 2) < M / 2 - 1, device=dev)

    def binned(x):
        return x.reshape(x.shape[0], M, BIN, M, BIN).mean(dim=(2, 4))

    truth_b = binned(truth)
    clean_px = clean / px
    # what the centre tolerance allows: the true centre against a shift of it
    rt_tol = RecToolsDIRCuPy(N, 0, NZ, C_TRUE + TOL_CENTRE, angles, N, device=dev)
    for label, got, run_found, run_true, run_tol in (
        ("FOURIER_INV", fi, rt.FOURIER_INV, rt_true.FOURIER_INV, rt_tol.FOURIER_INV),
        ("FBP", fbp, lambda s: rt.FBP(s.transpose(0, 1)), lambda s: rt_true.FBP(s.transpose(0, 1)),
         lambda s: rt_tol.FBP(s.transpose(0, 1))),
    ):
        got_b = binned(got)
        corr = min(float(torch.corrcoef(torch.stack([got_b[z][inside], truth_b[z][inside]]))[0, 1])
                   for z in range(NZ))
        corr_full = min(float(torch.corrcoef(torch.stack([got[z].flatten(), truth[z].flatten()]))[0, 1])
                        for z in range(NZ))
        true_noisy = run_true(sino)
        found_clean, true_clean = run_found(clean_px), run_true(clean_px)
        tol_b = rel_l2(torch, binned(run_tol(clean_px)), binned(true_clean))
        rel = {
            "clean, binned": rel_l2(torch, binned(found_clean), binned(true_clean)),
            "clean": rel_l2(torch, found_clean, true_clean),
            "normalised, binned": rel_l2(torch, got_b, binned(true_noisy)),
            "normalised": rel_l2(torch, got, true_noisy),
        }
        print(f"[13] {label}: against the phantom, min corr over slices {corr:.4f} binned {BIN}x{BIN} "
              f"inside the inscribed circle (min {MIN_CORR_PHANTOM}), {corr_full:.4f} unbinned; found "
              f"vs true centre, rel L2 " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
              + f"; a {TOL_CENTRE} px shift of the true centre: {tol_b:.3e} (clean, binned; the "
              f"found centre's must not exceed it)")
        require(corr >= MIN_CORR_PHANTOM, f"{label}: correlation with the phantom {corr:.4f}")
        require(rel["clean, binned"] <= tol_b,
                f"{label}: found vs true centre {rel['clean, binned']:.3e} > {tol_b:.3e}")
    del fi, fbp, got, got_b, true_noisy, found_clean, true_clean, sino, by_angle, clean_px

    # ---- dynamic flat fields: host numpy/scipy on a cut -----------------------
    cut = (slice(None), slice(0, 180), slice(0, 640))  # [detY, frames, detX]
    d_raw = raw.transpose(0, 1)[cut].cpu().numpy()
    d_flats = flats.transpose(0, 1)[:, :, :640].cpu().numpy()
    d_darks = darks.transpose(0, 1)[:, :, :640].cpu().numpy()
    t0 = time.perf_counter()
    dyn = normaliser(d_raw, d_flats, d_darks, method="dynamic", axis=1)
    t_dyn = time.perf_counter() - t0
    ref = normaliser(d_raw, d_flats, d_darks, method="mean", axis=1)
    require(dyn.shape == d_raw.shape and np.isfinite(dyn).all(), "dynamic: bad result")
    print(f"[13] dynamic flat fields (host), cut to 180 projections x {NZ} x 640: {t_dyn:.2f} s; "
          f"rel L2 against the mean method {np.linalg.norm(dyn - ref) / np.linalg.norm(ref):.3e}")
    print(f"[13] the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def flagship_data(torch, dev):
    """6's inputs: the angles, the phantom, its clean sinogram and the
    noisy one (seed 6), on ``dev``."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import radon_fp

    N, NZ, NA, _ = FLAGSHIP
    angles = np.linspace(0.0, np.pi, NA, endpoint=False)
    truth = torch.as_tensor(phantom(N, NZ), device=dev)
    clean = radon_fp(truth, Geometry(N, NZ, angles, 0.0, N))
    return angles, truth, clean, noisy_sinogram(torch, clean, 6)


def sharded_references(torch, dev):
    """14's inputs and references made as phases 6 and 7 make them, without
    their checks (``tools/torch_sharded_flagship.py`` runs 14 alone).
    Returns the work directory, the references and the single card's FISTA
    ms."""
    from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy

    N, NZ, _, OS = FLAGSHIP
    angles, truth, clean, data = flagship_data(torch, dev)
    rt = RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N, OS_number=OS)
    lc = rt.powermethod({"projection_data": data, "data_fidelity": "PWLS"})
    recs, ms = fista_calls(torch, rt, {"projection_data": data, "data_fidelity": "PWLS"},
                           (1, 2, 3), lc, FLAGSHIP_REG)
    work, refs = sharded_inputs(rt, data, truth, recs, lc)
    rd = RecToolsDIRCuPy(N, 0, NZ, 0.0, angles, N, device=dev)
    sharded_direct_inputs(work, refs, clean, {"FOURIER_INV": rd.FOURIER_INV(clean),
                                              "FBP": rd.FBP(clean.transpose(0, 1))})
    return work, refs, ms


def sharded_inputs(rt, data, truth, recs, lc: float):
    """14's inputs from phase 6 (files its ranks read, in a temporary
    directory removed at exit) and its references (host copies): ``rt`` the
    flagship's ``RecToolsIRCuPy``, ``data`` its noisy sinogram, ``truth``
    the phantom, ``recs`` FISTA after 1, 2, 3 outer iterations, ``lc`` the
    Lipschitz constant.  Returns the directory and the references."""
    work = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    x = recs[-1].contiguous()
    refs = {"fp_sub0": rt.Atools.fp_sub(x, 0).cpu().numpy(),
            "bp_sub0": rt.Atools.bp_sub(rt.Atools.sino_subset(data, 0), 0).cpu().numpy(),
            "truth": truth.cpu().numpy().astype(np.float64)}
    for i, out in enumerate(recs):
        refs[f"fista{i + 1}"] = out.cpu().numpy()
    np.save(os.path.join(work, "data.npy"), data.cpu().numpy())
    np.save(os.path.join(work, "x3.npy"), refs["fista3"])
    NZ, NA, N = data.shape
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump({"N": N, "NZ": NZ, "NA": NA, "OS": rt.OS_number, "lc": lc}, f)
    return work, refs


def sharded_direct_inputs(work: str, refs: dict, clean, small: dict) -> None:
    """14's inputs from phase 7: its clean sinogram and its FOURIER_INV and
    FBP results."""
    refs.update({k: v.cpu().numpy() for k, v in small.items()})
    np.save(os.path.join(work, "clean.npy"), clean.cpu().numpy())


def sharded_rank(work: str, n_z: int, n_a: int, backend: str) -> int:
    """14, one rank (``--sharded-rank``): its slab of phase 6's flagship
    through the sharded layer; rank 0 writes the gathered results and every
    rank its report (launches, ms, peak memory, collective bytes, and what
    the collectives of one more outer iteration counted, which phase 15
    holds the collective model to)."""
    import torch
    import torch.distributed as dist

    from tomobar_tpu_torch import RecToolsDIRCuPy, _build
    from tomobar_tpu_torch.bench.scaling import count_collectives_in_step
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.parallel import (
        ShardedDirect, ShardedProjector, comm, distributed_init, make_mesh, sharded_regul_fn)
    from tomobar_tpu_torch.solvers import core as solvers
    from tomobar_tpu_torch.utils.tools import check_kwargs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(work, "config.json")) as f:
        cfg = json.load(f)
    dev = distributed_init(backend=backend)
    rank = dist.get_rank()
    mesh = make_mesh(n_z, n_a)
    N, NZ, NA, OS = cfg["N"], cfg["NZ"], cfg["NA"], cfg["OS"]
    angles = np.linspace(0.0, np.pi, NA, endpoint=False)
    sp = ShardedProjector(Geometry(N, NZ, angles, 0.0, N, os_number=OS), mesh)

    def load(name):
        return np.load(os.path.join(work, name + ".npy"), mmap_mode="r")

    data = sp.device_put_sino(load("data"))
    x3 = sp.device_put_vol(load("x3"))
    reg = sharded_regul_fn(mesh, FLAGSHIP_REG, nonneg=True)
    keep = {}

    def gather(name, t):
        # every rank of the z group calls it; its bytes are not the path's
        path_stats = {op: dict(v) for op, v in comm.stats.items()}
        full = sp.gather_vol(t)
        comm.stats.clear()
        comm.stats.update(path_stats)
        if rank == 0:
            keep[name] = full.cpu().numpy()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    _build.reset_launch_counts()
    comm.reset_stats()
    gather("fp_sub0", sp.fp_sub(x3, 0))
    gather("bp_sub0", sp.bp_sub(sp.sino_subset(data, 0), 0))
    del x3
    ms = []
    for iters in (1, 2, 3):
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x = solvers.fista(sp, data, iters, cfg["lc"], nonnegativity=True, fidelity="PWLS",
                          regul_fn=reg)
        x = check_kwargs(x, recon_mask_radius=1.0)  # as RecToolsIRCuPy.FISTA ends
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        gather(f"fista{iters}", x)
    path = dict(_build.launch_counts)
    path_stats = {op: dict(v) for op, v in comm.stats.items()}
    step_comm = count_collectives_in_step(mesh, sp, data, cfg["lc"], FLAGSHIP_REG)
    comm.stats.clear()
    comm.stats.update(path_stats)
    del x, data
    direct, halo = {}, {}
    if (n_z, n_a) == (2, 1):
        _build.reset_launch_counts()
        rd = RecToolsDIRCuPy(N, 0, NZ, 0.0, angles, N, device=dev)
        sd = ShardedDirect(rd, mesh)
        clean = sd.device_put_sino(load("clean"))
        gather("FBP", sd.fbp(clean))
        gather("FOURIER_INV", sd.fourier_inv(clean))
        direct = dict(_build.launch_counts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    if (n_z, n_a) == (2, 1):
        path_stats = {op: dict(v) for op, v in comm.stats.items()}
        halo = sharded_halo_prox(torch, mesh, dev, N)
        comm.stats.clear()
        comm.stats.update(path_stats)
    torch.cuda.synchronize()
    report = {
        "rank": rank, "z": mesh.z_index, "a": mesh.angle_index, "device": str(dev),
        "launches": path, "direct_launches": direct, "halo": halo, "ms": ms,
        "peak_mib": peak / 2**20, "comm": comm.stats, "step_comm": step_comm,
    }
    if rank == 0:
        for name, arr in keep.items():
            np.save(os.path.join(work, f"out_{n_z}x{n_a}_{name}.npy"), arr)
    with open(os.path.join(work, f"report_{n_z}x{n_a}_{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_halo_prox(torch, mesh, dev, n: int) -> dict:
    """14, mesh (2, 1): the halo prox where the halo is shorter than a
    slab.  Every rank makes the same ``HALO_DEPTH`` x n x n uniform noise on
    the card (seed 14), runs the sharded PD-TV prox (``FLAGSHIP_REG``,
    nonneg) on its slab, then the single-card prox of the whole volume, and
    holds its slab of that against its own result.  Returns the sharded
    prox's launches, the slices its z_halo moved, the slab's depth, whether
    the two are bit-equal and their rel L2."""
    import torch.distributed as dist

    from tomobar_tpu_torch import _build
    from tomobar_tpu_torch.parallel import comm, sharded_regul_fn
    from tomobar_tpu_torch.regularisers import PD_TV

    gen = torch.Generator(device=dev).manual_seed(14)
    whole = torch.rand((HALO_DEPTH, n, n), generator=gen, device=dev)
    z0, z1 = mesh.z_slab(HALO_DEPTH)
    prox = sharded_regul_fn(mesh, FLAGSHIP_REG, nonneg=True)
    slab = whole[z0:z1].clone()
    torch.cuda.synchronize()
    dist.barrier()
    _build.reset_launch_counts()
    comm.reset_stats()
    got = prox(slab)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    moved = comm.stats.get("z_halo", {}).get("bytes", 0) // (n * n * 4)
    ref = PD_TV(whole, FLAGSHIP_REG["regul_param"], FLAGSHIP_REG["iterations"], 0, 1, 12.0)
    ref = ref[z0:z1]
    rel = float(torch.linalg.vector_norm((got - ref).double())
                / torch.linalg.vector_norm(ref.double()))
    return {"launches": launches, "moved_slices": int(moved), "slab": z1 - z0,
            "equal": bool(torch.equal(got, ref)), "rel": rel}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(torch, work: str, n_z: int, n_a: int) -> str:
    """Start the ranks of one mesh of phase 14 and wait for them
    (``run_ranks``); returns the backend used."""
    world = n_z * n_a
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= world else "gloo"
    layout = ("one rank per card" if backend == "nccl"
              else f"all {world} ranks on cuda:0, CUDA tensors staged through pinned host memory")
    print(f"[14] mesh (z, angles) = ({n_z}, {n_a}): {world} ranks, {backend}, {layout}")
    run_ranks([os.path.abspath(__file__), "--sharded-rank", work, str(n_z), str(n_a), backend],
              world, work, f"{n_z}x{n_a}", "14")
    return backend


def run_ranks(argv, world: int, work: str, tag: str, phase: str) -> None:
    """Start ``world`` ranks of ``python3 argv...`` (the rendezvous in the
    environment, as ``torchrun`` sets it; each rank's output in
    ``work/rank_<tag>_<rank>.log``), wait for all of them (``RANK_TIMEOUT``
    seconds in all) and fail with each rank's tail if one fails or hangs."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(os.path.join(work, f"rank_{tag}_{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, *argv], env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    failed = []
    while not failed and any(p.poll() is None for p in procs):
        failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode not in (None, 0)]
        if not failed and time.monotonic() > deadline:
            failed = [(r, f"timed out after {RANK_TIMEOUT} s") for r, p in enumerate(procs)
                      if p.poll() is None]
        time.sleep(0.2)
    failed = failed or [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    for p in procs:  # a failed rank leaves the others waiting in a collective
        if p.poll() is None:
            p.kill()
        p.wait()
    for log in logs:
        log.close()
    if failed:
        for r in range(world):
            with open(os.path.join(work, f"rank_{tag}_{r}.log")) as f:
                tail = f.read()[-3000:]
            print(f"[{phase}] rank {r} of {tag} output (tail):\n{tail}")
        require(False, f"phase {phase}: {tag}: rank(s) failed: {failed}")


def sharded_path(torch, work: str, refs: dict) -> dict:
    """14: the sharded layer on phase 6's flagship; ``refs`` holds phases 6
    and 7's single-device results (numpy, on the host).  Returns the
    launches of every rank's path, summed, and per mesh each rank's z
    coordinate and the collectives its one counted outer iteration made."""
    launches, counted = {}, {}
    t_phase = time.perf_counter()
    truth = refs["truth"]
    for n_z, n_a in SHARDED_MESHES:
        t0 = time.perf_counter()
        backend = run_world(torch, work, n_z, n_a)
        world = n_z * n_a
        for rank in range(world):
            with open(os.path.join(work, f"report_{n_z}x{n_a}_{rank}.json")) as f:
                rep = json.load(f)
            ms = rep["ms"]
            comm_line = ", ".join(
                f"{op} {v['calls']} calls {v['bytes'] / 2**20:.1f} MiB moved "
                f"{v['staged'] / 2**20:.1f} MiB staged {v['seconds']:.2f} s"
                for op, v in sorted(rep["comm"].items()))
            t_comm = sum(v["seconds"] for v in rep["comm"].values())
            comm_line += (f"; collectives {t_comm:.2f} s (host) against "
                          f"{sum(ms) / 1e3:.2f} s of FISTA calls")
            print(f"[14] ({n_z}, {n_a}) rank {rank} (z {rep['z']}, a {rep['a']}, {rep['device']}): "
                  f"launches {json.dumps({k: v for k, v in rep['launches'].items() if v})}; "
                  f"FISTA calls {', '.join(f'{t:.1f}' for t in ms)} ms, per outer iteration "
                  f"{ms[2] - ms[1]:.1f} ms (the 3- less the 2-iteration call; the first call "
                  f"carries set-up); peak {rep['peak_mib']:.1f} MiB; "
                  f"{comm_line or 'no collective'}")
            for k in SHARDED_PATH:
                require(rep["launches"].get(k, 0) > 0,
                        f"phase 14 ({n_z}, {n_a}) rank {rank}: {k} was not launched")
            if rep["direct_launches"]:
                print(f"[14] ({n_z}, {n_a}) rank {rank} direct path launches "
                      f"{json.dumps({k: v for k, v in rep['direct_launches'].items() if v})}")
                for k in SHARDED_DIRECT:
                    require(rep["direct_launches"].get(k, 0) > 0,
                            f"phase 14 ({n_z}, {n_a}) rank {rank}: {k} was not launched "
                            "by FBP and FOURIER_INV")
            halo = rep["halo"]
            if halo:
                print(f"[14] ({n_z}, {n_a}) rank {rank} PD-TV prox on {HALO_DEPTH} slices: "
                      f"z_halo moved {halo['moved_slices']} slices against a slab of "
                      f"{halo['slab']}; {'bit-equal' if halo['equal'] else 'not bit-equal'} "
                      f"to the whole volume's prox, rel L2 {halo['rel']:.3e}; launches "
                      f"{json.dumps({k: v for k, v in halo['launches'].items() if v})}")
                require(halo["launches"].get("PDw", 0) > 0,
                        f"phase 14 ({n_z}, {n_a}) rank {rank}: the halo prox did not launch PDw")
                require(0 < halo["moved_slices"] < halo["slab"],
                        f"phase 14 ({n_z}, {n_a}) rank {rank}: the halo moved "
                        f"{halo['moved_slices']} slices, not fewer than a slab's {halo['slab']}")
                require(halo["equal"], f"phase 14 ({n_z}, {n_a}) rank {rank}: the halo prox "
                        f"on {HALO_DEPTH} slices is not bit-equal to the whole volume's")
            counted.setdefault((n_z, n_a), []).append((rep["z"], rep["step_comm"]))
            for part in (rep["launches"], rep["direct_launches"], halo.get("launches", {})):
                for k, v in part.items():
                    launches[k] = launches.get(k, 0) + v

        def out(name):
            return np.load(os.path.join(work, f"out_{n_z}x{n_a}_{name}.npy"))

        zonly = n_a == 1
        checks = [("fp_sub0", 0.0), ("bp_sub0", 0.0 if zonly else TOL_SHARD_BP),
                  ("fista1", 0.0 if zonly else None), ("fista2", 0.0 if zonly else None),
                  ("fista3", 0.0 if zonly else TOL_SHARD_FISTA)]
        if (n_z, n_a) == (2, 1):
            checks += [("FBP", 0.0), ("FOURIER_INV", 0.0)]
        rmse = []
        for name, tol in checks:
            got, ref = out(name), refs[name]
            require(got.shape == ref.shape, f"phase 14 {name}: shape {got.shape} != {ref.shape}")
            require(bool(np.isfinite(got).all()), f"phase 14 {name}: non-finite values")
            equal = bool(np.array_equal(got, ref))
            rel = float(np.linalg.norm((got - ref).astype(np.float64))
                        / np.linalg.norm(ref.astype(np.float64)))
            held = ("bit for bit" if tol == 0.0 else "printed" if tol is None
                    else f"tol {tol:g} rel L2")
            print(f"[14] ({n_z}, {n_a}) {name} against the single device: "
                  f"{'bit-equal' if equal else 'not bit-equal'}, rel L2 {rel:.3e} ({held})")
            if tol == 0.0:
                require(equal, f"phase 14 ({n_z}, {n_a}) {name}: not bit-equal to the single device")
            elif tol is not None:
                require(rel <= tol, f"phase 14 ({n_z}, {n_a}) {name}: rel L2 {rel:.3e} > {tol:g}")
            if name.startswith("fista"):
                rmse.append(float(np.sqrt(np.mean((got.astype(np.float64) - truth) ** 2))))
        print(f"[14] ({n_z}, {n_a}) RMSE vs phantom after 1, 2, 3 outer iterations: "
              + ", ".join(f"{r:.6f}" for r in rmse))
        require(rmse[0] > rmse[1] > rmse[2], f"phase 14 ({n_z}, {n_a}): RMSE does not fall {rmse}")
        print(f"[14] mesh ({n_z}, {n_a}) on {backend}: {time.perf_counter() - t0:.1f} s wall")
    print(f"[14] the phase took {time.perf_counter() - t_phase:.1f} s; launches of its ranks "
          f"{json.dumps(launches)}")
    return launches, counted


def memory_plans(torch, dev) -> None:
    """15: ``estimate_memory`` on meta tensors: a plan for a volume larger
    than the card (FORWPROJ of ``MEMPLAN_DEPTH`` slices) launches and
    allocates nothing, and at the flagship's 8 slices the plans of
    ``fp`` and one PD-TV prox match the card's measured peak."""
    from tomobar_tpu_torch import _build
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector
    from tomobar_tpu_torch.regularisers import PD_TV
    from tomobar_tpu_torch.utils.memest import estimate_memory

    N, NZ, NA, _ = FLAGSHIP
    angles = np.linspace(0.0, np.pi, NA, endpoint=False)
    big = Projector(Geometry(N, MEMPLAN_DEPTH, angles, 0.0, N))
    card = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.synchronize()
    held, before = torch.cuda.memory_allocated(dev), dict(_build.launch_counts)
    t0 = time.perf_counter()
    plan = estimate_memory(big.fp, torch.empty((MEMPLAN_DEPTH, N, N), device="meta"))
    t_plan = time.perf_counter() - t0
    torch.cuda.synchronize()
    print(f"[15] estimate_memory of FORWPROJ on {MEMPLAN_DEPTH}x{N}^2 ({plan['argument'] / 1e9:.1f} "
          f"GB in, the card holds {card / 1e9:.1f} GB): total {plan['total'] / 1e9:.2f} GB, "
          f"output {plan['output'] / 1e9:.2f} GB, in {t_plan:.2f} s wall, with no launch and no "
          f"allocation")
    require(dict(_build.launch_counts) == before and torch.cuda.memory_allocated(dev) == held,
            "the meta plan launched or allocated on the card")
    require(plan["argument"] > card and plan["total"] >= plan["argument"] + plan["output"],
            f"the plan of a volume larger than the card: {plan}")
    proj = Projector(Geometry(N, NZ, angles, 0.0, N))
    for label, fn in (("fp", proj.fp), ("PD-TV prox", lambda v: PD_TV(v, 5e-4, 20, 0, 1, 12.0))):
        x = torch.rand((NZ, N, N), device=dev)
        est = estimate_memory(fn, torch.empty(x.shape, device="meta"))["total"]
        fn(x)  # the first call makes the kernel parameters, which stay
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        fn(x)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated(dev) - held + x.numel() * 4
        print(f"[15] {label} on {NZ}x{N}^2: meta plan {est / 2**20:.1f} MiB, the card's peak "
              f"above what was held, plus the input, {measured / 2**20:.1f} MiB: ratio "
              f"{est / measured:.4f} (allowed {TOL_PLAN[0]}-{TOL_PLAN[1]})")
        require(TOL_PLAN[0] <= est / measured <= TOL_PLAN[1], f"{label}: meta plan {est / measured:.4f}")
        del x


def check_northstar_kernels(torch, errs, measure, dev) -> tuple:
    """15: the kernels of the north-star path against their plain versions
    on its own inputs and shapes: K1-K4 on both driven groups of OS subset
    0 at its slice count (fp_sub's chain on the phantom, bp_sub's on the
    noisy sinogram's subset), F on the FBP filter's packed rows (the
    forward transform, then the inverse of the filtered spectrum) and one
    PD-TV prox of its iterations on its FBP, clamped at 0: PDw, the
    y-wavefront of every volume of more than 8 slices, timed there beside
    its plain version and bound, and held on 64 slices (that FBP repeated,
    times 1 + sin(0.7 z) / 2)."""
    from tomobar_tpu_torch import RecToolsDIRCuPy
    from tomobar_tpu_torch.bench.northstar import northstar_inputs
    from tomobar_tpu_torch.ops import fft_kernels as FK
    from tomobar_tpu_torch.ops import pd_tv as PDT
    from tomobar_tpu_torch.ops import projector_kernels as K
    from tomobar_tpu_torch.ops.filters import hermitian_extend_real, sinc_filter_half
    from tomobar_tpu_torch.ops.projector import Projector

    ns = NORTHSTAR
    N, NZ, NA = ns["N"], ns["nz"], ns["nproj"]
    P, phantom, sino = northstar_inputs(N, NZ, NA, ns["os_number"], ns["i0"], dev)
    sub0 = Projector(P._sub_geoms[0])
    b0 = P.sino_subset(sino, 0)
    for g in sub0._plan.groups(N, N, dev):
        U0, LU, A = g.prm.U0, g.prm.LU, g.prm.A
        label = f"north star, {'y' if g.swap else 'x'}-driven {A} angles x {NZ} x LU {LU}"
        s = K.shear_fp_plain(phantom, g.beta, U0, LU, g.swap)
        errs.compare("K1", label, K.shear_fp(phantom, g.beta, U0, LU, g.swap), s, tol=0.0)
        errs.compare("K2", label, K.resample_fp(s, g.alpha, g.gamma, U0, N),
                     K.resample_fp_plain(s, g.alpha, g.gamma, U0, N))
        del s
        q = K.resample_bp_plain(b0, g.alpha, g.gamma, U0, LU, index=g.idx)
        errs.compare("K3", label + f", rows by index from {b0.shape[1]} angles",
                     K.resample_bp(b0, g.alpha, g.gamma, U0, LU, index=g.idx), q, tol=0.0)
        errs.compare("K4", label, K.unshear_bp(q, g.beta, U0, N, N, g.swap),
                     K.unshear_bp_plain(q, g.beta, U0, N, N, g.swap), tol=0.0)
        del q
    del b0, phantom
    # the FBP filter's F: slices' rows packed in pairs, transposed to (N, rows)
    rows = torch.nn.functional.pad(sino, (0, 0, 0, NA % 2))
    re = rows[:, 0::2].reshape(-1, N).transpose(0, 1).contiguous()
    im = rows[:, 1::2].reshape(-1, N).transpose(0, 1).contiguous()
    del rows
    label = f"north star, the FBP filter's {N} x {re.shape[1]} rows"
    fre, fim = FK.fft_axis2_plain(re, im, -1)
    errs.compare("F", label + ", sign -1", FK.fft_axis2(re, im, -1), (fre, fim))
    w = torch.as_tensor(hermitian_extend_real(sinc_filter_half(N, 1.1, 1.0 / NA), N),
                        device=dev)[:, None]
    gre, gim = fre * w, fim * w
    del re, im, fre, fim
    errs.compare("F", label + ", filtered, sign +1", FK.fft_axis2(gre, gim, 1),
                 FK.fft_axis2_plain(gre, gim, 1))
    del gre, gim
    angles = np.linspace(0, np.pi, NA, endpoint=False).astype(np.float32)
    x = torch.clamp(RecToolsDIRCuPy(N, 0, NZ, 0.0, angles, N, device=dev).FBP(
        sino.transpose(0, 1), cutoff_freq=1.1), min=0.0).contiguous()
    del sino
    iters = ns["tv_iters"]
    args = (x, ns["regul_param"], iters, 0, 1, 12.0)
    label = f"one prox of {iters} iterations on the north star's FBP, {NZ} x {N}^2"
    errs.compare("PDw", label, PDT.pd_tv(*args), PDT.pd_tv_plain(*args))
    measure("PDw", label, lambda: PDT.pd_tv(*args), lambda: PDT.pd_tv_plain(*args),
            work_pd(NZ, N, iters), reps=5, plain_reps=1, check=False, phase="15")
    deep = x.repeat(4, 1, 1)[:64] * (1.0 + 0.5 * torch.sin(0.7 * torch.arange(64, device=dev)))[
        :, None, None]
    del x
    args = (deep, ns["regul_param"], iters, 0, 1, 12.0)
    errs.compare("PDw", f"one prox of {iters} iterations on 64 x {N}^2 (the FBP repeated)",
                 PDT.pd_tv(*args), PDT.pd_tv_plain(*args))
    print(f"[15] PDw pd_tv, one prox of {iters} iterations on 64 x {N}^2: kernel "
          f"{time_cuda(lambda: PDT.pd_tv(*args), 3):.3f} ms, plain "
          f"{time_cuda(lambda: PDT.pd_tv_plain(*args), 1):.3f} ms, bound "
          f"{work_pd(64, N, iters)[0] / PEAK_FLOPS * 1e3:.3f} ms (operations)")


def bench_phase(torch, errs, measure, dev, ms_outer: float, bd: dict, ms_fi: float, fb: dict,
                counted: dict) -> tuple:
    """15: the bench modules (``tomobar_tpu_torch/bench``) at BASELINE's
    shapes.  ``ms_outer`` is phase 6's outer iteration and ``bd`` its
    ``flagship_breakdown``, ``ms_fi`` phase 7's FOURIER_INV call and ``fb``
    its ``fourier_breakdown``, ``counted`` phase 14's collectives of one
    outer iteration per mesh and rank.  Returns the north-star run's
    launches and PDw's launches per FISTA outer iteration of that run (the
    counters read after each of its steps) with what that iteration is."""
    from tomobar_tpu_torch import _build
    from tomobar_tpu_torch.bench.northstar import run_northstar
    from tomobar_tpu_torch.bench.scaling import comm_model

    t_phase = time.perf_counter()
    N, NZ, NA, OS = FLAGSHIP
    records = {stage: rec for stage, rec in bd.items() if isinstance(rec, dict)}
    utils = {f"{stage}.{k}": v for stage, rec in records.items()
             for k, v in rec.items() if k.endswith("_util")}
    clamped = {f"{stage}.{k}": v for stage, rec in records.items()
               for k, v in rec.items() if k.endswith("_raw")}
    print(f"[15] phase 6's flagship_breakdown: utilisations {json.dumps(utils)}")
    require(len(utils) == 6 and all(0.0 < v <= 1.0 for v in utils.values()),
            f"a utilisation outside (0, 1]: {utils}")
    require(not clamped, f"a work model above the card's bound (clamped to 1): {clamped}")
    print(f"[15] outer_estimate_ms {bd['outer_estimate_ms']:.3f} against phase 6's outer "
          f"iteration {ms_outer:.3f} ms: ratio {bd['outer_estimate_ms'] / ms_outer:.4f}")

    stages = fb["stages"]
    clamped = {f"{k}.{u}": v for k in STAGES for u, v in stages[k].items() if u.endswith("_raw")}
    rel = abs(stages["stage_sum_ms"] - ms_fi) / ms_fi
    print(f"[15] phase 7's FOURIER_INV stages sum to {stages['stage_sum_ms']:.3f} ms against its "
          f"call, {ms_fi:.3f} ms: {100 * rel:.2f}% apart (allowed {100 * TOL_STAGE_SUM:.0f}%); "
          + ", ".join(f"{k} {stages[k]['ms']:.3f}" for k in STAGES))
    require(rel <= TOL_STAGE_SUM, f"FOURIER_INV's stages {stages['stage_sum_ms']:.3f} ms, the call "
            f"{ms_fi:.3f} ms")
    require(not clamped, f"a FOURIER_INV stage's model above the card's bound: {clamped}")

    memory_plans(torch, dev)

    shape = f"{NORTHSTAR['N']}^2 x {NORTHSTAR['nz']} x {NORTHSTAR['nproj']}"
    print(f"[15] the north star's kernels against their plain versions on its inputs, {shape}:")
    check_northstar_kernels(torch, errs, measure, dev)
    print(f"[15] run_northstar {shape}, OS{NORTHSTAR['os_number']}, TV{NORTHSTAR['tv_iters']}, "
          f"{NORTHSTAR['fista_outer']} FISTA and {NORTHSTAR['admm_outer']} ADMM iterations:")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    after_step = {"fista": [], "admm": []}
    ns = run_northstar(**NORTHSTAR, device=dev, on_step=lambda solver, i: after_step[solver].append(
        _build.launch_counts["PDw"]))
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    steps = after_step["fista"]
    per_step = sorted({b - a for a, b in zip(steps, steps[1:])})
    print(f"[15] PDw launches in each FISTA outer iteration of the north-star run after the "
          f"first: {per_step}")
    require(len(steps) == NORTHSTAR["fista_outer"] and len(per_step) == 1 and per_step[0] > 0,
            f"PDw launches per FISTA outer iteration of the north-star run: {per_step}")
    pdw_per_call = (per_step[0], f"north-star FISTA outer iteration ({NORTHSTAR['os_number']} "
                    f"PD-TV proxes of {NORTHSTAR['tv_iters']} iterations on {NORTHSTAR['nz']} x "
                    f"{NORTHSTAR['N']}^2)")
    print(f"[15] north-star run {time.perf_counter() - t0:.1f} s wall, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {json.dumps(launches)}")
    print(f"[15] run_northstar: {json.dumps(ns)}")
    for k in NORTHSTAR_PATH:
        require(launches.get(k, 0) > 0, f"kernel {k} was not launched by the north-star run")
    fista = [r for _, r, _ in ns["fista"]["trajectory"]]
    admm = [r for _, r, _ in ns["admm"]["trajectory"]]
    fbp = ns["rel_rmse_fbp"]
    print(f"[15] rel-RMSE: FBP {fbp:.4f}; FISTA " + ", ".join(f"{r:.4f}" for r in fista)
          + f"; ADMM " + ", ".join(f"{r:.4f}" for r in admm))
    print(f"[15] FISTA reached FBP's rel-RMSE after {ns['fista']['time_to_fbp_rmse_s']} s, 1.02 x "
          f"its best after {ns['fista']['time_to_rmse_s']} s; {ns['fista']['iter_s']} outer "
          f"iterations/s; step s " + ", ".join(f"{d:.4f}" for _, _, d in ns["fista"]["trajectory"]))
    print(f"[15] the TPU run's quality (NORTHSTAR_r04.json, rel-RMSE, not times): FBP "
          f"{NORTHSTAR_TPU['fbp']}, FISTA {NORTHSTAR_TPU['fista']}, ADMM {NORTHSTAR_TPU['admm']}; "
          f"here FBP {fbp:.4f}, FISTA {fista[-1]:.4f}, ADMM {admm[-1]:.4f}")
    require(all(a > b for a, b in zip(fista, fista[1:])), f"FISTA's rel-RMSE does not fall: {fista}")
    require(ns["fista"]["time_to_fbp_rmse_s"] is not None,
            f"FISTA did not reach FBP's rel-RMSE {fbp} in {len(fista)} iterations: {fista}")
    require(admm[-1] < fbp, f"ADMM's rel-RMSE {admm[-1]} is not below FBP's {fbp}")

    for (n_z, n_a), ranks in sorted(counted.items()):
        for z, got in sorted(ranks, key=lambda r: r[0]):
            model = comm_model(N, NZ, OS, ms_outer / 1e3, (n_z, n_a),
                               FLAGSHIP_REG["iterations"], NA, z)["stats"]
            print(f"[15] comm_model mesh ({n_z}, {n_a}), z {z}: {json.dumps(model)}; counted in "
                  f"phase 14: {json.dumps(got)}")
            require(got == model, f"comm_model mesh ({n_z}, {n_a}) z {z} differs from the counts")
    print(f"[15] the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, pdw_per_call


def load_example(name: str):
    """The example ``name`` of ``examples/torch/``, loaded from its file (its
    JAX counterpart in ``examples/`` has the same module name)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(REPO, "examples", "torch", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_on_path(torch, dev, launches: dict, label: str, kernels, fn) -> dict:
    """16: ``fn()`` with the launch counters and the peak-memory statistic
    reset before it and read after it; fails unless it launched each of
    ``kernels``; adds its launches to ``launches`` and returns what ``fn``
    returns with its peak (MiB), wall seconds and launches."""
    from tomobar_tpu_torch import _build

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.launch_counts.items() if v}
    for k in kernels:
        require(counts.get(k, 0) > 0, f"phase 16: {label} did not launch {k}")
    for k, v in counts.items():
        launches[k] += v
    return dict(out, peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
                wall_s=time.perf_counter() - t0, launches=counts)


def require_quality(label: str, quality: dict) -> None:
    bad = {k: v for k, v in quality.items() if not np.isfinite(v)}
    require(not bad, f"phase 16: {label}: non-finite rel-RMSE {bad}")


def examples_on_card(torch, dev, modules: dict, launches: dict) -> None:
    """16a: every example at its own default size through ``main(device=
    "cuda")``; the sharded one runs a world of one rank in this process."""
    for name, kernels in EXAMPLES.items():
        print(f"[16] examples/torch/{name}.py, main(device='cuda'):")
        out = run_on_path(torch, dev, launches, name, kernels,
                          lambda: modules[name].main(device="cuda"))
        quality = {k: v for k, v in out.items() if k not in ("peak_mib", "wall_s", "launches")}
        require_quality(name, quality)
        print(f"[16] {name}: rel-RMSE " + ", ".join(f"{k} {v:.4f}" for k, v in quality.items())
              + f"; {out['wall_s']:.1f} s wall, peak {out['peak_mib']:.1f} MiB, launches "
              + json.dumps(out["launches"]))


def flagship_examples(torch, dev, modules: dict, launches: dict, smi: str,
                      ms_pwls: float) -> None:
    """16b: the examples' new paths at the flagship width, with their own
    dictionaries; ``ms_pwls`` is phase 6's outer iteration (PWLS)."""
    from tomobar_tpu_torch import RecToolsIRCuPy
    from tomobar_tpu_torch.bench.harness import rel_rmse

    N, NZ, NA, _ = FLAGSHIP
    angles = np.linspace(0.0, np.pi, NA, endpoint=False).astype(np.float32)
    # the artifacts and counts examples' phantom, over NZ slices
    stack = (modules["quickstart_2d"].shepp_logan(N)[None]
             * np.linspace(0.95, 1.05, NZ, dtype=np.float32)[:, None, None])
    rows = {}

    def admm_warm():
        """Raw counts -> normaliser -> padded FBP -> ADMM-OS24 (config 4)."""
        ex = modules["realdata_warmstart_admm"]
        t0 = time.perf_counter()
        truth = ex.ellipsoid_phantom(N, NZ)
        proj, flats, darks = ex.synth_raw_counts(truth, angles, dev)
        data = ex.normalise(proj, flats, darks, N)
        del proj
        t_raw = time.perf_counter() - t0
        fbp, ms_fbp = timed_call(torch, lambda: ex.warm_start(data, angles, N, dev))
        require(fbp.shape == (NZ, N + 2 * ex.PAD, N + 2 * ex.PAD), f"warm start {fbp.shape}")
        rt = RecToolsIRCuPy(N, ex.PAD, NZ, 0.0, angles, N, OS_number=24, device=dev)
        ex.admm(data, fbp, angles, N, dev, iterations=1, rec_it=rt)  # L, the plans
        _, ms1 = timed_call(torch, lambda: ex.admm(data, fbp, angles, N, dev, iterations=1,
                                                   rec_it=rt))
        rec, ms2 = timed_call(torch, lambda: ex.admm(data, fbp, angles, N, dev, rec_it=rt))
        require(rec.shape == (NZ, N, N), f"ADMM shape {rec.shape}")
        p = ex.PAD
        quality = {"fbp": rel_rmse(fbp[:, p:-p, p:-p], truth), "admm": rel_rmse(rec, truth)}
        require_quality("config 4", quality)
        require(quality["admm"] < quality["fbp"],
                f"phase 16: ADMM did not end below its warm start: {quality}")
        print(f"[16] config 4: raw counts made and normalised on the host in {t_raw:.1f} s; "
              f"padded FBP on a {N + 2 * p}^2 grid {ms_fbp:.1f} ms; ADMM calls of 1 / 2 "
              f"iterations {ms1:.1f} / {ms2:.1f} ms")
        return {"ms_outer": ms2 - ms1, "quality": quality}

    def swls_huber():
        """FISTA-OS10, PWLS / PWLS + Huber / SWLS + Huber on corrupted data."""
        ex = modules["artifacts3d_swls_huber"]
        scale = N / 256
        rt = RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N, OS_number=10, device=dev)
        sino = ex.corrupted_data(rt, stack, scale=scale)
        quality = ex.reconstruct(rt, sino, stack, scale=scale)  # asserts SWLS < PWLS
        require_quality("SWLS + Huber", quality)
        data = dict(ex.fidelities(scale)[2][1], projection_data=sino)
        ms = [timed_call(torch, lambda: rt.FISTA(dict(data), dict(ex.ALGORITHM, iterations=k),
                                                 dict(ex.REGULARISATION)))[1] for k in (2, 3)]
        print(f"[16] SWLS + Huber: FISTA calls of 2 / 3 iterations {ms[0]:.1f} / {ms[1]:.1f} ms")
        return {"ms_outer": ms[1] - ms[0], "quality": quality}

    def kl_osem():
        """OSEM (OS 8), MLEM (one subset of 1801 angles), FISTA-KL from OSEM,
        FISTA-LS on Poisson counts."""
        ex = modules["osem_kl_counts"]
        rt = RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N, OS_number=8, device=dev)
        rt1 = RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N, OS_number=1, device=dev)
        counts, scale = ex.count_data(rt, stack, 50.0)
        b = counts / scale
        quality = ex.reconstruct(rt, rt1, b, stack, volumes=True)
        osem = quality.pop("volumes")["osem"]
        require_quality("KL / OSEM", quality)
        data = {"projection_data": b, "data_fidelity": "KL"}
        ms = [timed_call(torch, lambda: rt.FISTA(
            dict(data), dict(ex.FISTA, iterations=k, initialise=osem),
            dict(ex.REGULARISATION)))[1] for k in (2, 3)]
        print(f"[16] KL / OSEM: FISTA-KL calls of 2 / 3 iterations {ms[0]:.1f} / {ms[1]:.1f} ms")
        return {"ms_outer": ms[1] - ms[0], "quality": quality}

    for label, fn in (("config 4: ADMM-OS24 warm-started from raw counts", admm_warm),
                      ("FISTA-OS10 SWLS + Huber", swls_huber),
                      ("FISTA-OS8 KL from OSEM", kl_osem)):
        print(f"[16] {label}, {NA} x {NZ} x {N}:")
        rows[label] = run_on_path(torch, dev, launches, label, ITERATIVE, fn)
    print(f"[16] outer iterations at {NA} x {NZ} x {N} on {smi} (CUDA events; phase 6's "
          f"FISTA-OS10 PWLS beside: {ms_pwls:.1f} ms):")
    for label, row in rows.items():
        print(f"[16]   {label}: {row['ms_outer']:.1f} ms an outer iteration, peak "
              f"{row['peak_mib']:.1f} MiB, {row['wall_s']:.1f} s wall; rel-RMSE "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["quality"].items())
              + "; launches " + json.dumps(row["launches"]))


def sharded_example(torch, dev, ex7, launches: dict) -> None:
    """16c: the sharded example on worlds of gloo ranks sharing the card
    against a world of one rank (this process) at the same sizes."""
    import torch.distributed as dist

    work = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    atexit.register(shutil.rmtree, work, True)
    for (n_z, n_a), nz in EXAMPLE_WORLDS:
        tag = f"example_{n_z}x{n_a}"
        ref = run_on_path(torch, dev, launches, f"the sharded example on one rank, {nz} slices",
                          ITERATIVE, lambda: ex7.main(nz=nz, device="cuda", volumes=True))
        save = os.path.join(work, f"{tag}.npz")
        t0 = time.perf_counter()
        run_ranks([ex7.__file__, "--backend", "gloo", "--mesh", f"{n_z},{n_a}", "--nz", str(nz),
                   "--save", save], n_z * n_a, work, tag, "16")
        wall = time.perf_counter() - t0
        with np.load(save) as f:
            got = {k: f[k] for k in ("fbp", "fista")}
        for k, want in ref["volumes"].items():
            require(got[k].shape == want.shape and bool(np.isfinite(got[k]).all()),
                    f"phase 16 {tag} {k}: shape {got[k].shape} or non-finite values")
            if n_a == 1:
                require(np.array_equal(got[k], want),
                        f"phase 16 {tag} {k}: not bit-equal to one rank")
                held = "bit-equal"
            else:
                rel = float(np.linalg.norm(got[k] - want) / np.linalg.norm(want))
                require(rel <= TOL_EXAMPLE_SHARD,
                        f"phase 16 {tag} {k}: rel L2 {rel:.3e} > {TOL_EXAMPLE_SHARD:g}")
                held = f"rel L2 {rel:.3e} (tol {TOL_EXAMPLE_SHARD:g})"
            print(f"[16] sharded example, mesh ({n_z}, {n_a}), {nz} slices, {n_z * n_a} gloo ranks "
                  f"on one card, {k}: {held} against one rank (rel-RMSE {ref[k]:.4f})")
        print(f"[16] mesh ({n_z}, {n_a}): the world took {wall:.1f} s wall (ranks share the card "
              "through the host: not scaling)")
    dist.destroy_process_group()


def examples_phase(torch, dev, smi: str, ms_pwls: float) -> dict:
    """16: the examples of ``examples/torch/``; returns their launches."""
    launches = {k: 0 for k in KERNELS}
    t_phase = time.perf_counter()
    modules = {name: load_example(name) for name in EXAMPLES}
    examples_on_card(torch, dev, modules, launches)
    flagship_examples(torch, dev, modules, launches, smi, ms_pwls)
    sharded_example(torch, dev, modules["multichip_sharded_recon"], launches)
    print(f"[16] the phase took {time.perf_counter() - t_phase:.1f} s; launches "
          + json.dumps({k: v for k, v in launches.items() if v}))
    return launches


def slice_rel_l2(torch, got, ref) -> list:
    """rel L2 of each slice (leading axis) of ``got`` against ``ref``, float64."""
    got, ref = got.double().flatten(1), ref.double().flatten(1)
    return ((got - ref).norm(dim=1) / ref.norm(dim=1)).tolist()


def analytic_crosscheck(torch, dev, n: int, nz: int, angles, cor: float, tol_fp: float,
                        min_cor: float, path, tag: str = "[17]") -> dict:
    """17: the direct entry points against the closed-form Radon transform
    of ``bench.analytic``'s ellipses scaled to ``n``, on ``nz`` slices whose
    values are scaled by 1 + k/8: 3D and one-slice ``FORWPROJ`` within
    ``tol_fp`` rel L2 of the transform per slice and more than ``MIN_FLIP``
    from its negated angles and mirrored detector; at centre offset ``cor``
    within ``tol_fp`` of the transform at ``cor`` and more than ``min_cor``
    from it at ``-cor``; 3D and 2D FBP (ram-lak) and FOURIER_INV of the
    exact sinogram on the absolute scale of each slice's value, FOURIER_INV
    beating its four 1-pixel shifts on slice 0.  Fails unless each kernel
    of ``path`` was launched; returns the launches."""
    from tomobar_tpu_torch import RecToolsDIRCuPy, _build
    from tomobar_tpu_torch.bench import analytic as AN

    t_phase = time.perf_counter()
    ell = AN.scaled(AN.ELLIPSES, n)
    values = 1.0 + np.arange(nz) / 8.0
    vals = torch.as_tensor(values, dtype=torch.float32, device=dev)[:, None, None]
    truth = torch.as_tensor(AN.ellipse_phantom(n, ell), device=dev) * vals
    sino = {c: torch.as_tensor(AN.ellipse_sinogram(angles, n, ell, c), device=dev) * vals
            for c in (0.0, cor, -cor)}
    negated = torch.as_tensor(AN.ellipse_sinogram(-angles, n, ell), device=dev) * vals
    flat = torch.as_tensor(AN.flat_interior_mask(n), device=dev)
    circle = torch.as_tensor(AN.incircle_mask(n), device=dev)
    print(f"{tag} {len(angles)} angles x {nz} slices x {n}: phantom and analytic sinograms "
          f"(float64, then float32) in {time.perf_counter() - t_phase:.2f} s")

    def check(label, got, bound, above=False):
        got = [float(g) for g in np.atleast_1d(got)]
        ok = all(g > bound if above else g <= bound for g in got)
        print(f"{tag} {label}: " + ", ".join(f"{g:.4e}" for g in got)
              + f" ({'>' if above else '<='} {bound:g})")
        require(ok, f"{tag} {label}: {got} not {'>' if above else '<='} {bound:g}")

    def timed(label, fn, shape):
        out, ms = timed_call(torch, fn)
        print(f"{tag} {label}: {ms:.1f} ms (CUDA events, one call)")
        require(tuple(out.shape) == shape, f"{tag} {label}: shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), f"{tag} {label}: non-finite values")
        return out

    def flat_error(rec, scale=1.0):
        """|the flat interior's mean / (``scale`` x each slice's value) - 1|."""
        return np.abs(rec[:, flat].double().mean(1).cpu().numpy() / scale / values[:len(rec)] - 1)

    def incircle_rmse(rec):
        ref = truth[:len(rec), circle].double()
        d = rec[:, circle].double() - ref
        return (d.square().mean(1).sqrt() / ref.square().mean(1).sqrt()).tolist()

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    na = len(angles)
    rd = RecToolsDIRCuPy(n, 0, nz, 0.0, angles, n)
    rd2 = RecToolsDIRCuPy(n, 0, None, 0.0, angles, n)
    fp = timed("3D FORWPROJ", lambda: rd.FORWPROJ(truth), (nz, na, n))
    check("3D FORWPROJ against the transform, rel L2 per slice",
          slice_rel_l2(torch, fp, sino[0.0]), tol_fp)
    check("3D FORWPROJ against negated angles", slice_rel_l2(torch, fp, negated), MIN_FLIP, True)
    check("3D FORWPROJ against a mirrored detector",
          slice_rel_l2(torch, fp, sino[0.0].flip(2)), MIN_FLIP, True)
    fp = timed(f"3D FORWPROJ at centre offset {cor}",
               lambda: RecToolsDIRCuPy(n, 0, nz, cor, angles, n).FORWPROJ(truth), (nz, na, n))
    check(f"centre offset {cor} against the transform at {cor}",
          slice_rel_l2(torch, fp, sino[cor]), tol_fp)
    check(f"centre offset {cor} against the transform at {-cor}",
          slice_rel_l2(torch, fp, sino[-cor]), min_cor, True)
    del fp, negated
    one = timed("one-slice FORWPROJ", lambda: rd2.FORWPROJ(truth[0]), (na, n))
    check("one-slice FORWPROJ against the transform", slice_rel_l2(torch, one[None], sino[0.0][:1]),
          tol_fp)
    rec = timed("3D FBP (ram-lak)",
                lambda: rd.FBP(sino[0.0].transpose(0, 1), filter_type="ram-lak"), (nz, n, n))
    check("3D FBP |flat interior / value - 1|", flat_error(rec), TOL_FLAT_FBP)
    check("3D FBP rel RMSE inside 0.45 N", incircle_rmse(rec), MAX_RMSE_FBP)
    rec = timed("2D FBP (ram-lak), slice 0",
                lambda: rd2.FBP(sino[0.0][0], filter_type="ram-lak"), (n, n))[None]
    check("2D FBP |flat interior / value - 1|", flat_error(rec), TOL_FLAT_FBP)
    check("2D FBP rel RMSE inside 0.45 N", incircle_rmse(rec), MAX_RMSE_FBP)
    rec = timed("FOURIER_INV (ramp)", lambda: rd.FOURIER_INV(sino[0.0], filter_type="ramp"),
                (nz, n, n))
    check("FOURIER_INV |flat interior / (8/pi) / value - 1|",
          flat_error(rec, AN.FOURIER_INV_SCALE), TOL_FLAT_FI)
    base, shifted = AN.shift_rmse(rec[0].cpu().numpy() / AN.FOURIER_INV_SCALE,
                                  truth[0].cpu().numpy(), AN.incircle_mask(n))
    print(f"{tag} FOURIER_INV slice 0: RMSE inside 0.45 N {base:.5f}; 1-pixel shifts "
          + ", ".join(f"{d}: {v:.5f}" for d, v in shifted.items()) + " (each must be larger)")
    require(all(v > base for v in shifted.values()),
            f"{tag} FOURIER_INV: a 1-pixel shift fits better than the reconstruction")
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.launch_counts.items() if v}
    for k in path:
        require(counts.get(k, 0) > 0, f"{tag} {k} was not launched")
    print(f"{tag} the phase took {time.perf_counter() - t_phase:.1f} s; launches "
          + json.dumps(counts))
    return counts


def main() -> int:
    pkg = os.path.join(REPO, "tomobar_tpu_torch")
    import torch

    # ---- 1. device ---------------------------------------------------------
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    kind = torch.cuda.get_device_name(0)
    smi = card_line()
    print(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[1] nvidia-smi name, power.limit: {smi}")

    import tomobar_tpu_torch
    from tomobar_tpu_torch import RecToolsIRCuPy, _build
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops import pd_tv as PDT
    from tomobar_tpu_torch.ops import projector_kernels as K
    from tomobar_tpu_torch.ops.projector import Projector, radon_fp

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
    print("[3] K3 with the angle gather (index) at 1, 3 and 8 slices, shuffled angles, cor 3.5:")
    check_k3_shapes(torch, K, errs, dev)
    check_k3_index_guard()
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
    check_adjointness(torch, geoms, dev, 4, "4")

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
    N, NZ, NA, OS = FLAGSHIP
    t0 = time.perf_counter()
    angles, truth, clean, data = flagship_data(torch, dev)
    torch.cuda.synchronize()
    print(f"[6] data: phantom, FP and Poisson noise in {time.perf_counter() - t0:.2f} s")

    rt = RecToolsIRCuPy(N, 0, NZ, 0.0, angles, N, OS_number=OS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    lc = rt.powermethod({"projection_data": data, "data_fidelity": "PWLS"})
    torch.cuda.synchronize()
    t_power = time.perf_counter() - t0
    counts_after = [dict(_build.launch_counts)]
    recs, ms = fista_calls(torch, rt, {"projection_data": data, "data_fidelity": "PWLS"},
                           (1, 2, 3), lc, FLAGSHIP_REG,
                           lambda: counts_after.append(dict(_build.launch_counts)))
    launches = dict(_build.launch_counts)
    per_call = outer_iteration_launches(counts_after, ITERATIVE, "3D FISTA outer iteration")
    print("[6] launches per outer iteration: "
          + json.dumps({k: v[0] for k, v in per_call.items()}))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[6] power method: L = {lc:.6g} in {t_power:.2f} s wall")
    lc6 = lc
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
                 "bound_ms": 0.0, "library_ms": None, "device_ms": None} for k in KERNELS}

    def measure(key, label, kern, plain, work, reps=10, plain_reps=2, check=True,
                tol=TOL_KERNEL, library=None, small=False, phase=None):
        """Time kern() beside plain() (and library(), one PyTorch call for the
        same function) and add them, and the bound of `work` = (operations,
        bytes), to the kernel's sums.  ``small``: a kernel that takes less
        than the host needs to enqueue it is also timed on the device alone,
        from a CUDA graph (``device_ms``)."""
        phase = phase or ("6" if key in ITERATIVE else "8" if key in TWO_D else "7")
        if check:
            errs.compare(key, f"flagship, {label}", kern(), plain(), tol=tol)
        t = times[key]
        t_kern = time_cuda(kern, reps)
        t_plain = time_cuda(plain, plain_reps)
        ops_ms, bytes_ms = work[0] / PEAK_FLOPS * 1e3, work[1] / PEAK_BYTES * 1e3
        t["ms"] += t_kern
        t["plain_ms"] += t_plain
        t["ops_ms"] += ops_ms
        t["bytes_ms"] += bytes_ms
        t["bound_ms"] += max(ops_ms, bytes_ms)
        line = (f"[{phase}] {key} {KERNELS[key][0]}, {label}: kernel {t_kern:.3f} ms, "
                f"plain {t_plain:.3f} ms, bound {max(ops_ms, bytes_ms):.3f} ms "
                f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        if small:
            t_dev = time_device(kern)
            t["device_ms"] = (t["device_ms"] or 0.0) + t_dev
            line += f", on the device alone (CUDA graph) {t_dev:.3f} ms"
        if library is not None:
            t_lib = time_cuda(library, reps)
            t["library_ms"] = (t["library_ms"] or 0.0) + t_lib
            line += f", library call {t_lib:.3f} ms"
        print(line)

    t_copy = time_cuda(lambda: x.transpose(1, 2).contiguous(), 10)
    print(f"[6] transposed copy of the volume, inside K1's y-driven time: {t_copy:.3f} ms")
    sub0 = Projector(rt.Atools._sub_geoms[0])
    b0 = rt.Atools.sino_subset(data, 0)  # what bp_sub hands K3, with each group's idx
    for g in sub0._plan.groups(N, N, dev):
        U0, LU, A = g.prm.U0, g.prm.LU, g.prm.A
        label = f"{'y' if g.swap else 'x'}-driven {A} angles x {NZ} x LU {LU}"
        s = K.shear_fp_plain(x, g.beta, U0, LU, g.swap)
        p = K.resample_fp_plain(s, g.alpha, g.gamma, U0, N)
        q = K.resample_bp_plain(p, g.alpha, g.gamma, U0, LU)
        errs.compare("K3", f"flagship, {label}, its own rows",
                     K.resample_bp(p, g.alpha, g.gamma, U0, LU), q, tol=0.0)
        measure("K1", label, lambda: K.shear_fp(x, g.beta, U0, LU, g.swap),
                lambda: K.shear_fp_plain(x, g.beta, U0, LU, g.swap),
                work_shear(A, NZ, N, N, LU), tol=0.0)
        measure("K2", label, lambda: K.resample_fp(s, g.alpha, g.gamma, U0, N),
                lambda: K.resample_fp_plain(s, g.alpha, g.gamma, U0, N),
                work_resample(A, NZ, LU, N, 13), small=True)
        measure("K3", label + f", rows by index from {b0.shape[1]} angles",
                lambda: K.resample_bp(b0, g.alpha, g.gamma, U0, LU, index=g.idx),
                lambda: K.resample_bp_plain(b0, g.alpha, g.gamma, U0, LU, index=g.idx),
                work_resample(A, NZ, LU, N, 26), tol=0.0, small=True)
        measure("K4", label, lambda: K.unshear_bp(q, g.beta, U0, N, N, g.swap),
                lambda: K.unshear_bp_plain(q, g.beta, U0, N, N, g.swap),
                work_unshear(A, NZ, N, LU), tol=0.0)
    pd_args = (x, 5e-4, 20, 0, 1, 12.0)
    errs.compare("PD", "flagship, 20 iterations", PDT.pd_tv(*pd_args), PDT.pd_tv_plain(*pd_args))
    one = (*pd_args[:2], 1, *pd_args[3:])
    print(f"[6] PD pd_tv, one iteration on {NZ}x{N}x{N}: "
          f"kernel {time_cuda(lambda: PDT.pd_tv(*one), 10):.3f} ms, "
          f"plain {time_cuda(lambda: PDT.pd_tv_plain(*one), 2):.3f} ms")
    measure("PD", f"one prox of 20 iterations on {NZ}x{N}x{N}",
            lambda: PDT.pd_tv(*pd_args), lambda: PDT.pd_tv_plain(*pd_args),
            work_pd(NZ, N, 20), reps=5, plain_reps=1, check=False)
    # one OS subset of the FISTA step by stage: fp_sub (K1 x2, K2 x2),
    # bp_sub (K3 x2, K4 x2) and one PD-TV prox of 20 iterations
    print(f"[6] one OS subset by stage, flagship_breakdown {NA}x{NZ}x{N}, OS{OS}, TV20, against "
          f"the H100 SXM's {PEAK_FLOPS / 1e12:.0f} TFLOP/s and {PEAK_BYTES / 1e12:.2f} TB/s:")
    bd = flagship_breakdown(N, NZ, NA, OS, FLAGSHIP_REG["iterations"], device=dev)
    print(f"[6] flagship_breakdown: {json.dumps(bd)}")
    work, refs = sharded_inputs(rt, data, truth, recs, lc6)
    del b0
    del x, recs, data, truth

    # ---- 7. the direct path ------------------------------------------------
    *parts, small, ms_fi, fb = direct_path(torch, errs, measure, dev, clean, angles)
    for part, whole in zip(parts, (launches, per_call)):
        whole.update(part)
    sharded_direct_inputs(work, refs, clean, small)

    # ---- 8. the 2D path ----------------------------------------------------
    for part, whole in zip(two_d_path(torch, K, errs, measure, dev), (launches, per_call)):
        whole.update(part)

    # ---- 9. the big stack -------------------------------------------------
    stack_launches, plan_512 = big_stack(torch, errs, dev, clean, angles, small)
    for k, v in stack_launches.items():
        launches[k] += v
    del small

    # ---- 10. the regularisers ----------------------------------------------
    regularisers_on_card(torch, dev)

    # ---- 11. a legacy prox on the main path --------------------------------
    for k, v in legacy_main_path(torch, dev, clean, angles, lc6).items():
        launches[k] += v
    del clean

    # ---- 12. the Joseph pair and the plain gridding ------------------------
    joseph_on_card(torch, dev)

    # ---- 13. raw projections to a reconstruction ---------------------------
    for k, v in raw_to_reconstruction(torch, dev, angles, plan_512).items():
        launches[k] += v

    # ---- 14. the sharded layer on the flagship -----------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share this card
    sharded_launches, counted = sharded_path(torch, work, refs)
    for k, v in sharded_launches.items():
        launches[k] += v
    del refs

    # ---- 15. the bench modules ---------------------------------------------
    ns_launches, per_call["PDw"] = bench_phase(torch, errs, measure, dev, per_iter[2], bd, ms_fi,
                                               fb, counted)
    for k, v in ns_launches.items():
        launches[k] += v

    # ---- 16. the examples ---------------------------------------------------
    for k, v in examples_phase(torch, dev, smi, per_iter[2]).items():
        launches[k] += v

    # ---- 17. the closed-form Radon transform at the flagship's width --------
    for k, v in analytic_crosscheck(torch, dev, N, NZ, angles, C_TRUE, TOL_ANALYTIC_FP,
                                    MIN_ANALYTIC_COR, ANALYTIC_PATH).items():
        launches[k] += v

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
                "device_ms": times[k]["device_ms"],
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
    if len(sys.argv) == 6 and sys.argv[1] == "--sharded-rank":
        sys.exit(sharded_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
