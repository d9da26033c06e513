#!/usr/bin/env python3
"""Time the K1, K1p, K2, K3, K4, K4p, PD, F, Ff and G kernels of tomobar_tpu_torch at their flagship
shapes, for several source trees in one call, in turns, on one NVIDIA GPU.

Two versions of a kernel can be compared only inside one call on one card,
so this script takes any number of trees and runs them alternately::

    # this checkout against another commit unpacked into an ignored directory
    git archive <commit> | tar -x -C _archive/parent
    python3 tools/torch_kernel_times.py --repo . --repo _archive/parent

    # this checkout against variants of its kernels' compile-time constants
    python3 tools/torch_kernel_times.py --repo . --set kK1R=4,kK1W=512 --set kK1U=4

    # only some kernels
    python3 tools/torch_kernel_times.py --repo . --repo _archive/parent --kernels PD,K4

    # with each tree's register and spill report (nvcc -Xptxas -v) first
    python3 tools/torch_kernel_times.py --repo . --repo _archive/parent --ptxas pd_tv.cu

A tree is timed through the package's public wrappers (``shear_fp``,
``shear_fp_packed``, ``unshear_bp``, ``unshear_bp_packed``, ``pd_tv``,
``fft_axis2``, ``grid``), whose signatures do not change with the kernels behind
them, in a process of its own (the kernel library is
built from that tree's sources at first use).  ``--set`` copies this
checkout's package into ``_archive/variants/`` with ``constexpr int NAME =
value;`` lines of its CUDA sources replaced.

Shapes: K1 and K4 on both driven groups of OS subset 0 of the 3D flagship
(1801 angles, OS10, 8 x 2560^2) and at one slice beside K1p and K4p (K4 and
K4p also on all 1801 angles of one slice, and K4p adding into a slice); K2
and K3 on both groups of OS subset 0 at 8 slices and at 1 slice, K3 on the
group's own rows, after an indexed copy of them out of the subset's
sinogram, and (where the tree's wrapper takes ``index``) gathering them
itself, beside the copy alone and a launch on four samples; K1p on
both groups of OS subset 0 and of all 1801 angles of one 2560^2 slice,
beside K1 at nz = 1, and (where the tree's wrapper takes ``splits``) with
1, 2, 4, 8 and 16 runs of rows; G on 4 z-pairs x 1801 x 2560 random spectra
(one FOURIER_INV call of the flagship) and on 28 z-pairs (``Gx``: the
kernel alone with other tile orders, without compensation and with fewer
angles); PD as
one prox of 20 iterations (lambda 5e-4, L 12, iso, nonneg) on 8, 1, 2, 4, 12
and 16 x 2560^2 (this tree sends more than 8 slices to the y-wavefront
kernel, trees before it up to 16 to the tile kernel); ``PDw``: on 20, 64 and
512 x 2560^2 (trees before the wavefront: the tile kernel's z-chunks), 40
iterations on 20 x 2608^2 (the ADMM recipe's padded grid) and,
where the tree has the wavefront, that kernel alone on 8 x 2560^2 through
its C entry, a route the wrapper does not take there; F at 4 x 5120 x 5120
(sign +1), 8192 x 7208 and 2560 x 7208 (sign -1), beside its plain version
(``torch.fft`` with the complex pack and split) and ``torch.fft`` alone on
an already complex tensor; ``ifft2``: FOURIER_INV's whole ifft2 stage
(``usfft._ifft2_centered``) on 4 x 5120 x 5120 grids, the centred F (Fc)
where the tree has it, the chain of passes around F before; ``filter``:
FOURIER_INV's filter stage (``usfft._fbp_filter_stage``) on one z-block of
the benchmark's 512-row cell, 57 x 1801 x 2560 rows at ow 8192, F's filter
variant (Ff) where the tree has it, beside its plain version (the edge pad,
F twice, the crop), the plain version alone before.  Times are means of CUDA-event timings in ms;
the first line of output is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(repo: str, kernels) -> dict:
    sys.path.insert(0, os.path.abspath(repo))
    import numpy as np
    import torch

    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops import fft_kernels as FK
    from tomobar_tpu_torch.ops import pd_tv as PDT
    from tomobar_tpu_torch.ops import projector_kernels as K
    from tomobar_tpu_torch.ops import usfft_kernels as UK
    from tomobar_tpu_torch.ops.projector import Projector

    dev = torch.device("cuda", 0)

    def ms(fn, reps):
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

    def ms_device(fn, n=20, reps=10):
        """Milliseconds of one fn() on the device alone: n calls captured in
        a CUDA graph and replayed, so that the host's time to enqueue a call
        (more than a small kernel takes) is not what is measured."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        return ms(graph.replay, reps) / n

    out = {}
    N, NZ = 2560, 8
    gen = torch.Generator(device=dev).manual_seed(0)
    angles = np.linspace(0.0, np.pi, 1801, endpoint=False)
    vol = torch.randn((NZ, N, N), generator=gen, device=dev)
    one = vol[:1].contiguous()
    sub0 = Projector(Geometry(N, NZ, angles, 0.0, N, os_number=10))._sub_plans[0]
    if "K1" in kernels:
        for g in sub0.groups(N, N, dev):
            tag = "y" if g.swap else "x"
            out[f"K1 {tag} 8 slices"] = ms(lambda: K.shear_fp(vol, g.beta, g.prm.U0, g.prm.LU, g.swap), 10)
        for g in sub0.groups(N, N, dev, True):
            tag = "y" if g.swap else "x"
            rows = one.transpose(1, 2).contiguous() if g.swap else one
            out[f"K1 {tag} 1 slice"] = ms(lambda: K.shear_fp(one, g.beta, g.prm.U0, g.prm.LU, g.swap), 20)
            out[f"K1p {tag} 1 slice"] = ms(lambda: K.shear_fp_packed(rows, g.beta, g.prm.U0, g.prm.LU), 20)
    if "K1p" in kernels:
        import inspect

        has_splits = "splits" in inspect.signature(K.shear_fp_packed).parameters
        full = Projector(Geometry(N, 1, angles, 0.0, N))._plan
        for name, plan in (("OS subset 0", sub0), ("1801 angles", full)):
            for g in plan.groups(N, N, dev, True):
                tag = f"{'y' if g.swap else 'x'} {name}"
                rows = one.transpose(1, 2).contiguous() if g.swap else one
                out[f"K1p {tag}"] = ms(lambda: K.shear_fp_packed(rows, g.beta, g.prm.U0, g.prm.LU), 20)
                out[f"K1 at nz=1 {tag}"] = ms(lambda: K.shear_fp(one, g.beta, g.prm.U0, g.prm.LU, g.swap), 20)
                for sp in (1, 2, 4, 8, 16):
                    out[f"K1p {tag}, {sp} runs"] = ms(
                        lambda: K.shear_fp_packed(rows, g.beta, g.prm.U0, g.prm.LU, splits=sp), 20
                    ) if has_splits else float("nan")
    if "G" in kernels:
        theta = -angles
        for pairs, reps in ((4, 5), (28, 2)):
            g_re = torch.randn((pairs, 1801, N), generator=gen, device=dev)
            g_im = torch.randn((pairs, 1801, N), generator=gen, device=dev)
            out[f"G {pairs} z-pairs x 1801 x {N}"] = ms(lambda: UK.grid(g_re, g_im, N, theta), reps)
            del g_re, g_im
    if "Gx" in kernels and hasattr(UK, "tile_order"):
        # what G's time is made of: the C entry called with other tile orders,
        # without the compensated centre sums, and with fewer angles
        from tomobar_tpu_torch import _build

        lib, prm, theta = _build.library(), UK.grid_params(N), -angles
        cos_t, sin_t = UK._device_angles(theta.tobytes(), dev)
        g_re = torch.randn((4, 1801, N), generator=gen, device=dev)
        g_im = torch.randn((4, 1801, N), generator=gen, device=dev)
        f_re = torch.empty((4, 2 * N, 2 * N), device=dev)
        f_im = torch.empty_like(f_re)
        first = UK.tile_order(N, lib.tt_usfft_grid_tile(0), lib.tt_usfft_grid_tile(1))

        def launch(order, R, nproj):
            err = lib.tt_usfft_grid(
                g_re.data_ptr(), g_im.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
                f_re.data_ptr(), f_im.data_ptr(), order.data_ptr(), 4, nproj, N, prm.m, R,
                float(prm.coeff0), float(prm.coeff1), float(prm.clamp),
                torch.cuda.current_stream(dev).cuda_stream)
            _build.check("G", err)

        for label, order, R, nproj in (
            ("centre tiles first, R 128", first, 128, 1801),
            ("centre tiles first, no compensation", first, 0, 1801),
            ("centre tiles last", first[::-1].copy(), 128, 1801),
            ("row-major tiles", np.arange(first.size, dtype=np.int32), 128, 1801),
            ("900 angles", first, 128, 900),
            ("1 angle", first, 128, 1),
        ):
            order_t = torch.as_tensor(order, device=dev)
            out[f"G kernel alone, {label}"] = ms(lambda: launch(order_t, R, nproj), 5)
        del g_re, g_im, f_re, f_im
    if "K4" in kernels:
        for g in sub0.groups(N, N, dev):
            tag = "y" if g.swap else "x"
            q = torch.randn((g.prm.A, NZ, g.prm.LU), generator=gen, device=dev)
            out[f"K4 {tag} 8 slices"] = ms(lambda: K.unshear_bp(q, g.beta, g.prm.U0, N, N, g.swap), 10)
            out[f"K4 {tag} 8 slices, accumulate"] = ms(
                lambda: K.unshear_bp(q, g.beta, g.prm.U0, N, N, g.swap, out=vol), 10)
        one_out = torch.randn((1, N, N), generator=gen, device=dev)
        full = Projector(Geometry(N, 1, angles, 0.0, N))._plan
        for name, plan in (("1 slice", sub0), ("1 slice, 1801 angles", full)):
            for g in plan.groups(N, N, dev, True):
                tag = "y" if g.swap else "x"
                q = torch.randn((g.prm.A, 1, g.prm.LU), generator=gen, device=dev)
                out[f"K4 {tag} {name}"] = ms(lambda: K.unshear_bp(q, g.beta, g.prm.U0, N, N, g.swap), 20)
                out[f"K4p {tag} {name}"] = ms(lambda: K.unshear_bp_packed(q, g.beta, g.prm.U0, N, g.swap), 20)
                out[f"K4p {tag} {name}, accumulate"] = ms(
                    lambda: K.unshear_bp_packed(q, g.beta, g.prm.U0, N, g.swap, out=one_out), 20)
        del q, one_out
    if "K3" in kernels or "K2" in kernels:
        import inspect

        has_index = "index" in inspect.signature(K.resample_bp).parameters
        for nz_, single in ((NZ, False), (1, True)):
            sino = torch.randn((nz_, 1801 // 10 + 1, N), generator=gen, device=dev)  # OS subset 0
            for g in sub0.groups(N, N, dev, single):
                tag = f"{'y' if g.swap else 'x'} {nz_} slice{'s' if nz_ > 1 else ''}"
                p = sino[:, g.idx].contiguous()
                s = torch.randn((g.prm.A, nz_, g.prm.LU), generator=gen, device=dev)
                args = (g.alpha, g.gamma, g.prm.U0, g.prm.LU)
                # "device": calls replayed from a CUDA graph; "host loop": calls
                # enqueued one by one, as the projector makes them
                for how, timer in (("device", ms_device), ("host loop", lambda fn: ms(fn, 50))):
                    if "K2" in kernels:
                        out[f"K2 {tag} ({how})"] = timer(
                            lambda: K.resample_fp(s, g.alpha, g.gamma, g.prm.U0, N))
                    if "K3" in kernels:
                        out[f"K3 {tag}, rows copied before ({how})"] = timer(
                            lambda: K.resample_bp(p, *args))
                        out[f"K3 {tag}, copy + K3 ({how})"] = timer(
                            lambda: K.resample_bp(sino[:, g.idx], *args))
                        out[f"K3 {tag}, index ({how})"] = timer(
                            lambda: K.resample_bp(sino, *args, index=g.idx)) if has_index else float("nan")
                        out[f"the copy alone {tag} ({how})"] = timer(lambda: sino[:, g.idx])
            del sino, p, s
        # the floor of a launch on this card: the same kernel on four samples
        empty = torch.empty((1, 1, 4), device=dev)
        one_a = torch.ones(1, device=dev)
        out["K3 on 1 x 1 x 4 samples, LU 4 (device)"] = ms_device(
            lambda: K.resample_bp(empty, one_a, one_a, 0, 4))
        out["K3 on 1 x 1 x 4 samples, LU 4 (host loop)"] = ms(
            lambda: K.resample_bp(empty, one_a, one_a, 0, 4), 200)
    if "PD" in kernels:
        torch.abs_(vol)
        out["PD 20 iterations 8 slices"] = ms(lambda: PDT.pd_tv(vol, 5e-4, 20, 0, 1, 12.0), 5)
        out["PD 20 iterations 1 slice"] = ms(lambda: PDT.pd_tv(one, 5e-4, 20, 0, 1, 12.0), 20)
        out["PD 1 iteration 8 slices"] = ms(lambda: PDT.pd_tv(vol, 5e-4, 1, 0, 1, 12.0), 10)
        for nz_ in (2, 4, 12, 16):
            few = torch.rand((nz_, N, N), generator=gen, device=dev)
            out[f"PD 20 iterations {nz_} slices"] = ms(
                lambda: PDT.pd_tv(few, 5e-4, 20, 0, 1, 12.0), 5)
            del few
    if "PDw" in kernels:
        for nz_, reps in ((20, 5), (64, 3), (512, 1)):
            deep = torch.rand((nz_, N, N), generator=gen, device=dev)
            out[f"PD 20 iterations {nz_} slices"] = ms(
                lambda: PDT.pd_tv(deep, 5e-4, 20, 0, 1, 12.0), reps)
            del deep
            torch.cuda.empty_cache()
        # the ADMM recipe's prox: 40 iterations on the 24-px-padded 2608^2 grid
        deep = torch.rand((20, N + 48, N + 48), generator=gen, device=dev)
        out[f"PD 40 iterations 20 slices {N + 48}^2"] = ms(
            lambda: PDT.pd_tv(deep, 5e-4, 40, 0, 1, 12.0), 5)
        del deep
        from tomobar_tpu_torch import _build

        lib = _build.library()
        if hasattr(lib, "tt_pd_tv_wave"):
            torch.abs_(vol)
            out["PDw alone 20 iterations 8 slices"] = ms(
                lambda: wave_prox(PDT, lib, vol, 5e-4, 20, 12.0), 5)
    del vol, one
    rows = NZ * 1802 // 2
    for shape, sign in (((4, 2 * N, 2 * N), 1), ((8192, rows), -1), ((N, rows), -1)):
        if "F" not in kernels:
            break
        re_ = torch.randn(shape, generator=gen, device=dev)
        im_ = torch.randn(shape, generator=gen, device=dev)
        xc = torch.complex(re_, im_)
        tag = "x".join(map(str, shape))
        out[f"F {tag}"] = ms(lambda: FK.fft_axis2(re_, im_, sign), 10)
        out[f"F plain {tag}"] = ms(lambda: FK.fft_axis2_plain(re_, im_, sign), 10)
        out[f"torch.fft {tag}"] = ms(
            (lambda: torch.fft.fft(xc, dim=-2)) if sign < 0
            else (lambda: torch.fft.ifft(xc, dim=-2, norm="forward")), 10)
        del re_, im_, xc
    if "ifft2" in kernels:  # FOURIER_INV's whole ifft2 stage, whatever runs it
        from tomobar_tpu_torch.ops import usfft as US

        re_ = torch.randn((4, 2 * N, 2 * N), generator=gen, device=dev)
        im_ = torch.randn((4, 2 * N, 2 * N), generator=gen, device=dev)
        out[f"ifft2 stage 4x{2 * N}x{2 * N}"] = ms(lambda: US._ifft2_centered(re_, im_, N), 10)
        del re_, im_
    if "filter" in kernels:  # FOURIER_INV's filter stage, whatever runs it
        from tomobar_tpu_torch.ops import usfft as US

        block = torch.rand((57, 1801, N), generator=gen, device=dev)
        tag = f"57x1801x{N}"
        out[f"filter stage {tag}"] = ms(
            lambda: US._fbp_filter_stage(block, N, N, "shepp", 1.0, 0.5), 5)
        if hasattr(US, "_fbp_filter_plain"):  # the trees that have Ff: its plain version
            ow = US._oversampled_width(N, N, True, 4)
            out[f"filter plain {tag}"] = ms(
                lambda: US._fbp_filter_plain(block, ow, N, N, "shepp", 1.0, 0.5), 3)
        del block
    return out


def wave_prox(PDT, lib, data, lam: float, iterations: int, lc: float):
    """One iso, nonneg prox of the y-wavefront kernel through its C entry,
    on any slice count of at least 2 (the wrapper sends only more than
    ``FUSE_Z_MAX`` slices there): the wrapper's launches and buffers."""
    import torch

    sigma, tau, lt, theta = PDT.pd_tv_constants(lam, lc)
    nz, ny, nx = data.shape
    u = [torch.empty_like(data) for _ in range(2)]
    ps = [[torch.empty_like(data) for _ in range(3)] for _ in range(2)]
    stream = torch.cuda.current_stream(data.device).cuda_stream
    unused = data.data_ptr()
    plan = PDT.launch_plan(iterations, PDT.FUSE)
    for i, (k, first, last) in enumerate(plan):
        src = [unused] * 3 if first else [p.data_ptr() for p in ps[(i - 1) % 2]]
        dst = [unused] * 3 if last else [p.data_ptr() for p in ps[i % 2]]
        cut = ()  # a tree whose kernel takes its cut: the wrapper's
        if hasattr(PDT, "wave_plan"):
            slots = PDT._slots(lib, data.device, PDT.wave_slabs(nz, k)[0], k, False, True)
            cut = PDT.wave_plan(nz, ny, nx, k, slots)
        err = lib.tt_pd_tv_wave(
            data.data_ptr(), unused if first else u[(i - 1) % 2].data_ptr(), *src,
            u[i % 2].data_ptr(), *dst, nz, ny, nx, sigma, tau, lt, theta, 1, 1, 0, k,
            int(first), int(last), *cut, stream)
        if err:
            raise RuntimeError(f"tt_pd_tv_wave: CUDA error {err}")
    return u[(len(plan) - 1) % 2]


def ptxas_report(path: str, source: str) -> None:
    """Registers and spills of each kernel of ``csrc/<source>`` in the tree at
    ``path``, as ``nvcc -Xptxas -v`` reports them with the build's flags."""
    from tomobar_tpu_torch import _build

    src = os.path.join(path, "tomobar_tpu_torch", "csrc", source)
    with tempfile.TemporaryDirectory() as tmp:
        run = subprocess.run([_build._nvcc(), *_build._NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              os.path.join(tmp, "k.o"), src], capture_output=True, text=True)
    if run.returncode != 0:
        raise SystemExit(f"{path}: nvcc failed\n{run.stderr[-4000:]}")
    name = None
    for line in run.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("spill" in line or "registers" in line):
            print(f"{path} {name}: {line.split(':', 1)[-1].strip()}")


def make_variant(spec: str) -> str:
    """A copy of this checkout's package with the named constants replaced."""
    dst = os.path.join(HERE, "_archive", "variants", re.sub(r"[^A-Za-z0-9=,]", "_", spec))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "tomobar_tpu_torch"), os.path.join(dst, "tomobar_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(dst, "tomobar_tpu_torch", "csrc")
    for item in spec.split(","):
        name, value = item.split("=")
        hits = 0
        for fname in os.listdir(csrc):
            path = os.path.join(csrc, fname)
            text = open(path).read()
            new, n = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{value};", text)
            if n:
                open(path, "w").write(new)
                hits += n
        if hits != 1:
            raise SystemExit(f"--set {item}: {hits} lines 'constexpr int {name} = ...;' found")
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", action="append", default=[], help="a source tree to time")
    ap.add_argument("--set", action="append", default=[], dest="sets", metavar="NAME=VALUE,...",
                    help="a variant of this checkout with constexpr ints replaced")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", default="K1,K4,PD,F",
                    help="comma-separated: K1, K1p, K2, K3, K4 (with K4p), PD, PDw (PD on 20, 64 and "
                         "512 slices, 40 iterations on 20 x 2608^2), F, G, Gx (G's C entry with other tile orders, no compensation, "
                         "fewer angles), ifft2 (FOURIER_INV's ifft2 stage), filter (its filter stage)")
    ap.add_argument("--ptxas", metavar="SOURCE.cu",
                    help="first print each tree's register and spill report of csrc/SOURCE.cu")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker, args.kernels.split(","))))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    trees = [(r, r) for r in (args.repo or ["."])] + [(s, make_variant(s)) for s in args.sets]
    if args.ptxas:
        sys.path.insert(0, HERE)
        for _, path in trees:
            ptxas_report(path, args.ptxas)
    results = {name: [] for name, _ in trees}
    for rnd in range(args.rounds):
        for name, path in (trees if rnd % 2 == 0 else trees[::-1]):
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", path,
                                  "--kernels", args.kernels],
                                 capture_output=True, text=True)
            line = [x for x in run.stdout.splitlines() if x.startswith("RESULT ")]
            if run.returncode != 0 or not line:
                print(run.stdout[-2000:], run.stderr[-4000:])
                raise SystemExit(f"{name}: the timing process failed")
            results[name].append(json.loads(line[0][7:]))
    keys = []
    for runs in results.values():
        keys += [k for k in runs[0] if k not in keys]
    print("ms per call; one column per round: " + " | ".join(name for name, _ in trees))
    for k in keys:
        print(f"{k:>48}: " + " | ".join(
            " ".join(f"{r.get(k, float('nan')):8.3f}" for r in results[name]) for name, _ in trees))
    return 0


if __name__ == "__main__":
    sys.exit(main())
