"""Port parity of memory planning: ``DeviceMemStack``, the shape-tuple dry
run of ``RecToolsDIRCuPy.FOURIER_INV`` and the model behind it
(``utils/memest.py``), held against the JAX package's shape mode and
against the live bytes of real CPU ``FOURIER_INV`` calls.

The model replays ``ops/usfft.py``'s allocations from the shapes; on the
CPU its peak must lie within [1.0, 1.3] of the peak that
``LiveBytes`` sees in the real call plus the input (the tensor made from a
numpy array shares its memory, so the tracker does not see it).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tomobar_tpu import RecToolsDIRCuPy as JaxDIR
from tomobar_tpu.utils import memest as JM

from tomobar_tpu_torch import RecToolsDIRCuPy
from tomobar_tpu_torch.ops.usfft import fourier_inv_pair_bytes
from tomobar_tpu_torch.utils import memest as M

torch.set_num_threads(1)


def problem(nz, nproj, det, recon=None, seed=0):
    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    recon = recon or det - det % 2
    rt = RecToolsDIRCuPy(det, 0, nz, 0.0, angles, recon, device="cpu")
    data = np.random.default_rng(seed).standard_normal((nz, nproj, det)).astype(np.float32)
    return rt, data, angles


def test_device_mem_stack_semantics():
    """512-byte rounding, balance, nesting (the outermost stack stays the
    instance), and a free of what was never allocated fails: as the JAX
    package's."""
    for pkg in (M, JM):
        assert pkg.DeviceMemStack.instance() is None
        with pkg.DeviceMemStack() as outer:
            assert pkg.DeviceMemStack.instance() is outer
            outer.malloc(1)
            outer.malloc(1000)
            assert outer.current == 512 + 1024 and outer.highwater == 1536
            with pkg.DeviceMemStack() as inner:
                assert pkg.DeviceMemStack.instance() is outer and inner is not outer
            assert pkg.DeviceMemStack.instance() is outer
            outer.free(1000)
            outer.malloc(513)
            assert outer.current == 512 + 1024 and outer.highwater == 1536
            outer.free(1)
            outer.free(513)
            assert outer.current == 0 and outer.allocations == []
            with pytest.raises(AssertionError):
                outer.free(7)
        assert pkg.DeviceMemStack.instance() is None


@pytest.mark.parametrize("shape", [(4, 30, 64), (5, 31, 65), (30, 64)])
def test_shape_mode_matches_jax_and_the_real_call(shape):
    nz = shape[0] if len(shape) == 3 else None
    nproj, det = shape[-2:]
    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    rt = RecToolsDIRCuPy(det, 0, nz, 0.0, angles, 64, device="cpu")
    jrt = JaxDIR(det, 0, nz, 0.0, angles, 64)
    data = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    with M.DeviceMemStack() as stack, M.LiveBytes() as live:
        got = rt.FOURIER_INV(shape)
    assert live.peak == 0  # the real call never ran: nothing was allocated
    assert stack.current == 0 and stack.highwater > 0
    with JM.DeviceMemStack():
        ref = jrt.FOURIER_INV(shape)
    real = rt.FOURIER_INV(data)
    assert tuple(got) == tuple(ref) == tuple(real.shape)
    assert stack.highwater >= (data.size + real.numel()) * 4
    with M.DeviceMemStack():
        assert tuple(rt.FOURIER_INV(list(shape))) == tuple(got)


def test_shape_tuple_outside_a_stack_raises():
    rt, _, _ = problem(4, 8, 32)
    with pytest.raises(ValueError, match="DeviceMemStack"):
        rt.FOURIER_INV((4, 8, 32))


def test_per_stage_names_match_jax():
    rt, _, angles = problem(4, 30, 64)
    got = M.estimate_fourier_inv_memory(rt, (4, 30, 64), per_stage=True)
    ref = JM.estimate_fourier_inv_memory(JaxDIR(64, 0, 4, 0.0, angles, 64), (4, 30, 64), per_stage=True)
    assert set(got["stages"]) == set(ref["stages"]) == {"filter", "fft1d", "grid", "ifft2", "unpad"}
    assert got["stage_peak"] == max(s["total"] for s in got["stages"].values())
    assert got["stages"][got["stage_peak_name"]]["total"] == got["stage_peak"]
    for s in got["stages"].values():
        assert s["total"] == s["argument"] + s["output"] + s["temp"]
    assert got["output_shape"] == ref["output_shape"]


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("size", [(8, 90, 96), (7, 61, 101)])
def test_model_against_the_live_bytes_of_a_real_call(size, chunks):
    rt, data, _ = problem(*size, recon=96)
    kw = {"chunk_count": chunks}
    est = M.estimate_fourier_inv_memory(rt, data.shape, **kw)
    with M.LiveBytes() as live:
        out = rt.FOURIER_INV(data, **kw)
    measured = live.peak + data.nbytes
    assert est["output_shape"] == tuple(out.shape)
    assert est["argument"] == data.nbytes and est["output"] == out.numel() * 4
    assert 1.0 <= est["total"] / measured <= 1.3, (est["total"], measured)


def test_model_with_mask_and_padding_against_a_real_call():
    rt, data, _ = problem(6, 45, 70, recon=64)
    kw = {"recon_mask_radius": 0.9, "padding": 5, "filter_type": "hann"}
    est = M.estimate_fourier_inv_memory(rt, data.shape, **kw)
    with M.LiveBytes() as live:
        rt.FOURIER_INV(data, **kw)
    assert 1.0 <= est["total"] / (live.peak + data.nbytes) <= 1.3


@pytest.mark.parametrize("nz,nproj,n", [(4, 90, 640), (8, 180, 1024), (16, 1801, 2560)])
def test_chunk_heuristic_within_a_quarter_of_the_ifft2_stage(nz, nproj, n):
    """``fourier_inv_pair_bytes`` (the chunk count's plan, 4 grid-sized
    buffer pairs per z-pair) against the modelled peak stage on a CUDA
    device, where every call is planned: the ifft2 stage, within 25%.  The
    model only (no call runs).  At n > 512, where the ifft2 passes run the
    F kernel; below, they run ``torch.fft`` with its complex copies and the
    plan covers ~0.64 of the stage (a third of the free memory is the
    budget)."""
    rt, _, _ = problem(nz, nproj, n)
    # the model of a CUDA-bound instance, which this machine need not have
    on_cuda = SimpleNamespace(device=torch.device("cuda"), recon_size=rt.recon_size,
                              detectors_x_pad=rt.detectors_x_pad)
    r = M.estimate_fourier_inv_memory(on_cuda, (nz, nproj, n), per_stage=True, chunk_count=1)
    assert r["stage_peak_name"] == "ifft2"
    ratio = fourier_inv_pair_bytes(n) * (nz // 2) / r["stage_peak"]
    assert 0.75 <= ratio <= 1.25, ratio
    # the CPU model of the same call: the plain FFT's complex copies
    cpu = M.estimate_fourier_inv_memory(rt, (nz, nproj, n), per_stage=True)
    assert cpu["stages"]["ifft2"]["total"] > r["stages"]["ifft2"]["total"]


def test_estimate_memory_runs_on_zeros():
    calls = []

    def fn(x, y, scale=1.0):
        calls.append(float(x.abs().sum()))
        return (x * scale + y).sum(dim=0)

    x = torch.ones(64, 32)
    res = M.estimate_memory(fn, x, np.ones((64, 32), np.float32), scale=2.0)
    assert calls == [0.0]  # zeros of the example shapes
    assert res["argument"] == 2 * 64 * 32 * 4 and res["output"] == 32 * 4
    assert res["total"] == res["argument"] + res["output"] + res["temp"]
    assert res["temp"] >= 64 * 32 * 4  # x * scale
    assert res["generated_code"] == 0 and res["alias"] == 0


def test_live_bytes_counts_storages_once():
    with M.LiveBytes() as live:
        a = torch.zeros(1000)
        b = a[10:]  # a view: nothing new
        a.add_(1.0)  # in place: nothing new
        c = a * 2
        assert live.live == 8000
        del c
        assert live.live == 4000
        del a
        assert live.live == 4000  # the view keeps the storage
        del b
    assert live.live == 0 and live.peak == 8000


def test_live_bytes_tells_meta_storages_apart():
    """Every meta storage has the address 0: storages are told apart by
    identity."""
    with M.LiveBytes() as live:
        a = torch.empty(1000, device="meta")
        b = torch.empty(500, device="meta")
        c = a + 1.0
        assert live.live == 4000 + 2000 + 4000
        del a, c
        assert live.live == 2000
        del b
    assert live.live == 0 and live.peak == 10000


def test_estimate_memory_of_an_example_larger_than_the_machine():
    """An example larger than the machine's memory (64 GiB, or twice the
    physical memory where that is more) is planned on meta tensors: the
    estimate covers it, and nothing of its size is allocated."""
    import resource

    phys = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    numel = max(64 * 2**30, 2 * phys) // 4
    example = torch.zeros(1).expand(numel)  # its shape, one float of storage
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    res = M.estimate_memory(lambda x: x * 2.0 + 1.0, example)
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) * 1024
    assert res["argument"] == res["output"] == 4 * numel
    assert res["total"] >= 64 * 2**30 and res["total"] >= 3 * 4 * numel  # x, x*2, +1
    assert grown < 2**30, grown


def test_estimate_memory_of_a_card_path_on_meta():
    """PD-TV's prox on a 64 GiB meta volume: the wrapper's buffers (u twice,
    three duals twice, per z-chunk), no launch, and the same keys as the
    measured path."""
    from tomobar_tpu_torch import _build
    from tomobar_tpu_torch.regularisers import PD_TV

    _build.reset_launch_counts()
    vol = torch.empty((2**34 // (1024 * 1024), 1024, 1024), device="meta")
    res = M.estimate_memory(lambda v: PD_TV(v, 1e-3, 8, 0, 1, 12.0), vol)
    assert set(res) == {"argument", "output", "temp", "generated_code", "alias", "total"}
    assert res["argument"] == res["output"] == 2**36
    assert res["total"] > 2 * 2**36
    assert all(v == 0 for v in _build.launch_counts.values())


META_PATHS = ["fp", "bp", "fp_sub", "fp_2d", "bp_2d", "pd_tv", "pd_tv_2d", "fourier_inv", "fbp"]


@pytest.mark.parametrize("path", META_PATHS)
def test_meta_branches_give_the_plain_shapes(monkeypatch, path):
    """Each path through the kernel wrappers, planned on meta (forced), makes
    the result the CPU run makes, launches nothing, and PD-TV holds its nine
    volumes (the input, u twice, three duals twice)."""
    from tomobar_tpu_torch import _build
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector
    from tomobar_tpu_torch.regularisers import PD_TV

    n, nz, na = 64, 4, 30
    angles = np.linspace(0, np.pi, na, endpoint=False)
    proj = Projector(Geometry(n, nz, angles, 0.0, n, os_number=3))
    proj1 = Projector(Geometry(n, 1, angles, 0.0, n))
    rd = {d: RecToolsDIRCuPy(n, 0, nz, 0.0, angles, n, device=d) for d in ("cpu", "meta")}
    cases = {
        "fp": (proj.fp, (nz, n, n)), "bp": (proj.bp, (nz, na, n)),
        "fp_sub": (lambda v: proj.fp_sub(v, 1), (nz, n, n)),
        "fp_2d": (proj1.fp, (1, n, n)), "bp_2d": (proj1.bp, (1, na, n)),
        "pd_tv": (lambda v: PD_TV(v, 1e-3, 20, 0, 1, 12.0), (nz, n, n)),
        "pd_tv_2d": (lambda v: PD_TV(v, 1e-3, 20, 0, 1, 12.0), (n, n)),
        "fourier_inv": (None, (nz, na, n)), "fbp": (None, (na, nz, n)),
    }
    fn, shape = cases[path]
    outs = {}
    for dev in ("cpu", "meta"):
        call = fn or getattr(rd[dev], path.upper())
        outs[dev] = call(torch.zeros(shape, device=dev))
    assert outs["meta"].is_meta and outs["meta"].shape == outs["cpu"].shape
    monkeypatch.setattr(M, "_fits", lambda nbytes, device: False)
    _build.reset_launch_counts()
    res = M.estimate_memory(fn or getattr(rd["meta"], path.upper()), torch.zeros(shape))
    assert all(v == 0 for v in _build.launch_counts.values())
    assert res["output"] == outs["cpu"].numel() * 4
    assert res["total"] >= res["argument"] + res["output"]
    if path.startswith("pd_tv"):  # one slice: two duals a set
        assert res["total"] == (9 if path == "pd_tv" else 7) * res["argument"]
