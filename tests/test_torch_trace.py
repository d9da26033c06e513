"""The spans and counters of ``tomobar_tpu_torch.trace`` on the CPU.

* with no profiler recording, a span is one shared object that records
  nothing;
* under ``torch.profiler`` (CPU activity) spans nest with the right parent
  and call ids, self time is the time less the children's, counters report
  their increase over the recording (the kernel launches of
  ``_build.launch_counts`` among them) and the profile holds the spans'
  ``tomobar::`` ranges;
* at a tiny size each traced entry point gives its span tree, with answers
  bit for bit those of an untraced call: FISTA-OS ``iterations x OS``
  subsets of one gradient and one prox each, a 2D FBP one ``api.init`` and
  two plan builds a reconstructor, FOURIER_INV five stages a z-block.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from tomobar_tpu_torch import RecToolsDIR, RecToolsDIRCuPy, RecToolsIRCuPy, _build, trace

torch.set_num_threads(1)

N = 32
ANGLES = np.linspace(0.0, np.pi, 30, endpoint=False)


@pytest.fixture(autouse=True)
def fresh_record():
    trace.reset()
    yield
    trace.reset()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _disc(nz=2):
    yy, xx = np.mgrid[-1:1:N * 1j, -1:1:N * 1j]
    return np.stack([(xx ** 2 + yy ** 2 < 0.5).astype(np.float32)] * nz)


def _names(snap):
    return Counter(s["name"] for s in snap["spans"])


def _children(snap, parent):
    return [s for s in snap["spans"] if s["parent"] == parent["id"]]


def test_off_a_span_is_one_shared_object_and_records_nothing():
    a, b = trace.span("tomobar::a"), trace.span("tomobar::b", nz=3)
    assert a is b
    with trace.span("tomobar::a", nz=1):
        with trace.span("tomobar::b"):
            pass
    rt = RecToolsDIR(N, 0, None, 0.0, ANGLES, N, device="cpu")
    rt.FBP(rt.FORWPROJ(_disc(1)[0]))
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["dropped"] == 0
    assert not any(snap["counters"].values())


def test_off_a_span_lets_an_exception_through():
    with pytest.raises(KeyError):
        with trace.span("tomobar::a"):
            raise KeyError("x")


def test_spans_nest_with_parent_call_and_self_time():
    with _profile() as prof:
        with trace.span("tomobar::api.Outer"):
            with trace.span("tomobar::inner", k=1):
                with trace.span("tomobar::leaf"):
                    sum(range(20000))
            with trace.span("tomobar::inner", k=2):
                pass
        with trace.span("tomobar::loose"):
            pass
    snap = trace.snapshot()
    by = {s["id"]: s for s in snap["spans"]}
    outer, in1, leaf, in2, loose = (by[i] for i in range(5))
    assert [s["name"] for s in (outer, in1, leaf, in2, loose)] == [
        "tomobar::api.Outer", "tomobar::inner", "tomobar::leaf", "tomobar::inner",
        "tomobar::loose"]
    assert (outer["parent"], in1["parent"], leaf["parent"], in2["parent"]) == (None, 0, 1, 0)
    assert {s["call"] for s in (outer, in1, leaf, in2)} == {0} and loose["call"] is None
    assert (in1["attrs"], in2["attrs"]) == ({"k": 1}, {"k": 2})
    for s in snap["spans"]:
        kids = _children(snap, s)
        assert s["self_host_s"] == pytest.approx(s["host_s"] - sum(k["host_s"] for k in kids))
        # no card: the device's times are the host's
        assert s["device_s"] == s["host_s"] and s["self_device_s"] == s["self_host_s"]
        assert s["self_host_s"] >= 0
    assert outer["host_s"] >= in1["host_s"] + in2["host_s"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"tomobar::api.Outer", "tomobar::inner", "tomobar::leaf", "tomobar::loose"} <= names


def test_counters_report_their_increase_over_the_recording():
    assert _build.launch_counts is trace.launches
    _build.reset_launch_counts()
    trace.count("K1")  # before the recording: counted, not recorded
    builds = trace.counters["projector.plan_builds"]
    with _profile():
        trace.count("K1", 2)
        trace.count("PDw")
        trace.count("projector.plan_builds")
    trace.count("G")  # after it
    snap = trace.snapshot()["counters"]
    assert snap["K1"] == 2 and snap["PDw"] == 1 and snap["G"] == 0
    assert snap["projector.plan_builds"] == 1 and snap["projector.plan_hits"] == 0
    assert _build.launch_counts["K1"] == 3 and _build.launch_counts["G"] == 1
    assert trace.counters["projector.plan_builds"] == builds + 1
    _build.reset_launch_counts()
    assert all(v == 0 for v in _build.launch_counts.values())


def test_pdw_counts_its_launched_and_kept_block_rows(monkeypatch):
    """At each PDw launch the wrapper adds the launch's block-rows to
    ``pdw.rows_launched`` (waves x slots x slab slices x (segment rows +
    2K)) and ``pdw.rows_kept`` (strips x nz x ny), and hands the kernel
    ``wave_plan``'s cut: here through a stand-in for the kernel library on
    a card of 132 slots, 9 iterations (launches of 4, 4, 1) on 41 x 100 x
    120.  K 4: 2 slabs of 25, 20 segments of 5 rows, 3 strips of 56
    columns, 120 blocks in one wave, so 132 x 25 x 13 = 42900 block-rows
    launched and 3 x 41 x 100 = 12300 kept; K 1: 2 slabs of 22, 25
    segments of 4, 2 strips of 62, so 132 x 22 x 6 = 17424 and 8200."""
    from contextlib import nullcontext
    from types import SimpleNamespace

    from tomobar_tpu_torch.ops import pd_tv as PDT

    cuts = []

    def wave(*args):
        cuts.append(args[-4:-1])
        return 0

    lib = SimpleNamespace(tt_pd_tv_fuse=lambda nz: 4, tt_pd_tv_wave=wave,
                          tt_pd_tv_wave_slots=lambda zs, k, bf16, iso: 132)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(PDT, "_wave_slots", {})
    with _profile():
        PDT._pd_tv_cuda(torch.zeros((41, 100, 120)), 0.05, 9, 0, 1, 12.0, False)
    assert cuts == [(5, 25, 2), (5, 25, 2), (4, 22, 2)]
    snap = trace.snapshot()["counters"]
    assert snap["PDw"] == 3
    assert snap["pdw.rows_launched"] == 2 * 132 * 25 * 13 + 132 * 22 * 6 == 103224
    assert snap["pdw.rows_kept"] == 2 * 3 * 41 * 100 + 2 * 41 * 100 == 32800


def test_a_full_record_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 2)
    with _profile():
        for _ in range(3):
            with trace.span("tomobar::api.X"):
                with trace.span("tomobar::y"):
                    pass
    snap = trace.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["tomobar::api.X", "tomobar::y"]
    assert snap["dropped"] == 4


def test_reset_clears_the_record():
    with _profile():
        with trace.span("tomobar::a"):
            trace.count("projector.plan_hits")
    trace.reset()
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["counters"]["projector.plan_hits"] == 0


@pytest.mark.parametrize("os_number, iterations", [(3, 2), (1, 1)])
def test_fista_os_gives_subsets_of_one_gradient_and_one_prox(os_number, iterations):
    def fista():
        rt = RecToolsIRCuPy(N, 0, 2, 0.0, ANGLES, N, OS_number=os_number, device="cpu")
        sino = rt.Atools.fp(torch.as_tensor(_disc()))
        return rt.FISTA({"projection_data": sino, "data_fidelity": "PWLS"},
                        {"iterations": iterations, "nonnegativity": True},
                        {"method": "PD_TV", "regul_param": 1e-3, "iterations": 5})

    off = fista()
    with _profile():
        on = fista()
    assert torch.equal(off, on)
    snap = trace.snapshot()
    (call,) = [s for s in snap["spans"] if s["name"] == "tomobar::api.FISTA"]
    subsets = [s for s in snap["spans"] if s["name"] == "tomobar::solver.subset"]
    assert len(subsets) == iterations * os_number
    for s in subsets:
        assert s["call"] == call["id"] and s["attrs"] == {"nz": 2, "n": N}
        kids = _children(snap, s)
        assert sorted(k["name"] for k in kids) == ["tomobar::fidelity.grad", "tomobar::regul.prox"]
        (prox,) = [k for k in kids if k["name"] == "tomobar::regul.prox"]
        assert prox["attrs"] == {"method": "PD_TV", "nz": 2, "n": N, "iterations": 5}
        (grad,) = [k for k in kids if k["name"] == "tomobar::fidelity.grad"]
        assert sorted(k["name"] for k in _children(snap, grad)) == [
            "tomobar::projector.bp", "tomobar::projector.fp"]
    names = _names(snap)
    assert names["tomobar::fidelity.grad"] == names["tomobar::regul.prox"] == len(subsets)
    assert names["tomobar::api.init"] == 1 and names["tomobar::api.powermethod"] == 1


def test_fbp_2d_builds_two_plans_a_reconstructor():
    sino = RecToolsDIR(N, 0, None, 0.0, ANGLES, N, device="cpu").FORWPROJ(_disc(1)[0])

    def calls(k):
        return [RecToolsDIR(N, 0, None, 0.0, ANGLES, N, device="cpu").FBP(sino) for _ in range(k)]

    off = calls(3)
    with _profile():
        on = calls(3)
    assert all(np.array_equal(a, b) for a, b in zip(off, on))
    snap = trace.snapshot()
    names = _names(snap)
    assert names["tomobar::api.init"] == names["tomobar::api.FBP"] == 3
    assert names["tomobar::projector.plan"] == 6 and names["tomobar::projector.bp"] == 3
    assert snap["counters"]["projector.plan_builds"] == 6
    assert snap["counters"]["projector.plan_hits"] == 0
    for plan in (s for s in snap["spans"] if s["name"] == "tomobar::projector.plan"):
        assert plan["attrs"]["rows"] == N and plan["attrs"]["A"] > 0
        assert {snap["spans"][plan["call"]]["name"]} == {"tomobar::api.FBP"}
    assert sum(p["attrs"]["A"] for p in snap["spans"]
               if p["name"] == "tomobar::projector.plan") == 3 * ANGLES.size


@pytest.mark.parametrize("chunk_count", [1, 2])
def test_fourier_inv_gives_five_stages_a_block(chunk_count):
    rd = RecToolsDIRCuPy(N, 0, 4, 0.0, ANGLES, N, device="cpu")
    sino = rd.FORWPROJ(_disc(4))
    off = rd.FOURIER_INV(sino, chunk_count=chunk_count)
    with _profile():
        on = rd.FOURIER_INV(sino, chunk_count=chunk_count)
    assert torch.equal(off, on)
    snap = trace.snapshot()
    stages = ("filter", "fft1d", "grid", "ifft2", "unpad")
    (call,) = [s for s in snap["spans"] if s["name"] == "tomobar::api.FOURIER_INV"]
    found = [s for s in snap["spans"] if s["name"].startswith("tomobar::usfft.")]
    assert [s["name"].split(".")[-1] for s in found] == list(stages) * chunk_count
    assert all(s["parent"] == call["id"] for s in found)
    assert [s["attrs"]["nz"] for s in found[::5]] == [4 // chunk_count] * chunk_count
    assert {(s["attrs"]["nproj"], s["attrs"]["n"]) for s in found} == {(ANGLES.size, N)}
