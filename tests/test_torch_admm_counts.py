"""The benchmark's ADMM cell on the CPU at a small size: ToMoBAR's real-data
recipe as the port runs it (raw counts, ``normaliser``, the padded FBP
warm start, ADMM with ordered subsets, PWLS and PD-TV) against the plain
reference ``benchmark/reference/admm.py``, which the same reference in
bfloat16 fails; the normaliser and its guards against the plain one; the
spans ``tomobar::solver.admm_subset`` and ``tomobar::prep.normalise``;
the readers of the two metrics that read them; and the harness's runs of
the cells the ADMM cell came with."""

import json
import math

import numpy as np
import pytest
import torch

from benchmark import inputs, program, registry, run
from benchmark.reference import admm as ref_admm
from benchmark.reference.common import rel_l2
from benchmark.tests.tiny import REPO, control_entry
from benchmark.tests.tiny_cells import tiny_root

CELL = "admm_os24.counts.chunk20"
CONFIG = REPO / "benchmark" / "configs" / "admm_os24_pwls_pdtv_counts_1801x2560.json"
TRAFFIC = {"entry": "ADMM", "chunk_slices": 4, "distinct_chunks": 1}
ROWS, N, PAD, OS = 4, 64, 4, 4


def _limit() -> float:
    own = json.loads((REPO / "benchmark" / "workloads" / f"{CELL}.json").read_text())
    return own["limits"]["rel_l2"]


def _config(iterations: int = 2) -> dict:
    """The cell's configuration at 64 x 64 x 60 angles, a 4-pixel pad and
    4 subsets (3 outer iterations reach the relaxation)."""
    cfg = json.loads(CONFIG.read_text())
    cfg["geometry"].update(angles=60, detector_x=N, recon_size=N)
    cfg["data"]["scan_rows"] = 64
    cfg["reconstructor"].update(DetectorsDimH_pad=PAD, OS_number=OS)
    cfg["ADMM"]["algorithm"]["iterations"] = iterations
    cfg["ADMM"]["regularisation"]["regul_param"] = 1.2e-2
    return cfg


def _chunk(cfg, seed=2**31 + 5):
    return inputs.make_chunks(cfg, TRAFFIC, seed, "cpu")[0]


@pytest.fixture
def entry():
    return registry.entry(REPO, "ADMM")


@pytest.mark.parametrize("iterations", [2, 3])
def test_recipe_matches_the_reference_and_bf16_fails(entry, iterations):
    cfg = _config(iterations)
    chunk = _chunk(cfg)
    prog = entry.warmup(cfg, TRAFFIC, chunk, "cpu")
    ref = entry.reference(cfg, TRAFFIC, chunk, [0])[0]
    assert prog.shape == ref.shape == (ROWS, N, N)
    assert rel_l2(prog, ref) < _limit() / 10
    assert rel_l2(entry.reference(cfg, TRAFFIC, chunk, [0], "bf16")[0], ref) > _limit()


def test_a_call_uses_the_frames_set_up_made(entry):
    cfg = _config()
    chunk = _chunk(cfg)
    with pytest.raises(RuntimeError, match="no raw frames"):
        entry.call(cfg, TRAFFIC, chunk, "cpu")
    first = entry.warmup(cfg, TRAFFIC, chunk, "cpu")
    assert torch.equal(entry.call(cfg, TRAFFIC, chunk, "cpu"), first)
    with pytest.raises(RuntimeError, match="no raw frames"):
        entry.call(cfg, TRAFFIC, chunk.clone(), "cpu")


def test_raw_frames_are_counts_that_normalise_back_to_the_chunk(entry):
    cfg = _config()
    chunk = _chunk(cfg)
    frames, flats, darks = entry.raw_frames(cfg, chunk)
    again = entry.raw_frames(cfg, chunk)
    assert all(torch.equal(a, b) for a, b in zip((frames, flats, darks), again))
    assert [t.shape for t in (frames, flats, darks)] == [(60, ROWS, N), (20, ROWS, N), (10, ROWS, N)]
    for t in (frames, flats, darks):
        assert t.dtype == torch.float32 and torch.equal(t, torch.round(t))
    # the gain pattern is in the frames and the flats, and divides out
    assert float(flats.mean(0).std() / flats.mean()) > 0.03
    back = ref_admm.normalise(frames, flats, darks).transpose(0, 1) * (N / 4.0)
    assert rel_l2(back, chunk) < 0.02


def test_normaliser_matches_the_plain_one_with_its_guards():
    from tomobar_tpu_torch.utils.tools import normaliser

    g = torch.Generator().manual_seed(11)
    frames = torch.poisson(torch.full((30, 3, 40), 500.0), generator=g)
    flats = torch.poisson(torch.full((6, 3, 40), 900.0), generator=g)
    darks = torch.poisson(torch.full((4, 3, 40), 50.0), generator=g)
    frames[:, 0, :5] = 0.0  # below the dark: a negative numerator
    flats[:, 1, 5:9] = 10.0  # flat below dark: a non-positive denominator
    flats[:, 1, 9] = darks[:, 1, 9].mean()  # a zero denominator
    frames[:, 2, 20:24] = 5000.0  # brighter than the flat: a negative -log
    got = normaliser(frames, flats, darks, log=True, method="mean")
    want = ref_admm.normalise(frames, flats, darks)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[:, 0, :5] != 0).all() and (got[:, 2, 20:24] == 0).all()
    assert (got >= 0).all()


def _admm_spans(entry, iterations):
    from tomobar_tpu_torch import trace

    cfg = _config(iterations)
    chunk = _chunk(cfg)
    entry.warmup(cfg, TRAFFIC, chunk, "cpu")
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        entry.call(cfg, TRAFFIC, chunk, "cpu")
    snap = trace.snapshot()
    trace.reset()
    return snap


@pytest.mark.parametrize("iterations", [2, 3])
def test_the_spans_of_a_call(entry, iterations):
    snap = _admm_spans(entry, iterations)
    spans = snap["spans"]
    subsets = [s for s in spans if s["name"] == "tomobar::solver.admm_subset"]
    assert len(subsets) == iterations * OS
    for s in subsets:
        kids = sorted(c["name"] for c in spans if c["parent"] == s["id"])
        assert kids == ["tomobar::fidelity.grad", "tomobar::regul.prox"]
        assert s["attrs"] == {"nz": ROWS, "n": N + 2 * PAD}
        assert s["call"] is not None
    norm = [s for s in spans if s["name"] == "tomobar::prep.normalise"]
    assert len(norm) == 1
    assert norm[0]["attrs"] == {"frames": 60, "rows": ROWS, "det_x": N, "flats": 20, "darks": 10}
    assert not [s for s in spans if s["name"] == "tomobar::solver.subset"]  # FISTA's


def _snapshot(spans):
    return {"spans": spans, "counters": {}, "dropped": 0}


def _span(i, name, attrs, dev, parent=None):
    return {"id": i, "parent": parent, "call": 0, "name": name, "attrs": attrs, "start_ns": 0,
            "host_s": dev, "device_s": dev, "self_host_s": dev, "self_device_s": dev}


def test_the_readers_on_a_synthetic_snapshot(monkeypatch):
    upd = registry.metric(REPO, "admm_update_roofline_pct")
    nrm = registry.metric(REPO, "normalise_roofline_pct")
    subset = _span(0, "tomobar::solver.admm_subset", {"nz": 20, "n": 2608}, 0.5)
    subset["self_device_s"] = 0.01  # less its fidelity and prox children
    norm_attrs = {"frames": 1801, "rows": 20, "det_x": 2560, "flats": 20, "darks": 10}
    spans = [subset, _span(1, "tomobar::fidelity.grad", {}, 0.2, 0),
             _span(2, "tomobar::regul.prox", {}, 0.29, 0),
             _span(3, "tomobar::prep.normalise", norm_attrs, 0.002),
             _span(4, "tomobar::solver.subset", {"nz": 20, "n": 2560}, 1.0)]
    monkeypatch.setattr(program, "snapshot", lambda: _snapshot(spans))
    assert upd.update_bytes(20, 2608) == 6 * 4 * 20 * 2608**2
    assert nrm.normalise_bytes(**norm_attrs) == 4 * 20 * 2560 * (2 * 1801 + 30)
    u, v = upd.read(None), nrm.read(None)
    assert u == pytest.approx(100 * upd.update_bytes(20, 2608) / 3.35e12 / 0.01)
    assert v == pytest.approx(100 * nrm.normalise_bytes(**norm_attrs) / 3.35e12 / 0.002)
    assert all(math.isfinite(x) and 0 < x < 100 for x in (u, v))
    # a program without the spans (or without the trace module) reads nothing
    for snap in (_snapshot(spans[4:]), None):
        monkeypatch.setattr(program, "snapshot", lambda snap=snap: snap)
        assert upd.read(None) is None and nrm.read(None) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("admm"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", [CELL, "fista_pdtv.chunk64"])
def test_the_harness_runs_the_new_cells(root, cell, trace):
    from tomobar_tpu_torch import trace as program_trace

    program_trace.reset()
    res = run.run(cell, 2**31 + 17, 0.05, trace, root=root, device="cpu", check_device=False)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    if trace:
        # the metrics of the program's spans (no device trace on the CPU)
        news = ({"admm_update_roofline_pct", "normalise_roofline_pct"} if cell == CELL
                else {"solver_roofline_pct"})
        for name in news:
            assert math.isfinite(res["metrics"][name]["value"]), name
    else:
        assert {"slices_per_s", "setup_s"} <= set(res["metrics"])


def test_the_bf16_control_through_the_harness_is_not_correct(root, monkeypatch):
    control_entry(monkeypatch)
    res = run.run(CELL, 2**31 + 31, 0.05, False, root=root, device="cpu", check_device=False)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert not res["correct"], res["checks"]


def test_the_reference_recipe_crops_or_masks(entry):
    cfg = _config()
    chunk = _chunk(cfg)
    frames, flats, darks = entry.raw_frames(cfg, chunk)
    theta = inputs.angles(cfg["geometry"])
    regul = cfg["ADMM"]["regularisation"]
    args = (frames, flats, darks, theta, 0.0, N)
    padded = ref_admm.admm_counts(*args, PAD, OS, 1.1, 1, 0.9, 1.7, regul)
    unpadded = ref_admm.admm_counts(*args, 0, OS, 1.1, 1, 0.9, 1.7, regul, mask_radius=1.0)
    assert padded.shape == unpadded.shape == (ROWS, N, N)
    assert float(unpadded[:, 0, 0].abs().max()) == 0.0
    assert rel_l2(padded, unpadded) > 1e-3
    assert np.isfinite(padded.numpy()).all()
