"""The metrics that read the program's own spans and counters
(``benchmark/program.py``), on a CPU run of every cell at the tiny size
with ``--trace 1``: each cell reports its new metrics, finite and
positive (the preview two plan builds a call), and the metrics that time
the layers from outside read what they read with the program's spans
turned off; no ``tomobar::`` range is a device operation."""

import math

import pytest

from benchmark import program, run
from benchmark.tests.tiny import tiny_root

NEW = {
    "fista_pdtv.chunk20": {"solver_roofline_pct"},
    "fista_pdtv.chunk8": {"solver_roofline_pct"},
    "direct.fourier_inv.chunk512": {"usfft_grid_roofline_pct", "usfft_transform_roofline_pct"},
    "direct.fbp2d.preview": {"call_setup_ms", "plan_builds_per_call"},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("spans"))


def _traced(root, cell):
    from tomobar_tpu_torch import trace

    trace.reset()  # the record is one per process, and each run reads its own
    return run.run(cell, 2**31 + 29, 0.05, True, root=root, device="cpu", check_device=False)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reports_the_program_metrics(root, cell):
    res = _traced(root, cell)
    assert res["correct"]
    for name in NEW[cell]:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    if cell == "direct.fbp2d.preview":
        assert res["metrics"]["plan_builds_per_call"]["value"] == 2.0
    assert not any(op.startswith("tomobar::") for op, _ in res["breakdown"]["device_ops"])


@pytest.mark.parametrize("cell", sorted(NEW))
def test_the_outside_metrics_read_the_same_without_the_program_spans(root, cell, monkeypatch):
    from tomobar_tpu_torch import trace

    with_spans = _traced(root, cell)
    monkeypatch.setattr(trace, "_Span", lambda name, attrs: trace._OFF)
    without = _traced(root, cell)
    assert program.snapshot()["spans"] == []
    outside = set(with_spans["metrics"]) - NEW[cell]
    assert outside and outside <= set(without["metrics"])
    for name in outside:
        m = without["metrics"][name]
        if name.split(".")[0] == "device_idle_pct":
            # no device on the CPU: the whole window is idle either way
            assert m["value"] == with_spans["metrics"][name]["value"] == 100.0
        else:
            assert m == with_spans["metrics"][name]


def test_a_program_without_the_module_reports_nothing(root, monkeypatch):
    import sys

    import tomobar_tpu_torch

    monkeypatch.delattr(tomobar_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "tomobar_tpu_torch.trace", None)
    assert program.snapshot() is None
    from benchmark import registry

    ctx = run.Window()
    ctx.calls = 3
    for names in NEW.values():
        for name in names:
            assert registry.metric(root, name).read(ctx) is None
