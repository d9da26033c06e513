"""The harness finds every cell, configuration, traffic, entry point and
metric by its name, and a new cell is one more file and entry."""

import json
import shutil

import pytest

from benchmark import registry
from benchmark.tests.tiny import REPO, tiny_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(name):
    c = registry.load_cell(REPO, name)
    assert c.cell["name"] == name
    assert c.config["name"] == c.cell["config"]
    entry = registry.entry(REPO, c.traffic["entry"])
    assert callable(entry.call) and callable(entry.reference)
    assert set(c.own["limits"]) == {"rel_l2"} and c.own["answers_kept"] >= 1
    for kind in ("end_to_end", "per_layer"):
        assert registry.cell_metrics(c, kind)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    mod = registry.metric(REPO, name)
    assert callable(mod.read) and isinstance(mod.SPANS, dict)


def test_a_new_workload_file_is_picked_up_without_an_edit(tmp_path):
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "direct.fourier_inv.chunk2", "config": "direct_1801x2560",
                               "traffic": "fourier_inv_chunk2", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("slices_per_s", "device_idle_pct"):
            m["workloads"].append("direct.fourier_inv.chunk2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "traffic" / "fourier_inv_chunk2.json").write_text(json.dumps(
        {"entry": "FOURIER_INV", "chunk_slices": 2, "distinct_chunks": 2, "warmup_calls": 1,
         "trace_calls": 1}))
    shutil.copy(root / "benchmark" / "workloads" / "direct.fourier_inv.chunk512.json",
                root / "benchmark" / "workloads" / "direct.fourier_inv.chunk2.json")
    from benchmark import run

    res = run.run("direct.fourier_inv.chunk2", 7, 0.2, False, root=root, device="cpu",
                  check_device=False)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"slices_per_s", "setup_s"}


def test_a_split_metric_is_read_by_its_quantity_or_its_own_file(tmp_path):
    root = tiny_root(tmp_path)
    assert registry.metric(root, "device_idle_pct.preview").__file__.endswith("device_idle_pct.py")
    own = root / "benchmark" / "metrics" / "device_idle_pct_serve.py"
    own.write_text("SPANS = {}\n\n\ndef read(ctx):\n    return 1.0\n")
    assert registry.metric(root, "device_idle_pct.serve").read(None) == 1.0
