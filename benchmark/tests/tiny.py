"""A copy of the benchmark at a size the CPU runs in seconds: 64 x 64
slices, 60 angles, chunks of 4 / 2 / 6 rows, 3 FISTA iterations."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path) -> Path:
    """A root holding ``BENCHMARK.json`` and ``benchmark/`` at the tiny size."""
    root = Path(tmp) / "tiny"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["geometry"].update(angles=60, detector_x=64, recon_size=64)
        cfg["data"]["scan_rows"] = 64
        if "FISTA" in cfg:
            cfg["FISTA"]["algorithm"]["iterations"] = 3
            # the same smoothing per pixel as 2e-4 at 2560 px
            cfg["FISTA"]["regularisation"]["regul_param"] = 8e-3
        path.write_text(json.dumps(cfg))
    for name, rows in (("fista_chunk20", 4), ("fista_chunk8", 2), ("fourier_inv_chunk512", 6)):
        path = root / "benchmark" / "traffic" / f"{name}.json"
        t = json.loads(path.read_text())
        t["chunk_slices"] = rows
        path.write_text(json.dumps(t))
    return root


def control_entry(monkeypatch):
    """Make every entry the harness loads answer with its reference in
    bfloat16 (the control) in place of the program, shaped as the
    program's answer, so a run goes through the harness's own comparison
    with the control's answers."""
    import torch

    from benchmark import registry

    load = registry.entry

    def entry(root, name):
        mod = load(root, name)

        def call(config, traffic, chunk, device):
            ids = list(range(chunk.shape[0])) if name == "FOURIER_INV" else [0]
            low = mod.reference(config, traffic, chunk, ids, "bf16")
            return torch.stack([low[j] for j in ids]) if name == "FOURIER_INV" else low[0]

        monkeypatch.setattr(mod, "call", call)
        monkeypatch.delattr(mod, "warmup", raising=False)
        return mod

    monkeypatch.setattr(registry, "entry", entry)
