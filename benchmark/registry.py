"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

* a configuration: the file its entry names (``benchmark/configs/``);
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* a cell's own numbers (the answers it keeps, the limits of its checks):
  ``benchmark/workloads/<cell>.json``;
* an entry point: ``benchmark/entries/<entry>.py`` (the traffic's
  ``entry``);
* a metric: ``benchmark/metrics/<name>.py`` (with ``.`` in the name as
  ``_``); a quantity split by the end-to-end metric its cells report
  (``<quantity>.<suffix>``) with no reader of its own is read by
  ``<quantity>.py``.

So a later cell, configuration, traffic or metric is added by adding files
and entries, and no file here is edited.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple


class Cell(NamedTuple):
    root: Path
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    own: dict  # benchmark/workloads/<cell>.json


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    root = Path(root)
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(root / configs[cell["config"]]["file"])
    traffic = _read(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    own = _read(root / "benchmark" / "workloads" / f"{name}.json")
    return Cell(root, bench, cell, config, traffic, own)


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(root: Path, name: str) -> ModuleType:
    """The entry-point module ``benchmark/entries/<name>.py``."""
    return _module(Path(root) / "benchmark" / "entries" / f"{name}.py", f"bench_entry_{name}")


def metric(root: Path, name: str) -> ModuleType:
    """The reader ``benchmark/metrics/<name>.py`` (``.`` read as ``_``), or
    else that of the quantity before the first ``.``."""
    folder = Path(root) / "benchmark" / "metrics"
    stem = name.replace(".", "_")
    if not (folder / f"{stem}.py").exists():
        stem = name.split(".")[0]
    return _module(folder / f"{stem}.py", f"bench_metric_{stem}")


def cell_metrics(c: Cell, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``c`` reports."""
    name = c.cell["name"]
    return [m for m in c.bench[kind] if name in m.get("workloads", [name])]
