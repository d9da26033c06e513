"""The tiny copy of ``tiny.py`` for every cell, those added after it too:
the ADMM recipe at a 4-pixel pad, 4 ordered subsets and 4-row chunks (on
``tiny.py``'s 64 x 64 slices and 60 angles), and FISTA's 64-row chunks as
8 rows.  ``conftest.py`` makes this the ``tiny_root`` of every test here."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.tests.tiny import tiny_root as _tiny_root

ROWS = {"fista_chunk64": 8, "admm_counts_chunk20": 4}


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def _admm(cfg: dict) -> None:
    cfg["reconstructor"].update(DetectorsDimH_pad=4, OS_number=4)
    # the same smoothing per pixel as 3e-4 at 2560 px (tiny.py's FISTA rule)
    cfg["ADMM"]["regularisation"]["regul_param"] = 1.2e-2


def tiny_root(tmp: Path) -> Path:
    """``tiny.tiny_root`` with the later cells cut to the tiny size too."""
    root = _tiny_root(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        if "ADMM" in json.loads((root / c["file"]).read_text()):
            _edit(root / c["file"], _admm)
    for name, rows in ROWS.items():
        path = root / "benchmark" / "traffic" / f"{name}.json"
        if path.exists():
            _edit(path, lambda t, rows=rows: t.update(chunk_slices=rows))
    return root
