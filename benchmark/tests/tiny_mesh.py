"""The tiny copy of ``tiny_cells.py`` with ``fista_pdtv.mesh4`` cut to the
tiny size too: its 256-row volume as 16 rows (4 a rank in a world of 4,
all 16 in one process) on ``tiny.py``'s 64 x 64 slices, 60 angles and 3
FISTA iterations, with PD-TV's 20 iterations kept, so the halo (20
slices) is wider than a slab.  ``benchmark/conftest.py`` makes this the
``tiny_root`` of every test here."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.tests.tiny_cells import tiny_root as _tiny_root

ROWS = {"fista_mesh4_vol256": 16}


def tiny_root(tmp: Path) -> Path:
    """``tiny_cells.tiny_root`` with the mesh cell cut to the tiny size."""
    root = _tiny_root(tmp)
    for name, rows in ROWS.items():
        path = root / "benchmark" / "traffic" / f"{name}.json"
        if path.exists():
            t = json.loads(path.read_text())
            t["chunk_slices"] = rows
            path.write_text(json.dumps(t))
    for path in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if "volume_rows" in cfg:
            cfg["volume_rows"] = ROWS["fista_mesh4_vol256"]
            path.write_text(json.dumps(cfg))
    return root
