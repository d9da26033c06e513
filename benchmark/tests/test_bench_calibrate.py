"""``calibrate.py`` reads a cell whose entry makes its inputs in set-up:
it calls the entry's ``warmup`` on a chunk before the chunk's call (the
ADMM entry makes the chunk's raw frames there, and its ``call`` raises
for a chunk without them)."""

from benchmark import calibrate
from benchmark.tests.tiny import tiny_root

CELL = "admm_os24.counts.chunk20"


def test_calibrate_reads_the_admm_cell(tmp_path):
    root = tiny_root(tmp_path)
    (line,) = calibrate.readings(CELL, [2**31 + 5], 1, 1, root=root, device="cpu")
    limit = 1e-3  # benchmark/workloads/admm_os24.counts.chunk20.json
    assert line["program"] < limit < line["control_bf16"], line
