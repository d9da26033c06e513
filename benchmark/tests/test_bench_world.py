"""``run.py``'s world of ranks, on 4 gloo ranks on the CPU (and, marked
``cuda``, on 4 NCCL ranks where a host has 4 cards).

A toy cell ``toy.world4`` with ``chips`` 4, its entry and its files are
built in the test's temporary copy of the benchmark, not in the repo's
``BENCHMARK.json``; each run goes through ``run.run_world`` (the launcher,
after its card check) in a process of its own, and ``calibrate.py`` reads
the cell the same way.  The toy's answer is each
row's mean over the angles of a chunk: each rank keeps its quarter of the
rows (``local``) and computes their means, and one all-reduce (the
exchange) assembles the whole answer on every rank.  Environment variables
plant, in the window's calls only, a sleep or a raise on a rank after the
exchange, a rank that exits, or the exchange left out on every
rank (each rank's answer its own part)."""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.tests.tiny import REPO, tiny_root

CELL = "toy.world4"
SEED = 2**31 + 101
LIMIT_S = 150  # one run, each

TOY_ENTRY = r'''
import os
import sys
import time

import torch
import torch.distributed as dist

CALLS = [0]


def _rows(n):
    step = -(-n // dist.get_world_size())
    lo = dist.get_rank() * step
    return lo, min(n, lo + step)


def local(config, traffic, chunk):
    lo, hi = _rows(chunk.shape[0])
    return chunk[lo:hi].clone()


def _answer(traffic, part, device, exchange=True):
    n = int(traffic["chunk_slices"])
    lo, hi = _rows(n)
    out = torch.zeros((n, part.shape[-1]), dtype=torch.float32, device=device)
    out[lo:hi] = part.mean(1)
    if exchange:
        dist.all_reduce(out)
    return out


def warmup(config, traffic, part, device):
    return _answer(traffic, part, device)


def call(config, traffic, part, device):
    CALLS[0] += 1
    rank = str(dist.get_rank())
    if os.environ.get("TOY_EXIT_RANK") == rank:
        os._exit(9)
    out = _answer(traffic, part, device, os.environ.get("TOY_NO_EXCHANGE") != "1")
    if os.environ.get("TOY_SLEEP_RANK") == rank:
        time.sleep(float(os.environ["TOY_SLEEP_S"]))
    if os.environ.get("TOY_RAISE_RANK") == rank:
        raise RuntimeError("planted")
    return out


def answer_count(out):
    return 1


def answer(out, j):
    return out


def reference(config, traffic, chunk, ids, prec="fp32"):
    sys.stderr.write(f"toy rank {dist.get_rank()} calls {CALLS[0]}\n")
    return {0: chunk.double().mean(1).float()}
'''

# a per-layer metric whose reading differs by rank: the mean over 4 is 1.5
RANK_METRIC = '''
import torch.distributed as dist

SPANS = {}


def read(ctx):
    return float(dist.get_rank())
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("world"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "direct_1801x2560", "traffic": "toy_world",
                               "chips": 4, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] in ("slices_per_s", "chunk_ms_p95"):
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "rank_id", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "device",
                               "moves": "slices_per_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = root / "benchmark"
    (b / "entries" / "TOY.py").write_text(TOY_ENTRY)
    (b / "metrics" / "rank_id.py").write_text(RANK_METRIC)
    (b / "traffic" / "toy_world.json").write_text(json.dumps(
        {"entry": "TOY", "chunk_slices": 8, "distinct_chunks": 2, "warmup_calls": 2,
         "trace_calls": 3}))
    (b / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"answers_kept": 2, "limits": {"rel_l2": 1e-5}}))
    return root


def _ranks_left(root: Path) -> list:
    """Processes whose command line names ``root``."""
    left = []
    for proc in Path("/proc").iterdir():
        try:
            if proc.name.isdigit() and str(root) in (proc / "cmdline").read_bytes().decode(
                    errors="replace"):
                left.append(int(proc.name))
        except OSError:
            pass
    return left


def _world(root, device="cpu", trace=0, seconds=1.0, **faults):
    """One run of the toy cell through the launcher; returns the exit code,
    standard output's lines, standard error and the seconds it took."""
    code = ("import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import run;"
            "sys.exit(run.run_world(sys.argv[3:], 4, Path(sys.argv[1]), sys.argv[2]))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("TOY_")}
    env.update({f"TOY_{k.upper()}": str(v) for k, v in faults.items()})
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-c", code, str(root), device, "--workload", CELL,
                          "--seed", str(SEED), "--seconds", str(seconds), "--trace", str(trace)],
                         capture_output=True, text=True, timeout=LIMIT_S, env=env, cwd=root)
    took = time.monotonic() - t0
    assert not _ranks_left(root), "a rank outlived the run"
    return res.returncode, res.stdout.splitlines(), res.stderr, took


def _result(lines) -> dict:
    found = [json.loads(x) for x in lines if x.startswith("{")]
    assert len(found) == 1, lines
    assert lines[-1].startswith("{")
    return found[0]


def _calls_by_rank(err: str) -> dict:
    calls = {}
    for rank, n in re.findall(r"toy rank (\d+) calls (\d+)", err):
        calls.setdefault(int(rank), set()).add(int(n))
    return calls


@pytest.fixture(scope="module")
def sound(root):
    """A sound run in which rank 3 sleeps 0.2 s in every call."""
    return _world(root, sleep_rank=3, sleep_s=0.2)


def test_one_result_line_with_the_world_count(sound):
    rc, lines, err, _ = sound
    assert rc == 0, err[-4000:]
    res = _result(lines)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4 and res["device"]["platform"] == "cpu"
    assert err.rstrip().splitlines()[-1].startswith("check rel_l2 = ")


def test_every_rank_makes_the_same_calls(sound):
    rc, lines, err, _ = sound
    calls = _calls_by_rank(err)
    assert sorted(calls) == [0, 1, 2, 3], err[-4000:]
    assert all(n == {_result(lines)["attempted"]} for n in calls.values()), calls


@pytest.fixture(scope="module")
def unexchanged(root):
    """A run with the exchange left out on every rank, so only the
    harness's collectives join the ranks, and rank 3 sleeping 0.2 s after
    every call's work."""
    return _world(root, no_exchange=1, sleep_rank=3, sleep_s=0.2)


def test_rank_0_times_the_slowest_rank(unexchanged):
    rc, lines, err, _ = unexchanged
    assert rc == 0, err[-4000:]
    m = _result(lines)["metrics"]
    # every call of rank 0 ends with rank 3's
    assert m["chunk_ms_p95"]["value"] >= 200.0
    assert m["slices_per_s"]["value"] <= 8 / 0.2


def test_a_call_that_raises_on_one_rank_fails_the_run(root):
    rc, lines, err, took = _world(root, raise_rank=2, seconds=30)
    assert rc == 0, err[-4000:]
    res = _result(lines)
    assert not res["correct"] and res["failed"] == 1 and res["attempted"] == 1
    assert took < 30


def test_a_rank_that_exits_ends_the_world(root):
    rc, lines, err, _ = _world(root, exit_rank=1)
    assert rc != 0
    assert not [x for x in lines if x.startswith("{")], lines


def test_a_killed_launcher_leaves_no_rank(root):
    code = ("import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import run;"
            "sys.exit(run.run_world(sys.argv[2:], 4, Path(sys.argv[1]), 'cpu'))")
    launcher = subprocess.Popen([sys.executable, "-c", code, str(root), "--workload", CELL,
                                 "--seed", str(SEED), "--seconds", "60", "--trace", "0"],
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=root)
    deadline = time.monotonic() + 60
    while len(_ranks_left(root)) < 5 and time.monotonic() < deadline:  # the launcher and 4 ranks
        time.sleep(0.2)
    assert len(_ranks_left(root)) == 5
    launcher.kill()
    launcher.wait(timeout=10)
    deadline = time.monotonic() + 10
    while _ranks_left(root) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not _ranks_left(root), "a rank outlived its launcher"


def test_the_exchange_left_out_is_not_correct(unexchanged):
    rc, lines, err, _ = unexchanged
    assert rc == 0, err[-4000:]
    res = _result(lines)
    assert res["failed"] == 0 and not res["correct"], res["checks"]


def test_a_traced_world_reads_every_rank(root):
    rc, lines, err, _ = _world(root, trace=1)
    assert rc == 0, err[-4000:]
    res = _result(lines)
    assert res["correct"] and res["attempted"] == 3
    assert res["metrics"]["rank_id"]["value"] == 1.5
    assert "rank_id by rank: [0.0, 1.0, 2.0, 3.0]" in err
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_calibrate_runs_a_world_cell(root):
    res = subprocess.run([sys.executable, str(root / "benchmark" / "calibrate.py"), "--workload",
                          CELL, "--seeds", "5", str(SEED), "--controls", "1"],
                         capture_output=True, text=True, timeout=LIMIT_S, cwd=root)
    assert not _ranks_left(root), "a rank outlived the run"
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()]
    assert [x["seed"] for x in lines] == [5, SEED]
    assert all(x["program"] < 1e-5 for x in lines), lines


@pytest.mark.cuda
def test_a_world_of_four_cards(root):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    rc, lines, err, _ = _world(root, device="cuda", sleep_rank=3, sleep_s=0.2)
    assert rc == 0, err[-4000:]
    res = _result(lines)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 4
    assert res["metrics"]["chunk_ms_p95"]["value"] >= 200.0
    calls = _calls_by_rank(err)
    assert all(n == {res["attempted"]} for n in calls.values()), calls
