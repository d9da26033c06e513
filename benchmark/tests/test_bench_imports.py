"""Nothing a run executes imports JAX or the JAX package, the reference
imports nothing of the port, and without a card the command prints no
result."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.tests.tiny import REPO, tiny_root

FORBIDDEN = {"jax", "jaxlib", "flax", "tomobar_tpu"}


def _top_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_imports_no_jax(tmp_path):
    root = tiny_root(tmp_path)
    cells = [w["name"] for w in json.loads((root / "BENCHMARK.json").read_text())["workloads"]]
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1]); from pathlib import Path;"
        "from benchmark import run;"
        "[run.run(w, 5, 0.01, t, root=Path(sys.argv[2]), device='cpu', check_device=False)"
        " for w in sys.argv[3:] for t in (False, True)];"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    out = subprocess.run([sys.executable, "-c", code, str(REPO), str(root), *cells],
                         capture_output=True, text=True, timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tomobar_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        assert not _top_imports(path) & (FORBIDDEN | {"tomobar_tpu_torch"}), path
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.fista, benchmark.reference.direct;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert "tomobar_tpu" not in out.stdout and "jax" not in out.stdout


def test_no_card_no_result(tmp_path):
    # this sandbox has no CUDA device: the command exits with 2 and prints
    # nothing on standard output
    res = subprocess.run([sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
                          "direct.fbp2d.preview", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout == ""
