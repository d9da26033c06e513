"""The port's documentation, ``docs/torch/``.

* every module of ``tomobar_tpu_torch`` (but ``csrc``, ``_build`` and
  ``native``) has an API page, and ``docs/torch/api/`` equals a fresh
  render of ``docs/build_torch.py``, which imports neither jax nor
  ``tomobar_tpu`` and builds no kernel;
* every Python block of the guides runs on the CPU, each in under 10 s
  (timed after the interpreter has imported torch and numpy; on one
  thread, as the other CPU tests run, which keeps parallel test workers
  from starving each other);
* no page links to a file that does not exist;
* no API page of the modules users call says "*Undocumented.*".
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs", "torch")
API = os.path.join(DOCS, "api")
GUIDES = sorted(f for f in os.listdir(DOCS) if f.endswith(".md"))
BLOCK_SECONDS = 10.0
# the modules users call: their pages, and their submodules', document
# every public name
DOCUMENTED = ("models", "solvers", "regularisers", "regularisers_legacy", "fidelity",
              "geometry", "parallel", "utils", "bench")
REGENERATE = "regenerate with `python docs/build_torch.py`"


def _load_build_torch():
    spec = importlib.util.spec_from_file_location(
        "build_torch", os.path.join(REPO, "docs", "build_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _python_blocks():
    """(page, index, code) of every ```python block of the guides."""
    out = []
    for page in GUIDES:
        with open(os.path.join(DOCS, page)) as f:
            blocks = re.findall(r"```python\n(.*?)```", f.read(), re.S)
        out += [(page, i, code) for i, code in enumerate(blocks)]
    return out


BLOCKS = _python_blocks()


def _modules_on_disk():
    """Module names of the package's ``.py`` files outside the skipped parts."""
    pkg = os.path.join(REPO, "tomobar_tpu_torch")
    names = []
    for root, dirs, files in os.walk(pkg):
        rel = os.path.relpath(root, REPO).split(os.sep)
        if set(rel[1:]) & {"csrc", "_build", "native"} or "__pycache__" in rel:
            continue
        for f in files:
            if f == "__init__.py":
                names.append(".".join(rel))
            elif f.endswith(".py") and not f.startswith("_"):
                names.append(".".join(rel + [f[:-3]]))
    return sorted(names)


def test_every_module_has_a_page():
    build_torch = _load_build_torch()
    on_disk = _modules_on_disk()
    assert build_torch.module_names() == on_disk
    with open(os.path.join(API, "index.md")) as f:
        index = f.read()
    for name in on_disk:
        page = build_torch.page_name(name)
        assert os.path.isfile(os.path.join(API, page)), f"no page for {name}: {REGENERATE}"
        assert f"]({page})" in index, f"{name} is not in docs/torch/api/index.md: {REGENERATE}"


def test_api_pages_equal_a_fresh_render(tmp_path):
    """A render in a process of its own, which must import no jax, no
    ``tomobar_tpu`` and build no kernel library."""
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('build_torch', {os.path.join(REPO, 'docs', 'build_torch.py')!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        f"m.build({str(tmp_path)!r})\n"
        "from tomobar_tpu_torch import _build\n"
        "print(json.dumps({'jax': 'jax' in sys.modules, 'tomobar_tpu': 'tomobar_tpu' in sys.modules,\n"
        "                  'built': _build.library.cache_info().currsize}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    state = json.loads(proc.stdout.strip().splitlines()[-1])
    assert state == {"jax": False, "tomobar_tpu": False, "built": 0}
    fresh = sorted(os.listdir(tmp_path))
    assert sorted(os.listdir(API)) == fresh, f"docs/torch/api/ has other files: {REGENERATE}"
    for name in fresh:
        with open(os.path.join(API, name), "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), f"docs/torch/api/{name} is stale: {REGENERATE}"


@pytest.mark.parametrize("page,index", [(p, i) for p, i, _ in BLOCKS],
                         ids=[f"{p}-{i}" for p, i, _ in BLOCKS])
def test_python_block_runs_on_the_cpu(tmp_path, page, index):
    code = next(c for p, i, c in BLOCKS if p == page and i == index)
    path = tmp_path / "block.py"
    path.write_text(code)
    runner = (
        "import sys, time\n"
        "import numpy, torch\n"
        "torch.set_num_threads(1)\n"
        "t0 = time.perf_counter()\n"
        "exec(compile(open(sys.argv[1]).read(), sys.argv[1], 'exec'), {'__name__': '__main__'})\n"
        "print('BLOCK_SECONDS', time.perf_counter() - t0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", runner, str(path)], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, f"{page} block {index}:\n{proc.stderr[-4000:]}"
    seconds = float(proc.stdout.strip().splitlines()[-1].split()[1])
    assert seconds < BLOCK_SECONDS, f"{page} block {index} took {seconds:.1f} s"


def test_guides_have_python_blocks():
    assert {p for p, _, _ in BLOCKS} >= {"building.md", "devices.md", "direct.md",
                                          "iterative.md", "preprocessing.md",
                                          "multigpu.md", "performance.md"}


@pytest.mark.parametrize("page", GUIDES + ["api/index.md"])
def test_links_resolve(page):
    with open(os.path.join(DOCS, page)) as f:
        text = f.read()
    for target in re.findall(r"\]\(([^)\s]+)\)", text):
        if re.match(r"[a-z]+:", target) or target.startswith("#"):
            continue
        path = os.path.join(DOCS, os.path.dirname(page), target.split("#")[0])
        assert os.path.exists(path), f"docs/torch/{page} links to {target}, which does not exist"


def _documented_pages():
    return [name.replace(".", "_") + ".md" for name in _modules_on_disk()
            if len(name.split(".")) > 1 and name.split(".")[1] in DOCUMENTED]


@pytest.mark.parametrize("page", _documented_pages())
def test_api_page_documents_every_public_name(page):
    with open(os.path.join(API, page)) as f:
        text = f.read()
    assert "*Undocumented.*" not in text, f"docs/torch/api/{page} has an undocumented name"
