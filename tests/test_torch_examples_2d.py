"""The seven examples of ``examples/torch/`` against their JAX counterparts
in ``examples/``, at N = 48 on the CPU (this file: the 2D quick-start and
the legacy regulariser tour, and what every example must refuse or avoid).

The port's example runs through its ``main(device="cpu")`` on the one-pass
Joseph pair (``set_projector_backend("xla")``), the path the JAX examples
take on the CPU; the JAX example runs unedited through its own ``main()``,
its sizes from ``TOMOBAR_EXAMPLE_N`` / ``_NZ``, its standard output
captured.  Every rel-RMSE the JAX example prints must agree with the
port's to 1e-3 absolute (the JAX lines print 4 decimals).  The helpers
here serve ``test_torch_examples_3d.py``, ``_counts.py`` and
``_sharded.py``.
"""

import contextlib
import importlib
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

from tomobar_tpu_torch.ops import projector as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import load_example  # noqa: E402

JAX_EXAMPLES = os.path.join(REPO, "examples")
PORT_EXAMPLES = os.path.join(REPO, "examples", "torch")
N_PARITY = 48
TOL_ABS = 1e-3
RMSE_LINE = re.compile(r"rel-RMSE:?\s+(-?[0-9.]+)")
EXAMPLES = ("quickstart_2d", "phantom3d_fista_os_tv", "artifacts3d_swls_huber",
            "osem_kl_counts", "realdata_warmstart_admm", "legacy_regularisers_tour",
            "multichip_sharded_recon")


def printed_rmse(text: str) -> list:
    return [float(v) for v in RMSE_LINE.findall(text)]


def run_port(name: str, **kw):
    """The port's example on the CPU on the Joseph pair at N_PARITY;
    returns what ``main`` returns and what it printed."""
    saved = TP._BACKEND
    TP.set_projector_backend("xla")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = load_example(name).main(N=N_PARITY, device="cpu", **kw)
    finally:
        TP.set_projector_backend(saved)
    return out, buf.getvalue()


def run_jax(name: str, nz=None) -> str:
    """The JAX example's ``main()`` at N_PARITY (and ``nz`` slices where it
    reads them), unedited; returns what it printed."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        # ahead of examples/torch/, which the port's examples put on the path
        mp.syspath_prepend(JAX_EXAMPLES)
        module = importlib.import_module(name)
        mp.setenv("TOMOBAR_EXAMPLE_N", str(N_PARITY))
        if nz is not None:
            mp.setenv("TOMOBAR_EXAMPLE_NZ", str(nz))
        with contextlib.redirect_stdout(buf):
            module.main()
    return buf.getvalue()


class Parity:
    """Each example run once on each side, on first use."""

    def __init__(self, runs: dict):
        self.runs, self.done = runs, {}

    def __call__(self, name: str):
        if name not in self.done:
            port_fn, jax_fn = self.runs[name]
            self.done[name] = (*port_fn(), jax_fn())
        return self.done[name]


def check_metric(parity: Parity, name: str, metric: str) -> None:
    """``metric`` of the port's example against the value at the same place
    in the JAX example's printed lines."""
    out, _, jax_text = parity(name)
    keys = list(out)
    jax_values = printed_rmse(jax_text)
    assert len(jax_values) == len(keys), (keys, jax_text)
    want = jax_values[keys.index(metric)]
    assert np.isfinite(out[metric])
    assert abs(out[metric] - want) <= TOL_ABS, (
        f"{name} {metric}: port {out[metric]:.6f}, JAX printed {want:.4f}")


def check_prints(parity: Parity, name: str) -> None:
    """The port prints its rel-RMSEs in the JAX example's order, as it
    returns them."""
    out, text, _ = parity(name)
    assert printed_rmse(text) == pytest.approx(list(out.values()), abs=5e-5)


PARITY = Parity({
    "quickstart_2d": (lambda: run_port("quickstart_2d"), lambda: run_jax("quickstart_2d")),
    "legacy_regularisers_tour": (lambda: run_port("legacy_regularisers_tour"),
                                 lambda: run_jax("legacy_regularisers_tour")),
})


@pytest.mark.parametrize("metric", ["fbp", "fista"])
def test_quickstart_2d_matches_jax(metric):
    check_metric(PARITY, "quickstart_2d", metric)


@pytest.mark.parametrize("metric", [
    "noisy", "FGP_TV", "SB_TV", "LLT_ROF", "TGV", "NDF (Huber)", "Diff4th", "WAVELETS",
    "NLTV", "fista"])
def test_legacy_regularisers_tour_matches_jax(metric):
    check_metric(PARITY, "legacy_regularisers_tour", metric)


@pytest.mark.parametrize("name", ["quickstart_2d", "legacy_regularisers_tour"])
def test_prints_what_it_returns(name):
    check_prints(PARITY, name)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_cuda_unless_asked_for_the_cpu(name):
    """Every example runs on ``cuda:0`` by default and raises where CUDA is
    missing, before it does any work: no silent fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_example(name).main(N=8)


@pytest.mark.parametrize("name", EXAMPLES + ("_common",))
def test_example_imports_no_jax(name):
    """The port's examples import neither jax nor ``tomobar_tpu``."""
    with open(os.path.join(PORT_EXAMPLES, f"{name}.py")) as f:
        source = f.read()
    assert not re.search(r"^\s*(import|from) (jax|tomobar_tpu)\b(?!_torch)", source, re.M)
