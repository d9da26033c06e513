"""The port's sharded example against its JAX counterpart at N = 48 on 16
slices: the port on a world of 4 CPU ranks (gloo, mesh (2, 2)), the JAX
example on the tier-1 run's 8 virtual CPU devices (mesh (4, 2)), which
sets 16 slices as ``2 * n_dev``; both reconstruct the same phantom.  Each
printed rel-RMSE to 1e-3 absolute; see ``test_torch_examples_2d.py``."""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_examples_2d import (
    N_PARITY, PORT_EXAMPLES, Parity, check_metric, check_prints, printed_rmse, run_jax)
from test_torch_sharding import REPO, WORLD_TIMEOUT, _free_port

WORLD, NZ = 4, 16
SCRIPT = os.path.join(PORT_EXAMPLES, "multichip_sharded_recon.py")


def run_port_world(tmp_dir: str):
    """The port's example under 4 ranks, started as ``torchrun`` starts
    them (environment rendezvous); returns rank 0's rel-RMSEs and output."""
    port = _free_port()
    saved = os.path.join(tmp_dir, "ranks.npz")
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   TOMOBAR_TPU_PROJECTOR="xla")
        procs.append(subprocess.Popen(
            [sys.executable, SCRIPT, "-N", str(N_PARITY), "--nz", str(NZ), "--device", "cpu",
             "--save", saved],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed (rc {p.returncode}):\n{out}\n{err[-4000:]}"
    with np.load(saved) as f:
        out = {k: float(f[f"rel_rmse_{k}"]) for k in ("fbp", "fista")}
    return out, outs[0][0]


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded_example"))
    return Parity({"multichip_sharded_recon": (lambda: run_port_world(tmp),
                                               lambda: run_jax("multichip_sharded_recon"))})


def test_jax_example_runs_on_eight_devices(parity):
    _, _, jax_text = parity("multichip_sharded_recon")
    assert "over 8 x cpu" in jax_text, jax_text


def test_port_runs_on_a_mesh_of_four_ranks(parity):
    _, text, _ = parity("multichip_sharded_recon")
    assert "mesh: {'z': 2, 'angles': 2} over 4 x cpu" in text, text
    assert f"slices 0:{NZ // 2} of {NZ}" in text, text
    assert len(printed_rmse(text)) == 2


@pytest.mark.parametrize("metric", ["fbp", "fista"])
def test_multichip_sharded_recon_matches_jax(parity, metric):
    check_metric(parity, "multichip_sharded_recon", metric)


def test_prints_what_it_returns(parity):
    check_prints(parity, "multichip_sharded_recon")
