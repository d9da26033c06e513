"""A run on the CPU at the tiny size, with the chip check skipped: sound,
``correct`` is true; with the bfloat16 control in the program's place, or
with the timed path broken underneath, false.  Each
cell gets the faults it can have: a step that returns its state unchanged,
half of the batch left out (the mean of the rest in its place), an answer
altered where it is produced.  (No cell spans chips yet; the exchange
between chips left out is ``test_bench_world.py``'s, on a toy cell of 4
ranks.)"""

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import control_entry, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"))


def _run(root, cell):
    return run.run(cell, 2**31 + 17, 0.05, False, root=root, device="cpu", check_device=False)


def _half_mean(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    h = max(t.shape[dim] // 2, 1)
    t = t.clone()
    t.narrow(dim, h, t.shape[dim] - h).copy_(t.narrow(dim, 0, h).mean(dim, keepdim=True)
                                             .expand_as(t.narrow(dim, h, t.shape[dim] - h)))
    return t


def _fista_faults(mp, fault):
    from tomobar_tpu_torch.models import iterative
    from tomobar_tpu_torch.solvers import core

    grad = core.grad_data_term
    if fault == "state_unchanged":
        mp.setattr(core, "grad_data_term", lambda *a, **k: torch.zeros_like(a[1]))
    elif fault == "half_batch":
        mp.setattr(core, "grad_data_term", lambda *a, **k: _half_mean(grad(*a, **k)))
    elif fault == "answer_altered":
        fin = iterative.RecToolsIRTPU._finalise
        # the FISTA limit (3e-2) sits far above the float32 floor of a
        # chaotic 200-step solve (5e-4), so a 10% alteration is the test
        mp.setattr(iterative.RecToolsIRTPU, "_finalise", lambda self, x, a: fin(self, x, a) * 1.1)


def _fourier_faults(mp, fault):
    from tomobar_tpu_torch.ops import usfft

    unpad = usfft._unpad_mul_phi
    if fault == "state_unchanged":
        def no_grid(g_re, g_im, n, theta, eps=1e-4):
            z = torch.zeros((g_re.shape[0], 2 * n, 2 * n), dtype=g_re.dtype)
            return z, z.clone()
        mp.setattr(usfft, "grid", no_grid)
    elif fault == "half_batch":
        mp.setattr(usfft, "_unpad_mul_phi", lambda *a: _half_mean(unpad(*a)))
    elif fault == "answer_altered":
        mp.setattr(usfft, "_unpad_mul_phi", lambda *a: unpad(*a) * 1.01)


def _fbp_faults(mp, fault):
    from tomobar_tpu_torch.models import direct
    from tomobar_tpu_torch.ops.projector import Projector

    bp, out = Projector.bp, direct.RecToolsDIR._out
    if fault == "state_unchanged":
        mp.setattr(direct, "filter_sino_sinc", lambda data, cutoff=0.35: data)
    elif fault == "half_batch":
        def half_angles(self, sino):
            s = sino.clone()
            s[1::2] = s[0::2][: s[1::2].shape[0]]
            return bp(self, s)
        mp.setattr(Projector, "bp", half_angles)
    elif fault == "answer_altered":
        mp.setattr(direct.RecToolsDIR, "_out", lambda self, x: out(self, x * 1.01))


CELLS = {
    "fista_pdtv.chunk8": _fista_faults,
    "direct.fourier_inv.chunk512": _fourier_faults,
    "direct.fbp2d.preview": _fbp_faults,
}


@pytest.mark.parametrize("cell", [*CELLS, "fista_pdtv.chunk20"])
def test_sound_run_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    CELLS[cell](monkeypatch, fault)
    res = _run(root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", [*CELLS, "fista_pdtv.chunk20"])
def test_control_run_is_not_correct(root, cell, monkeypatch):
    control_entry(monkeypatch)
    res = _run(root, cell)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert not res["correct"], res["checks"]
