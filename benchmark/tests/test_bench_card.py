"""On the card: every cell of the tiny copy runs through the harness with
its chip check, correct, and with the bfloat16 control in the program's
place the same run comes out not correct.
Marked ``cuda``; skips without a card (decided in the fixture)."""

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import control_entry, tiny_root

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tiny_root(tmp_path_factory.mktemp("card"))


CELLS = ["fista_pdtv.chunk20", "direct.fourier_inv.chunk512", "fista_pdtv.chunk8",
         "direct.fbp2d.preview"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card_root, cell, trace):
    res = run.run(cell, 2**31 + 29, 0.5, trace, root=card_root)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_fails_on_the_card(card_root, cell, monkeypatch):
    control_entry(monkeypatch)
    res = run.run(cell, 2**31 + 31, 0.5, False, root=card_root)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert not res["correct"], res["checks"]
