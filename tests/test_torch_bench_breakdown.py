"""The port's breakdowns (``tomobar_tpu_torch/bench/breakdown.py`` and
``fourier_breakdown.py``) on the CPU at N 32: the JAX package's keys, and
FOURIER_INV's five stages read from the spans of whole calls, one of each
per z-block that the call plans."""

import numpy as np
import pytest
import torch

from tomobar_tpu_torch import RecToolsDIRCuPy
from tomobar_tpu_torch.bench import breakdown as B
from tomobar_tpu_torch.bench import fourier_breakdown as FB

torch.set_num_threads(1)


def test_flagship_breakdown_keys(capsys):
    out = B.flagship_breakdown(32, 4, 24, 2, 5, reps=2, device="cpu")
    assert set(out) == {"fp_sub", "bp_sub", "pd_tv", "outer_estimate_ms"}
    for k in ("fp_sub", "bp_sub", "pd_tv"):
        assert out[k]["ms"] > 0 and {"gflops", "fp32_util", "hbm_gbs", "hbm_util"} <= set(out[k])
    assert out["outer_estimate_ms"] == pytest.approx(
        2 * sum(out[k]["ms"] for k in ("fp_sub", "bp_sub", "pd_tv")), rel=1e-3)
    capsys.readouterr()


def test_fourier_breakdown_keys(capsys):
    out = FB.fourier_breakdown(32, 4, 24, reps=2, device="cpu")
    assert set(out) == {"shape", "oversampled_width", "stages"}
    assert out["shape"] == "24x4x32" and out["oversampled_width"] == 128
    assert set(out["stages"]) == set(FB.STAGES) | {"total_ms", "stage_sum_ms"}
    assert out["stages"]["stage_sum_ms"] == pytest.approx(
        sum(out["stages"][k]["ms"] for k in FB.STAGES), abs=1e-3)
    capsys.readouterr()


def test_fourier_breakdown_on_given_data(capsys):
    """Given data, the breakdown runs on its device and shape; another shape
    is refused."""
    data = torch.as_tensor(np.random.default_rng(5).standard_normal((4, 24, 32)).astype(np.float32))
    out = FB.fourier_breakdown(32, 4, 24, reps=2, data=data)
    assert out["shape"] == "24x4x32" and set(out["stages"]) >= set(FB.STAGES)
    with pytest.raises(ValueError, match="not"):
        FB.fourier_breakdown(32, 4, 26, reps=1, data=data)
    capsys.readouterr()


def _stage_spans(rt, data, **kwargs):
    seconds, spans = FB.stage_seconds(lambda: rt.FOURIER_INV(data, **kwargs), calls=2)
    assert list(seconds) == list(spans) == list(FB.STAGES)
    assert all(v > 0 for v in seconds.values()), seconds
    return spans


@pytest.mark.parametrize("n, nz, nproj", [(32, 4, 24), (64, 2, 30), (48, 6, 17)])
def test_chained_stages_equal_fourier_inv(n, nz, nproj):
    """The stages chained inside the call: asked for 2 z-blocks (one where
    the volume holds one z-pair), every stage is timed (> 0 s) and
    recorded once per planned z-block."""
    blocks = min(2, nz // 2)
    angles = np.linspace(0, np.pi, nproj, endpoint=False)
    rt = RecToolsDIRCuPy(n, 0, nz, 0.0, angles, n, device="cpu")
    data = torch.as_tensor(np.random.default_rng(n).standard_normal((nz, nproj, n)).astype(np.float32))
    assert _stage_spans(rt, data, chunk_count=2) == dict.fromkeys(FB.STAGES, blocks)
    assert _stage_spans(rt, data) == dict.fromkeys(FB.STAGES, 1)


def test_stages_refuse_odd_axes():
    """Odd axes and padding, which the stages no longer refuse: the call's
    own stages, all five reported; a call with no FOURIER_INV reports
    none."""
    rt = RecToolsDIRCuPy(31, 0, 3, 0.0, np.linspace(0, np.pi, 10, endpoint=False), 31, device="cpu")
    data = torch.as_tensor(np.random.default_rng(3).standard_normal((3, 10, 31)).astype(np.float32))
    assert _stage_spans(rt, data, padding=4) == dict.fromkeys(FB.STAGES, 1)
    assert FB.stage_seconds(lambda: None) == (dict.fromkeys(FB.STAGES, 0.0),
                                               dict.fromkeys(FB.STAGES, 0))


def test_breakdown_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        B.flagship_breakdown(32, 4, 24, 2, 5)


def test_harness_on_the_cpu(tmp_path):
    """``time_fn`` and ``Marks`` time on the host clock for CPU work,
    ``rmse``/``rel_rmse`` are the JAX package's formulas (equal to 0), and
    ``trace`` exports a Chrome trace."""
    import json
    import time

    from tomobar_tpu.bench import harness as JH
    from tomobar_tpu_torch.bench import harness as H

    assert H.time_fn(lambda x: time.sleep(0.01) or x, torch.ones(3), reps=2) >= 0.01
    marks = H.Marks("cpu")
    marks.mark()
    time.sleep(0.01)
    marks.mark()
    assert marks.elapsed_ms()[0] >= 10.0
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((4, 5)), rng.standard_normal((4, 5)).astype(np.float32)
    assert H.rmse(a, b) == JH.rmse(a, b) and H.rel_rmse(a, b) == JH.rel_rmse(a, b)
    with H.trace(str(tmp_path / "tr")):
        torch.ones(64).add_(1.0)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    H.device_sync(torch.ones(2))  # a no-op on the CPU
