"""The frozen work models give the counts worked out by hand."""

import pytest

from benchmark import work


def test_projector_counts():
    assert work.projector_flops(2, 3, 4, 5) == 4 * 2 * 3 * 4 * 5
    assert work.projector_work(2, 3, 4, 6) == (4 * 2 * 3 * 16, 4 * (2 * 16 + 2 * 3 * 6))


def test_pd_counts():
    assert work.work_pd(2, 4, 5) == (36 * 5 * 2 * 16, 8 * 2 * 16)
    assert work.work_pd(1, 4, 5) == (28 * 5 * 16, 8 * 16)


def test_grid_and_fft_counts():
    assert work.work_grid(1, 2, 3, m=1) == (2 * 3 * 9 * (8 + 4), 8 * 2 * 3 + 8 * 4 * 9 + 16)
    assert work.work_fft((8, 3)) == (5 * 24 * 3, 16 * 24)
    assert work.grid_m(2560) == 5


def test_stage_work_and_bound():
    st = work.stage_work(4, 2, 3, 16)
    assert st["fft1d"] == (5 * 1 * 3 * 4 * 2, 4 * 2 * 3 * 4 + 2 * 4 * 3 * 4)
    assert st["unpad"] == (None, 2 * 4 * 2 * 16)
    assert work.oversampled_width(2560) == 8192
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
