"""The inputs follow from the seed alone, and the closed-form sinogram is
the Radon transform of the phantom."""

import json

import numpy as np
import torch

from benchmark import inputs
from benchmark.tests.tiny import REPO

CFG = json.loads((REPO / "benchmark" / "configs" / "fista_os10_pwls_pdtv_1801x2560.json").read_text())
CFG["geometry"].update(angles=45, detector_x=48, recon_size=48)
CFG["data"]["scan_rows"] = 48
TRAFFIC = {"chunk_slices": 3, "distinct_chunks": 2}


def test_same_seed_same_inputs():
    a = inputs.make_chunks(CFG, TRAFFIC, 2**31 + 99, "cpu")
    b = inputs.make_chunks(CFG, TRAFFIC, 2**31 + 99, "cpu")
    c = inputs.make_chunks(CFG, TRAFFIC, 2**31 + 100, "cpu")
    assert len(a) == 2 and a[0].shape == (3, 45, 48)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], a[1])


def test_closed_form_matches_a_rasterised_projection():
    # one slice through the middle of a 256-px phantom, summed along the
    # beam at 0 and 90 degrees, against the closed form
    n = 256
    theta = np.array([0.0, np.pi / 2])
    p = inputs.clean_sinogram(theta, n, n, 257, [128], 0.0, "cpu")[0].double()
    h = (n - 1) / 2.0
    x = (np.arange(n) - h) / h
    X, Y = np.meshgrid(x, x)
    vol = np.zeros((n, n))
    for cx, cy, cz, ax, ay, az, v in inputs.ELLIPSOIDS:
        s = 1.0 - (cz / az) ** 2
        if s > 0:
            vol += v * (((X - cx) / (ax * np.sqrt(s))) ** 2 + ((Y - cy) / (ay * np.sqrt(s))) ** 2 <= 1)
    # theta 0 integrates along y for each x; 90 degrees along x for each y
    assert np.linalg.norm(p[0].numpy() - vol.sum(0)) / np.linalg.norm(vol.sum(0)) < 0.02
    assert np.linalg.norm(p[1].numpy() - vol.sum(1)) / np.linalg.norm(vol.sum(1)) < 0.02


def test_chunks_lie_inside_the_object():
    for seed in (0, 1, 2**31 + 5):
        starts = inputs.chunk_starts(seed, 2560, 512, 2)
        assert len(set(starts)) == 2
        assert all(0 <= s and s + 512 <= 2560 for s in starts)
