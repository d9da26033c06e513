"""``RecToolsDIRCuPy(...).FOURIER_INV(data)`` with its default keywords on
one chunk per call.  Each reconstructed slice is an answer; the reference
rebuilds the pairs of slices that hold the kept ones (the method packs
slices 2q and 2q + 1 into one complex transform)."""

from __future__ import annotations

import copy

import numpy as np

from benchmark.inputs import angles


def call(config: dict, traffic: dict, chunk, device):
    from tomobar_tpu_torch import RecToolsDIRCuPy

    g = config["geometry"]
    rt = RecToolsDIRCuPy(int(g["detector_x"]), 0, int(chunk.shape[0]), float(g["centre_offset"]),
                         angles(g), int(g["recon_size"]), device=device)
    return rt.FOURIER_INV(chunk, **copy.deepcopy(config["FOURIER_INV"]))


def answer_count(out) -> int:
    return int(out.shape[0])


def answer(out, j: int):
    return out[j]


def reference(config: dict, traffic: dict, chunk, ids, prec: str = "fp32") -> dict:
    from benchmark.reference.direct import fourier_inv

    if config["FOURIER_INV"]:
        raise ValueError("the FOURIER_INV reference covers the default keywords only")
    g = config["geometry"]
    pairs = sorted({j // 2 for j in ids})
    rows = np.array([z for q in pairs for z in (2 * q, 2 * q + 1)])
    rec = fourier_inv(chunk[rows.tolist()], angles(g), float(g["centre_offset"]),
                      int(g["recon_size"]), prec)
    where = {int(z): k for k, z in enumerate(rows)}
    return {j: rec[where[j]] for j in ids}
