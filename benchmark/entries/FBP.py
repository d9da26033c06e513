"""``RecToolsDIRCuPy(...).FBP(data)`` with the default sinc filter (cutoff
1.1) on one slice per call: the traffic's chunks are one row each, and the
call takes that row's sinogram [angles, detX].  The slice is the answer."""

from __future__ import annotations

import copy

from benchmark.inputs import angles


def _row(chunk):
    if chunk.shape[0] != 1:
        raise ValueError("the FBP entry reconstructs one slice a call (chunk_slices 1)")
    return chunk[0]


def call(config: dict, traffic: dict, chunk, device):
    from tomobar_tpu_torch import RecToolsDIRCuPy

    g = config["geometry"]
    rt = RecToolsDIRCuPy(int(g["detector_x"]), 0, None, float(g["centre_offset"]), angles(g),
                         int(g["recon_size"]), device=device)
    return rt.FBP(_row(chunk), **copy.deepcopy(config["FBP"]))


def answer_count(out) -> int:
    return 1


def answer(out, j: int):
    return out


def reference(config: dict, traffic: dict, chunk, ids, prec: str = "fp32") -> dict:
    from benchmark.reference.direct import fbp

    kw = config["FBP"]
    if set(kw) - {"cutoff_freq"}:
        raise ValueError("the FBP reference covers the sinc filter only")
    g = config["geometry"]
    return {0: fbp(_row(chunk), angles(g), float(g["centre_offset"]), int(g["recon_size"]),
                   float(kw.get("cutoff_freq", 1.1)), prec)}
