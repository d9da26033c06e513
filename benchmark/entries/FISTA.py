"""``RecToolsIRCuPy(...).FISTA``: one chunk of a scan per call, with the
reconstructor made for each chunk and given no Lipschitz constant (the
power method runs in every call), as a pipeline calls it chunk by chunk.
The answer of a call is the whole reconstructed chunk: the prox couples
its slices."""

from __future__ import annotations

import copy

from benchmark.inputs import angles


def call(config: dict, traffic: dict, chunk, device):
    from tomobar_tpu_torch import RecToolsIRCuPy

    g, r, m = config["geometry"], config["reconstructor"], config["FISTA"]
    rt = RecToolsIRCuPy(int(g["detector_x"]), 0, int(chunk.shape[0]), float(g["centre_offset"]),
                        angles(g), int(g["recon_size"]), OS_number=int(r["OS_number"]),
                        device=device)
    data = dict(copy.deepcopy(m["data"]), projection_data=chunk)
    return rt.FISTA(data, copy.deepcopy(m["algorithm"]), copy.deepcopy(m["regularisation"]))


def warmup(config: dict, traffic: dict, chunk, device):
    """The call with one outer iteration: every kernel, shape and plan of
    the timed call (all subsets, the prox, the power method) in 1/20 of
    its time."""
    cfg = copy.deepcopy(config)
    cfg["FISTA"]["algorithm"]["iterations"] = 1
    return call(cfg, traffic, chunk, device)


def answer_count(out) -> int:
    return 1


def answer(out, j: int):
    return out


def reference(config: dict, traffic: dict, chunk, ids, prec: str = "fp32") -> dict:
    """The reference's reconstruction of ``chunk`` (answer 0)."""
    from benchmark.reference.fista import fista

    g, r, m = config["geometry"], config["reconstructor"], config["FISTA"]
    a, reg = m["algorithm"], m["regularisation"]
    supported = (m["data"].get("data_fidelity") == "PWLS" and a.get("nonnegativity") is True
                 and reg.get("method") == "PD_TV" and set(a) <= {"iterations", "nonnegativity"}
                 and set(reg) <= {"method", "regul_param", "iterations"})
    if not supported:
        raise ValueError("the FISTA reference covers PWLS, non-negativity and iso PD-TV only")
    out = fista(chunk, angles(g), float(g["centre_offset"]), int(g["recon_size"]),
                int(r["OS_number"]), int(a["iterations"]), reg, prec)
    return {0: out}
