"""ToMoBAR's real-data recipe (``Demos/RealData.py:228-235``) on one chunk
of a scan per call: ``normaliser`` on the raw frames, flats and darks on
the card, ``RecToolsDIRCuPy(...).FBP`` on the padded detector as the warm
start, then ``RecToolsIRCuPy(...).ADMM`` with ordered subsets, PWLS and
the PD-TV prox.  Both reconstructors are made for each chunk (the power
method and the plans run in every call), as a pipeline calls them chunk
by chunk.

The raw frames are made once per input chunk during set-up
(:func:`warmup`) and kept here, keyed by the chunk: the chunk's Poisson
counts at ``i0`` (the log undone, counts = round(i0 exp(-chunk 4/n))),
times a fixed gain pattern, plus the dark level, in (angles, rows, det_x)
as a detector writes them; the flats and darks are Poisson counts around
the same gain and dark level (:func:`raw_frames`).  A call never makes
frames: it raises for a chunk that set-up did not see.  The answer of a
call is the whole reconstructed chunk: the prox couples its slices."""

from __future__ import annotations

import copy

import torch

from benchmark.inputs import angles

# id(chunk) -> (chunk, frames, flats, darks), filled by warmup
_FRAMES = {}


def raw_frames(config: dict, chunk: torch.Tensor):
    """The raw frames (angles, rows, det_x), flats (flats, rows, det_x) and
    darks (darks, rows, det_x) of ``chunk`` [rows, angles, det_x], float32
    whole counts on the chunk's device; the gain pattern, flats and darks
    come from a generator seeded with the configuration's ``raw.seed``, so
    the same chunk gives the same frames."""
    raw, i0 = config["raw"], float(config["data"]["i0"])
    rows, _, det_x = chunk.shape
    gen = torch.Generator(device=chunk.device).manual_seed(int(raw["seed"]))
    gain = 1.0 + float(raw["flat_gain_sd"]) * torch.randn(
        (rows, det_x), generator=gen, dtype=torch.float64, device=chunk.device)
    dark, mu = float(raw["dark_level"]), 4.0 / int(config["geometry"]["recon_size"])
    counts = torch.round(i0 * torch.exp(-mu * chunk.double()))
    frames = torch.round(counts * gain[:, None, :] + dark).float().transpose(0, 1).contiguous()
    del counts
    flats = torch.poisson((i0 * gain + dark).expand(int(raw["flats"]), rows, det_x).contiguous(),
                          generator=gen).float()
    darks = torch.poisson(torch.full((int(raw["darks"]), rows, det_x), dark, dtype=torch.float64,
                                     device=chunk.device), generator=gen).float()
    return frames, flats, darks


def _kept(chunk):
    kept = _FRAMES.get(id(chunk))
    if kept is None or kept[0] is not chunk:
        raise RuntimeError("no raw frames for this chunk: set-up (warmup) makes them")
    return kept[1:]


def call(config: dict, traffic: dict, chunk, device):
    from tomobar_tpu_torch import RecToolsDIRCuPy, RecToolsIRCuPy
    from tomobar_tpu_torch.utils.tools import normaliser

    frames, flats, darks = _kept(chunk)
    g, r, m = config["geometry"], config["reconstructor"], config["ADMM"]
    n, det_x, pad = int(g["recon_size"]), int(g["detector_x"]), int(r["DetectorsDimH_pad"])
    rows, theta, cor = int(chunk.shape[0]), angles(g), float(g["centre_offset"])
    # -log(I / I0) in attenuation units of 4 / n per pixel, back in pixel units
    data = normaliser(frames, flats, darks, **config["normaliser"]).mul_(n / 4.0)
    fbp = RecToolsDIRCuPy(det_x, pad, rows, cor, theta, n + 2 * pad, device=device).FBP(
        data, **copy.deepcopy(config["FBP"]))
    rt = RecToolsIRCuPy(det_x, pad, rows, cor, theta, n, OS_number=int(r["OS_number"]),
                        device=device)
    d = dict(copy.deepcopy(m["data"]), projection_data=data,
             data_axes_labels_order=["angles", "detY", "detX"])
    return rt.ADMM(d, dict(copy.deepcopy(m["algorithm"]), initialise=fbp),
                   copy.deepcopy(m["regularisation"]))


def warmup(config: dict, traffic: dict, chunk, device):
    """Make ``chunk``'s raw frames (once) and run the whole call on them."""
    if id(chunk) not in _FRAMES:
        _FRAMES[id(chunk)] = (chunk, *raw_frames(config, chunk))
    return call(config, traffic, chunk, device)


def answer_count(out) -> int:
    return 1


def answer(out, j: int):
    return out


def reference(config: dict, traffic: dict, chunk, ids, prec: str = "fp32") -> dict:
    """The reference's reconstruction (answer 0) from ``chunk``'s raw frames,
    made anew by :func:`raw_frames`."""
    from benchmark.reference.admm import admm_counts

    g, r, m = config["geometry"], config["reconstructor"], config["ADMM"]
    a, reg = m["algorithm"], m["regularisation"]
    supported = (m["data"].get("data_fidelity") == "PWLS" and not a.get("nonnegativity", False)
                 and reg.get("method") == "PD_TV"
                 and set(a) <= {"iterations", "ADMM_rho_const", "ADMM_relax_par",
                                "recon_mask_radius"}
                 and set(reg) <= {"method", "regul_param", "iterations"}
                 and config["normaliser"] == {"method": "mean", "log": True}
                 and set(config["FBP"]) <= {"cutoff_freq"})
    if not supported:
        raise ValueError("the ADMM reference covers the mean -log normaliser, the sinc FBP, "
                         "PWLS without non-negativity and iso PD-TV only")
    frames, flats, darks = raw_frames(config, chunk)
    out = admm_counts(frames, flats, darks, angles(g), float(g["centre_offset"]),
                      int(g["recon_size"]), int(r["DetectorsDimH_pad"]), int(r["OS_number"]),
                      float(config["FBP"].get("cutoff_freq", 1.1)), int(a["iterations"]),
                      float(a["ADMM_rho_const"]), float(a["ADMM_relax_par"]), reg,
                      float(a.get("recon_mask_radius", 1.0)), prec)
    return {0: out}
