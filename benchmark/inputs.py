"""The benchmark's inputs: sinograms of an ellipsoid phantom, made on the
device from the run's seed.

``ELLIPSOIDS`` is a frozen copy of ``tomobar_tpu_torch/bench/northstar.py``
at commit 4cba618f362617c7 (the JAX package's bench phantom).  Each slice
of a scan cuts every ellipsoid in an ellipse, whose parallel-beam
projection has the closed form of ``tomobar_tpu_torch/bench/analytic.py``
at the same commit, rewritten here in plain PyTorch:

    p(s) = 2 v a b / w^2 sqrt(w^2 - (s - s0)^2),
    w^2  = a^2 cos^2(theta) + b^2 sin^2(theta),
    s0   = x0 cos(theta) + y0 sin(theta),

with the line ``x cos(theta) + y sin(theta) = s`` and ``s = t - (det_x -
1)/2 + cor`` in pixels.  So no projector of the program makes the data.

A scan has ``scan_rows`` detector rows over the phantom's height; a chunk
is ``chunk`` adjacent rows of it.  The seed draws where the chunks lie and,
where the configuration asks for it, the Poisson counting noise.
"""

from __future__ import annotations

import numpy as np
import torch

# (cx, cy, cz, ax, ay, az, value) in the unit cube [-1, 1]^3
ELLIPSOIDS = (
    (0.0, 0.0, 0.0, 0.69, 0.90, 0.92, 1.0),
    (0.0, -0.02, 0.0, 0.62, 0.85, 0.87, -0.6),
    (0.22, 0.0, 0.0, 0.11, 0.31, 0.25, -0.2),
    (-0.22, 0.0, 0.0, 0.16, 0.41, 0.30, -0.2),
    (0.0, 0.35, -0.15, 0.21, 0.25, 0.30, 0.3),
    (0.0, 0.1, 0.25, 0.046, 0.046, 0.05, 0.3),
    (-0.08, -0.605, 0.0, 0.046, 0.023, 0.02, 0.25),
    (0.06, -0.605, 0.1, 0.023, 0.046, 0.02, 0.25),
)

# rows of the scan whose |z| is above this carry next to nothing
_Z_SPAN = 0.8


def angles(geometry: dict) -> np.ndarray:
    """The scan's projection angles in radians, float64."""
    span = np.deg2rad(float(geometry["angle_range_deg"]))
    return np.linspace(0.0, span, int(geometry["angles"]),
                       endpoint=bool(geometry.get("angles_endpoint", False)))


def chunk_starts(seed: int, scan_rows: int, chunk: int, count: int) -> list:
    """First rows of ``count`` distinct chunks of ``chunk`` rows, drawn from
    ``seed`` among the rows where the phantom is (|z| <= 0.8)."""
    z = np.linspace(-1.0, 1.0, scan_rows)
    lo = int(np.searchsorted(z, -_Z_SPAN))
    hi = max(int(np.searchsorted(z, _Z_SPAN, side="right")) - chunk, lo + count)
    rng = np.random.default_rng(seed)
    return sorted(int(s) for s in rng.choice(np.arange(lo, hi), size=count, replace=False))


def clean_sinogram(theta: np.ndarray, det_x: int, n: int, scan_rows: int, rows,
                   cor: float, device, block: int = 16) -> torch.Tensor:
    """The closed-form sinogram of :data:`ELLIPSOIDS` on detector ``rows``
    of a ``scan_rows``-row scan: float32 ``[len(rows), angles, det_x]`` on
    ``device``, computed in float64 blocks of ``block`` rows.  The phantom
    spans the n x n slice (pixel pitch 2 / (n - 1) of the unit cube)."""
    rows = np.asarray(rows)
    half = (n - 1) / 2.0
    zs = np.linspace(-1.0, 1.0, scan_rows)[rows]
    th = torch.as_tensor(np.asarray(theta, np.float64), device=device)[:, None]
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    s = torch.arange(det_x, dtype=torch.float64, device=device) - (det_x - 1) / 2.0 + cor
    out = torch.empty((rows.size, th.shape[0], det_x), dtype=torch.float32, device=device)
    for b0 in range(0, rows.size, block):
        zb = torch.as_tensor(zs[b0:b0 + block], dtype=torch.float64, device=device)
        acc = torch.zeros((zb.shape[0], th.shape[0], det_x), dtype=torch.float64, device=device)
        for cx, cy, cz, ax, ay, az, v in ELLIPSOIDS:
            # the ellipse this ellipsoid cuts at each row's height (0 outside)
            scale = torch.sqrt(torch.clamp(1.0 - ((zb - cz) / az) ** 2, min=0.0))
            a = (ax * half * scale)[:, None, None]
            b = (ay * half * scale)[:, None, None]
            w2 = a * a * cos_t ** 2 + b * b * sin_t ** 2
            s0 = (cx * half) * cos_t + (cy * half) * sin_t
            d2 = torch.clamp(w2 - (s - s0) ** 2, min=0.0)
            acc += torch.where(w2 > 0, 2.0 * v * a * b / torch.clamp(w2, min=1e-300), 0.0) * torch.sqrt(d2)
        out[b0:b0 + block] = acc.float()
    return out


def noisy(sino: torch.Tensor, i0: float, n: int, generator: torch.Generator) -> torch.Tensor:
    """Post-log data with Poisson counting noise at ``i0`` photons: the
    sinogram in attenuation units of 4 / n per pixel length, as
    ``tomobar_tpu_torch/bench/northstar.py`` makes it, back in pixel units."""
    mu_scale = 4.0 / n
    counts = torch.poisson(i0 * torch.exp(-sino.double() * mu_scale), generator=generator)
    return (-torch.log(torch.clamp(counts, min=1.0) / i0) / mu_scale).float()


def make_chunks(config: dict, traffic: dict, seed: int, device) -> list:
    """The run's distinct input chunks, each ``[chunk, angles, det_x]``,
    made on ``device`` from ``seed``."""
    g, d = config["geometry"], config["data"]
    theta = angles(g)
    chunk = int(traffic["chunk_slices"])
    starts = chunk_starts(seed, int(d["scan_rows"]), chunk, int(traffic["distinct_chunks"]))
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    chunks = []
    for z0 in starts:
        sino = clean_sinogram(theta, int(g["detector_x"]), int(g["recon_size"]),
                              int(d["scan_rows"]), np.arange(z0, z0 + chunk),
                              float(g["centre_offset"]), device)
        if d.get("noise") == "poisson":
            sino = noisy(sino, float(d["i0"]), int(g["recon_size"]), gen)
        chunks.append(sino)
    return chunks
