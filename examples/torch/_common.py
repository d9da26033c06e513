"""What the examples of ``examples/torch/`` share: the device they run on,
their sizes and command line, their phantoms and the quality metric.

Each example mirrors its JAX counterpart in ``examples/``: the same
phantom, seeds, geometry, dictionaries, iteration counts and printed lines.
It runs on ``cuda:0`` unless the caller asks for another device
(``--device cpu`` on the command line, ``main(device="cpu")`` from Python);
without CUDA it raises.  On a CUDA device the hand-written kernels of
``tomobar_tpu_torch/csrc`` run; on the CPU their plain PyTorch versions.
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from tomobar_tpu_torch.bench.harness import rel_rmse  # noqa: E402

__all__ = ["arguments", "ellipsoid_phantom", "example_device", "example_size",
           "rel_rmse", "shepp_logan"]


def example_device(device=None) -> torch.device:
    """``cuda:0`` unless ``device`` names another; raises where CUDA is asked
    for and not available (no fallback to the CPU)."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass --device cpu (main(device='cpu')) "
            "to run the example on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def example_size(value, variable: str, default: int) -> int:
    """``value``, or else the environment's ``variable``, or else
    ``default`` (the JAX examples read the same variables)."""
    return int(os.environ.get(variable, default)) if value is None else int(value)


def arguments(doc: str, *extra) -> dict:
    """The command line of an example: ``--device`` (default ``cuda:0``),
    ``-N``/``--nz`` (default: ``TOMOBAR_EXAMPLE_N``/``_NZ``, else the
    example's own) and the example's ``extra`` options, each a pair of
    (flags, ``add_argument`` keywords); returns them as ``main``'s keywords."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu or cuda:1 (default cuda:0)")
    parser.add_argument("-N", type=int, default=None, help="slice size")
    parser.add_argument("--nz", type=int, default=None, help="slices")
    for flags, kwargs in extra:
        parser.add_argument(*flags, **kwargs)
    return vars(parser.parse_args())


def shepp_logan(n: int) -> np.ndarray:
    """Classic ellipse phantom (value, a, b, x0, y0, phi_deg)."""
    ellipses = [
        (1.0, 0.69, 0.92, 0.0, 0.0, 0.0),
        (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0.0),
        (-0.2, 0.11, 0.31, 0.22, 0.0, -18.0),
        (-0.2, 0.16, 0.41, -0.22, 0.0, 18.0),
        (0.1, 0.21, 0.25, 0.0, 0.35, 0.0),
        (0.1, 0.046, 0.046, 0.0, 0.1, 0.0),
    ]
    y, x = np.mgrid[-1 : 1 : n * 1j, -1 : 1 : n * 1j]
    img = np.zeros((n, n), dtype=np.float32)
    for v, a, b, x0, y0, phi in ellipses:
        p = np.deg2rad(phi)
        xr = (x - x0) * np.cos(p) + (y - y0) * np.sin(p)
        yr = -(x - x0) * np.sin(p) + (y - y0) * np.cos(p)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += v
    return np.clip(img, 0.0, None)


def ellipsoid_phantom(n: int, nz: int) -> np.ndarray:
    """A Shepp-Logan-like stack of ellipsoids, values in [0, 1]."""
    z, y, x = np.meshgrid(
        np.linspace(-1, 1, nz),
        np.linspace(-1, 1, n),
        np.linspace(-1, 1, n),
        indexing="ij",
    )
    vol = np.zeros((nz, n, n), np.float32)
    # (cx, cy, cz, ax, ay, az, value)
    for cx, cy, cz, ax, ay, az, v in [
        (0.0, 0.0, 0.0, 0.69, 0.90, 0.92, 1.0),
        (0.0, -0.02, 0.0, 0.62, 0.85, 0.87, -0.6),
        (0.22, 0.0, 0.0, 0.11, 0.31, 0.25, -0.2),
        (-0.22, 0.0, 0.0, 0.16, 0.41, 0.30, -0.2),
        (0.0, 0.35, -0.15, 0.21, 0.25, 0.30, 0.3),
        (0.0, 0.1, 0.25, 0.046, 0.046, 0.05, 0.3),
        (-0.08, -0.605, 0.0, 0.046, 0.023, 0.02, 0.25),
        (0.06, -0.605, 0.1, 0.023, 0.046, 0.02, 0.25),
    ]:
        vol += v * (
            ((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2 + ((z - cz) / az) ** 2
            <= 1.0
        )
    return np.clip(vol, 0.0, None)
