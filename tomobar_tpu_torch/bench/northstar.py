"""The north-star measurement: time-to-RMSE on the 2560^2 x 20 phantom, on
the card.

``BASELINE.json`` names the headline metric: "FISTA-OS-TV iterations/s and
time-to-RMSE on 2560^2x20 TomoPhantom 3D ... at RMSE parity".  This module
measures it on the card with converging data (an ellipsoid phantom,
Poisson counting noise, the power method's Lipschitz constant), after the
reference workflow (``Demos/tomophantom_3D_recon1.py``: RMSE after FBP
and after FISTA) and its warm-started ADMM (``Demos/RealData.py``).
Counterpart of ``tomobar_tpu/bench/northstar.py``; everything is made and
run on the card, nothing is compiled.

Reported (seconds from CUDA events around each outer iteration; rel-RMSE
against the phantom, taken outside the timed steps):

* ``rel_rmse_fbp``: the direct method's quality floor (sinc, cutoff 1.1);
* ``fista.trajectory``: (cumulative s, rel-RMSE, the step's s) after each
  outer iteration of FISTA-OS-PWLS-PD-TV; each step's time is kept as
  measured (the JAX package's bench clamps a step above 5x the median to
  the median and reports the rest as ``stall_excluded_s``; here nothing is
  clamped or left out);
* ``fista.time_to_fbp_rmse_s`` / ``time_to_rmse_s``: seconds of FISTA to
  reach FBP's rel-RMSE / 1.02 x the run's best;
* ``fista.iter_s``: outer iterations per second, from the 3- less the
  2-iteration call of ``solvers.core.fista`` after a warm-up call;
* ``admm.*``: warm-started (FBP) relaxed ADMM-OS24, 3 outer iterations.

The trajectories time ``solvers.core.fista`` and ``admm`` themselves.  The
prox each solver is given is watched: its output at the last subset of an
outer iteration is that iteration's x (the momentum or dual update that
follows does not change x), so there the step's end is marked, the
rel-RMSE taken and the next step's start marked.  Step 1 therefore also
holds the solver's set-up (the weights and the subset slices, a few ms),
and each step's momentum (FISTA) or dual (ADMM) update is counted in the
step after it.

Run on a machine with the card::

    python -m tomobar_tpu_torch.bench.northstar
"""

from __future__ import annotations

import json
import os
import time
from itertools import accumulate, count
from typing import Callable, List, Optional

import numpy as np
import torch

__all__ = ["ELLIPSOIDS", "ellipsoid_phantom", "northstar_inputs", "run_northstar"]

# (cx, cy, cz, ax, ay, az, value): the JAX package's bench phantom
# (examples/phantom3d_fista_os_tv.py's ellipsoids)
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


def ellipsoid_phantom(n: int, nz: int, device) -> torch.Tensor:
    """Shepp-Logan-like stack of :data:`ELLIPSOIDS` (nz, n, n), float32,
    values >= 0, built on ``device`` in float32 as the JAX package builds
    it."""
    z = torch.linspace(-1, 1, nz, device=device)[:, None, None]
    y = torch.linspace(-1, 1, n, device=device)[None, :, None]
    x = torch.linspace(-1, 1, n, device=device)[None, None, :]
    vol = torch.zeros((nz, n, n), dtype=torch.float32, device=device)
    for cx, cy, cz, ax, ay, az, v in ELLIPSOIDS:
        inside = ((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2 + ((z - cz) / az) ** 2 <= 1.0
        vol = vol + v * inside.to(torch.float32)
    return torch.clamp(vol, min=0.0)


def _rel_rmse(rec: torch.Tensor, ref: torch.Tensor) -> float:
    """rel-RMSE of ``rec`` against ``ref`` on their device, in float64."""
    num = torch.sqrt(torch.mean((rec.double() - ref.double()) ** 2))
    return float(num / torch.clamp(torch.sqrt(torch.mean(ref.double() ** 2)), min=1e-30))


def _trajectory(solve: Callable, prox: Callable, n_sub: int, phantom: torch.Tensor,
                on_step: Optional[Callable] = None):
    """``solve(regul_fn)`` with ``regul_fn`` the prox ``prox`` watched: its
    output at every ``n_sub``-th call is an outer iteration's x, where the
    step's end is marked (CUDA events on a card, ``time.perf_counter`` on
    the CPU), its rel-RMSE taken, ``on_step(i)`` called (where given) and
    the next step's start marked; the output is passed on unchanged.
    Returns the solver's result and [(cumulative s, rel-RMSE, the step's
    s)], the steps' times as measured."""
    from tomobar_tpu_torch.bench.harness import Marks

    marks, rmses, calls = Marks(phantom.device), [], count(1)

    def watched(v):
        x = prox(v)
        if next(calls) % n_sub == 0:
            marks.mark()
            rmses.append(_rel_rmse(x, phantom))
            if on_step is not None:
                on_step(len(rmses) - 1)
            marks.mark()
        return x

    marks.mark()
    x = solve(watched)
    steps = [ms / 1e3 for ms in marks.elapsed_ms()[0::2]]
    return x, list(zip(accumulate(steps), rmses, steps))


def _traj_out(traj: List[tuple]) -> list:
    return [(round(t, 4), round(r, 4), round(d, 4)) for t, r, d in traj]


def northstar_inputs(N: int, nz: int, nproj: int, os_number: int, i0: float, device,
                     seed: int = 0):
    """The run's projector (``os_number`` subsets of ``nproj`` angles over
    [0, pi)), phantom and noisy sinogram [detY, angles, detX] on
    ``device``: Poisson counting noise at ``i0`` photons in intensity space,
    from a generator seeded with ``seed``, in mu-units scaled so that the
    sinogram keeps the projector's pixel-sum scale."""
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector

    angles = np.linspace(0, np.pi, nproj, endpoint=False).astype(np.float32)
    P = Projector(Geometry(N, nz, angles, 0.0, N, os_number=os_number))
    phantom = ellipsoid_phantom(N, nz, device)
    mu_scale = 4.0 / N
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = torch.poisson(i0 * torch.exp(-P.fp(phantom) * mu_scale), generator=gen)
    sino = (-torch.log(torch.clamp(counts, min=1.0) / i0) / mu_scale).float()
    return P, phantom, sino


def run_northstar(
    N: int = 2560,
    nz: int = 20,
    nproj: int = 1801,
    os_number: int = 10,
    tv_iters: int = 20,
    fista_outer: int = 20,
    admm_outer: int = 3,
    regul_param: float = 2e-4,
    i0: float = 8000.0,
    verbose: bool = True,
    device=None,
    seed: int = 0,
    on_step: Optional[Callable] = None,
) -> dict:
    """The north-star run on ``device`` (the card by default; ``"cpu"`` on
    the host): phantom, noisy sinogram, Lipschitz constant, FBP, then the
    FISTA and the ADMM trajectories; returns the JAX package's keys (but
    ``stall_excluded_s``: no step is left out).  ``on_step(solver, i)``,
    where given, is called after outer step i of each trajectory
    (``solver`` ``"fista"`` or ``"admm"``), outside its timing."""
    from tomobar_tpu_torch import RecToolsDIRCuPy
    from tomobar_tpu_torch.bench.breakdown import _device
    from tomobar_tpu_torch.bench.harness import device_sync, outer_iteration_s
    from tomobar_tpu_torch.geometry import Geometry
    from tomobar_tpu_torch.ops.projector import Projector
    from tomobar_tpu_torch.regularisers import PD_TV
    from tomobar_tpu_torch.solvers import core as solvers

    dev = _device(device)

    def log(msg):
        if verbose:
            print(f"[northstar] {msg}", flush=True)

    out = {"shape": f"{nproj}x{nz}x{N}", "os": os_number, "tv": tv_iters}
    angles = np.linspace(0, np.pi, nproj, endpoint=False).astype(np.float32)
    P, phantom, sino = northstar_inputs(N, nz, nproj, os_number, i0, dev, seed)
    device_sync(sino)
    log("phantom projected, Poisson noise applied")

    # the Lipschitz constant: the power method on subset 0; the second call
    # is the run alone (the first also builds the kernels' plans)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        L = solvers.power_method(P, (nz, N, N), iterations=15, device=dev)
        times.append(time.perf_counter() - t0)
    out["lipschitz_const"] = round(float(L), 2)
    out["powermethod_s"] = round(times[0], 3)
    out["powermethod_run_s"] = round(times[1], 3)
    out["powermethod_compile_s"] = round(max(times[0] - times[1], 0.0), 3)
    log(f"power method L={L:.1f} ({times[0]:.2f} s first call, {times[1]:.2f} s run)")

    # the FBP quality floor and the ADMM warm start
    rt_dir = RecToolsDIRCuPy(N, 0, nz, 0.0, angles, N, device=dev)
    fbp = rt_dir.FBP(sino.transpose(0, 1), cutoff_freq=1.1)
    device_sync(fbp)
    t0 = time.perf_counter()
    fbp = rt_dir.FBP(sino.transpose(0, 1), cutoff_freq=1.1)
    device_sync(fbp)
    out["fbp_s"] = round(time.perf_counter() - t0, 4)
    rmse_fbp = _rel_rmse(fbp, phantom)
    out["rel_rmse_fbp"] = round(rmse_fbp, 4)
    log(f"FBP rel-RMSE {rmse_fbp:.4f} ({out['fbp_s']} s)")

    # FISTA-OS-PWLS-PD-TV from zero
    def prox(x):
        return PD_TV(x, regul_param, tv_iters, 0, 1, 12.0)

    def fista(k, regul_fn=prox):
        return solvers.fista(P, sino, k, L, nonnegativity=True, fidelity="PWLS",
                             regul_fn=regul_fn)

    _, traj = _trajectory(lambda reg: fista(fista_outer, reg), prox, len(P.subset_indices),
                          phantom, on_step and (lambda i: on_step("fista", i)))
    rmses = [r for _, r, _ in traj]
    best = min(rmses)
    tgt = 1.02 * best
    t_conv = next(t for t, r, _ in traj if r <= tgt)
    t_fbp = next((t for t, r, _ in traj if r <= rmse_fbp), None)
    iter_dt = outer_iteration_s(fista)
    out["fista"] = {
        "rel_rmse_final": round(rmses[-1], 4),
        "rel_rmse_best": round(best, 4),
        "rmse_target": round(tgt, 4),
        "time_to_rmse_s": round(t_conv, 4),
        "time_to_rmse_cold_s": round(t_conv + times[1], 4),
        "time_to_rmse_warm_s": round(t_conv, 4),
        "time_to_fbp_rmse_s": None if t_fbp is None else round(t_fbp, 4),
        "outer_iters": fista_outer,
        "total_s": round(traj[-1][0], 4),
        "trajectory": _traj_out(traj),
        "iter_s": round(1.0 / iter_dt, 4) if iter_dt > 0 else None,
    }
    log(f"FISTA: best rel-RMSE {best:.4f}, time-to-RMSE {t_conv:.2f} s, "
        f"{out['fista']['iter_s']} iter/s")

    # warm-start ADMM-OS24, LS; rho 1, so its prox (of regul_param / rho) is FISTA's
    P24 = Projector(Geometry(N, nz, angles, 0.0, N, os_number=24))
    x0 = fbp.contiguous()
    _, traj = _trajectory(
        lambda reg: solvers.admm(P24, sino, admm_outer, L, rho_const=1.0, nonnegativity=True,
                                 regul_fn=reg, x0=x0),
        prox, len(P24.subset_indices), phantom, on_step and (lambda i: on_step("admm", i)))
    out["admm"] = {
        "warm_start": "FBP",
        "os": 24,
        "rel_rmse_final": round(traj[-1][1], 4),
        "outer_iters": admm_outer,
        "total_s": round(traj[-1][0], 4),
        "trajectory": _traj_out(traj),
    }
    log(f"ADMM warm start: rel-RMSE {traj[-1][1]:.4f} after {admm_outer} outer "
        f"({traj[-1][0]:.2f} s)")
    return out


def main():
    from tomobar_tpu_torch.bench.breakdown import _device, card_line

    print(f"device: {torch.cuda.get_device_name(_device(None))}; nvidia-smi name, "
          f"power.limit: {card_line()}")
    res = run_northstar(
        N=int(os.environ.get("TOMOBAR_NS_N", 2560)),
        nz=int(os.environ.get("TOMOBAR_NS_NZ", 20)),
        nproj=int(os.environ.get("TOMOBAR_NS_NPROJ", 1801)),
        os_number=int(os.environ.get("TOMOBAR_NS_OS", 10)),
        tv_iters=int(os.environ.get("TOMOBAR_NS_TV", 20)),
        fista_outer=int(os.environ.get("TOMOBAR_NS_OUTER", 20)),
        regul_param=float(os.environ.get("TOMOBAR_NS_REG", 2e-4)),
    )
    print(json.dumps(res))


if __name__ == "__main__":
    main()
