#!/usr/bin/env python3
"""Run the port's GPU lane on the card and record the result.

The tier-1 run on the CPU skips the lane's two files; this runner runs
them with ``TOMOBAR_TORCH_TEST_DEVICE=cuda``: ``tests/test_torch_hardware.py``
(every CUDA kernel against its plain version, adjointness, the GPU against
the CPU) and ``tests/test_torch_goldens_cuda.py`` (``GOLDEN_CUDA``).  It
writes a JSON artifact (``GPU_LANE_r{N}.json``, the keys of
``TPU_LANE_r05.json``) so that a green run on the card is a committed fact.
``--noconftest``: ``tests/conftest.py`` imports jax, which the lane neither
needs nor may find.

Usage:  python3 tools/run_gpu_lane.py [artifact.json]
"""

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["tests/test_torch_hardware.py", "tests/test_torch_goldens_cuda.py"]
CMD = ("TOMOBAR_TORCH_TEST_DEVICE=cuda python -m pytest --noconftest -p no:cacheprovider "
       + " ".join(FILES) + " -q")


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable: {e}"


def main() -> int:
    artifact = sys.argv[1] if len(sys.argv) > 1 else "GPU_LANE.json"
    env = dict(os.environ, TOMOBAR_TORCH_TEST_DEVICE="cuda")
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", *FILES,
         "-q", "--tb=short", "-rs"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=3000,
    )
    dt = time.time() - t0
    summary = next((line.strip() for line in proc.stdout.splitlines()[::-1]
                    if re.search(r"\d+ (passed|failed|error|skipped)", line)), "")
    out = {
        "lane": "cuda",
        "device": card(),
        "returncode": proc.returncode,
        "summary": summary,
        "wall_s": round(dt, 1),
        "cmd": CMD,
        "tail": "\n".join(proc.stdout.strip().splitlines()[-60:]),
    }
    with open(os.path.join(REPO, artifact), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "tail"}))
    if proc.returncode:
        print(proc.stdout[-20000:])
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
