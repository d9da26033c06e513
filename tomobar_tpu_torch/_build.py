"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, which is loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu   (one per source)
    nvcc -shared -o _build/libtomobar_kernels_<hash>.so *.o

The library is built at first use into ``_build/`` beside this file (listed
in ``.gitignore``), keyed by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is built when the
module is imported: CPU-only installs import every module of the package.

Every C entry point returns the ``cudaError_t`` of its launch
(``cudaGetLastError()``); :func:`check` turns a non-zero code into an
exception.  Each kernel wrapper counts its launches in :data:`launch_counts`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = [
    "library",
    "check",
    "launch_counts",
    "reset_launch_counts",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of csrc/*.cu (pointers and the stream as void*, ints as int)
_SIGNATURES = {
    "tt_shear_fp": [_P] * 3 + [_I] * 6 + [_P],
    "tt_resample_fp": [_P] * 4 + [_I] * 5 + [_P],
    "tt_resample_bp": [_P] * 5 + [_I] * 6 + [_P],
    "tt_unshear_bp": [_P] * 3 + [_I] * 8 + [_P],
    "tt_shear_fp_packed": [_P] * 4 + [_I] * 6 + [_P],
    "tt_shear_fp_packed_band": [],
    "tt_unshear_bp_packed": [_P] * 3 + [_I] * 6 + [_P],
    "tt_pd_tv": [_P] * 9 + [_I] * 3 + [_F] * 4 + [_I] * 6 + [_P],
    "tt_pd_tv_fuse": [_I],
    "tt_pd_tv_wave": [_P] * 9 + [_I] * 3 + [_F] * 4 + [_I] * 6 + [_P],
    "tt_usfft_grid": [_P] * 7 + [_I] * 5 + [_F] * 3 + [_P],
    "tt_usfft_grid_tile": [_I],
    "tt_fft_axis2": [_P] * 5 + [_I] * 4 + [_P, _I, _P],
}

# launches per kernel since the last reset; each wrapper adds one where it
# launches its kernel and nowhere else
launch_counts = {
    "K1": 0, "K1p": 0, "K2": 0, "K3": 0, "K4": 0, "K4p": 0, "PD": 0, "PDw": 0, "G": 0,
    "F": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "tomobar_tpu_torch cannot be built"
    )


def _run_all(cmds) -> None:
    """Run the commands in parallel, wait for every one of them, then raise
    with the output of the first that failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}"
            )


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = sorted(_CSRC.glob("*.cu"))
    headers = sorted(_CSRC.glob("*.cuh"))
    so = _BUILD_DIR / f"libtomobar_kernels_{_source_hash(sources + headers)}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
            nvcc = _nvcc()
            objs = [Path(work) / f"{src.stem}.o" for src in sources]
            _run_all([
                [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)
            ])
            tmp = Path(work) / so.name
            _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tt_error_string.argtypes = [ctypes.c_int]
    lib.tt_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = library().tt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")
