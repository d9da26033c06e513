"""Native (C++/OpenMP) host-side preprocessing: the fused flat/dark
normalisation and per-projection statistics of :mod:`preproc.cpp`.

Counterpart of ``tomobar_tpu/native/__init__.py``.  ``libpreproc.so`` is
built at first use with the system toolchain,

    g++ -O3 -fopenmp -shared -fPIC preproc.cpp -o libpreproc_<hash>.so

into ``_build/`` beside the CUDA kernels (listed in ``.gitignore``), keyed
by a hash of the source and flags, so an edited source is rebuilt and an
unchanged one is reused; nothing is written beside the source.  It is bound
with ctypes.  When no compiler is found the entry points return None and
the callers take their numpy path; ``available()`` says which is active.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "normalise_native", "proj_stats_native"]

_SRC = Path(__file__).resolve().parent / "preproc.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libpreproc_{h.hexdigest()[:16]}.so"


def _build_and_load() -> Optional[ctypes.CDLL]:
    if not _SRC.exists():
        return None
    so = _library_path()
    try:
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
                tmp = Path(work) / so.name
                subprocess.run(
                    ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, so)
        return ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        return None


@functools.cache
def _lib() -> Optional[ctypes.CDLL]:
    lib = _build_and_load()
    if lib is not None:
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.normalise_f32.argtypes = [f32p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int32]
        lib.normalise_f32.restype = None
        lib.proj_stats_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64] + [f32p] * 3
        lib.proj_stats_f32.restype = None
        lib.n_threads.argtypes = []
        lib.n_threads.restype = ctypes.c_int32
    return lib


def available() -> bool:
    """True when the native library compiled and loaded."""
    return _lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def normalise_native(
    data: np.ndarray,
    flat: np.ndarray,
    dark: np.ndarray,
    log_transform: bool = True,
) -> Optional[np.ndarray]:
    """Fused (data - dark)/(flat - dark) [+ -log] over the leading axes.

    data: (..., n_inner) with flat/dark broadcast over the leading axes,
    i.e. flat.shape == dark.shape == data.shape[-flat.ndim:].
    Returns None when the native library is unavailable or the shapes do
    not broadcast so (the caller falls back to numpy).
    """
    lib = _lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    flat = np.ascontiguousarray(flat, dtype=np.float32)
    dark = np.ascontiguousarray(dark, dtype=np.float32)
    n_inner = int(np.prod(flat.shape))
    if data.shape[-flat.ndim:] != flat.shape or flat.shape != dark.shape:
        return None
    n_outer = int(np.prod(data.shape)) // n_inner
    out = np.empty_like(data)
    lib.normalise_f32(
        _fptr(data), _fptr(flat), _fptr(dark), _fptr(out),
        ctypes.c_int64(n_outer), ctypes.c_int64(n_inner),
        ctypes.c_int32(1 if log_transform else 0),
    )
    return out


def proj_stats_native(data: np.ndarray):
    """Per-projection (min, max, mean) over data (n_proj, ...); None if the
    native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    n_proj = data.shape[0]
    n_pix = int(np.prod(data.shape[1:]))
    mins = np.empty(n_proj, np.float32)
    maxs = np.empty(n_proj, np.float32)
    means = np.empty(n_proj, np.float32)
    lib.proj_stats_f32(
        _fptr(data), ctypes.c_int64(n_proj), ctypes.c_int64(n_pix),
        _fptr(mins), _fptr(maxs), _fptr(means),
    )
    return mins, maxs, means
