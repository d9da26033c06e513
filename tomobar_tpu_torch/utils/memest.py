"""Device-memory planning: the reference's ``DeviceMemStack`` dry-run
allocator, a model of ``FOURIER_INV``'s memory from shapes alone, and a
measured estimate for any function.

Counterpart of ``tomobar_tpu/utils/memest.py``, which reads XLA's
compile-time memory analysis.  PyTorch has none, so here:

* :func:`estimate_fourier_inv_memory` replays the allocations and frees of
  the port's ``fourier_inv`` (``ops/usfft.py``) from the shapes, stage by
  stage and chunk by chunk, in the order the code makes them, as the
  reference's own ``*_estimator`` methods do (``methodsDIR_CuPy.py:547-989``).
  It runs nothing and allocates nothing on the device.
* :func:`estimate_memory` runs the function once on zeros of the example
  shapes and measures its peak where the example fits its device, and
  otherwise runs it on ``meta`` tensors, which hold no memory: the kernel
  wrappers make their outputs and workspaces there and launch nothing.
* :class:`LiveBytes` counts the bytes held by the tensors made while it is
  active, on any device (``meta`` included); :func:`estimate_memory` uses it
  on the CPU, where PyTorch keeps no peak statistic, and on ``meta``.
"""

from __future__ import annotations

import os
import weakref
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

__all__ = ["estimate_memory", "estimate_fourier_inv_memory", "DeviceMemStack"]

F32 = 4  # bytes of a float32
MIB = 1 << 20
# PyTorch's CUDA caching allocator rounds each block up to 512 bytes, and
# hands out a cached block whose remainder would be 1 MiB or less whole,
# so a block above 1 MiB may hold up to 1 MiB more than was asked
CUDA_BLOCK = 512
CUDA_LARGE_SLACK = MIB
# cuFFT's work area in a torch.fft call on a CUDA tensor, through the
# caching allocator: under 1 MiB along the last axis at the pipeline's
# shapes on an H100 (chip_smoke.py phase 13 measures it); along axis -2
# PyTorch copies the input instead (replayed as such)
CUFFT_WORK = MIB


class LiveBytes(TorchDispatchMode):
    """Live and peak bytes of the tensor storages that operators make while
    the mode is active.  A storage counts once, from the operator that
    made it until it is freed (a weakref finalizer); views and in-place
    results add nothing, nor does memory that a tensor made elsewhere
    shares (``torch.from_numpy``).  Storages are told apart by identity,
    not by address: every ``meta`` storage has the address 0."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held = set()

    def _release(self, key, nbytes: int) -> None:
        self._held.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        inputs = {
            t.untyped_storage()._cdata
            for t in tree_flatten((args, kwargs))[0]
            if isinstance(t, torch.Tensor)
        }
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            nbytes = st.nbytes()
            if nbytes == 0 or key in inputs or key in self._held:
                continue
            self._held.add(key)
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key, nbytes)
        return out


def _result(argument: int, output: int, total: int) -> Dict[str, int]:
    return {
        "argument": argument,
        "output": output,
        "temp": max(total - argument - output, 0),
        "total": total,
    }


def _fits(nbytes: int, device: torch.device) -> bool:
    """Whether an example of ``nbytes`` may be made on ``device`` to be
    measured: at most half of what the device has free (the host's free
    memory for the CPU)."""
    if device.type == "cuda":
        from tomobar_tpu_torch.utils.tools import free_device_bytes

        free = free_device_bytes(device)
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return nbytes <= free // 2


def estimate_memory(fn: Callable, *example_args, **example_kwargs) -> Dict[str, int]:
    """Peak memory of ``fn`` for the given example shapes, in bytes.

    The examples are tensors (``meta`` ones included) or numpy arrays; only
    their shapes and dtypes are read.  Unlike the JAX package's (which
    compiles ``fn`` and reads XLA's memory analysis without running it),
    this runs ``fn`` once, in one of two ways:

    * measured, where no example is a meta tensor and the examples take at
      most half of their device's free memory: on zeros of the examples'
      shapes and dtypes, on the example tensors' device (numpy examples:
      the CPU).  On CUDA the peak is ``max_memory_allocated`` above what
      was held before the zeros were made (a peak that does not fit raises
      the card's out-of-memory error: pass meta examples to plan it); on
      the CPU it is the peak of :class:`LiveBytes`.
    * planned on ``meta`` tensors otherwise: nothing is computed or
      allocated, and the peak is :class:`LiveBytes`'s over the storages
      that ``fn`` makes.  The kernel wrappers make their outputs and
      workspaces there, as on the card, and launch nothing, so the
      estimate is that of the card's path (z-chunks planned with the
      budgets of ``CHUNK_BYTES``, not a card's free memory).  ``fn`` must
      not read values (``float(t)``, ``t.item()``) on that path.

    Other arguments are passed as they are.  Returns keys: argument,
    output, temp, generated_code, alias, total (generated_code and alias
    are 0: PyTorch has neither).
    """
    tensors = [
        a for a in tree_flatten((example_args, example_kwargs))[0]
        if isinstance(a, (torch.Tensor, np.ndarray))
    ]
    devs = [a.device for a in tensors if isinstance(a, torch.Tensor)]
    dev = devs[0] if devs else torch.device("cpu")
    example = sum(int(np.prod(a.shape)) * a.itemsize for a in tensors)
    if any(d.type == "meta" for d in devs) or not _fits(example, dev):
        dev = torch.device("meta")

    def zeros_like(a):
        if isinstance(a, torch.Tensor):
            return torch.zeros(a.shape, dtype=a.dtype, device=dev)
        if isinstance(a, np.ndarray):
            return torch.zeros(a.shape, dtype=torch.from_numpy(a[:0]).dtype, device=dev)
        return a

    def nbytes(tree) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)
        )

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        args, kwargs = tree_map(zeros_like, (example_args, example_kwargs))
        out = fn(*args, **kwargs)
        torch.cuda.synchronize(dev)
        total = torch.cuda.max_memory_allocated(dev) - held
    else:
        with LiveBytes() as live:
            args, kwargs = tree_map(zeros_like, (example_args, example_kwargs))
            out = fn(*args, **kwargs)
        total = live.peak
    res = _result(nbytes((args, kwargs)), nbytes(out), total)
    res["generated_code"] = 0
    res["alias"] = 0
    return res


# ---------------------------------------------------------------------------
# the model of FOURIER_INV: a replay of ops/usfft.py's allocations
# ---------------------------------------------------------------------------


class _Replay:
    """Live and peak bytes of a replayed sequence of allocations and frees.
    ``new`` returns the bytes the allocation holds (rounded up to CUDA's
    block on a CUDA device), which is what ``free`` takes back."""

    def __init__(self, cuda: bool, live: int = 0):
        self.cuda = cuda
        self.live = live
        self.peak = live

    def new(self, nbytes: int) -> int:
        b = int(nbytes)
        if self.cuda:
            b = -(-b // CUDA_BLOCK) * CUDA_BLOCK
            if b > MIB:
                b += CUDA_LARGE_SLACK
        self.live += b
        self.peak = max(self.peak, self.live)
        return b

    def free(self, *held: int) -> None:
        for b in held:
            self.live -= b


def _fft(r: _Replay, size: int, kernel: bool, axis2: bool):
    """An (re, im) pair of ``size`` bytes each through one transform:
    ``fft_axis2`` on a CUDA tensor (``kernel``: its two outputs), else the
    plain route of ``fft_pairs``/``ifft_pairs``/``fft_axis2_plain``: the
    complex pack, ``torch.fft`` (on CUDA with cuFFT's work area, and along
    axis -2 PyTorch's contiguous copy of its input), the split."""
    if kernel:
        return r.new(size), r.new(size)
    x = r.new(2 * size)
    copy = r.new(2 * size) if r.cuda and axis2 else 0
    y = r.new(2 * size)
    work = r.new(CUFFT_WORK) if r.cuda else 0
    r.free(work, copy)
    re, im = r.new(size), r.new(size)
    r.free(x, y)
    return re, im


def _complex_mul(r: _Replay, size: int) -> int:
    """``a * b - c * d``: two products, then their sum."""
    t1, t2 = r.new(size), r.new(size)
    out = r.new(size)
    r.free(t1, t2)
    return out


def _sign_vector(r: _Replay, n: int) -> int:
    """``usfft._sign_vector``: int64 arange, its parity, the mask, the
    float32 signs."""
    i = r.new(8 * n)
    parity = r.new(8 * n)
    mask = r.new(n)
    r.free(parity)
    sign = r.new(F32 * n)
    r.free(mask, i)
    return sign


def _filter_stage(r: _Replay, p, bz: int) -> int:
    """``_fbp_filter_stage`` with ``apply_freq_filter_real`` on ``bz``
    slices; returns the storage that ``filtered`` views."""
    from tomobar_tpu_torch.ops.fft_real import use_fused_axis2

    ow, A = p.ow, p.nproj
    # the filter spectrum: a copy on CUDA, numpy's memory on the CPU
    w = [r.new(F32 * ow) for _ in range(2)] if r.cuda else []
    tmp = r.new(F32 * bz * A * ow)  # the edge pad
    odd = A % 2
    stacked = F32 * bz * (A + odd) * ow
    half = stacked // 2
    x2 = r.new(stacked) if odd else 0
    fused = use_fused_axis2(ow)
    # fused: the two transposed copies, both transforms along axis -2
    pair_t = [r.new(half), r.new(half)] if fused else []
    fre, fim = _fft(r, half, r.cuda and fused, fused)
    gre, gim = _complex_mul(r, half), _complex_mul(r, half)
    yre, yim = _fft(r, half, r.cuda and fused, fused)
    if fused:  # the 1/n scale, each after its transpose view
        s = r.new(half)
        r.free(yre)
        yre = s
        s = r.new(half)
        r.free(yim)
        yim = s
    y = r.new(stacked)  # the stack of the two halves
    r.free(x2, *pair_t, fre, fim, gre, gim, yre, yim, tmp, *w)
    return y


def _fft1d_stage(r: _Replay, p, pairs: int):
    """``_pack_pairs`` and ``usfft_grid`` up to the gridding.  Returns the
    packed pairs (held by ``run_block`` through the rest of the block), the
    scaled spectra (G's input) and what ``usfft_grid`` holds until G
    returns: the STEP1 transform and the scale vector."""
    size = F32 * pairs * p.nproj * p.n
    sign = _sign_vector(r, p.n)
    packed = (r.new(size), r.new(size))
    r.free(sign)
    sre, sim = _fft(r, size, False, False)
    sign = _sign_vector(r, p.n)
    scale = r.new(F32 * p.n)
    r.free(sign)
    scaled = (r.new(size), r.new(size))
    return packed, scaled, (sre, sim, scale)


def _grid_stage(r: _Replay, p, pairs: int) -> Tuple[int, int]:
    """G on a CUDA tensor (its two grids; its tables are cached), or its
    plain version: the two zeroed grids and, at the loop's peak, its index
    and weight vectors over the k = angles x n samples (l1, row, l0 and
    idx int64, w1, w0 and w float32: 44 bytes a sample) with either one
    weighted copy of the spectra or an index's two int64 temporaries."""
    grid = F32 * pairs * (2 * p.n) ** 2
    grids = (r.new(grid), r.new(grid))
    if not r.cuda:
        k = p.nproj * p.n
        two_n = r.new(F32)
        loop = r.new(44 * k + max(F32 * pairs * k, 16 * k))
        r.free(loop, two_n)
    return grids


def _ifft2_stage(r: _Replay, p, pairs: int) -> Tuple[int, int]:
    """``_ifft2_centered``: the checkerboard (int64 temporaries), the signed
    grids, the half-pixel ramps and products, two axis -2 passes around a
    transposed copy of each grid, the scaled outputs."""
    from tomobar_tpu_torch.ops.fft_kernels import MAX_C
    from tomobar_tpu_torch.ops.fft_real import use_fused_axis2

    n, two_n = p.n, 2 * p.n
    cell = F32 * two_n * two_n
    grid = pairs * cell
    arange = r.new(8 * two_n)
    isum = r.new(2 * cell)
    parity = r.new(2 * cell)
    r.free(isum)
    mask = r.new(cell // 4)
    r.free(parity)
    checker = r.new(cell)
    r.free(mask)
    signed = (r.new(grid), r.new(grid))
    ramps_1d = (r.new(F32 * two_n), r.new(F32 * two_n))
    ramp_re, ramp_im = _complex_mul(r, cell), _complex_mul(r, cell)
    shifted = (_complex_mul(r, grid), _complex_mul(r, grid))
    r.free(*signed)
    kernel = r.cuda and two_n > MAX_C and use_fused_axis2(two_n)
    fre, fim = _fft(r, grid, kernel, True)
    r.free(*shifted)
    t = r.new(grid)
    r.free(fre)
    fre = t
    t = r.new(grid)
    r.free(fim)
    fim = t
    out = _fft(r, grid, kernel, True)
    r.free(fre, fim)
    fre, fim = out
    scale = r.new(cell)
    out = (r.new(grid), r.new(grid))
    r.free(fre, fim, scale, ramp_re, ramp_im, *ramps_1d, checker, arange)
    return out


def _unpad_stage(r: _Replay, p, pairs: int, out_slices: int, size: int, phi_new: bool) -> int:
    """``_unpad_mul_phi``: phi (a float32 copy, cached after the first
    call for the geometry), the two products, their stack, the contiguous
    crop."""
    crop = F32 * pairs * size * size
    if phi_new:
        r.new(F32 * size * size)  # held by the cache after the call
    prods = (r.new(crop), r.new(crop))
    stacked = r.new(2 * crop)
    r.free(*prods)
    out = r.new(F32 * out_slices * size * size)
    r.free(stacked)
    return out


def _block(r: _Replay, p, bz: int, trailing_odd: bool, size: int, phi_new: bool) -> int:
    """``run_block`` of ``fourier_inv`` on ``bz`` slices; returns its part."""
    pairs = bz // 2
    filtered = _filter_stage(r, p, bz)
    packed, scaled, held = _fft1d_stage(r, p, pairs)
    grids = _grid_stage(r, p, pairs)
    r.free(*scaled, *held)
    out = _ifft2_stage(r, p, pairs)
    r.free(*grids)
    part = _unpad_stage(r, p, pairs, bz - int(trailing_odd), size, phi_new)
    r.free(filtered, *packed, *out)
    return part


def _circular_mask(r: _Replay, recon: int, size: int) -> int:
    """``apply_circular_mask`` on a tensor: float64 distances, the bool and
    float32 masks, the masked copy."""
    c = r.new(8 * size)
    sq = (r.new(8 * size), r.new(8 * size))
    dist = r.new(8 * size * size)
    root = r.new(8 * size * size)
    r.free(dist)
    mask = r.new(size * size)
    r.free(root, *sq)
    mask32 = r.new(F32 * size * size)
    out = r.new(recon)
    r.free(mask, mask32, c)
    return out


def _shape_and_pipeline(model, data_shape, kwargs):
    from tomobar_tpu_torch.ops import usfft as U
    from tomobar_tpu_torch.utils.tools import data_dims_swapper

    shape = tuple(int(s) for s in data_shape)
    order = kwargs.get("data_axes_labels_order")
    squeeze_2d = len(shape) == 2
    if squeeze_2d:
        if order is not None:
            shape = data_dims_swapper(shape, order, ["angles", "detX"])
        shape = (1, *shape)
    elif order is not None:
        shape = data_dims_swapper(shape, order, ["detY", "angles", "detX"])
    return shape, squeeze_2d, U._pipeline(model, shape, kwargs)


def estimate_fourier_inv_memory(
    model, data_shape: Tuple[int, ...], per_stage: bool = False, **kwargs
) -> Dict[str, int]:
    """Peak device memory of ``FOURIER_INV`` on a float32 (detY, angles,
    detX) input of the given shape (2D: (angles, detX)), in bytes, without
    running it: the use case the reference serves with its
    shape-instead-of-array dry-run mode (``methodsDIR_CuPy.py:253-258``).

    The model replays the port's pipeline (``ops/usfft.py``): the odd-size
    pads, then per z-chunk (the count ``_fourier_inv_memory_chunks`` picks
    for these kwargs and the device, so on CUDA from its free memory now)
    the padded and filtered sinogram, the packed pairs, the (pairs, A, n)
    spectra, the (pairs, 2n, 2n) grids, the ifft2 buffers and the cropped
    part, with the previous part and the output held, as the code holds
    them.  What runs where follows the device: on CUDA the kernels' outputs,
    cuFFT's work area and the caching allocator's blocks (512-byte steps,
    up to 1 MiB more above 1 MiB: an upper bound, loose where the buffers
    are a few MiB); on the CPU the plain versions' temporaries.  The
    device is the model's (``model.device``).

    Returns argument (the input), output, temp, total (the peak, input
    included) and output_shape.  With ``per_stage=True`` each stage of the
    unchunked pipeline (filter / fft1d / grid / ifft2 / unpad) is also
    replayed on its own and reported under ``"stages"``, with
    ``"stage_peak"`` and ``"stage_peak_name"``: the stage that sets the
    high-water mark the chunk heuristic
    (``ops/usfft.py:fourier_inv_pair_bytes``) plans against.
    """
    from tomobar_tpu_torch.ops import usfft as U

    device = torch.device(model.device)
    cuda = device.type == "cuda"
    shape, squeeze_2d, p = _shape_and_pipeline(model, data_shape, kwargs)
    nz0, A, d0 = shape
    size = model.recon_size
    out_slices = p.nz - int(p.odd_vert)
    output = F32 * out_slices * size * size
    argument = F32 * nz0 * A * d0

    r = _Replay(cuda, argument)
    padded = []
    if p.odd_vert:
        padded.append(r.new(F32 * p.nz * A * d0))
    if p.odd_horiz:
        padded.append(r.new(F32 * p.nz * A * p.data_n))
        if p.odd_vert:
            r.free(padded.pop(0))
    n_chunks = U._fourier_inv_memory_chunks(p.nz, p.n, kwargs, device)
    if n_chunks <= 1:
        recon = _block(r, p, p.nz, p.odd_vert, size, True)
        last = 0
    else:
        pairs = p.nz // 2
        per = -(-pairs // n_chunks)
        recon, last = 0, 0
        for q0 in range(0, pairs, per):
            z1 = min(2 * (q0 + per), p.nz)
            part = _block(r, p, z1 - 2 * q0, p.odd_vert and z1 == p.nz, size, q0 == 0)
            r.free(last)
            if not recon:
                recon = r.new(output)
            last = part
    if kwargs.get("recon_mask_radius") is not None:
        masked = _circular_mask(r, recon, size)
        r.free(recon)
        recon = masked
    r.free(last, *padded)

    res = _result(argument, output, r.peak)
    res["output_shape"] = (size, size) if squeeze_2d else (out_slices, size, size)
    if per_stage:
        res["stages"] = _stage_memory(p, cuda, size)
        res["stage_peak"] = max(s["total"] for s in res["stages"].values())
        res["stage_peak_name"] = max(res["stages"], key=lambda k: res["stages"][k]["total"])
    return res


def _fft1d_alone(r: _Replay, p, pairs: int) -> int:
    packed, scaled, held = _fft1d_stage(r, p, pairs)
    r.free(*packed, *held)
    return sum(scaled)


def _stage_memory(p, cuda: bool, size: int) -> Dict[str, Dict[str, int]]:
    """Each stage of the unchunked pipeline replayed alone, from its inputs
    (``argument``) to its outputs, as the JAX package compiles each alone."""
    pairs = p.nz // 2
    spectra = 2 * F32 * pairs * p.nproj * p.n
    grids = 2 * F32 * pairs * (2 * p.n) ** 2
    stacked = F32 * p.nz * (p.nproj + p.nproj % 2) * p.ow

    def stage(argument, run):
        r = _Replay(cuda, argument)
        output = run(r)
        return _result(argument, output, r.peak)

    return {
        "filter": stage(F32 * p.nz * p.nproj * p.data_n, lambda r: _filter_stage(r, p, p.nz)),
        "fft1d": stage(stacked, lambda r: _fft1d_alone(r, p, pairs)),
        "grid": stage(spectra, lambda r: sum(_grid_stage(r, p, pairs))),
        "ifft2": stage(grids, lambda r: sum(_ifft2_stage(r, p, pairs))),
        "unpad": stage(grids, lambda r: _unpad_stage(
            r, p, pairs, p.nz - int(p.odd_vert), size, True)),
    }


class DeviceMemStack:
    """API-compatible shim of the reference's simulated allocator
    (``memory_estimator_helpers.py:4-44``) for user code that used it as a
    context manager; tracks 512-byte-rounded malloc/free high-water marks."""

    ALLOCATION_UNIT_SIZE = 512
    _instance = None
    _stack_count = 0

    def __enter__(self):
        if DeviceMemStack._stack_count == 0:
            DeviceMemStack._instance = self
        DeviceMemStack._stack_count += 1
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        DeviceMemStack._stack_count -= 1
        if DeviceMemStack._stack_count == 0:
            DeviceMemStack._instance = None

    @classmethod
    def instance(cls):
        return cls._instance

    def __init__(self) -> None:
        self.allocations = []
        self.current = 0
        self.highwater = 0

    def _round_up(self, size: int) -> int:
        unit = self.ALLOCATION_UNIT_SIZE
        return (size + unit - 1) // unit * unit

    def malloc(self, byte_count: int) -> None:
        self.allocations.append(byte_count)
        self.current += self._round_up(byte_count)
        self.highwater = max(self.current, self.highwater)

    def free(self, byte_count: int) -> None:
        assert byte_count in self.allocations
        self.allocations.remove(byte_count)
        self.current -= self._round_up(byte_count)
        assert self.current >= 0
