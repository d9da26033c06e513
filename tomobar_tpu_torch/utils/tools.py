"""Pre/post-processing support tools on numpy arrays and PyTorch tensors.

Counterpart of ``tomobar_tpu/utils/tools.py``: flat/dark normalisation,
auto-cropping, axis-label ordering, circular mask, recon crop, detector
edge padding and ``check_kwargs``.  A numpy array in gives a numpy array
out (the host path: numpy and the native fused pass of
:mod:`tomobar_tpu_torch.native`); a tensor in gives a tensor out, computed
on that tensor's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tomobar_tpu_torch.trace import span

__all__ = [
    "normaliser",
    "autocropper",
    "apply_circular_mask",
    "perform_recon_crop",
    "apply_horiz_detector_padding",
    "check_kwargs",
    "swap_data_axes_to_accepted",
    "data_dims_swapper",
    "free_device_bytes",
]


def free_device_bytes(device) -> int:
    """Bytes a new tensor can still take on a CUDA device: the free memory
    CUDA reports plus what PyTorch's allocator holds but has handed to no
    tensor."""
    free = torch.cuda.mem_get_info(device)[0]
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def _get_swap_tuple(data_axis_labels, labels_order):
    for in_l1, str_1 in enumerate(labels_order):
        for in_l2, str_2 in enumerate(data_axis_labels):
            if str_1 == str_2 and in_l1 != in_l2:
                return (in_l1, in_l2)
    return None


def swap_data_axes_to_accepted(
    data_axes_labels: Sequence[str], required_labels_order: Sequence[str]
) -> List[Optional[Tuple[int, int]]]:
    """Compute the (up to two) axis swaps needed to reach the required order."""
    if len(data_axes_labels) != len(required_labels_order):
        raise ValueError(
            "The mismatch in length between provided labels and data dimensions."
        )
    for lbl in data_axes_labels:
        if lbl not in required_labels_order:
            raise ValueError(
                f'Axis title "{lbl}" is not valid, please use one of these: '
                '"angles", "detX", or "detY"'
            )
    labels = list(data_axes_labels)
    swap1 = _get_swap_tuple(labels, required_labels_order)
    swap2 = None
    if swap1 is not None:
        labels[swap1[0]], labels[swap1[1]] = labels[swap1[1]], labels[swap1[0]]
        swap2 = _get_swap_tuple(labels, required_labels_order)
    return [swap1, swap2]


def data_dims_swapper(data, data_axes_labels_order, required_labels_order):
    """Swap array axes (or a shape tuple) into the required label order."""
    swaps = swap_data_axes_to_accepted(data_axes_labels_order, required_labels_order)
    for swap in swaps:
        if swap is None:
            continue
        if isinstance(data, tuple):
            items = list(data)
            items[swap[0]], items[swap[1]] = items[swap[1]], items[swap[0]]
            data = tuple(items)
        elif isinstance(data, torch.Tensor):
            data = data.transpose(swap[0], swap[1])
        else:
            data = np.swapaxes(data, swap[0], swap[1])
    return data


# ---------------------------------------------------------------------------
# normalisation (reference: suppTools.py:187-264)
# ---------------------------------------------------------------------------


_FIELD_REDUCERS = {"mean": np.mean, "median": np.median}


def _median_torch(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.median`` along ``axis``: the mean of the two middle order
    statistics for an even count (``torch.median`` takes the lower one, and
    ``torch.quantile`` refuses inputs above 2**24 elements)."""
    n = x.shape[axis]
    s = torch.sort(x, dim=axis).values
    lo, hi = s.select(axis, (n - 1) // 2), s.select(axis, n // 2)
    return (lo + hi) / 2


def _normalise_torch(data, flats, darks, log: bool, method, axis: int):
    """The mean/median normaliser on ``data``'s device: the same reductions
    and guards as the numpy path, in float32."""
    dev = data.device
    data = data.to(torch.float32)
    flats, darks = (torch.as_tensor(f, device=dev).to(torch.float32) for f in (flats, darks))
    if method == "median":
        flat_field, dark_field = (_median_torch(f, axis) for f in (flats, darks))
    else:
        flat_field, dark_field = (f.mean(dim=axis) for f in (flats, darks))
    if axis == 1:
        flat_field = flat_field[:, None, :]
        dark_field = dark_field[:, None, :]
    denom = flat_field - dark_field
    denom.masked_fill_(denom <= 0.0, 1.0)
    ratio = data - dark_field
    ratio.masked_fill_(ratio < 0.0, 1.0)
    ratio.div_(denom)
    if log:
        positive = ratio > 0.0
        ratio.masked_fill_(~positive, 1.0).log_().neg_()
        ratio.masked_fill_(~positive | (ratio < 0.0), 0.0)
    return ratio


def _normalise_dynamic(data, flats, darks, **kwargs) -> np.ndarray:
    """The "dynamic" eigen-flat-field ratio (before the log), on the host."""
    from tomobar_tpu_torch.utils.dffc import (
        dynamic_flatfield_correction,
        wavelet_denoise,
    )

    # dyn_denoiser: None/'gaussian' (default blur), 'wavelet' (Haar
    # soft-threshold, edge-preserving — the built-in stand-in for the
    # reference's optional BM3D), or any callable img -> img
    denoiser = kwargs.get("dyn_denoiser")
    if denoiser == "wavelet":
        denoiser = wavelet_denoise
    elif denoiser in (None, "gaussian"):
        denoiser = None
    elif not callable(denoiser):
        raise NameError(
            "dyn_denoiser should be 'gaussian', 'wavelet' or a callable"
        )
    host = (
        a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        for a in (data, flats, darks)
    )
    return dynamic_flatfield_correction(
        *host,
        downsample=kwargs.get("dyn_downsample", 2),
        n_pa_repetitions=kwargs.get("dyn_iterations", 10),
        denoise_fn=denoiser,
    )[0]


def normaliser(
    data,
    flats,
    darks,
    log: bool = True,
    method: str = "mean",
    axis: int = 0,
    **kwargs,
):
    """Flat/dark-field normalisation with optional -log transform.

    Computes ``(data - dark) / (flat - dark)`` after reducing the flat/dark
    stacks along ``axis`` ("mean" or "median"); the "dynamic" PCA-based
    eigen-flat-field method lives in :mod:`tomobar_tpu_torch.utils.dffc`
    and runs on the host.  Guard semantics match the reference
    (``suppTools.py:187-264``): non-positive denominators and negative
    numerators are both replaced by 1.0 before the division, and the -log
    transform only touches strictly positive ratios (negatives are zeroed).

    A numpy ``data`` gives numpy out: the fields are reduced with numpy and
    the native fused pass runs when ``axis == 0`` and the shapes allow it,
    the numpy expression otherwise.  A tensor ``data`` gives a float32
    tensor on its device, computed there (``flats``/``darks`` may be numpy
    arrays or tensors; they are moved to that device).  Raises ``NameError``
    for non-3D data and for an unknown method.
    """
    if np.ndim(data) != 3:
        raise NameError("Normalisation is implemented for 3d data input")
    is_tensor = isinstance(data, torch.Tensor)
    if darks is None:
        darks = (
            torch.zeros(tuple(flats.shape), dtype=torch.float32, device=data.device)
            if is_tensor else np.zeros(np.shape(flats), dtype="float32")
        )
    if method is None:
        method = "mean"

    if method == "dynamic":
        ratio = _normalise_dynamic(data, flats, darks, **kwargs)
    else:
        reduce = _FIELD_REDUCERS.get(method)
        if reduce is None:
            raise NameError(
                "Please choose the normalisation method out of: mean, "
                "median or dynamic"
            )
        if is_tensor:
            with span("tomobar::prep.normalise", frames=data.shape[axis],
                      rows=data.shape[1 - axis], det_x=data.shape[2],
                      flats=flats.shape[axis], darks=darks.shape[axis]):
                return _normalise_torch(data, flats, darks, log, method, axis)
        flat_field = reduce(flats, axis)
        dark_field = reduce(darks, axis)

        if axis == 0 and np.shape(data)[-np.ndim(flat_field):] == np.shape(
            flat_field
        ):
            # fused multicore C++ path (one pass, no temporaries); falls
            # back to numpy when the native library is unavailable
            from tomobar_tpu_torch import native

            fused = native.normalise_native(data, flat_field, dark_field, log)
            if fused is not None:
                return fused

        if axis == 1:
            flat_field = flat_field[:, None, :]
            dark_field = dark_field[:, None, :]
        denom = flat_field - dark_field
        denom[denom <= 0.0] = 1.0
        numer = data - dark_field
        numer[numer < 0.0] = 1.0
        ratio = numer / denom

    if log:
        positive = ratio > 0.0
        ratio[positive] = -np.log(ratio[positive])
        ratio[ratio < 0.0] = 0.0
    if is_tensor:
        return torch.as_tensor(ratio, dtype=torch.float32, device=data.device)
    return ratio


# ---------------------------------------------------------------------------
# auto-cropping (reference: suppTools.py:267-361)
# ---------------------------------------------------------------------------


def _first_last_above(profiles, thr):
    """Per row of ``profiles`` (n, m), numpy or a tensor: first and last
    index where the profile exceeds its threshold; (0, m) when nothing
    does."""
    above = profiles > thr[:, None]
    m = profiles.shape[1]
    if isinstance(above, torch.Tensor):
        hit = above.to(torch.uint8)
        any_above = above.any(dim=1)
        first = torch.where(any_above, hit.argmax(dim=1), 0)
        last = torch.where(any_above, m - hit.flip(1).argmax(dim=1), m)
        return first, last
    any_above = above.any(axis=1)
    first = np.where(any_above, above.argmax(axis=1), 0)
    last = np.where(any_above, m - above[:, ::-1].argmax(axis=1), m)
    return first, last


def autocropper(data, addbox: int, backgr_pix1: int):
    """Crop 3D projection data [Projections, detY, detX] to the union
    bounding box of the imaged object.

    Same contract as the reference (``suppTools.py:267-361``): the
    background level is estimated from two object-free strips of width
    ``backgr_pix1`` at the left/right detector edges around the vertical
    midline, and the crop box is padded by ``addbox`` pixels.  The bound
    search itself is the JAX package's vectorised design: per projection
    the row/column mean profiles are thresholded at the combined strip mean
    and the first/last crossings taken (the reference instead walks outward
    from the profile peak, which can cut off secondary objects).  A tensor
    in is cropped on its device (a view, as for numpy)."""
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    n_proj, det_v, det_h = data.shape
    strip_v = int(2.5 * backgr_pix1)
    mid = det_v // 2
    lo, hi = max(mid - strip_v, 0), min(mid + strip_v, det_v)

    def mean(a, axis):
        return a.mean(dim=axis) if isinstance(a, torch.Tensor) else a.mean(axis=axis)

    bg = (
        mean(data[:, lo:hi, :backgr_pix1], (1, 2))
        + mean(data[:, lo:hi, det_h - 1 - backgr_pix1 : det_h - 1], (1, 2))
    )
    top, bottom = _first_last_above(mean(data, 2), bg)  # rows (n_proj, det_v)
    left, right = _first_last_above(mean(data, 1), bg)  # columns (n_proj, det_h)

    up = max(int(top.min()) - addbox, 0)
    down = min(int(bottom.max()) + addbox, det_v)
    lft = max(int(left.min()) - addbox, 0)
    rgt = min(int(right.max()) + addbox, det_h)
    return data[:, up:down, lft:rgt]


def apply_circular_mask(data, recon_mask_radius: float, cupyrun: bool = False):
    """Zero values outside a circular mask.  Radius semantics mirror the
    reference (``suppTools.py:387-394``): values <= 1 shrink the mask,
    values > 1 grow it (2.0 is a de-facto no-op).  A numpy array in gives a
    numpy array out; ``cupyrun`` is accepted as in the JAX package and, as
    there, not read: the array's own family decides."""
    del cupyrun
    axis = 2 if data.ndim == 3 else 1
    recon_size = data.shape[axis]
    half = recon_size // 2
    if recon_mask_radius <= 1.0:
        limit = half - abs(half - half / recon_mask_radius)
    else:
        limit = half + abs(half - half / recon_mask_radius)
    if isinstance(data, torch.Tensor):
        # the mask is made where the data lies, with the same float64
        # arithmetic (exact integers under a correctly rounded root): made
        # on the host it cost a 2560^2 reconstruction ~70 ms per call
        c = torch.arange(recon_size, dtype=torch.float64, device=data.device) - half
        mask = torch.sqrt(c[None, :] ** 2 + c[:, None] ** 2) <= limit
        return data * mask.to(data.dtype)
    Y, X = np.ogrid[:recon_size, :recon_size]
    mask = np.sqrt((X - half) ** 2 + (Y - half) ** 2) <= limit
    return data * np.asarray(mask, dtype=data.dtype)


def perform_recon_crop(data, cropped_size: int):
    """Centre-crop a (padded) reconstruction back to ``cropped_size``."""
    axis = 2 if data.ndim == 3 else 0
    original = data.shape[axis]
    start = (original - cropped_size) // 2
    stop = cropped_size + start
    if data.ndim == 3:
        return data[:, start:stop, start:stop]
    return data[start:stop, start:stop]


def apply_horiz_detector_padding(data, detector_width_pad: int, cupyrun: bool = False):
    """Edge-pad detX symmetrically; 3D data is [detY, angles, detX], 2D is
    [angles, detX] (reference ``suppTools.py:425-459``).  Numpy in, numpy
    out; ``cupyrun`` is accepted and not read, as in the JAX package."""
    del cupyrun
    if detector_width_pad <= 0:
        return data
    if not isinstance(data, torch.Tensor):
        pads = ((0, 0),) * (data.ndim - 1) + ((detector_width_pad, detector_width_pad),)
        return np.pad(data, pads, mode="edge")
    pad = (detector_width_pad, detector_width_pad)
    if data.dim() == 2:
        return torch.nn.functional.pad(data[None], pad, mode="replicate")[0]
    return torch.nn.functional.pad(data, pad, mode="replicate")


def check_kwargs(reconstruction, **kwargs):
    """Post-hoc application of optional kwargs (mask); ``cupyrun`` among
    them is passed on as the JAX package passes it."""
    for key, value in kwargs.items():
        if key == "recon_mask_radius" and value is not None:
            reconstruction = apply_circular_mask(
                reconstruction, value, kwargs.get("cupyrun", False)
            )
    return reconstruction
