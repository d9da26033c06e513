"""Pre/post-processing helpers of the iterative path, on PyTorch tensors.

Counterpart of the parts of ``tomobar_tpu/utils/tools.py`` that
``RecToolsIRTPU`` calls: axis-label ordering, circular mask, recon crop,
detector edge padding and ``check_kwargs``.  The axis helpers also take
numpy arrays, as user data arrives as numpy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
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


def apply_circular_mask(data: torch.Tensor, recon_mask_radius: float) -> torch.Tensor:
    """Zero values outside a circular mask.  Radius semantics mirror the
    reference (``suppTools.py:387-394``): values <= 1 shrink the mask,
    values > 1 grow it (2.0 is a de-facto no-op)."""
    axis = 2 if data.dim() == 3 else 1
    recon_size = data.shape[axis]
    half = recon_size // 2
    Y, X = np.ogrid[:recon_size, :recon_size]
    dist = np.sqrt((X - half) ** 2 + (Y - half) ** 2)
    if recon_mask_radius <= 1.0:
        mask = dist <= half - abs(half - half / recon_mask_radius)
    else:
        mask = dist <= half + abs(half - half / recon_mask_radius)
    return data * torch.as_tensor(mask, dtype=data.dtype, device=data.device)


def perform_recon_crop(data: torch.Tensor, cropped_size: int) -> torch.Tensor:
    """Centre-crop a (padded) reconstruction back to ``cropped_size``."""
    axis = 2 if data.dim() == 3 else 0
    original = data.shape[axis]
    start = (original - cropped_size) // 2
    stop = cropped_size + start
    if data.dim() == 3:
        return data[:, start:stop, start:stop]
    return data[start:stop, start:stop]


def apply_horiz_detector_padding(data: torch.Tensor, detector_width_pad: int) -> torch.Tensor:
    """Edge-pad detX symmetrically; 3D data is [detY, angles, detX], 2D is
    [angles, detX] (reference ``suppTools.py:425-459``)."""
    if detector_width_pad <= 0:
        return data
    pad = (detector_width_pad, detector_width_pad)
    if data.dim() == 2:
        return torch.nn.functional.pad(data[None], pad, mode="replicate")[0]
    return torch.nn.functional.pad(data, pad, mode="replicate")


def check_kwargs(reconstruction: torch.Tensor, **kwargs) -> torch.Tensor:
    """Post-hoc application of optional kwargs (mask)."""
    for key, value in kwargs.items():
        if key == "recon_mask_radius" and value is not None:
            reconstruction = apply_circular_mask(reconstruction, value)
    return reconstruction
