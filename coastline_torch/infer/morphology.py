"""Mask morphology on the device (counterpart of `coastline/infer/morphology.py`).

`dilate` is cv2.dilate with an elliptical structuring element on binarized
masks; on a CUDA tensor it always runs the disk-dilation kernel
(`kernels/morphology.py`), whatever the mask's size. `coastline_band` is
the dilated-minus-original band the reference extracts shorelines from.

Both take a numpy array or a tensor and return a tensor on `device`
(default "cuda"; without a card they raise unless `device="cpu"`).
"""

import numpy as np
import torch

from coastline_torch.kernels.morphology import dilate_disk
from coastline_torch.utils.device import resolve_device


def elliptical_kernel(size: int) -> np.ndarray:
    """(size, size) uint8 ellipse SE, equal to
    cv2.getStructuringElement(MORPH_ELLIPSE, (size, size)): cv2's fill rule,
    per row dx = round(r * sqrt(1 - dy^2 / r^2)) with r = size // 2."""
    r = size // 2
    ker = np.zeros((size, size), np.uint8)
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(size):
        dy = i - r
        if abs(dy) > r:
            continue
        dx = int(round(r * np.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
        ker[i, max(0, r - dx):min(size, r + dx + 1)] = 1
    return ker


def _to_device(mask, device) -> torch.Tensor:
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.ascontiguousarray(mask))
    return mask.to(resolve_device(device))


def dilate(mask, size: int = 5, device="cuda") -> torch.Tensor:
    """cv2.dilate(mask, ellipse(size)) for binary (H, W) or (N, H, W) masks.

    The input is binarized (> 0) first, as in the JAX package; the result
    has the input's dtype."""
    x = _to_device(mask, device)
    binary = (x > 0).to(torch.uint8).contiguous()
    return dilate_disk(binary, elliptical_kernel(size)).to(x.dtype)


def coastline_band(water_mask, dilation_size: int = 5, device="cuda") -> torch.Tensor:
    """The pixels the dilation added. 0/255 masks are binarized first, so
    the subtraction stays in the 0/1 domain (no uint8 wrap-around)."""
    water = _to_device(water_mask, device)
    binary = (water > 0).to(water.dtype)
    return dilate(binary, dilation_size, device=water.device) - binary
