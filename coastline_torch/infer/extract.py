"""Coastline extraction serving path (counterpart of `coastline/infer/extract.py`).

`CoastlineExtractor` holds the production 2-class UNet on one device and
turns batches of (N, H, W, 3) uint8 images into (N, H, W) uint8 water masks
(normalize -> forward -> argmax, with the optional D4 test-time-augmentation
ensemble); `serve()` puts the micro-batching server in front of it. The
coastline band and contours come from `infer/morphology.py` and
`infer/contours.py`.

Not ported yet: the Orbax `checkpoint_dir` branch, int8, scenes, file-path
extraction (PIL I/O, `predict_mask`, `extract_batch`) and the figure and
GeoJSON writers.
"""

from typing import Mapping, Optional

import numpy as np
import torch

from coastline_torch.data.pipeline import normalize_u8
from coastline_torch.infer.server import BatchedPredictor
from coastline_torch.models.unet import UNet
from coastline_torch.utils.device import resolve_device
from coastline_torch.utils.torch_import import unet_state_dict


def _make_predict_fn(model, tta: bool = False):
    """(N, H, W, 3) uint8 tensor on the model's device -> (N, H, W) uint8
    masks. The NHWC input is normalized in float32 and handed to the model
    as an NCHW view, i.e. already channels_last.

    With `tta=True` the class probabilities (float32) are averaged over the
    identity, H-flip, W-flip and 180-degree terms and, for square inputs,
    the same four on the transposed image, each inverted before averaging,
    in the JAX package's order."""

    @torch.inference_mode()
    def predict(x_u8):
        x = normalize_u8(x_u8).permute(0, 3, 1, 2)
        if not tta:
            return model(x).argmax(dim=1).to(torch.uint8)

        def probs_of(xi):
            return torch.softmax(model(xi).float(), dim=1)

        acc = probs_of(x)
        for dims in ((2,), (3,), (2, 3)):
            acc = acc + torch.flip(probs_of(torch.flip(x, dims)), dims)
        if x.shape[2] == x.shape[3]:
            xt = x.transpose(2, 3)
            acc = acc + probs_of(xt).transpose(2, 3)
            for dims in ((2,), (3,), (2, 3)):
                acc = acc + torch.flip(probs_of(torch.flip(xt, dims)), dims).transpose(2, 3)
        return acc.argmax(dim=1).to(torch.uint8)

    return predict


class CoastlineExtractor:
    """The 2-class UNet behind the serving entry points.

    Weights come from `variables` (a JAX-package UNet tree as numpy, through
    the weight bridge) or `torch_checkpoint` (a reference `.pth`, loaded
    with strict=True); with neither, the UNet keeps its seeded random init.
    `dtype` is the compute dtype (torch.float32 or torch.bfloat16)."""

    def __init__(self, variables: Optional[Mapping] = None,
                 torch_checkpoint: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, image_size: int = 512,
                 tta: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.tta = tta
        model = UNet(n_classes=2, dtype=dtype)
        if variables is not None:
            model.load_state_dict(unet_state_dict(variables), strict=True)
        elif torch_checkpoint is not None:
            sd = torch.load(torch_checkpoint, map_location="cpu", weights_only=True)
            model.load_state_dict(sd, strict=True)
        else:
            print("WARNING: no checkpoint provided — using random weights")
        self.model = model.to(self.device).eval()
        self._predict_fn = _make_predict_fn(self.model, tta=tta)

    def predict_masks_batch_async(self, images_u8) -> torch.Tensor:
        """(N, H, W, 3) uint8 (numpy or tensor) -> (N, H, W) uint8 masks as a
        tensor on the device; on CUDA the work is queued, not waited for."""
        x = images_u8
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.ndim != 4 or x.shape[-1] != 3 or x.dtype != torch.uint8:
            raise ValueError(f"expected uint8 (N, H, W, 3), got {x.dtype} {tuple(x.shape)}")
        return self._predict_fn(x.to(self.device))

    def predict_masks_batch(self, images_u8) -> np.ndarray:
        """Batched (N, H, W, 3) uint8 -> (N, H, W) uint8 numpy masks."""
        return self.predict_masks_batch_async(images_u8).cpu().numpy()

    def serve(self, batch_size: int = 8, max_delay_ms: float = 5.0) -> BatchedPredictor:
        """Micro-batching server over `predict_masks_batch`: concurrent
        callers submit single images, the model sees fixed-shape batches.
        Use as a context manager."""
        return BatchedPredictor(self.predict_masks_batch, batch_size=batch_size,
                                image_size=self.image_size, max_delay_ms=max_delay_ms)
