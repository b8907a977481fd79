"""The evaluation epoch (counterpart of `coastline/train/loop.py:44-65,83-89,
112-135,231-300`).

`make_eval_epoch` returns the validation pass of the comparison protocol:
fixed-shape, gather-indexed batches of a dataset held on the device as
uint8, ImageNet normalization, the eval forward, a validity-masked loss and
per-image metrics, aggregated as a validity-masked mean and population std.
The JAX package passes `params` and `batch_stats` to a jitted scan; here the
model carries its own weights and the batches run eagerly, with one
device-to-host copy at the end.

Training (`make_train_epoch`, the Adam step, train-mode BN and dropout, the
`hsv_bce` loss) is the next slice.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from coastline_torch.data.pipeline import normalize_u8 as normalize_images  # the JAX loop's name
from coastline_torch.train.losses import per_image_bce, per_image_cross_entropy
from coastline_torch.train.metrics import per_image_metrics
from coastline_torch.utils.device import resolve_device


@dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX package's `TrainConfig` that the evaluation
    epoch reads, with its defaults (the comparison protocol); the training
    fields come with the training slice. The batch size is the width of the
    `idx` plan handed to the epoch (`batch_indices`)."""

    loss: str = "bce"  # bce (sigmoid models) | ce (2-class UNet) | hsv_bce
    threshold: float = 0.5


def batch_indices(n: int, batch_size: int, *, shuffle: bool, rng: np.random.Generator):
    """Fixed-shape (num_batches, B) index and validity arrays covering all n
    samples; the last batch is padded wrap-around with the first samples of
    the order, marked invalid (the JAX package's rule, `loop.py:278-299`)."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    num_batches = (n + batch_size - 1) // batch_size
    total = num_batches * batch_size
    padded = order[np.arange(total) % n].astype(np.int32)
    valid = np.zeros(total, dtype=np.float32)
    valid[:n] = 1.0
    return padded.reshape(num_batches, batch_size), valid.reshape(num_batches, batch_size)


def _check_loss(config: TrainConfig):
    if config.loss == "hsv_bce":
        raise NotImplementedError("the hsv_bce loss is ported with training (the next slice)")
    if config.loss not in ("bce", "ce"):
        raise ValueError(f"unknown loss {config.loss!r}")


def _compute_loss(config: TrainConfig, logits, masks, valid):
    """Masked mean over the valid samples of per-image mean losses; logits
    NCHW (one channel for bce, two classes for ce), masks (N, H, W)."""
    w = valid.float()
    per_img = (per_image_cross_entropy(logits, masks) if config.loss == "ce"
               else per_image_bce(logits, masks))
    return (per_img * w).sum() / w.sum().clamp_min(1.0)


def _probs(config: TrainConfig, logits):
    if config.loss == "ce":
        return torch.softmax(logits, dim=1)[:, 1]
    return torch.sigmoid(logits[:, 0] if logits.ndim == 4 else logits)


def make_eval_epoch(model, config: TrainConfig, device="cuda"):
    """The model on `device`, in eval mode, behind
    `eval_epoch(images_u8, masks, idx, valid) -> (loss, {'mean_*', 'std_*'})`.

    images_u8 (N, H, W, 3) uint8 and masks (N, H, W), numpy or tensors, are
    moved to the device once; idx and valid are `batch_indices`' arrays. The
    loss is the mean over batches of each batch's masked mean; every metric
    is aggregated over the valid samples only, with the population std.
    Raises without a card unless `device='cpu'`."""
    _check_loss(config)
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def eval_epoch(images_u8, masks, idx, valid) -> Tuple[float, Dict[str, float]]:
        images = torch.as_tensor(images_u8, device=dev)
        masks = torch.as_tensor(masks, device=dev)
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=dev)
        valid = torch.as_tensor(np.asarray(valid), dtype=torch.float32, device=dev)
        losses, metrics = [], []
        for bidx, bvalid in zip(idx, valid):
            x = normalize_images(images.index_select(0, bidx)).permute(0, 3, 1, 2)
            y = masks.index_select(0, bidx)
            logits = model(x, return_logits=True)
            losses.append(_compute_loss(config, logits, y, bvalid))
            metrics.append(per_image_metrics(_probs(config, logits), y.float(), config.threshold))
        v = valid.reshape(-1)
        n = v.sum().clamp_min(1.0)
        agg = {}
        for key in metrics[0]:
            vals = torch.cat([m[key] for m in metrics])
            mean = (vals * v).sum() / n
            agg[f"mean_{key}"] = mean
            agg[f"std_{key}"] = torch.sqrt((((vals - mean) ** 2) * v).sum() / n)
        out = torch.stack([torch.stack(losses).mean(), *agg.values()]).cpu().tolist()
        return out[0], dict(zip(agg, out[1:]))

    return eval_epoch
