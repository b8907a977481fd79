"""Segmentation losses (counterpart of `coastline/train/losses.py:20-45`).

Logits are NCHW with the class axis at dim 1, as the port's models return
them; the JAX package keeps classes last. The losses work in float32. The
per-image losses take `count`, the image's pixel count, when a rank holds
some of its rows (the mesh's space axis): each rank's sum over its pixels
divided by the whole image's count, the ranks' terms adding up to the
per-image mean.
`LOSS_REGISTRY` names them beside the HSV-guided BCE (`train/hsv.py`).
"""

from typing import Callable, Dict

import torch


def _bce(logits, targets):
    """Elementwise BCE from logits: max(l, 0) - l * t + log1p(exp(-|l|))."""
    l, t = logits.float(), targets.float()
    return l.clamp_min(0.0) - l * t + torch.log1p(torch.exp(-l.abs()))


def _cross_entropy(logits, targets):
    """Per-pixel softmax cross-entropy over dim 1: logsumexp minus the
    target class's logit. The logit is picked by a product with the one-hot
    targets, which equals the gather for finite logits (x * 1 + 0), because
    a gather's backward is a scatter-add, which has no deterministic CUDA
    version: the one-hot product keeps a train step bit-reproducible under
    `torch.use_deterministic_algorithms(True)`."""
    l = logits.float()
    classes = torch.arange(l.shape[1], device=l.device)[:, None, None]
    onehot = (targets.long()[:, None] == classes).to(l.dtype)
    return torch.logsumexp(l, dim=1) - (l * onehot).sum(1)


def bce_loss(logits, targets):
    """Mean binary cross-entropy from logits (the reference's BCELoss on
    sigmoid outputs); `targets` broadcast against `logits`."""
    return _bce(logits, targets).mean()


def bce_on_probs(probs, targets, eps: float = 1e-12):
    """Mean BCE directly on probabilities, each log clamped at -100 as
    torch's BCELoss clamps it (`coastline/train/losses.py:31-37`)."""
    p, t = probs.float(), targets.float()
    logp = torch.log(p + eps).clamp_min(-100.0)
    log1mp = torch.log1p(-p + eps).clamp_min(-100.0)
    return -(t * logp + (1.0 - t) * log1mp).mean()


def cross_entropy_loss(logits, targets):
    """Mean softmax cross-entropy of (N, K, H, W) logits against (N, H, W)
    integer class maps."""
    return _cross_entropy(logits, targets).mean()


def _per_image_mean(values, count=None):
    """(N, ...) -> (N,): the mean over each image's values, or their sum
    over `count`."""
    values = values.flatten(1)
    return values.mean(1) if count is None else values.sum(1) / count


def per_image_bce(logits, targets, count=None):
    """(N, 1, H, W) or (N, H, W) logits, (N, H, W) targets -> (N,) mean BCE
    (the sum over `count` pixels with `count`)."""
    if logits.ndim == 4 and targets.ndim == 3:
        targets = targets[:, None]
    return _per_image_mean(_bce(logits, targets), count)


def per_image_cross_entropy(logits, targets, count=None):
    """(N, K, H, W) logits, (N, H, W) classes -> (N,) mean cross-entropy
    (the sum over `count` pixels with `count`)."""
    return _per_image_mean(_cross_entropy(logits, targets), count)


def _hsv_guided_bce(*args, **kwargs):
    from coastline_torch.train.hsv import hsv_guided_bce  # hsv imports this module

    return hsv_guided_bce(*args, **kwargs)


LOSS_REGISTRY: Dict[str, Callable] = {  # `coastline/train/losses.py:56-61`
    "bce": bce_loss,
    "bce_probs": bce_on_probs,
    "ce": cross_entropy_loss,
    "hsv_bce": _hsv_guided_bce,
}
