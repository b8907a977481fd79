"""Segmentation losses (counterpart of `coastline/train/losses.py:20-45`).

Logits are NCHW with the class axis at dim 1, as the port's models return
them; the JAX package keeps classes last. Both losses work in float32.
"""

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


def cross_entropy_loss(logits, targets):
    """Mean softmax cross-entropy of (N, K, H, W) logits against (N, H, W)
    integer class maps."""
    return _cross_entropy(logits, targets).mean()


def per_image_bce(logits, targets):
    """(N, 1, H, W) or (N, H, W) logits, (N, H, W) targets -> (N,) mean BCE."""
    if logits.ndim == 4 and targets.ndim == 3:
        targets = targets[:, None]
    return _bce(logits, targets).flatten(1).mean(1)


def per_image_cross_entropy(logits, targets):
    """(N, K, H, W) logits, (N, H, W) classes -> (N,) mean cross-entropy."""
    return _cross_entropy(logits, targets).flatten(1).mean(1)
