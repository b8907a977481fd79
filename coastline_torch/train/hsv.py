"""HSV-guided loss term (counterpart of `coastline/train/hsv.py`).

    hsv_guided_bce = BCE + weight * consistency(pred, hsv_water_prior)

The prior scores open water from HSV cues (dark, cyan-blue hue); the
consistency term is |probs - prior| weighted by the prior's confidence
|2 * prior - 1|, so where the prior is unsure it adds no gradient, and with
weight 0 the loss is the plain BCE. RGB inputs are in [0, 1], channels
last; everything is float32 torch ops, differentiable in the probabilities.
"""

import torch

from coastline_torch.train.losses import bce_loss


def rgb_to_hsv(rgb):
    """(..., 3) RGB in [0, 1] -> (..., 3) HSV in [0, 1] (the colorsys and
    matplotlib convention); hue 0 where max == min."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    spread = maxc - minc
    s = torch.where(maxc > 0, spread / maxc.clamp_min(1e-12), 0.0)
    safe = spread.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)  # Python's sign rule, as jnp's %; fmod differs
    h = torch.where(spread == 0, 0.0, h)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_water_prior(rgb01):
    """(..., 3) RGB in [0, 1] -> (...) soft water likelihood in [0, 1]:
    darkness sigmoid((0.45 - v) * 10) times (0.5 + 0.5 * hueness), hueness
    the sigmoid closeness of the hue to cyan-blue (0.55 on the circle)."""
    hsv = rgb_to_hsv(rgb01.clamp(0.0, 1.0))
    h, v = hsv[..., 0], hsv[..., 2]
    darkness = torch.sigmoid((0.45 - v) * 10.0)
    hue_dist = torch.minimum((h - 0.55).abs(), 1.0 - (h - 0.55).abs())
    hueness = torch.sigmoid((0.15 - hue_dist) * 12.0)
    return (darkness * (0.5 + 0.5 * hueness)).clamp(0.0, 1.0)


def hsv_consistency(probs, rgb01, axes=None, count=None):
    """Confidence-weighted |probs - prior|: a scalar mean with `axes=None`,
    else the mean over `axes` (`(1, 2)`: one value an image, the train
    loop's masked-mean path), or with `count` the sum over `axes` divided
    by it (a rank's rows of images of `count` pixels). probs (N, H, W),
    rgb01 (N, H, W, 3)."""
    prior = hsv_water_prior(rgb01)
    dev = (2.0 * prior - 1.0).abs() * (probs - prior).abs()
    if axes is None:
        return dev.mean()
    return dev.mean(dim=axes) if count is None else dev.sum(dim=axes) / count


def hsv_guided_bce(logits, targets, rgb01, weight: float = 0.1):
    """BCE from logits plus `weight` times the HSV consistency of their
    sigmoid. logits (N, H, W) or (N, 1, H, W), rgb01 (N, H, W, 3)."""
    base = bce_loss(logits, targets)
    if weight == 0.0:
        return base
    probs = torch.sigmoid(logits.float())
    if probs.ndim == 4:
        probs = probs[:, 0]
    return base + weight * hsv_consistency(probs, rgb01)
