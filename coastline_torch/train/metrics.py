"""Segmentation metrics (counterpart of `coastline/train/metrics.py`).

The reference's formulas and epsilons:
  iou  = tp / (tp + fp + fn + 1e-8)
  prec = tp / (tp + fp + 1e-8); rec = tp / (tp + fn + 1e-8)
  f1   = 2 p r / (p + r + 1e-8)
  acc  = (tp + tn) / (tp + tn + fp + fn)
per image, aggregated as a mean and a population std over images.
"""

from typing import Dict

import torch


def per_image_counts(probs, targets, threshold: float = 0.5) -> torch.Tensor:
    """probs, targets (N, H, W) or (N, 1, H, W) -> (N, 4) float32 pixel
    counts tp, fp, fn, tn of each image; a rank holding some rows of the
    images sums them with the other ranks' before `metrics_from_counts`."""
    if probs.ndim == 4:
        probs = probs[:, 0]
    if targets.ndim == 4:
        targets = targets[:, 0]
    pred = (probs > threshold).float()
    targ = (targets > 0.5).float()
    return torch.stack([(pred * targ).sum((1, 2)), (pred * (1 - targ)).sum((1, 2)),
                        ((1 - pred) * targ).sum((1, 2)),
                        ((1 - pred) * (1 - targ)).sum((1, 2))], 1)


def metrics_from_counts(counts) -> Dict[str, torch.Tensor]:
    """(N, 4) tp, fp, fn, tn -> per-image (N,) accuracy, iou, precision,
    recall and f1_score."""
    tp, fp, fn, tn = counts.unbind(1)
    iou = tp / (tp + fp + fn + 1e-8)
    precision = tp / (tp + fp + 1e-8)
    recall = tp / (tp + fn + 1e-8)
    f1 = 2 * precision * recall / (precision + recall + 1e-8)
    accuracy = (tp + tn) / (tp + tn + fp + fn)
    return {"accuracy": accuracy, "iou": iou, "precision": precision, "recall": recall,
            "f1_score": f1}


def per_image_metrics(probs, targets, threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """probs, targets (N, H, W) or (N, 1, H, W) -> per-image (N,) float32
    accuracy, iou, precision, recall and f1_score."""
    return metrics_from_counts(per_image_counts(probs, targets, threshold))


def binary_iou(pred_bool, targ_bool):
    """Whole-tensor IoU with the production trainer's rule that an empty
    union scores 1.0."""
    inter = torch.logical_and(pred_bool, targ_bool).float().sum()
    union = torch.logical_or(pred_bool, targ_bool).float().sum()
    return torch.where(union == 0, torch.ones_like(union), inter / union.clamp_min(1.0))


def aggregate_metrics(per_image: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-image arrays -> {'mean_*', 'std_*'} (population std)."""
    out = {}
    for key, values in per_image.items():
        out[f"mean_{key}"] = values.mean()
        out[f"std_{key}"] = values.std(correction=0)
    return out
