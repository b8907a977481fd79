"""Input normalization (counterpart of `coastline/data/pipeline.py:23-24`
and the u8 -> f32 step of `coastline/infer/extract.py:50-53`)."""

import torch

# torchvision Normalize constants, as in the reference training script
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 -> float32 `(x / 255 - mean) / std`, same op order as
    the JAX package so the f32 inputs agree bit for bit."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x_u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x_u8.device)
    return (x_u8.to(torch.float32) / 255.0 - mean) / std
