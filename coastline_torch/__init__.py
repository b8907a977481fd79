"""PyTorch/CUDA port of coastline: the serving path, the Robust U-Net's and
SegNet's evaluation epochs and the production trainer.

`coastline/` (JAX) is the frozen reference; this package computes the same
functions with PyTorch on an NVIDIA H100, and its TPU (Pallas) kernels are
re-written by hand in CUDA C++ under `csrc/`. It imports torch, numpy and
(for contour tracing) scipy, never jax and nothing of `coastline`.

Public entry points take `device=` and default to "cuda"; without a card
they raise unless the caller asks for "cpu" explicitly.
"""

from coastline_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
