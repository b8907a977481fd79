"""PyTorch/CUDA port of coastline: the serving path, the evaluation epochs,
the production trainer and the comparison protocol (`cli/bench_all.py`,
`train/loop.py::Evaluator`) over the whole model zoo of the JAX registry
(`models/registry.py`: the Robust U-Net, the UNet and ten baselines), and
coastline extraction from files and native-resolution scenes
(`cli/predict.py`, with `cli/convert.py`, `cli/change.py`, `cli/export.py`).

`coastline/` (JAX) is the frozen reference; this package computes the same
functions with PyTorch on an NVIDIA H100, and its TPU (Pallas) kernels are
re-written by hand in CUDA C++ under `csrc/`. It imports torch, numpy and
(for contour tracing) scipy, never jax and nothing of `coastline`; its
contour tracer for hosts without cv2 is C++ built with g++ (`native/`).

Public entry points take `device=` and default to "cuda"; without a card
they raise unless the caller asks for "cpu" explicitly.
"""

from coastline_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
