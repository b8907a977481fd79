"""Primitive layers (counterpart of `coastline/ops/primitives.py`).

The layers keep PyTorch's NCHW module idiom and the reference's parameter
names (`weight`, `bias`, BatchNorm's running buffers), so a reference
state_dict loads with `strict=True`. Parameters stay float32 and are cast to
the activation's dtype at use, as the JAX package's `param_dtype=float32`
does: the compute dtype is whatever dtype the model cast its input to.

Randomness comes only from the `torch.Generator` handed to
`reset_parameters`.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Conv(nn.Module):
    """torch Conv2d (stride 1, with bias) and torch's default init
    (`primitives.py:51-95`, init='torch'). The bias is added after the
    convolution in the compute dtype, where the JAX layer adds it."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 padding: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel_size, self.padding = kernel_size, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.weight[0].numel()
        # kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in)), torch's default
        _uniform_(self.weight, 1.0 / math.sqrt(fan_in), generator)
        _uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), padding=self.padding)
        return y + self.bias.to(x.dtype)[:, None, None]


class ConvTranspose(nn.Module):
    """torch ConvTranspose2d(k=2, stride=2) with bias — the UNet's
    upsampler (`primitives.py:98-146`). The weight is in torch's
    (in, out, kh, kw) layout; the JAX package stores it flipped, and the
    weight bridge (`utils/torch_import.py`) un-flips it."""

    def __init__(self, in_ch: int, out_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 2, 2))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.weight[0].numel()  # torch: out_ch * kh * kw
        _uniform_(self.weight, 1.0 / math.sqrt(fan_in), generator)
        _uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), stride=2)
        return y + self.bias.to(x.dtype)[:, None, None]


class Norm(nn.BatchNorm2d):
    """Eval-mode BatchNorm with the JAX package's rounding
    (`primitives.py:149-244`): the per-channel scale and shift are formed in
    float32 from the float32 parameters and running statistics, then
    applied in the activation's dtype as `x * inv + shift`.

    Train-mode statistics belong to the training slice; calling this in
    train mode raises rather than normalizing with the wrong statistics."""

    def folded(self):
        """(inv, shift) in float32: y = x * inv + shift."""
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        return inv, self.bias - self.running_mean * inv

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet; call .eval()")
        inv, shift = self.folded()
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def max_pool(x):
    """torch MaxPool2d(2) (`primitives.py:252-267`)."""
    return F.max_pool2d(x, 2)
