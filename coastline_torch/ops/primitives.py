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
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from coastline_torch.kernels import unpool
from coastline_torch.ops.initializers import (he_normal_, kaiming_normal_fanout_,
                                              torch_bias_init_, torch_conv_kernel_init_,
                                              torch_convt_kernel_init_)

_CONV_INITS = {"torch": torch_conv_kernel_init_, "kaiming_out": kaiming_normal_fanout_,
               "he_normal": he_normal_}


class Conv(nn.Module):
    """torch Conv2d (stride 1) with the JAX layer's options
    (`primitives.py:51-95`): `use_bias`, `dilation`, and `init` 'torch'
    (torch's default), 'kaiming_out' (kaiming-normal fan_out, the Robust
    U-Net's convs) or 'he_normal' (flax's, the Robust U-Net's channel MLP
    as the JAX package draws it). The bias, when there is one, is torch's default
    U(+-1/sqrt(fan_in)) and is added after the convolution in the compute
    dtype, where the JAX layer adds it. Without a bias there is no `bias`
    entry in the state_dict, as in the reference."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 padding: int = 0, dilation: int = 1, use_bias: bool = True,
                 init: str = "torch", generator: Optional[torch.Generator] = None):
        super().__init__()
        if init not in _CONV_INITS:
            raise ValueError(f"init must be one of {sorted(_CONV_INITS)}, got {init!r}")
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel_size, self.padding, self.dilation = kernel_size, padding, dilation
        self.init = init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _CONV_INITS[self.init](self.weight, generator)
        if self.bias is not None:
            torch_bias_init_(self.bias, math.prod(self.weight.shape[1:]), generator)

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), padding=self.padding, dilation=self.dilation)
        return y if self.bias is None else y + self.bias.to(x.dtype)[:, None, None]


class ConvTranspose(nn.Module):
    """torch ConvTranspose2d(k=2, stride=2) with bias and torch's default
    init — the U-Nets' upsampler (`primitives.py:98-146`). The weight is in
    torch's (in, out, kh, kw) layout; the JAX package stores it flipped, and
    the weight bridge (`utils/torch_import.py`) un-flips it."""

    def __init__(self, in_ch: int, out_ch: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 2, 2))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        torch_convt_kernel_init_(self.weight, generator)  # torch: fan_in = out * kh * kw
        torch_bias_init_(self.bias, math.prod(self.weight.shape[1:]), generator)

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), stride=2)
        return y + self.bias.to(x.dtype)[:, None, None]


class Norm(nn.BatchNorm2d):
    """BatchNorm with the JAX package's formulation and rounding
    (`primitives.py:149-244`): the per-channel scale and shift are formed in
    float32, then applied in the activation's dtype as `x * inv + shift`.

    At eval they come from the float32 parameters and running statistics.
    In train mode the batch statistics are taken in float32 over (N, H, W)
    as `mean` and `var = max(E[x^2] - mean^2, 0)`, the gradient flowing
    through both as JAX's autodiff takes it, and the running statistics move
    by torch's rule, momentum 0.1 with the unbiased variance (n / (n - 1)).
    This is not `F.batch_norm`, whose two-pass variance and fused backward
    round differently. `update_stats = False` leaves the running statistics
    as they are (a checkpointed block's recompute, `models/robust_unet.py`)."""

    update_stats = True

    def folded(self):
        """(inv, shift) in float32: y = x * inv + shift."""
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        return inv, self.bias - self.running_mean * inv

    def forward(self, x):
        if not self.training:
            inv, shift = self.folded()
        else:
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            if self.update_stats:
                with torch.no_grad():
                    n = x.numel() // x.shape[1]
                    m = 1.0 - self.momentum  # the JAX package's 0.9: new = m * old + (1 - m) * batch
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var * (n / max(n - 1, 1)))
                    self.num_batches_tracked.add_(1)
            inv = self.weight * torch.rsqrt(var + self.eps)
            shift = self.bias - mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def max_pool(x):
    """torch MaxPool2d(2) (`primitives.py:252-267`)."""
    return F.max_pool2d(x, 2)


def max_pool_with_indices(x, train: bool = False):
    """SegNet's 2x2/stride-2 max pool with window codes (`primitives.py:340-356`)
    on NCHW `x` in channels_last memory: (values, int32 codes 0..3), both
    NCHW views of NHWC tensors.

    At eval, on CUDA, it launches `kernels.unpool.max_pool_with_indices` on
    the NHWC view of `x`. With `train=True` it takes a differentiable
    formulation on any device: the values are `amax` over each window,
    whose gradient splits evenly among equal maxima as `jax.grad` of the
    JAX package's `xw.max` does (the kernel has no backward), and the codes
    are the plain version's, outside the graph."""
    xn = x.permute(0, 2, 3, 1)
    if not train:
        vals, codes = unpool.max_pool_with_indices(xn)
    else:
        b, h, w, c = xn.shape
        vals = xn.reshape(b, h // 2, 2, w // 2, 2, c).amax((2, 4))
        codes = unpool.max_pool_with_indices_plain(xn.detach())[1]
    return vals.permute(0, 3, 1, 2), codes.permute(0, 3, 1, 2)


def max_unpool(vals, codes, output_size: Optional[Tuple[int, int]] = None, train: bool = False):
    """Inverse of `max_pool_with_indices` (`primitives.py:359-375`): each value
    at its window position, zeros (carrying the value's sign) elsewhere, NCHW
    in channels_last memory. `output_size` (H, W) crops, then zero-pads, the
    (2h, 2w) result. At eval, on CUDA, it launches `kernels.unpool.max_unpool`;
    with `train=True` it runs the plain version, which autograd differentiates."""
    unpool_fn = unpool.max_unpool_plain if train else unpool.max_unpool
    y = unpool_fn(vals.permute(0, 2, 3, 1), codes.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    if output_size is not None and tuple(y.shape[2:]) != tuple(output_size):
        oh, ow = output_size
        y = y[:, :, :oh, :ow]
        y = F.pad(y, (0, ow - y.shape[3], 0, oh - y.shape[2])).contiguous(
            memory_format=torch.channels_last)
    return y
