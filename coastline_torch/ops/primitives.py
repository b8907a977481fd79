"""Primitive layers (counterpart of `coastline/ops/primitives.py`).

The layers keep PyTorch's NCHW module idiom and the reference's parameter
names (`weight`, `bias`, BatchNorm's running buffers), so a reference
state_dict loads with `strict=True`. Parameters stay float32 and are cast to
the activation's dtype at use, as the JAX package's `param_dtype=float32`
does: the compute dtype is whatever dtype the model cast its input to.

Randomness comes only from the `torch.Generator` handed to
`reset_parameters`.
"""

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from coastline_torch.kernels import unpool
from coastline_torch.parallel import collectives
from coastline_torch.ops.initializers import (he_normal_, kaiming_normal_fanout_,
                                              torch_bias_init_, torch_conv_kernel_init_,
                                              torch_convt_kernel_init_)

_CONV_INITS = {"torch": torch_conv_kernel_init_, "kaiming_out": kaiming_normal_fanout_,
               "he_normal": he_normal_}


def pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """torch Conv2d with the JAX layer's options (`primitives.py:51-95`):
    `stride`, `padding`, `dilation` (ints or (h, w) pairs), `groups`,
    `use_bias`, and `init` 'torch' (torch's default), 'kaiming_out'
    (kaiming-normal fan_out, the Robust U-Net's convs) or 'he_normal'
    (flax's, the Robust U-Net's channel MLP as the JAX package draws it).
    The bias, when there is one, is torch's default U(+-1/sqrt(fan_in)),
    fan_in = (in / groups) * kh * kw, and is added after the convolution in
    the compute dtype, where the JAX layer adds it. Without a bias there is
    no `bias` entry in the state_dict, as in the reference."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, padding=0, dilation=1,
                 use_bias: bool = True, init: str = "torch",
                 generator: Optional[torch.Generator] = None, stride=1, groups: int = 1):
        super().__init__()
        if init not in _CONV_INITS:
            raise ValueError(f"init must be one of {sorted(_CONV_INITS)}, got {init!r}")
        self.in_ch, self.out_ch, self.groups = in_ch, out_ch, groups
        self.kernel_size, self.padding = pair(kernel_size), pair(padding)
        self.dilation, self.stride = pair(dilation), pair(stride)
        self.init = init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _CONV_INITS[self.init](self.weight, generator)
        if self.bias is not None:
            torch_bias_init_(self.bias, math.prod(self.weight.shape[1:]), generator)

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride, padding=self.padding,
                     dilation=self.dilation, groups=self.groups)
        return y if self.bias is None else y + self.bias.to(x.dtype)[:, None, None]


class ConvTranspose(nn.Module):
    """torch ConvTranspose2d with bias and torch's default init
    (`primitives.py:98-146`): out = (in - 1) * stride - 2 * padding +
    kernel + output_padding. The zoo uses (k 2, s 2), (k 4, s 2, p 1) and
    (k 3, s 2, p 1, op 1); the default is the U-Nets' (k 2, s 2). The
    weight is in torch's (in, out, kh, kw) layout; the JAX package applies
    its kernel unflipped as an input-dilated conv, so it stores this one
    flipped, and the weight bridge (`utils/torch_import.py`) un-flips it."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=2, stride=2, padding=0,
                 output_padding: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = pair(stride), pair(padding)
        self.output_padding = pair(output_padding)
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, *pair(kernel_size)))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        torch_convt_kernel_init_(self.weight, generator)  # torch: fan_in = out * kh * kw
        torch_bias_init_(self.bias, math.prod(self.weight.shape[1:]), generator)

    def forward(self, x):
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), stride=self.stride,
                               padding=self.padding, output_padding=self.output_padding)
        return y + self.bias.to(x.dtype)[:, None, None]


#: Measurement control (`coastline/ops/primitives.py:206-230`): True makes
#: every train-mode `Norm` take its eval branch (running statistics, no
#: update, no all-reduce), isolating the cost of the batch-statistic
#: passes in a train step. JAX reads the flag when it traces a step; the
#: port is eager, so `Norm.forward` reads it at every call.
_BN_FROZEN = False


def set_bn_frozen(value: bool):
    global _BN_FROZEN
    _BN_FROZEN = bool(value)


@contextlib.contextmanager
def bn_frozen(value: bool = True):
    """Scoped BN freeze for measurement code: the previous value comes back
    on exit, also on error, so a leaked True cannot freeze BN statistics
    for later training in the process. Prefer it to `set_bn_frozen`."""
    global _BN_FROZEN
    prev = _BN_FROZEN
    _BN_FROZEN = bool(value)
    try:
        yield
    finally:
        _BN_FROZEN = prev


class Norm(nn.BatchNorm2d):
    """BatchNorm with the JAX package's formulation and rounding
    (`primitives.py:149-244`): the per-channel scale and shift are formed in
    float32, then applied in the activation's dtype as `x * inv + shift`.

    At eval they come from the float32 parameters and running statistics.
    In train mode the batch statistics are taken in float32 (float64 for a
    float64 input) over (N, H, W)
    as `mean` and `var = max(E[x^2] - mean^2, 0)`, the gradient flowing
    through both as JAX's autodiff takes it, and the running statistics move
    by torch's rule, momentum 0.1 with the unbiased variance (n / (n - 1)).
    This is not `F.batch_norm`, whose two-pass variance and fused backward
    round differently. `update_stats = False` leaves the running statistics
    as they are (a checkpointed block's recompute, `models/robust_unet.py`).
    Under `bn_frozen()` a train-mode forward takes the eval branch.

    Inside `parallel.collectives.split_batch(group)` (a train step whose
    batch is split over ranks) the per-channel sums of x and x^2 and the
    count are all-reduced over the group, through an all-reduce autograd
    sees, so mean, E[x^2], the gradient and n / (n - 1) are the whole
    batch's, as JAX's sharded step takes them (`nn.SyncBatchNorm` rounds
    differently)."""

    update_stats = True

    def folded(self):
        """(inv, shift) in float32: y = x * inv + shift."""
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        return inv, self.bias - self.running_mean * inv

    def forward(self, x):
        if not self.training or _BN_FROZEN:
            inv, shift = self.folded()
        else:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            group = collectives.batch_group()
            if group is None:
                n = x.numel() // x.shape[1]
                unbias = n / max(n - 1, 1)
                mean = xf.mean((0, 2, 3))
                ex2 = (xf * xf).mean((0, 2, 3))
            else:  # the batch is split over the group's ranks: its sums are global
                c = x.shape[1]
                local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                                   xf.new_full((1,), x.numel() // c)])
                sums = collectives.all_reduce_grad(local, group)
                n = sums[-1].detach()
                unbias = n / (n - 1).clamp_min(1.0)
                mean, ex2 = sums[:c] / n, sums[c:2 * c] / n
            var = (ex2 - mean * mean).clamp_min(0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = 1.0 - self.momentum  # the JAX package's 0.9: new = m * old + (1 - m) * batch
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var * unbias)
                    self.num_batches_tracked.add_(1)
            inv = self.weight * torch.rsqrt(var + self.eps)
            shift = self.bias - mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def max_pool(x, window=2, stride=None, padding=0):
    """torch MaxPool2d(window, stride, padding) (`primitives.py:252-267`):
    the padding is -inf, the stride the window unless given."""
    return F.max_pool2d(x, window, window if stride is None else stride, padding)


def avg_pool(x, window=2, stride=None, padding=0):
    """A window sum over window area (`primitives.py:270-282`): zero
    padding counted in the divisor, torch AvgPool2d's default."""
    return F.avg_pool2d(x, window, window if stride is None else stride, padding)


def max_pool_global(x):
    """AdaptiveMaxPool2d(1): (N, C, H, W) -> (N, C, 1, 1)."""
    return x.amax((2, 3), keepdim=True)


def avg_pool_global(x):
    """AdaptiveAvgPool2d(1): (N, C, H, W) -> (N, C, 1, 1), in x.dtype."""
    return x.mean((2, 3), keepdim=True)


def _adaptive_bounds(size: int, out: int):
    return ([math.floor(i * size / out) for i in range(out)],
            [math.ceil((i + 1) * size / out) for i in range(out)])


def _window_ones(size: int, out: int, device):
    """(out, size) float32: row i is 1 on window i, floor(i * size / out) ..
    ceil((i + 1) * size / out)."""
    starts, ends = _adaptive_bounds(size, out)
    pos = torch.arange(size, device=device)
    return ((pos >= torch.tensor(starts, device=device)[:, None])
            & (pos < torch.tensor(ends, device=device)[:, None])).float()


def adaptive_avg_pool(x, output_size):
    """torch AdaptiveAvgPool2d for any H and k (`primitives.py:301-322`):
    equal windows as one reshape and mean, as the JAX package takes them;
    unequal ones (PSPNet's levels 3 and 6 at 512^2) as float32 window sums,
    two small matmuls with 0/1 window matrices, over the window areas, cast
    back. Both backwards are deterministic on the card, which
    `F.adaptive_avg_pool2d`'s CUDA backward is not."""
    oh, ow = pair(output_size)
    n, c, h, w = x.shape
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean((3, 5))
    mh, mw = _window_ones(h, oh, x.device), _window_ones(w, ow, x.device)
    sums = torch.einsum("nchw,kh,lw->nckl", x.float(), mh, mw)
    return (sums / (mh.sum(1)[:, None] * mw.sum(1))).to(x.dtype)


def adaptive_max_pool(x, output_size):
    """torch AdaptiveMaxPool2d, the same windows (`primitives.py:325-337`),
    one max a window."""
    oh, ow = pair(output_size)
    (hs, he), (ws, we) = _adaptive_bounds(x.shape[2], oh), _adaptive_bounds(x.shape[3], ow)
    return torch.stack([torch.stack([x[:, :, hs[i]:he[i], ws[j]:we[j]].amax((2, 3))
                                     for j in range(ow)], dim=-1) for i in range(oh)], dim=-2)


class AdaptiveAvgPool(nn.Module):
    """`adaptive_avg_pool` as a parameterless module (the pyramid's levels)."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return adaptive_avg_pool(x, self.output_size)


def bilinear_resize(x, size):
    """F.interpolate(mode='bilinear', align_corners=False): half-pixel
    centres, no antialiasing, the function of `jax.image.resize(...,
    antialias=False)` (`primitives.py:383-390`) for every upsample the zoo
    makes. Its bf16 results round otherwise than XLA's."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def upsample_nearest(x, scale: int):
    """Nearest-neighbour upsampling by an integer `scale` (`primitives.py:393-395`)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def nearest_resize(x, size):
    """Nearest-neighbour resize to `size` with half-pixel centres, as
    `jax.image.resize(method='nearest')` (`primitives.py:398-400`)."""
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


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
