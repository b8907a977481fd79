"""Primitive layers (counterpart of `coastline/ops/primitives.py`).

The layers keep PyTorch's NCHW module idiom and the reference's parameter
names (`weight`, `bias`, BatchNorm's running buffers), so a reference
state_dict loads with `strict=True`. Parameters stay float32 and are cast to
the activation's dtype at use, as the JAX package's `param_dtype=float32`
does: the compute dtype is whatever dtype the model cast its input to.

Randomness comes only from the `torch.Generator` handed to
`reset_parameters`.

Inside `parallel.collectives.split_rows` (the mesh's `space` axis) an
activation is this rank's rows of the image. Every layer whose window
spans rows then takes the global view: from its input's global height it
derives its output's, the rows of the output this rank owns
(`collectives.row_share`) and the input rows those read, fetches the ones
it lacks from their owners (`collectives.fetch_rows`, rows outside the
image set to the layer's padding value, 0 or -inf), and runs the op on that
slab with no padding along H, so a strided window starts where one
process's would. 1x1 stride-1 convs and elementwise layers need nothing.
Global pools combine the ranks' partial sums and maxima; the adaptive
average pool and `resize_whole` make and read maps every rank holds whole
(`collectives.whole_rows`). `global_size` is a map's (H, W) as one process
sees it: models derive their resize targets from it.
"""

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
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


def global_size(x) -> Tuple[int, int]:
    """(H, W) of NCHW `x` as one process holds it: inside a row split the
    global height, else x's own."""
    split = collectives.row_split()
    return tuple(x.shape[2:]) if split is None else (split.height(x), x.shape[3])


def _rows_for_windows(x, kernel: int, stride: int, padding: int, dilation: int = 1, fill=0.0):
    """(slab, split, output height) for a window op along H on row-split
    `x`: the input rows this rank's output rows read, the first window at
    the slab's top, rows outside the image set to `fill`."""
    split = collectives.row_split()
    height = split.height(x)
    span = dilation * (kernel - 1) + 1
    out_h = (height + 2 * padding - span) // stride + 1
    needs = [(lo * stride - padding, (hi - 1) * stride - padding + span)
             for lo, hi in split.shares(out_h)]
    return collectives.fetch_rows(x, split, height, needs, fill), split, out_h


def _row_windowed(x, kernel: int, stride: int, padding: int, dilation: int, fill, op):
    """`op(slab)` (the op with no H padding) on this rank's rows of a
    window op, or `op` on x with its own padding outside a row split; the
    output's height is recorded."""
    if collectives.row_split() is None or (kernel == 1 and stride == 1 and padding == 0):
        return op(x, padding)
    slab, split, out_h = _rows_for_windows(x, kernel, stride, padding, dilation, fill)
    y = op(slab, 0)
    split.register(out_h, y.shape[3])
    return y


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
        w = self.weight.to(x.dtype)
        y = _row_windowed(x, self.kernel_size[0], self.stride[0], self.padding[0],
                          self.dilation[0], 0.0,
                          lambda t, ph: F.conv2d(t, w, stride=self.stride,
                                                 padding=(ph, self.padding[1]),
                                                 dilation=self.dilation, groups=self.groups))
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
        w = self.weight.to(x.dtype)
        split = collectives.row_split()
        if split is None:
            y = F.conv_transpose2d(x, w, stride=self.stride, padding=self.padding,
                                   output_padding=self.output_padding)
        else:
            y = self._rows(x, w, split)
        return y + self.bias.to(x.dtype)[:, None, None]

    def _rows(self, x, w, split):
        """This rank's output rows of a row-split transposed conv: output
        row o sums input rows i with o + p - i s in [0, k); the conv runs on
        those rows (zeros outside the image) with no H padding, and its
        output, whose row 0 is global row i0 s - p, is cropped."""
        (s, sw), (p, pw), (op, opw) = self.stride, self.padding, self.output_padding
        k = w.shape[2]
        if k < s:
            raise ValueError(f"a row-split transposed conv needs kernel >= stride, got {k} < {s}")
        height = split.height(x)
        out_h = (height - 1) * s - 2 * p + k + op
        needs = [(-(-(lo + p - k + 1) // s), (hi - 1 + p) // s + 1)
                 for lo, hi in split.shares(out_h)]
        slab = collectives.fetch_rows(x, split, height, needs)
        y = F.conv_transpose2d(slab, w, stride=(s, sw), padding=(0, pw),
                               output_padding=(0, opw))
        lo, hi = split.share(out_h)
        top = needs[split.rank][0] * s - p
        y = y[:, :, lo - top:hi - top]
        split.register(out_h, y.shape[3])
        return y.contiguous(memory_format=torch.channels_last)


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
    differently). Inside a row split each rank's sums cover its rows, so
    the same all-reduce over every rank of the step gives the whole
    batch's; a map every rank holds whole (`collectives.whole_rows`) sums
    over the ranks of the other samples only."""

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
    (k, kw), (p, pw) = pair(window), pair(padding)
    (s, sw) = pair(pair(window) if stride is None else stride)
    return _row_windowed(x, k, s, p, 1, float("-inf"),
                         lambda t, ph: F.max_pool2d(t, (k, kw), (s, sw), (ph, pw)))


class MaxPool(nn.MaxPool2d):
    """nn.MaxPool2d whose forward is `max_pool` (row split aware); no
    parameters, so the reference's state_dict indices are unchanged."""

    def forward(self, x):
        return max_pool(x, self.kernel_size, self.stride, self.padding)


def avg_pool(x, window=2, stride=None, padding=0):
    """A window sum over window area (`primitives.py:270-282`): zero
    padding counted in the divisor, torch AvgPool2d's default."""
    (k, kw), (p, pw) = pair(window), pair(padding)
    (s, sw) = pair(pair(window) if stride is None else stride)
    return _row_windowed(x, k, s, p, 1, 0.0,
                         lambda t, ph: F.avg_pool2d(t, (k, kw), (s, sw), (ph, pw)))


def max_pool_global(x):
    """AdaptiveMaxPool2d(1): (N, C, H, W) -> (N, C, 1, 1), whole on every
    rank of a row split."""
    split = collectives.row_split()
    mx = x.amax((2, 3), keepdim=True)
    return mx if split is None else collectives.global_max(mx, split.group)


def avg_pool_global(x):
    """AdaptiveAvgPool2d(1): (N, C, H, W) -> (N, C, 1, 1), in x.dtype; in a
    row split the float32 sums of the ranks' rows over the global area, whole
    on every rank."""
    split = collectives.row_split()
    if split is None:
        return x.mean((2, 3), keepdim=True)
    sums = collectives.all_reduce_grad(x.float().sum((2, 3), keepdim=True), split.group)
    return (sums / (split.height(x) * x.shape[3])).to(x.dtype)


def _adaptive_bounds(size: int, out: int):
    return ([math.floor(i * size / out) for i in range(out)],
            [math.ceil((i + 1) * size / out) for i in range(out)])


def _window_ones(size: int, out: int, device, rows=None):
    """(out, size) float32: row i is 1 on window i, floor(i * size / out) ..
    ceil((i + 1) * size / out); with `rows` = (lo, hi) only those columns."""
    starts, ends = _adaptive_bounds(size, out)
    lo, hi = (0, size) if rows is None else rows
    pos = torch.arange(lo, hi, device=device)
    return ((pos >= torch.tensor(starts, device=device)[:, None])
            & (pos < torch.tensor(ends, device=device)[:, None])).float()


def adaptive_avg_pool(x, output_size):
    """torch AdaptiveAvgPool2d for any H and k (`primitives.py:301-322`):
    equal windows as one reshape and mean, as the JAX package takes them;
    unequal ones (PSPNet's levels 3 and 6 at 512^2) as float32 window sums,
    two small matmuls with 0/1 window matrices, over the window areas, cast
    back. Both backwards are deterministic on the card, which
    `F.adaptive_avg_pool2d`'s CUDA backward is not. In a row split the
    window sums of the ranks' rows are summed over the ranks: the pooled
    map is whole on every rank (`collectives.whole_rows`)."""
    oh, ow = pair(output_size)
    n, c, h, w = x.shape
    split = collectives.row_split()
    if split is None and h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean((3, 5))
    height = h if split is None else split.height(x)
    rows = None if split is None else split.share(height)
    mh, mw = _window_ones(height, oh, x.device, rows), _window_ones(w, ow, x.device)
    sums = torch.einsum("nchw,kh,lw->nckl", x.float(), mh, mw)
    if split is not None:
        sums = collectives.all_reduce_grad(sums, split.group)
    areas = _window_ones(height, oh, x.device).sum(1)[:, None] * mw.sum(1)
    return (sums / areas).to(x.dtype)


def adaptive_max_pool(x, output_size):
    """torch AdaptiveMaxPool2d, the same windows (`primitives.py:325-337`),
    one max a window; in a row split the ranks' window maxima (-inf where a
    window has none of a rank's rows) combine by `global_max`, whole."""
    oh, ow = pair(output_size)
    split = collectives.row_split()
    height = x.shape[2] if split is None else split.height(x)
    lo = 0 if split is None else split.share(height)[0]
    (hs, he), (ws, we) = _adaptive_bounds(height, oh), _adaptive_bounds(x.shape[3], ow)

    def window(i, j):
        a, b = max(hs[i] - lo, 0), min(he[i] - lo, x.shape[2])
        if b <= a:
            return x.new_full(x.shape[:2], float("-inf"))
        return x[:, :, a:b, ws[j]:we[j]].amax((2, 3))

    out = torch.stack([torch.stack([window(i, j) for j in range(ow)], dim=-1)
                       for i in range(oh)], dim=-2)
    return out if split is None else collectives.global_max(out, split.group)


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
    makes. Its bf16 results round otherwise than XLA's. `size` is global
    (`global_size`): in a row split this rank's output rows read the source
    rows around them, fetched from their owners."""
    split = collectives.row_split()
    if split is None:
        return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
    height = split.height(x)
    rows = [_bilinear_taps(height, size[0], lo, hi) for lo, hi in split.shares(size[0])]
    needs = [(int(h0.min()), int(h1.max()) + 1) for h0, h1, _ in rows]
    slab = collectives.fetch_rows(x, split, height, needs)
    return _bilinear_rows(slab, needs[split.rank][0], rows[split.rank], size, split)


def resize_whole(x, size):
    """`bilinear_resize` of a map every rank holds whole (a pooled pyramid
    level, `collectives.whole_rows`) to global `size`: in a row split, this
    rank's rows of the result, with no exchange."""
    split = collectives.row_split()
    if split is None:
        return bilinear_resize(x, size)
    lo, hi = split.share(size[0])
    return _bilinear_rows(x, 0, _bilinear_taps(x.shape[2], size[0], lo, hi), size, split)


def _bilinear_taps(in_h: int, out_h: int, lo: int, hi: int):
    """(h0, h1, lambda1) of output rows [lo, hi) of a bilinear resize from
    in_h to out_h rows, in float32 as torch computes them: source
    (o + 0.5) * in / out - 0.5 clamped at 0, h1 = h0 + 1 short of the last
    row; a resize to the same height copies."""
    o = np.arange(lo, hi)
    if in_h == out_h:
        return o, o, np.zeros(len(o), np.float32)
    scale = np.float32(in_h) / np.float32(out_h)
    src = np.maximum((o.astype(np.float32) + np.float32(0.5)) * scale - np.float32(0.5),
                     np.float32(0))
    h0 = src.astype(np.int64)
    return h0, np.minimum(h0 + 1, in_h - 1), (src - h0.astype(np.float32)).astype(np.float32)


def _bilinear_rows(slab, first: int, taps, size, split):
    """The rows `taps` of a bilinear resize from `slab` (source rows from
    `first` on): the W pass by F.interpolate at the slab's height (a row
    copy along H), then lambda0 * row h0 + lambda1 * row h1 in float32,
    cast once to the slab's dtype."""
    h0, h1, lam = taps
    wide = F.interpolate(slab.float(), size=(slab.shape[2], size[1]), mode="bilinear",
                         align_corners=False)
    dev = slab.device
    i0 = torch.as_tensor(h0 - first, device=dev)
    i1 = torch.as_tensor(h1 - first, device=dev)
    l1 = torch.as_tensor(lam, device=dev)[:, None]
    y = wide.index_select(2, i0) * (1 - l1) + wide.index_select(2, i1) * l1
    split.register(size[0], size[1])
    return y.to(slab.dtype).contiguous(memory_format=torch.channels_last)


def _nearest_rows(x, size, src_of):
    """Nearest-neighbour resize to global `size` with source row
    `src_of(o)`: in a row split, this rank's output rows from their fetched
    source rows."""
    split = collectives.row_split()
    height = split.height(x)
    rows = [src_of(np.arange(lo, hi)) for lo, hi in split.shares(size[0])]
    needs = [(int(r.min()), int(r.max()) + 1) for r in rows]
    slab = collectives.fetch_rows(x, split, height, needs)
    idx = torch.as_tensor(rows[split.rank] - needs[split.rank][0], device=x.device)
    y = F.interpolate(slab.index_select(2, idx), size=(len(idx), size[1]), mode="nearest-exact")
    split.register(size[0], size[1])
    return y.contiguous(memory_format=torch.channels_last)


def upsample_nearest(x, scale: int):
    """Nearest-neighbour upsampling by an integer `scale` (`primitives.py:393-395`)."""
    split = collectives.row_split()
    if split is None:
        return F.interpolate(x, scale_factor=scale, mode="nearest")
    h, w = global_size(x)
    return _nearest_rows(x, (h * scale, w * scale), lambda o: o // scale)


def nearest_resize(x, size):
    """Nearest-neighbour resize to `size` with half-pixel centres, as
    `jax.image.resize(method='nearest')` (`primitives.py:398-400`)."""
    split = collectives.row_split()
    if split is None:
        return F.interpolate(x, size=tuple(size), mode="nearest-exact")
    in_h = split.height(x)
    scale = np.float32(in_h) / np.float32(size[0])
    return _nearest_rows(x, size, lambda o: np.minimum(
        np.floor((o.astype(np.float32) + np.float32(0.5)) * scale).astype(np.int64), in_h - 1))


def max_pool_with_indices(x, train: bool = False):
    """SegNet's 2x2/stride-2 max pool with window codes (`primitives.py:340-356`)
    on NCHW `x` in channels_last memory: (values, int32 codes 0..3), both
    NCHW views of NHWC tensors.

    At eval, on CUDA, it launches `kernels.unpool.max_pool_with_indices` on
    the NHWC view of `x`. With `train=True` it takes a differentiable
    formulation on any device: the values are `amax` over each window,
    whose gradient splits evenly among equal maxima as `jax.grad` of the
    JAX package's `xw.max` does (the kernel has no backward), and the codes
    are the plain version's, outside the graph. In a row split a window
    whose two rows straddle a seam reads its far row from the rank that
    owns it (48 rows over 2 ranks put the fourth pool on 3 + 3 rows)."""
    split = collectives.row_split()
    if split is not None:
        x, split, out_h = _rows_for_windows(x, 2, 2, 0)
        x = x.contiguous(memory_format=torch.channels_last)
    xn = x.permute(0, 2, 3, 1)
    if not train:
        vals, codes = unpool.max_pool_with_indices(xn)
    else:
        b, h, w, c = xn.shape
        vals = xn.reshape(b, h // 2, 2, w // 2, 2, c).amax((2, 4))
        codes = unpool.max_pool_with_indices_plain(xn.detach())[1]
    if split is not None:
        split.register(out_h, vals.shape[2])
    return vals.permute(0, 3, 1, 2), codes.permute(0, 3, 1, 2)


def max_unpool(vals, codes, output_size: Optional[Tuple[int, int]] = None, train: bool = False):
    """Inverse of `max_pool_with_indices` (`primitives.py:359-375`): each value
    at its window position, zeros (carrying the value's sign) elsewhere, NCHW
    in channels_last memory. `output_size` (H, W) crops, then zero-pads, the
    (2h, 2w) result. At eval, on CUDA, it launches `kernels.unpool.max_unpool`;
    with `train=True` it runs the plain version, which autograd differentiates.
    In a row split (no `output_size`) this rank's output rows come from the
    pooled rows they unpool, fetched where a window's row pair straddles a
    seam, and the unpooled slab is cropped to them."""
    unpool_fn = unpool.max_unpool_plain if train else unpool.max_unpool
    split = collectives.row_split()
    if split is not None:
        return _max_unpool_rows(vals, codes, output_size, unpool_fn, split)
    y = unpool_fn(vals.permute(0, 2, 3, 1), codes.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    if output_size is not None and tuple(y.shape[2:]) != tuple(output_size):
        oh, ow = output_size
        y = y[:, :, :oh, :ow]
        y = F.pad(y, (0, ow - y.shape[3], 0, oh - y.shape[2])).contiguous(
            memory_format=torch.channels_last)
    return y


def _max_unpool_rows(vals, codes, output_size, unpool_fn, split):
    height = split.height(vals)
    out_h = 2 * height
    if output_size is not None and tuple(output_size) != (out_h, 2 * vals.shape[3]):
        raise NotImplementedError("a row-split max_unpool takes the doubled size only")
    needs = [(lo // 2, (hi - 1) // 2 + 1) for lo, hi in split.shares(out_h)]
    vals = collectives.fetch_rows(vals, split, height, needs)
    codes = collectives.fetch_rows(codes, split, height, needs, 0)
    y = unpool_fn(vals.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1),
                  codes.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1))
    lo, hi = split.share(out_h)
    top = 2 * needs[split.rank][0]
    y = y[:, lo - top:hi - top].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    split.register(out_h, y.shape[3])
    return y
