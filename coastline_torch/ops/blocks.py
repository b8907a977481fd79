"""conv -> BN -> ReLU (counterpart of `coastline/ops/blocks.py:42-76`).

In bf16, a 3x3/pad-1 conv with 64 input and 64 output channels followed by
BN and ReLU goes through the fused conv kernel with BN and the conv bias
folded into one per-channel affine. The UNet's two full-resolution 64->64
layers are that shape, so a forward launches it twice. Every other conv,
and everything in float32, runs `F.conv2d` -> BN -> ReLU, as the JAX package
leaves those to XLA.
"""

import torch
import torch.nn.functional as F
from torch import nn

from coastline_torch.kernels.fused_conv import fused_conv3x3_bn_relu
from coastline_torch.ops.primitives import Conv, Norm


def fold_bn(conv: Conv, norm: Norm):
    """(w HWIO, scale, bias) in float32 with conv -> norm == conv(x, w) * scale
    + bias: scale = gamma / sqrt(var + eps), bias = beta + (b - mean) * scale."""
    scale, _ = norm.folded()
    bias = norm.bias + (conv.bias - norm.running_mean) * scale
    return conv.weight.permute(2, 3, 1, 0), scale, bias


def _fusable(conv: Conv, x: torch.Tensor) -> bool:
    return (x.dtype == torch.bfloat16 and conv.in_ch == conv.out_ch == 64
            and conv.kernel_size == 3 and conv.padding == 1)


def conv_bn_act(conv: Conv, norm: Norm, x: torch.Tensor):
    """conv -> BN -> ReLU on NCHW `x`. The fused path needs `x` in
    channels_last memory (its NHWC permute is then contiguous) and returns
    channels_last."""
    if _fusable(conv, x):
        w, scale, bias = fold_bn(conv, norm)
        y = fused_conv3x3_bn_relu(x.permute(0, 2, 3, 1), w, scale, bias, relu=True)
        return y.permute(0, 3, 1, 2)
    return F.relu(norm(conv(x)))


class ConvBNAct(nn.Sequential):
    """Sequential(conv, bn, relu) — the reference's state_dict layout
    (indices 0 and 1) — whose forward is `conv_bn_act`."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__(Conv(in_ch, out_ch, 3, padding=1, generator=generator),
                         Norm(out_ch), nn.ReLU())

    def forward(self, x):
        return conv_bn_act(self[0], self[1], x)
