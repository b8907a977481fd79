"""Building blocks of the ported models (counterpart of `coastline/ops/blocks.py`).

conv -> BN (-> ReLU): in bf16, a 3x3/pad-1 conv with 64 input and 64 output
channels goes through the fused conv kernel with BN and any conv bias folded
into one per-channel affine, with or without the ReLU. The UNet's two
full-resolution 64->64 ConvBNActs, SegNet's `enc1` conv 2 and `dec1` conv 0,
and the Robust U-Net's two 64-channel ResidualBlocks' second conv (conv ->
BN, no ReLU) are that shape, so each forward launches it twice. Every other
conv, and everything in float32, runs `F.conv2d` -> BN (-> ReLU), as the JAX
package leaves those to XLA. In train mode no conv takes the fused kernel,
which folds the running statistics and has no gradient (the JAX package's
train mode takes the module path too, `coastline/ops/blocks.py:185-222`):
`F.conv2d` -> train-mode BN (-> ReLU).

The Robust U-Net's blocks (`ops/blocks.py:30-245`): Dropout2d,
ChannelAttention, SpatialAttention, AttentionGate, ResidualBlock and
DilatedBlock, with the reference's state_dict names and the Robust U-Net's
init: every conv kaiming-normal fan_out, the channel MLP flax `he_normal`.
They are eval-only until the comparison protocol's training slice (the
next one): train mode raises. At eval a
ResidualBlock ends in
`kernels.cbam.fused_cbam_tail` (three CUDA kernels on the card) for every
shape; `ResidualBlock.module_tail` keeps the module composition it equals.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from coastline_torch.kernels.cbam import channel_gate, fused_cbam_tail
from coastline_torch.kernels.fused_conv import fused_conv3x3_bn_relu
from coastline_torch.kernels.pools import fused_avg_max_pool
from coastline_torch.ops.primitives import Conv, Norm

_INIT = "kaiming_out"  # every conv of the Robust U-Net's blocks (`Main_Final.py:282-288`)


def fold_bn(conv: Conv, norm: Norm):
    """(w HWIO, scale, bias) in float32 with conv -> norm == conv(x, w) * scale
    + bias: scale = gamma / sqrt(var + eps), bias = beta + (b - mean) * scale
    for a conv with bias b, beta - mean * scale for one without."""
    scale, shift = norm.folded()
    if conv.bias is not None:
        shift = norm.bias + (conv.bias - norm.running_mean) * scale
    return conv.weight.permute(2, 3, 1, 0), scale, shift


def _fusable(conv: Conv, x: torch.Tensor) -> bool:
    return (x.dtype == torch.bfloat16 and conv.in_ch == conv.out_ch == 64
            and conv.kernel_size == 3 and conv.padding == 1 and conv.dilation == 1)


def conv_bn(conv: Conv, norm: Norm, x: torch.Tensor, act: bool):
    """conv -> BN, then ReLU if `act`, on NCHW `x`. At eval the fused path
    needs `x` in channels_last memory (its NHWC permute is then contiguous)
    and returns channels_last; in train mode every conv is `F.conv2d`."""
    if not norm.training and _fusable(conv, x):
        w, scale, bias = fold_bn(conv, norm)
        y = fused_conv3x3_bn_relu(x.permute(0, 2, 3, 1), w, scale, bias, relu=act)
        return y.permute(0, 3, 1, 2)
    y = norm(conv(x))
    return F.relu(y) if act else y


class ConvBNAct(nn.Sequential):
    """Sequential(conv, bn, relu) — the reference's state_dict layout
    (indices 0 and 1) — whose forward is `conv_bn` with the ReLU."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__(Conv(in_ch, out_ch, 3, padding=1, generator=generator),
                         Norm(out_ch), nn.ReLU())

    def forward(self, x):
        return conv_bn(self[0], self[1], x, act=True)


class ConvStack(nn.Sequential):
    """ConvBNActs of `widths` (in, out 1, out 2, ...) flattened into one
    Sequential, conv at 3j and BN at 3j + 1 — the reference's layout of the
    UNet's double convs and SegNet's stages — optionally followed by a
    `head`: a 3x3 conv with bias to that many channels, without BN (SegNet's
    `dec1.3`)."""

    def __init__(self, widths, generator=None, head: Optional[int] = None):
        layers = [m for cin, cout in zip(widths, widths[1:])
                  for m in ConvBNAct(cin, cout, generator=generator)]
        if head is not None:
            layers.append(Conv(widths[-1], head, 3, padding=1, generator=generator))
        super().__init__(*layers)
        self.n_convs = len(widths) - 1

    def forward(self, x):
        for j in range(self.n_convs):
            x = conv_bn(self[3 * j], self[3 * j + 1], x, act=True)
        return x if len(self) == 3 * self.n_convs else self[-1](x)


def _eval_only(module: nn.Module):
    if module.training:
        raise NotImplementedError(
            f"train-mode {type(module).__name__} is not ported yet (the comparison "
            "protocol's training slice, next); call .eval()")


class Dropout2d(nn.Module):
    """Channel dropout (`blocks.py:30-39`): the identity at eval. Train mode
    waits for the comparison protocol's training slice, which draws its mask
    from a torch.Generator; until then it raises."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate > 0.0:
            _eval_only(self)
        return x


class ChannelAttention(nn.Module):
    """CBAM channel gate (`blocks.py:79-114`): x * sigmoid(mlp(avg) +
    mlp(max)) over the global average- and max-pooled channels, mlp = two
    bias-free 1x1 convs (`fc.0`, `fc.2`, ratio 16) with a ReLU between,
    drawn from flax's `he_normal` as in the JAX package. At eval the pooling
    is `kernels.pools.fused_avg_max_pool`."""

    def __init__(self, channels: int, generator=None):
        super().__init__()
        hidden = channels // 16

        def fc(cin, cout):
            return Conv(cin, cout, 1, use_bias=False, init="he_normal", generator=generator)

        self.fc = nn.Sequential(fc(channels, hidden), nn.ReLU(), fc(hidden, channels))

    def dense_kernels(self):
        """(fc1 (C, C // r), fc2 (C // r, C)): the MLP in the JAX Dense layout."""
        return self.fc[0].weight[:, :, 0, 0].t(), self.fc[2].weight[:, :, 0, 0].t()

    def forward(self, x):
        _eval_only(self)
        avg, mx = fused_avg_max_pool(x.permute(0, 2, 3, 1))
        return x * channel_gate(avg, mx, *self.dense_kernels())[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM spatial gate (`blocks.py:117-133`): x * sigmoid(conv7x7([mean_c,
    max_c])) with `conv1` (1, 2, 7, 7), no bias; the mean is summed in
    float32 and the sigmoid stays in the compute dtype."""

    def __init__(self, generator=None):
        super().__init__()
        self.conv1 = Conv(2, 1, 7, padding=3, use_bias=False, init=_INIT, generator=generator)

    def hwio(self):
        """The conv weight in the JAX HWIO layout, (7, 7, 2, 1)."""
        return self.conv1.weight.permute(2, 3, 1, 0)

    def forward(self, x):
        avg = x.mean(1, keepdim=True, dtype=torch.float32).to(x.dtype)
        att = self.conv1(torch.cat([avg, x.amax(1, keepdim=True)], dim=1))
        return x * torch.sigmoid(att)


class AttentionGate(nn.Module):
    """Attention-U-Net skip gate (`blocks.py:136-154`): psi =
    sigmoid(BN(1x1(relu(BN(1x1 g) + BN(1x1 x))))), taken in float32 and cast
    back; returns x * psi. `W_g`, `W_x`, `psi` are Sequential(1x1 conv with
    bias, BN), as in the reference."""

    def __init__(self, f_g: int, f_l: int, f_int: int, generator=None):
        super().__init__()

        def branch(cin, cout):
            return nn.Sequential(Conv(cin, cout, 1, init=_INIT, generator=generator), Norm(cout))

        self.W_g = branch(f_g, f_int)
        self.W_x = branch(f_l, f_int)
        self.psi = branch(f_int, 1)

    def forward(self, g, x):
        psi = self.psi(torch.relu(self.W_g(g) + self.W_x(x)))
        return x * torch.sigmoid(psi.float()).to(x.dtype)


class ResidualBlock(nn.Module):
    """Attention-augmented residual block (`blocks.py:157-225`):
    conv3x3-BN-ReLU-Dropout2d-conv3x3-BN (convs without bias) -> channel
    gate -> spatial gate -> + shortcut -> ReLU. The shortcut is a bias-free
    1x1 conv + BN (`shortcut.0`/`.1`) when the widths differ, else the
    identity. At eval the tail after bn2 is `fused_cbam_tail`."""

    def __init__(self, in_ch: int, out_ch: int, dropout_rate: float = 0.1, generator=None):
        super().__init__()

        def conv(cin, k):
            return Conv(cin, out_ch, k, padding=k // 2, use_bias=False, init=_INIT,
                        generator=generator)

        self.shortcut = nn.Sequential(conv(in_ch, 1), Norm(out_ch)) if in_ch != out_ch else None
        self.conv1 = conv(in_ch, 3)
        self.bn1 = Norm(out_ch)
        self.dropout = Dropout2d(dropout_rate)
        self.conv2 = conv(out_ch, 3)
        self.bn2 = Norm(out_ch)
        self.ca = ChannelAttention(out_ch, generator=generator)
        self.sa = SpatialAttention(generator=generator)

    def body(self, x):
        """(bn2 output, shortcut): everything before the CBAM tail."""
        shortcut = x if self.shortcut is None else self.shortcut(x)
        out = self.dropout(conv_bn(self.conv1, self.bn1, x, act=True))
        return conv_bn(self.conv2, self.bn2, out, act=False), shortcut

    def fused_tail(self, y, shortcut):
        """The eval tail through `fused_cbam_tail` on the NHWC views;
        returns channels_last NCHW."""
        _eval_only(self)
        out = fused_cbam_tail(y.permute(0, 2, 3, 1), shortcut.permute(0, 2, 3, 1),
                              *self.ca.dense_kernels(), self.sa.hwio())
        return out.permute(0, 3, 1, 2)

    def module_tail(self, y, shortcut):
        """The same tail as the module composition of the JAX package."""
        return torch.relu(self.sa(self.ca(y)) + shortcut)

    def forward(self, x):
        return self.fused_tail(*self.body(x))


class DilatedBlock(nn.Module):
    """Four-branch dilated bottleneck (`blocks.py:228-245`): 1x1 | 3x3 d1 |
    3x3 d2 | 3x3 d4 (`conv1`..`conv4`, with bias), each out/4 channels,
    concat -> BN (`bn`) -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        f4 = out_ch // 4

        def conv(k, d):
            return Conv(in_ch, f4, k, padding=d * (k // 2), dilation=d, init=_INIT,
                        generator=generator)

        self.conv1, self.conv2 = conv(1, 1), conv(3, 1)
        self.conv3, self.conv4 = conv(3, 2), conv(3, 4)
        self.bn = Norm(out_ch)

    def forward(self, x):
        branches = [conv(x) for conv in (self.conv1, self.conv2, self.conv3, self.conv4)]
        return torch.relu(self.bn(torch.cat(branches, dim=1)))
