"""Building blocks of the ported models (counterpart of `coastline/ops/blocks.py`).

conv -> BN -> activation (`conv_bn`): in bf16, a 3x3 conv with 64 input
and 64 output channels, stride 1, padding 1, dilation 1 and one group,
followed by a ReLU or nothing, goes through the fused conv kernel with BN
and any conv bias folded into one per-channel affine (`_fusable`). The
UNet's two full-resolution 64->64 ConvBNActs, SegNet's `enc1` conv 2 and
`dec1` conv 0, the Robust U-Net's two 64-channel ResidualBlocks' second conv
(conv -> BN, no ReLU) and WaterNet's `enc1`/`dec1` second convs are that
shape, so each forward launches it twice; HRNet-Water's second stem conv
once; no conv of the other zoo models. Every other conv (strided, grouped,
dilated, leaky or gelu ones too), and everything in float32, runs
`F.conv2d` -> BN -> activation, as the JAX package leaves those to XLA. In
train mode no conv takes the fused kernel, which folds the running
statistics and has no gradient (the JAX package's train mode takes the
module path too, `coastline/ops/blocks.py:185-222`): `F.conv2d` ->
train-mode BN -> activation.

The Robust U-Net's blocks (`ops/blocks.py:30-245`): Dropout2d,
ChannelAttention, SpatialAttention, AttentionGate, ResidualBlock and
DilatedBlock, with the reference's state_dict names and the Robust U-Net's
init: every conv kaiming-normal fan_out, the channel MLP flax `he_normal`.
At eval a ResidualBlock ends in `kernels.cbam.fused_cbam_tail` (three CUDA
kernels on the card) for every shape; in train mode it takes
`ResidualBlock.module_tail`, the module composition the fused tail equals,
with `mean`/`amax` pooling in ChannelAttention: the CBAM kernels have no
backward, and the JAX package's train mode takes its module path too
(`coastline/ops/blocks.py:105-111,219-221`). Dropout2d draws its masks from
the generator `set_dropout_generator` hands it (the train state's).

The rest of the zoo's blocks (`ops/blocks.py:248-451`): ASPP,
PyramidPooling, DepthwiseSeparableConv, MultiScaleBlock, WaterIndexModule,
MixFFN, EfficientSelfAttention, ENetInitialBlock and ENetBottleneck, with
the reference's state_dict names (those `utils/torch_import.py`'s exporters
write) and torch's default init. WaterNet's bottleneck ChannelAttention
launches `fused_avg_max_pool` at eval; no other block of these launches a
kernel.

In a row split (`parallel.collectives.split_rows`) the layers fetch their
rows (`ops/primitives.py`); the blocks add what needs the whole image:
ChannelAttention's train-mode mean and max over the ranks' rows, the
pyramid's and ASPP's pooled maps whole on every rank, and attention's
reduced keys and values gathered over the ranks.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from coastline_torch.kernels.cbam import channel_gate, fused_cbam_tail
from coastline_torch.kernels.fused_conv import fused_conv3x3_bn_relu
from coastline_torch.kernels.pools import fused_avg_max_pool
from coastline_torch.ops.primitives import (AdaptiveAvgPool, Conv, MaxPool, Norm,
                                             avg_pool_global, global_size, max_pool, pair,
                                             resize_whole)
from coastline_torch.parallel import collectives

_INIT = "kaiming_out"  # every conv of the Robust U-Net's blocks (`Main_Final.py:282-288`)
_ACT_MODULES = {"relu": nn.ReLU, "leaky": lambda: nn.LeakyReLU(0.1),
                "gelu": nn.GELU, "none": nn.Identity}
ACTS = tuple(_ACT_MODULES)


def fold_bn(conv: Conv, norm: Norm):
    """(w HWIO, scale, bias) in float32 with conv -> norm == conv(x, w) * scale
    + bias: scale = gamma / sqrt(var + eps), bias = beta + (b - mean) * scale
    for a conv with bias b, beta - mean * scale for one without."""
    scale, shift = norm.folded()
    if conv.bias is not None:
        shift = norm.bias + (conv.bias - norm.running_mean) * scale
    return conv.weight.permute(2, 3, 1, 0), scale, shift


def _fusable(conv: Conv, x: torch.Tensor, act: str) -> bool:
    """Whether conv -> BN -> `act` on `x` is the fused kernel's function: a
    bf16 3x3 conv, 64 -> 64 channels, stride 1, padding 1, dilation 1, one
    group, followed by a ReLU or nothing (the kernel's epilogue knows no
    other activation)."""
    return (x.dtype == torch.bfloat16 and conv.in_ch == conv.out_ch == 64 and conv.groups == 1
            and conv.kernel_size == (3, 3) and conv.padding == (1, 1)
            and conv.stride == (1, 1) and conv.dilation == (1, 1) and act in ("relu", "none"))


def activation(x, act: str):
    """The JAX ConvBNAct's activations (`blocks.py:69-76`): relu, leaky
    (slope 0.1), gelu (exact, erf) or none, in x.dtype."""
    if act == "relu":
        return F.relu(x)
    if act == "leaky":
        return F.leaky_relu(x, 0.1)
    if act == "gelu":
        return F.gelu(x, approximate="none")
    if act == "none":
        return x
    raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def conv_bn(conv: Conv, norm: Norm, x: torch.Tensor, act: str):
    """conv -> BN -> `act` ('relu', 'leaky', 'gelu' or 'none') on NCHW `x`.
    At eval a `_fusable` conv takes the fused kernel, which needs `x` in
    channels_last memory (its NHWC permute is then contiguous) and returns
    channels_last; in train mode every conv is `F.conv2d`."""
    if not norm.training and _fusable(conv, x, act):
        w, scale, bias = fold_bn(conv, norm)
        y = fused_conv3x3_bn_relu(x.permute(0, 2, 3, 1), w, scale, bias, relu=act == "relu")
        return y.permute(0, 3, 1, 2)
    return activation(norm(conv(x)), act)


class ConvBNAct(nn.Sequential):
    """Sequential(conv, bn, act) — the reference's state_dict layout
    (indices 0 and 1) — with the JAX layer's options (`blocks.py:42-76`):
    kernel, stride, padding (default kernel // 2), dilation, groups,
    `use_bias` and `act`; its forward is `conv_bn`. The third entry is a
    parameterless module that names the activation."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride=1, padding=None,
                 dilation=1, groups: int = 1, use_bias: bool = True, act: str = "relu",
                 generator=None):
        if act not in ACTS:
            raise ValueError(f"act must be one of {ACTS}, got {act!r}")
        if padding is None:
            padding = tuple(k // 2 for k in pair(kernel_size))
        conv = Conv(in_ch, out_ch, kernel_size, padding=padding, dilation=dilation,
                    use_bias=use_bias, generator=generator, stride=stride, groups=groups)
        super().__init__(conv, Norm(out_ch), _ACT_MODULES[act]())
        self.act = act

    def forward(self, x):
        return conv_bn(self[0], self[1], x, self.act)


class ConvStack(nn.Sequential):
    """3x3 ConvBNActs of `widths` (in, out 1, out 2, ...) flattened into one
    Sequential, conv at 3j and BN at 3j + 1 — the reference's layout of the
    UNet's and WaterNet's double convs, SegNet's stages and HRNet-Water's
    branches — optionally followed by a `head`: a 3x3 conv with bias to that
    many channels, without BN (SegNet's `dec1.3`). `stride` applies to the
    first conv (HRNet-Water's stem and downsampling branches)."""

    def __init__(self, widths, generator=None, head: Optional[int] = None, stride: int = 1):
        layers = [m for j, (cin, cout) in enumerate(zip(widths, widths[1:]))
                  for m in ConvBNAct(cin, cout, stride=stride if j == 0 else 1,
                                     generator=generator)]
        if head is not None:
            layers.append(Conv(widths[-1], head, 3, padding=1, generator=generator))
        super().__init__(*layers)
        self.n_convs = len(widths) - 1

    def forward(self, x):
        for j in range(self.n_convs):
            x = conv_bn(self[3 * j], self[3 * j + 1], x, "relu")
        return x if len(self) == 3 * self.n_convs else self[-1](x)


class Dropout2d(nn.Module):
    """Channel dropout (`blocks.py:30-39`): the identity at eval; in train
    mode one Bernoulli keep-mask per (sample, channel), drawn from
    `self.generator` (the torch default generator while it is None), and
    `where(keep, x / (1 - rate), 0)` as flax's Dropout computes it. The
    masks are not the JAX package's: the random streams differ by design.
    With `rows = (start, total)` the input is rows [start, start + N) of a
    batch of `total` split over ranks: the masks are drawn for the whole
    batch and this rank keeps its rows, so they equal one process's. The
    ranks of a space group hold the same samples and the same generator
    state, so they draw the same (N, C) mask for their rows of them."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.rows: Optional[Tuple[int, int]] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rows is None:
            keep = torch.rand(x.shape[:2], generator=self.generator, device=x.device)
        else:
            start, total = self.rows
            keep = torch.rand((total, x.shape[1]), generator=self.generator,
                              device=x.device)[start:start + x.shape[0]]
        keep = keep >= self.rate
        return torch.where(keep[:, :, None, None], x / (1.0 - self.rate), 0.0)


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator],
                          rows: Optional[Tuple[int, int]] = None):
    """Every Dropout2d of `model` draws from `generator` from now on (the
    train epoch hands it the train state's, after the augmentation's draws),
    for rows `rows` = (start, total) of a split batch, or the whole batch."""
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator
            m.rows = rows


class ChannelAttention(nn.Module):
    """CBAM channel gate (`blocks.py:79-114`): x * sigmoid(mlp(avg) +
    mlp(max)) over the global average- and max-pooled channels, mlp = two
    bias-free 1x1 convs (`fc.0`, `fc.2`, ratio 16) with a ReLU between.
    `conv_init` is the JAX layer's (`blocks.py:94-100`): 'kaiming_out' (the
    Robust U-Net's) draws the MLP from flax's `he_normal`, 'torch' (WaterNet's)
    from flax's variance_scaling(1/3, fan_in, uniform), U(+-1/sqrt(fan_in)),
    torch's conv default. At eval the pooling is
    `kernels.pools.fused_avg_max_pool`; in train mode `mean` (summed in
    float32) and `amax`, which autograd differentiates."""

    def __init__(self, channels: int, conv_init: str = "torch", generator=None):
        super().__init__()
        hidden = channels // 16
        init = {"kaiming_out": "he_normal", "torch": "torch"}[conv_init]

        def fc(cin, cout):
            return Conv(cin, cout, 1, use_bias=False, init=init, generator=generator)

        self.fc = nn.Sequential(fc(channels, hidden), nn.ReLU(), fc(hidden, channels))

    def dense_kernels(self):
        """(fc1 (C, C // r), fc2 (C // r, C)): the MLP in the JAX Dense layout."""
        return self.fc[0].weight[:, :, 0, 0].t(), self.fc[2].weight[:, :, 0, 0].t()

    def forward(self, x):
        split = collectives.row_split()
        if self.training and split is None:
            avg = x.mean((2, 3), dtype=torch.float32).to(x.dtype)
            mx = x.amax((2, 3))
        elif self.training:  # the float32 sums and the maxima of every rank's rows
            total = collectives.all_reduce_grad(x.sum((2, 3), dtype=torch.float32), split.group)
            avg = (total / (split.height(x) * x.shape[3])).to(x.dtype)
            mx = collectives.global_max(x.amax((2, 3)), split.group)
        else:
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
    identity. At eval the tail after bn2 is `fused_cbam_tail`, in train
    mode `module_tail`."""

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
        self.ca = ChannelAttention(out_ch, conv_init=_INIT, generator=generator)
        self.sa = SpatialAttention(generator=generator)

    def body(self, x):
        """(bn2 output, shortcut): everything before the CBAM tail."""
        shortcut = x if self.shortcut is None else self.shortcut(x)
        out = self.dropout(conv_bn(self.conv1, self.bn1, x, "relu"))
        return conv_bn(self.conv2, self.bn2, out, "none"), shortcut

    def fused_tail(self, y, shortcut):
        """The eval tail through `fused_cbam_tail` on the NHWC views;
        returns channels_last NCHW."""
        out = fused_cbam_tail(y.permute(0, 2, 3, 1), shortcut.permute(0, 2, 3, 1),
                              *self.ca.dense_kernels(), self.sa.hwio())
        return out.permute(0, 3, 1, 2)

    def module_tail(self, y, shortcut):
        """The same tail as the module composition of the JAX package."""
        return torch.relu(self.sa(self.ca(y)) + shortcut)

    def forward(self, x):
        tail = self.module_tail if self.training else self.fused_tail
        return tail(*self.body(x))


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


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (`blocks.py:248-266`): 1x1 (`conv1`),
    3x3 at dilations 6, 12, 18 (`conv2`..`conv4`) and a 1x1 of the global
    average resized back from 1x1 (`conv5`), concat -> 1x1 (`conv_out`) ->
    BN (`bn`) -> ReLU; every conv with bias."""

    def __init__(self, in_ch: int, features: int, generator=None):
        super().__init__()

        def conv(cin, k, d=1):
            return Conv(cin, features, k, padding=d * (k // 2), dilation=d, generator=generator)

        self.conv1 = conv(in_ch, 1)
        self.conv2, self.conv3, self.conv4 = (conv(in_ch, 3, d) for d in (6, 12, 18))
        self.conv5 = conv(in_ch, 1)
        self.conv_out = conv(5 * features, 1)
        self.bn = Norm(features)

    def forward(self, x):
        pooled = resize_whole(self.conv5(avg_pool_global(x)), global_size(x))
        branches = [conv(x) for conv in (self.conv1, self.conv2, self.conv3, self.conv4)]
        return torch.relu(self.bn(self.conv_out(torch.cat(branches + [pooled], dim=1))))


class PyramidPooling(nn.Module):
    """PSP pyramid pooling (`blocks.py:269-288`): for each level k in
    `pool_sizes`, adaptive average pool to k x k -> 1x1 conv to C / 4 -> BN
    -> ReLU -> bilinear back to H x W; concat with the input (2C channels).
    `convs.{i}` is Sequential(pool, conv, BN, ReLU), the reference's layout.
    In a row split the pooled level is whole on every rank, its conv, BN
    and ReLU run as one process's (`collectives.whole_rows`), and each rank
    resizes it to its own rows."""

    def __init__(self, in_ch: int, pool_sizes=(1, 2, 3, 6), generator=None):
        super().__init__()
        branch = in_ch // len(pool_sizes)
        self.convs = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(k), Conv(in_ch, branch, 1, generator=generator),
                          Norm(branch), nn.ReLU())
            for k in pool_sizes)

    def forward(self, x):
        size, outs = global_size(x), [x]
        for pool, conv, norm, relu in self.convs:
            pooled = pool(x)
            with collectives.whole_rows():
                outs.append(relu(norm(conv(pooled))))
            outs[-1] = resize_whole(outs[-1], size)
        return torch.cat(outs, dim=1)


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3x3 (`depthwise`, groups = C, stride 1 or 2) -> pointwise
    1x1 (`pointwise`) -> BN (`bn`) -> ReLU, both convs bias-free
    (`blocks.py:291-306`)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, generator=None):
        super().__init__()
        self.depthwise = Conv(in_ch, in_ch, 3, padding=1, use_bias=False, generator=generator,
                              stride=stride, groups=in_ch)
        self.pointwise = Conv(in_ch, features, 1, use_bias=False, generator=generator)
        self.bn = Norm(features)

    def forward(self, x):
        return torch.relu(self.bn(self.pointwise(self.depthwise(x))))


class MultiScaleBlock(nn.Module):
    """MSWNet's four-branch block (`blocks.py:309-323`): ConvBNActs 1x1, 3x3
    and 5x5 (`branch1`..`branch3`) and a 3x3/1 max pool then a 1x1
    ConvBNAct (`branch4` = Sequential(pool, conv, BN, ReLU)), each
    features / 4 channels, concatenated."""

    def __init__(self, in_ch: int, features: int, generator=None):
        super().__init__()
        f4 = features // 4
        self.branch1 = ConvBNAct(in_ch, f4, 1, generator=generator)
        self.branch2 = ConvBNAct(in_ch, f4, 3, generator=generator)
        self.branch3 = ConvBNAct(in_ch, f4, 5, generator=generator)
        self.branch4 = nn.Sequential(MaxPool(3, 1, 1),
                                     *ConvBNAct(in_ch, f4, 1, generator=generator))

    def forward(self, x):
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x), self.branch4(x)],
                         dim=1)


class WaterIndexModule(nn.Module):
    """WaterNet's learnable spectral-index head (`blocks.py:326-339`):
    `index_conv` = Sequential(1x1 to 16, BN, ReLU, 1x1 to `n_indices`), then
    a sigmoid taken in float32 and cast back to the compute dtype."""

    def __init__(self, in_ch: int = 3, n_indices: int = 4, generator=None):
        super().__init__()
        self.index_conv = nn.Sequential(Conv(in_ch, 16, 1, generator=generator), Norm(16),
                                        nn.ReLU(), Conv(16, n_indices, 1, generator=generator))

    def forward(self, x):
        return torch.sigmoid(self.index_conv(x).float()).to(x.dtype)


class MixFFN(nn.Module):
    """SegFormer's Mix-FFN (`blocks.py:342-354`): 1x1 to `hidden` (`fc1`) ->
    depthwise 3x3 (`dwconv`, groups = hidden) -> exact GELU -> 1x1 back
    (`fc2`); every conv with bias."""

    def __init__(self, channels: int, hidden: int, generator=None):
        super().__init__()
        self.fc1 = Conv(channels, hidden, 1, generator=generator)
        self.dwconv = Conv(hidden, hidden, 3, padding=1, generator=generator, groups=hidden)
        self.fc2 = Conv(hidden, channels, 1, generator=generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x)), approximate="none"))


class EfficientSelfAttention(nn.Module):
    """Spatial-reduction attention (`blocks.py:357-388`): queries from a 1x1
    conv of the full map (`q`), keys and values from a 1x1 conv (`kv`) of a
    `reduction` x `reduction`, stride-`reduction` conv of it (`reduction`),
    `num_heads` heads, then a 1x1 projection (`proj`). As the JAX package
    computes it, outside any kernel: two batched matmuls in the compute
    dtype, the scores scaled after the first, the softmax in float32 cast
    back. (`F.scaled_dot_product_attention` would round otherwise in bf16.)
    In a row split the queries stay this rank's; the reduction conv's
    stride-`reduction` windows start at global multiples of it
    (`ops/primitives.py`), and the reduced keys and values are gathered
    over the ranks in image order, so every query sees them all."""

    def __init__(self, channels: int, num_heads: int, reduction: int, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.q = Conv(channels, channels, 1, generator=generator)
        self.kv = Conv(channels, 2 * channels, 1, generator=generator)
        self.proj = Conv(channels, channels, 1, generator=generator)
        self.reduction = Conv(channels, channels, reduction, generator=generator,
                              stride=reduction)

    def forward(self, x):
        n, c, h, w = x.shape
        heads, dh = self.num_heads, c // self.num_heads
        q = self.q(x).reshape(n, heads, dh, h * w).transpose(2, 3)
        kv = self.kv(self.reduction(x))
        split = collectives.row_split()
        if split is not None:
            kv = collectives.gather_rows(kv, split)
        kv = kv.flatten(2)
        k = kv[:, :c].reshape(n, heads, dh, -1)            # (n, heads, dh, keys)
        v = kv[:, c:].reshape(n, heads, dh, -1).transpose(2, 3)
        scores = torch.matmul(q, k) * dh ** -0.5
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(2, 3).reshape(n, c, h, w)
        return self.proj(out.contiguous(memory_format=torch.channels_last))


class ENetInitialBlock(nn.Module):
    """ENet's stem (`blocks.py:391-406`): a bias-free 3x3/2 conv to
    `features - in` channels (`conv`) concatenated with a 2x2 max pool of
    the input, BN (`bn`), ReLU."""

    def __init__(self, in_ch: int = 3, features: int = 16, generator=None):
        super().__init__()
        self.conv = Conv(in_ch, features - in_ch, 3, padding=1, use_bias=False,
                         generator=generator, stride=2)
        self.bn = Norm(features)

    def forward(self, x):
        return torch.relu(self.bn(torch.cat([self.conv(x), max_pool(x, 2, 2)], dim=1)))


class ENetBottleneck(nn.Module):
    """ENet bottleneck (`blocks.py:409-451`), every conv bias-free, internal
    width in / 4: `conv1` a 1x1 ConvBNAct (stride 2 when downsampling);
    `conv2` a 3x3 at `dilation` -> BN -> ReLU, or with `asymmetric` a 5x1
    and a 1x5, each -> BN -> ReLU; `conv3` a 1x1 -> BN -> Dropout2d; then
    ReLU(out + identity). Downsampling, the identity is a 2x2 max pool -> 1x1
    -> BN (`conv_down`)."""

    def __init__(self, in_ch: int, features: int, dilation: int = 1, asymmetric: bool = False,
                 downsample: bool = False, dropout_rate: float = 0.1, generator=None):
        super().__init__()
        internal = in_ch // 4

        def conv(cin, cout, k, padding=0, d=1):
            return Conv(cin, cout, k, padding=padding, dilation=d, use_bias=False,
                        generator=generator)

        self.conv_down = (nn.Sequential(conv(in_ch, features, 1), Norm(features))
                          if downsample else None)
        self.conv1 = ConvBNAct(in_ch, internal, 1, stride=2 if downsample else 1,
                               use_bias=False, generator=generator)
        if asymmetric:
            self.conv2 = nn.Sequential(conv(internal, internal, (5, 1), (2, 0)), Norm(internal),
                                       nn.ReLU(), conv(internal, internal, (1, 5), (0, 2)),
                                       Norm(internal), nn.ReLU())
        else:
            self.conv2 = nn.Sequential(conv(internal, internal, 3, dilation, dilation),
                                       Norm(internal), nn.ReLU())
        self.conv3 = nn.Sequential(conv(internal, features, 1), Norm(features),
                                   Dropout2d(dropout_rate))

    def forward(self, x):
        identity = x if self.conv_down is None else self.conv_down(max_pool(x, 2, 2))
        return torch.relu(self.conv3(self.conv2(self.conv1(x))) + identity)
