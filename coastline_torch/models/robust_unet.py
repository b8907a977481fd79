"""Robust U-Net, the paper's method (counterpart of `coastline/models/robust_unet.py`).

A four-level encoder of attention-augmented residual blocks (64 -> 512,
channel dropout .1/.1/.2/.2) with 2x2 max-pool downsampling; a bottleneck of
max-pool, the four-branch dilated block (512 -> 1024) and a residual block
(1024, .3); a decoder of k2/s2 transposed convs whose skips pass an attention
gate and are concatenated as `[gated skip, upsampled]`; a 1x1 head. Every
conv the model owns is drawn kaiming-normal fan_out (the transposed convs
keep torch's default), BN gamma = 1, beta = 0. 40,872,223 parameters at
base 64.

Module names follow the reference state_dict (`inc`, `down1`..`down3` and
`bottleneck` as Sequentials whose index 0 is the parameterless max-pool,
`up4`..`up1`, `att4`..`att1`, `dec4`..`dec1`, `outc.0`), so a reference
`.pth` loads with `strict=True`.

`dtype` is the compute dtype (the JAX `dtype=`): the input is cast to it,
parameters stay float32 and are cast at use, and the logits come back as
float32. Activations stay channels_last, so the CBAM kernels and the fused
conv read their NHWC views without a copy. Eval only until the training
slice (`remat` belongs to it too).
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import AttentionGate, DilatedBlock, ResidualBlock
from coastline_torch.ops.primitives import Conv, ConvTranspose


class RobustUNet(nn.Module):
    def __init__(self, n_classes: int = 1, base: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        b = base

        def rb(cin, cout, rate):
            return ResidualBlock(cin, cout, rate, generator=g)

        def down(cin, cout, rate):
            return nn.Sequential(nn.MaxPool2d(2), rb(cin, cout, rate))

        self.inc = rb(3, b, 0.1)
        self.down1 = down(b, 2 * b, 0.1)
        self.down2 = down(2 * b, 4 * b, 0.2)
        self.down3 = down(4 * b, 8 * b, 0.2)
        self.bottleneck = nn.Sequential(nn.MaxPool2d(2),
                                        DilatedBlock(8 * b, 16 * b, generator=g),
                                        rb(16 * b, 16 * b, 0.3))
        for level, (cin, rate) in zip((4, 3, 2, 1), ((16 * b, 0.2), (8 * b, 0.2),
                                                     (4 * b, 0.1), (2 * b, 0.1))):
            cout = cin // 2
            setattr(self, f"up{level}", ConvTranspose(cin, cout, generator=g))
            setattr(self, f"att{level}", AttentionGate(cout, cout, cout // 2, generator=g))
            setattr(self, f"dec{level}", rb(cin, cout, rate))
        self.outc = nn.Sequential(Conv(b, n_classes, 1, init="kaiming_out", generator=g))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        d = self.bottleneck(x4)
        for level, skip in ((4, x4), (3, x3), (2, x2), (1, x1)):
            d = getattr(self, f"up{level}")(d)
            gated = getattr(self, f"att{level}")(d, skip)
            d = getattr(self, f"dec{level}")(torch.cat([gated, d], dim=1))
        logits = self.outc(d).float()
        return logits if return_logits else torch.sigmoid(logits)
