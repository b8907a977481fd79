"""Plain 2-class U-Net, the production serving model (counterpart of
`coastline/models/unet.py`): double-conv encoder 64 -> 1024, k2/s2
transposed-conv upsampling, concat skips `[up, skip]`, 1x1 head, raw logits.

Module names follow the reference state_dict (`enc1..enc4`, `bottleneck`,
`dec4..dec1` as Sequential(conv, bn, relu, conv, bn, relu), each a two-conv
`ConvStack`; `upconv4..1`, `final`), so a reference `.pth` loads with
`strict=True`.

`dtype` is the compute dtype (the JAX `dtype=`): the input is cast to it,
parameters stay float32 and are cast at use, and the logits come back as
float32. Activations are kept in channels_last memory, so the fused conv
kernel reads its NHWC input without a copy.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ConvStack
from coastline_torch.ops.primitives import Conv, ConvTranspose, max_pool


class UNet(nn.Module):
    def __init__(self, n_classes: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.enc1 = ConvStack((3, 64, 64), g)
        self.enc2 = ConvStack((64, 128, 128), g)
        self.enc3 = ConvStack((128, 256, 256), g)
        self.enc4 = ConvStack((256, 512, 512), g)
        self.bottleneck = ConvStack((512, 1024, 1024), g)
        self.upconv4 = ConvTranspose(1024, 512, generator=g)
        self.dec4 = ConvStack((1024, 512, 512), g)
        self.upconv3 = ConvTranspose(512, 256, generator=g)
        self.dec3 = ConvStack((512, 256, 256), g)
        self.upconv2 = ConvTranspose(256, 128, generator=g)
        self.dec2 = ConvStack((256, 128, 128), g)
        self.upconv1 = ConvTranspose(128, 64, generator=g)
        self.dec1 = ConvStack((128, 64, 64), g)
        self.final = Conv(64, n_classes, 1, generator=g)

    def forward(self, x, return_logits: bool = True):
        """(N, C, H, W) float -> (N, n_classes, H, W) float32 logits; like the
        JAX UNet it returns logits whatever `return_logits` says."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        e1 = self.enc1(x)
        e2 = self.enc2(max_pool(e1))
        e3 = self.enc3(max_pool(e2))
        e4 = self.enc4(max_pool(e3))
        bott = self.bottleneck(max_pool(e4))
        d4 = self.dec4(torch.cat([self.upconv4(bott), e4], dim=1))
        d3 = self.dec3(torch.cat([self.upconv3(d4), e3], dim=1))
        d2 = self.dec2(torch.cat([self.upconv2(d3), e2], dim=1))
        d1 = self.dec1(torch.cat([self.upconv1(d2), e1], dim=1))
        return self.final(d1).float()
