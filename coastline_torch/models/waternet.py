"""WaterNet (counterpart of `coastline/models/waternet.py`): a learnable
NDWI-style spectral-index head whose 4 maps are concatenated to the RGB
input (7 channels), a three-level double-conv U-Net (64, 128, 256) with a
512-channel bottleneck gated by a CBAM channel attention, k2/s2 transposed
convs, concat skips `[up, skip]` and a 1x1 head. 7,738,213 parameters with
one class.

Module names follow the reference state_dict (`water_index.index_conv`,
`enc1..enc3`, `bottleneck`, `dec3..dec1` as Sequential(conv, bn, relu, conv,
bn, relu), `water_attention.fc`, `up3..up1`, `outc.0`), so a reference
`.pth` loads with `strict=True`. Every conv has torch's default init, the
channel MLP too (the JAX layer's `conv_init="torch"`).

`dtype` is the compute dtype: the input is cast to it, parameters stay
float32 and are cast at use, and the logits come back as float32.
Activations stay channels_last, so in bf16 the fused conv (`enc1` and `dec1`
conv 2: 64 -> 64 at full resolution) and, in both dtypes, the bottleneck's
`fused_avg_max_pool` read their NHWC views without a copy: 2 + 1 launches a
bf16 forward, 1 in f32. In train mode no kernel runs (`ops/blocks.py`).
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ChannelAttention, ConvStack, WaterIndexModule
from coastline_torch.ops.primitives import Conv, ConvTranspose, max_pool


class WaterNet(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.water_index = WaterIndexModule(3, 4, generator=g)
        self.enc1 = ConvStack((7, 64, 64), g)
        self.enc2 = ConvStack((64, 128, 128), g)
        self.enc3 = ConvStack((128, 256, 256), g)
        self.bottleneck = ConvStack((256, 512, 512), g)
        self.water_attention = ChannelAttention(512, conv_init="torch", generator=g)
        self.up3 = ConvTranspose(512, 256, generator=g)
        self.dec3 = ConvStack((512, 256, 256), g)
        self.up2 = ConvTranspose(256, 128, generator=g)
        self.dec2 = ConvStack((256, 128, 128), g)
        self.up1 = ConvTranspose(128, 64, generator=g)
        self.dec1 = ConvStack((128, 64, 64), g)
        self.outc = nn.Sequential(Conv(64, n_classes, 1, generator=g))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`. H and W: multiples of 8."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = torch.cat([x, self.water_index(x)], dim=1)
        e1 = self.enc1(x)
        e2 = self.enc2(max_pool(e1))
        e3 = self.enc3(max_pool(e2))
        b = self.water_attention(self.bottleneck(max_pool(e3)))
        d3 = self.dec3(torch.cat([self.up3(b), e3], dim=1))
        d2 = self.dec2(torch.cat([self.up2(d3), e2], dim=1))
        d1 = self.dec1(torch.cat([self.up1(d2), e1], dim=1))
        logits = self.outc(d1).float()
        return logits if return_logits else torch.sigmoid(logits)
