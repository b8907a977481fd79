"""MSWNet (counterpart of `coastline/models/mswnet.py`): a four-level U-Net
whose encoder stages are multi-scale blocks (1x1 | 3x3 | 5x5 | 3x3 max pool
+ 1x1; 64, 128, 256, 512), a 1024-channel double-conv bridge, k2/s2
transposed convs and one 3x3 ConvBNAct a decoder level on the `[up, skip]`
concat, and a 1x1 head. 24,770,881 parameters with one class.

Module names follow the reference state_dict (`enc1..enc4.branch1..4`,
`bridge`, `up4..up1`, `dec4..dec1` as Sequential(conv, bn, relu), `outc.0`),
so a reference `.pth` loads with `strict=True`. No conv is the fused
kernel's (the only 64-output 3x3 reads 128 channels): a forward launches no
kernel.

`dtype` is the compute dtype (parameters float32, cast at use; float32
logits); activations stay channels_last. H and W: multiples of 16.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ConvBNAct, ConvStack, MultiScaleBlock
from coastline_torch.ops.primitives import Conv, ConvTranspose, max_pool


class MSWNet(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.enc1 = MultiScaleBlock(3, 64, generator=g)
        self.enc2 = MultiScaleBlock(64, 128, generator=g)
        self.enc3 = MultiScaleBlock(128, 256, generator=g)
        self.enc4 = MultiScaleBlock(256, 512, generator=g)
        self.bridge = ConvStack((512, 1024, 1024), g)
        for level, c in ((4, 512), (3, 256), (2, 128), (1, 64)):
            setattr(self, f"up{level}", ConvTranspose(2 * c, c, generator=g))
            setattr(self, f"dec{level}", ConvBNAct(2 * c, c, 3, generator=g))
        self.outc = nn.Sequential(Conv(64, n_classes, 1, generator=g))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        e1 = self.enc1(x)
        e2 = self.enc2(max_pool(e1))
        e3 = self.enc3(max_pool(e2))
        e4 = self.enc4(max_pool(e3))
        d = self.bridge(max_pool(e4))
        for level, skip in ((4, e4), (3, e3), (2, e2), (1, e1)):
            up = getattr(self, f"up{level}")(d)
            d = getattr(self, f"dec{level}")(torch.cat([up, skip], dim=1))
        logits = self.outc(d).float()
        return logits if return_logits else torch.sigmoid(logits)
