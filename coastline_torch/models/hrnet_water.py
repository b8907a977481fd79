"""HRNet-Water (counterpart of `coastline/models/hrnet_water.py`): a stride-2
stem (64), three parallel branches at /2 (48), /4 (96) and /8 (192), the two
lower ones projected to 48 channels (1x1 + BN) and bilinearly upsampled to
the high branch, concatenated (144), a 3x3 ConvBNAct head to 64, a x2
bilinear upsample and a 1x1 to the classes. 822,593 parameters with one
class.

Module names follow the reference state_dict (`stem`, `hr_branch`,
`mr_branch`, `lr_branch` as Sequential(conv, bn, relu, conv, bn, relu);
`mr_to_hr`/`lr_to_hr` as Sequential(conv, bn); `head` = Sequential(conv,
bn, relu, upsample, conv)), so a reference `.pth` loads with `strict=True`.

`dtype` is the compute dtype (parameters float32, cast at use; float32
logits). Activations stay channels_last, so in bf16 the stem's second conv
(64 -> 64 at /2) takes the fused conv kernel: 1 launch a bf16 forward, 0 in
f32 and in train mode.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ConvStack, conv_bn
from coastline_torch.ops.primitives import Conv, Norm, bilinear_resize, global_size


class HRNetWater(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.stem = ConvStack((3, 64, 64), g, stride=2)
        self.hr_branch = ConvStack((64, 48, 48), g)
        self.mr_branch = ConvStack((64, 96, 96), g, stride=2)
        self.lr_branch = ConvStack((96, 192, 192), g, stride=2)
        self.mr_to_hr = nn.Sequential(Conv(96, 48, 1, generator=g), Norm(48))
        self.lr_to_hr = nn.Sequential(Conv(192, 48, 1, generator=g), Norm(48))
        self.head = nn.Sequential(Conv(144, 64, 3, padding=1, generator=g), Norm(64), nn.ReLU(),
                                  nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
                                  Conv(64, n_classes, 1, generator=g))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`. H and W: multiples of 8."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        stem = self.stem(x)
        hr = self.hr_branch(stem)
        mr = self.mr_branch(stem)
        lr = self.lr_branch(mr)
        size = global_size(hr)
        fused = torch.cat([hr, bilinear_resize(self.mr_to_hr(mr), size),
                           bilinear_resize(self.lr_to_hr(lr), size)], dim=1)
        h = conv_bn(self.head[0], self.head[1], fused, "relu")
        h = bilinear_resize(h, tuple(2 * d for d in global_size(h)))
        logits = self.head[4](h).float()
        return logits if return_logits else torch.sigmoid(logits)
