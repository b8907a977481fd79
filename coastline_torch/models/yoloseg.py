"""YOLO-SEG (counterpart of `coastline/models/yoloseg.py`): a Darknet-style
backbone of 3x3/1x1 ConvBNActs with LeakyReLU(0.1) and four 2x2 max pools
(/16, 256 channels), and a head of four k4/s2/p1 transposed convs, each ->
BN -> LeakyReLU (128, 64, 32, 16), then a 3x3 conv to the classes.
1,497,889 parameters with one class.

Module names follow the reference state_dict: `backbone` and `seg_head` are
flat Sequentials (convs at backbone 0, 4, 8, 11, 14, 18, 21, 24, BN after
each; transposed convs at seg_head 0, 3, 6, 9, the head conv at 12), so a
reference `.pth` loads with `strict=True`. No conv is the fused kernel's
(LeakyReLU, and no 64 -> 64 3x3): a forward launches no kernel.

`dtype` is the compute dtype (parameters float32, cast at use; float32
logits); activations stay channels_last. H and W: multiples of 16.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ConvBNAct
from coastline_torch.ops.primitives import Conv, ConvTranspose, MaxPool, Norm

# the backbone: (in, out, kernel) for a LeakyReLU ConvBNAct, "M" for a 2x2 max pool
BACKBONE = ((3, 32, 3), "M", (32, 64, 3), "M", (64, 128, 3), (128, 64, 1), (64, 128, 3), "M",
            (128, 256, 3), (256, 128, 1), (128, 256, 3), "M")


class YOLOSeg(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.backbone = nn.Sequential(*(
            m for spec in BACKBONE
            for m in ((MaxPool(2),) if spec == "M"
                      else ConvBNAct(*spec, act="leaky", generator=g))))
        head = []
        for cin, cout in ((256, 128), (128, 64), (64, 32), (32, 16)):
            head += [ConvTranspose(cin, cout, 4, 2, 1, generator=g), Norm(cout),
                     nn.LeakyReLU(0.1)]
        self.seg_head = nn.Sequential(*head, Conv(16, n_classes, 3, padding=1, generator=g))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        logits = self.seg_head(self.backbone(x)).float()
        return logits if return_logits else torch.sigmoid(logits)
