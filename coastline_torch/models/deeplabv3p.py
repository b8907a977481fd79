"""DeepLabV3+ (counterpart of `coastline/models/deeplabv3p.py`): a simplified
strided backbone (7x7/2 ConvBNAct to 64, a 3x3/2 max pool, ConvBNActs to
128, 256 /2 and 512 /2: /16), ASPP (256), a decoder of four k4/s2/p1
transposed convs, each -> BN -> ReLU (128, 64, 32, 16), and a 3x3 conv to
the classes. 6,388,577 parameters with one class.

Module names follow the reference state_dict (`conv1..conv4`, `conv2`
leading with its parameterless max pool; `aspp.conv1..conv5`,
`aspp.conv_out`, `aspp.bn`; `decoder` a flat Sequential with the transposed
convs at 0, 3, 6, 9 and the head at 12), so a reference `.pth` loads with
`strict=True`. No conv is the fused kernel's: a forward launches no kernel.

`dtype` is the compute dtype (parameters float32, cast at use; float32
logits); activations stay channels_last. H and W: multiples of 16.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ASPP, ConvBNAct
from coastline_torch.ops.primitives import Conv, ConvTranspose, MaxPool, Norm


class DeepLabV3Plus(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.conv1 = ConvBNAct(3, 64, 7, stride=2, generator=g)
        self.conv2 = nn.Sequential(MaxPool(3, 2, 1), *ConvBNAct(64, 128, 3, generator=g))
        self.conv3 = ConvBNAct(128, 256, 3, stride=2, generator=g)
        self.conv4 = ConvBNAct(256, 512, 3, stride=2, generator=g)
        self.aspp = ASPP(512, 256, generator=g)
        decoder = []
        for cin, cout in ((256, 128), (128, 64), (64, 32), (32, 16)):
            decoder += [ConvTranspose(cin, cout, 4, 2, 1, generator=g), Norm(cout), nn.ReLU()]
        self.decoder = nn.Sequential(*decoder, Conv(16, n_classes, 3, padding=1, generator=g))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = self.conv4(self.conv3(self.conv2(self.conv1(x))))
        logits = self.decoder(self.aspp(x)).float()
        return logits if return_logits else torch.sigmoid(logits)
