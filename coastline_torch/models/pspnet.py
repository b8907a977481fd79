"""PSPNet (counterpart of `coastline/models/pspnet.py`): four 3x3/2
ConvBNActs (64, 128, 256, 512: /16), pyramid pooling at levels 1, 2, 3, 6
(512 -> 1024), a 3x3 ConvBNAct to 512, Dropout2d(0.1), a 1x1 to the
classes, and a bilinear upsample of the float32 logits to the input size.
6,537,217 parameters with one class.

Module names follow the reference state_dict (`conv1..conv4`,
`ppm.convs.{i}` = Sequential(pool, conv, bn, relu), `final_conv` =
Sequential(conv, bn, relu, dropout, conv)), so a reference `.pth` loads with
`strict=True`. At 512^2 the /16 map is 32 x 32, so levels 3 and 6 pool over
windows of unequal size (`adaptive_avg_pool`). No conv is the fused
kernel's: a forward launches no kernel.

`dtype` is the compute dtype (parameters float32, cast at use; float32
logits); activations stay channels_last. Dropout2d draws from the
generator `set_dropout_generator` hands it.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ConvBNAct, Dropout2d, PyramidPooling
from coastline_torch.ops.primitives import Conv, bilinear_resize, global_size


class PSPNet(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256), (256, 512)), 1):
            setattr(self, f"conv{i}", ConvBNAct(cin, cout, 3, stride=2, generator=g))
        self.ppm = PyramidPooling(512, generator=g)
        self.final_conv = nn.Sequential(*ConvBNAct(1024, 512, 3, generator=g), Dropout2d(0.1),
                                        Conv(512, n_classes, 1, generator=g))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        size = global_size(x)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = self.conv4(self.conv3(self.conv2(self.conv1(x))))
        logits = bilinear_resize(self.final_conv(self.ppm(x)).float(), size)
        return logits if return_logits else torch.sigmoid(logits)
