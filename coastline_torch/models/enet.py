"""ENet (counterpart of `coastline/models/enet.py`): an initial block (a
3x3/2 conv beside a 2x2 max pool, 16 channels), encoder 1 (a downsampling
bottleneck to 64 and three more, channel dropout 0.01), encoder 2 (a
downsampling bottleneck to 128, then plain, dilated 2, asymmetric 5x1/1x5,
dilated 4, plain, dilated 8, asymmetric, dilated 16; dropout 0.1), and a
decoder of two k3/s2/p1/op1 transposed convs -> BN -> ReLU (64, 16) and a
k2/s2 transposed conv to the classes. 257,680 parameters with one class.

Module names follow the reference state_dict (`initial.conv`,
`initial.bn`; `encoder1.{0..3}`, `encoder2.{0..8}` with `conv_down`,
`conv1`, `conv2`, `conv3`; `decoder` a flat Sequential with the transposed
convs at 0, 3 and 6), so a reference `.pth` loads with `strict=True`. No
conv is the fused kernel's: a forward launches no kernel.

`dtype` is the compute dtype (parameters float32, cast at use; float32
logits); activations stay channels_last. H and W: multiples of 8. Every
Dropout2d draws from the generator `set_dropout_generator` hands it.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ENetBottleneck, ENetInitialBlock
from coastline_torch.ops.primitives import ConvTranspose, Norm

# encoder 2 after its downsampling block: (dilation, asymmetric)
ENCODER2 = ((1, False), (2, False), (1, True), (4, False), (1, False), (8, False), (1, True),
            (16, False))


class ENet(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.initial = ENetInitialBlock(3, 16, generator=g)
        self.encoder1 = nn.Sequential(
            ENetBottleneck(16, 64, downsample=True, dropout_rate=0.01, generator=g),
            *(ENetBottleneck(64, 64, dropout_rate=0.01, generator=g) for _ in range(3)))
        self.encoder2 = nn.Sequential(
            ENetBottleneck(64, 128, downsample=True, generator=g),
            *(ENetBottleneck(128, 128, dilation=d, asymmetric=a, generator=g) for d, a in ENCODER2))
        self.decoder = nn.Sequential(
            ConvTranspose(128, 64, 3, 2, 1, output_padding=1, generator=g), Norm(64), nn.ReLU(),
            ConvTranspose(64, 16, 3, 2, 1, output_padding=1, generator=g), Norm(16), nn.ReLU(),
            ConvTranspose(16, n_classes, 2, 2, generator=g))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        logits = self.decoder(self.encoder2(self.encoder1(self.initial(x)))).float()
        return logits if return_logits else torch.sigmoid(logits)
