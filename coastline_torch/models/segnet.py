"""SegNet (counterpart of `coastline/models/segnet.py`): a VGG-style encoder of
ConvBNAct stages (64, 128, 256, 512 channels; 2, 2, 3, 3 convs) whose 2x2 max
pools keep each window's argmax, and a decoder that puts every value back at
its recorded position (max unpool) before its own ConvBNAct stages; a 3x3
head with bias. 15,278,593 parameters with one class.

Module names follow the reference state_dict (`enc1..enc4`, `dec4..dec1` as
Sequential(conv, bn, relu, ...), `dec1.3` the head), so a reference `.pth`
loads with `strict=True`. The pool and unpool carry no parameters.

`dtype` is the compute dtype (the JAX `dtype=`): the input is cast to it,
parameters stay float32 and are cast at use, and the logits come back as
float32. Activations stay channels_last, so the pool and unpool kernels
(`kernels/unpool.py`, 4 launches each a forward) and, in bf16, the fused conv
(`enc1` conv 2 and `dec1` conv 0) read their NHWC views without a copy. H and
W must be multiples of 16. In train mode no kernel runs: the convs take
cuDNN and train-mode BN, the pool and unpool their differentiable plain
formulations (`ops/primitives.py`), as the JAX SegNet differentiates its
XLA pool and unpool.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ConvStack
from coastline_torch.ops.primitives import max_pool_with_indices, max_unpool


class SegNet(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.enc1 = ConvStack((3, 64, 64), g)
        self.enc2 = ConvStack((64, 128, 128), g)
        self.enc3 = ConvStack((128, 256, 256, 256), g)
        self.enc4 = ConvStack((256, 512, 512, 512), g)
        self.dec4 = ConvStack((512, 512, 512, 256), g)
        self.dec3 = ConvStack((256, 256, 256, 128), g)
        self.dec2 = ConvStack((128, 128, 64), g)
        self.dec1 = ConvStack((64, 64), g, head=n_classes)

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        codes = []
        for enc in (self.enc1, self.enc2, self.enc3, self.enc4):
            x, c = max_pool_with_indices(enc(x), train=self.training)
            codes.append(c)
        for dec in (self.dec4, self.dec3, self.dec2, self.dec1):
            x = dec(max_unpool(x, codes.pop(), train=self.training))
        logits = x.float()
        return logits if return_logits else torch.sigmoid(logits)
