"""SegFormer-Lite (counterpart of `coastline/models/segformer_lite.py`): four
GELU patch-embedding ConvBNActs (7x7/4 to 32, 3x3/2 to 64, 128, 256: /4 to
/32), spatial-reduction attention (1, 2, 4 heads; reduction 8, 4, 2) and a
Mix-FFN (hidden 4x) as residual blocks on the first three stages, an
all-MLP decoder (each stage 1x1 to 256, bilinear to /4, concat, a 1x1
ConvBNAct), a 3x3 ConvBNAct head to 64, a 1x1 to the classes and a
bilinear upsample to the input size. 1,393,601 parameters with one class.

Module names follow the reference state_dict (`patch_embed1..4`,
`attn1..3.{q,kv,proj,reduction}`, `ffn1..3.{fc1,dwconv,fc2}`,
`linear_c4..c1`, `linear_fuse`, `head` = Sequential(conv, bn, relu, conv)),
so a reference `.pth` loads with `strict=True`.

The logits are upsampled and the sigmoid comes last, the JAX package's
documented ordering; `reference_ordering=True` takes the reference's
sigmoid before the upsample for the probabilities (it has no logits form,
so `return_logits=True` keeps the default ordering). Stage 1's attention
at 512^2 has 16,384 queries against 256 keys a head: its float32 scores are
128 MiB at batch 8. No conv is the fused kernel's: a forward launches no
kernel.

`dtype` is the compute dtype (parameters float32, cast at use; float32
logits); activations stay channels_last. H and W: multiples of 64.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ConvBNAct, EfficientSelfAttention, MixFFN
from coastline_torch.ops.primitives import Conv, Norm, bilinear_resize, global_size

STAGES = ((32, 1, 8), (64, 2, 4), (128, 4, 2))  # (channels, heads, reduction) of stages 1-3


class SegFormerLite(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32,
                 reference_ordering: bool = False):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype, self.reference_ordering = dtype, reference_ordering
        self.patch_embed1 = ConvBNAct(3, 32, 7, stride=4, act="gelu", generator=g)
        for i, (cin, cout) in enumerate(((32, 64), (64, 128), (128, 256)), 2):
            setattr(self, f"patch_embed{i}",
                    ConvBNAct(cin, cout, 3, stride=2, act="gelu", generator=g))
        for i, (c, heads, reduction) in enumerate(STAGES, 1):
            setattr(self, f"attn{i}", EfficientSelfAttention(c, heads, reduction, generator=g))
            setattr(self, f"ffn{i}", MixFFN(c, 4 * c, generator=g))
        for i, c in ((4, 256), (3, 128), (2, 64), (1, 32)):
            setattr(self, f"linear_c{i}", Conv(c, 256, 1, generator=g))
        self.linear_fuse = ConvBNAct(1024, 256, 1, generator=g)
        self.head = nn.Sequential(*ConvBNAct(256, 64, 3, generator=g),
                                  Conv(64, n_classes, 1, generator=g))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        size = global_size(x)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"patch_embed{i}")(x)
            if i < 4:
                x = x + getattr(self, f"attn{i}")(x)
                x = x + getattr(self, f"ffn{i}")(x)
            feats.append(x)
        quarter = global_size(feats[0])
        fused = [bilinear_resize(getattr(self, f"linear_c{i}")(feats[i - 1]), quarter)
                 for i in (4, 3, 2)] + [self.linear_c1(feats[0])]
        head = self.head(self.linear_fuse(torch.cat(fused, dim=1))).float()
        if self.reference_ordering and not return_logits:
            return bilinear_resize(torch.sigmoid(head), size)
        logits = bilinear_resize(head, size)
        return logits if return_logits else torch.sigmoid(logits)
