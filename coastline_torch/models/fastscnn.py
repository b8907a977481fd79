"""Fast-SCNN (counterpart of `coastline/models/fastscnn.py`): learning to
downsample (a bias-free 3x3/2 ConvBNAct to 32, depthwise-separable convs to
48 /2 and 64 /2: /8), a global feature extractor (depthwise-separable
bottlenecks at 64, 96 /2, 128, then pyramid pooling 128 -> 256), feature
fusion (both paths projected to 128 by a bias-free 1x1 + BN, the global one
bilinearly upsampled to /8, added, ReLU), a classifier of two
depthwise-separable convs and a 1x1, and a bilinear upsample of the float32
logits to the input size. 191,281 parameters with one class.

Module names follow the reference state_dict
(`learning_to_downsample.{conv1,dsconv1,dsconv2}`,
`global_feature_extractor.{block1,block2,block3,ppm}`,
`feature_fusion.{conv_low,conv_high}`, `classifier.{conv1,conv2,conv3}`),
so a reference `.pth` loads with `strict=True`. The depthwise convs run
cuDNN's grouped convolution; no conv is the fused kernel's (the 64-channel
3x3s are grouped): a forward launches no kernel.

`dtype` is the compute dtype (parameters float32, cast at use; float32
logits); activations stay channels_last.
"""

import torch
from torch import nn

from coastline_torch.ops.blocks import ConvBNAct, DepthwiseSeparableConv, PyramidPooling
from coastline_torch.ops.primitives import Conv, Norm, bilinear_resize, global_size


def _ds_stage(widths, first_stride, g):
    return nn.Sequential(*(DepthwiseSeparableConv(cin, cout, first_stride if j == 0 else 1,
                                                  generator=g)
                           for j, (cin, cout) in enumerate(zip(widths, widths[1:]))))


class FastSCNN(nn.Module):
    def __init__(self, n_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.learning_to_downsample = nn.ModuleDict(dict(
            conv1=ConvBNAct(3, 32, 3, stride=2, use_bias=False, generator=g),
            dsconv1=DepthwiseSeparableConv(32, 48, 2, generator=g),
            dsconv2=DepthwiseSeparableConv(48, 64, 2, generator=g)))
        self.global_feature_extractor = nn.ModuleDict(dict(
            block1=_ds_stage((64, 64, 64, 64), 1, g),
            block2=_ds_stage((64, 96, 96, 96), 2, g),
            block3=_ds_stage((96, 128, 128, 128), 1, g),
            ppm=PyramidPooling(128, generator=g)))

        def project(cin):
            return nn.Sequential(Conv(cin, 128, 1, use_bias=False, generator=g), Norm(128))

        self.feature_fusion = nn.ModuleDict(dict(conv_low=project(64), conv_high=project(256)))
        self.classifier = nn.ModuleDict(dict(
            conv1=DepthwiseSeparableConv(128, 128, generator=g),
            conv2=DepthwiseSeparableConv(128, 128, generator=g),
            conv3=Conv(128, n_classes, 1, generator=g)))

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        size = global_size(x)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        ltd, gfe = self.learning_to_downsample, self.global_feature_extractor
        low = ltd["dsconv2"](ltd["dsconv1"](ltd["conv1"](x)))
        g = gfe["ppm"](gfe["block3"](gfe["block2"](gfe["block1"](low))))
        high = bilinear_resize(self.feature_fusion["conv_high"](g), global_size(low))
        x = torch.relu(self.feature_fusion["conv_low"](low) + high)
        cls = self.classifier
        x = cls["conv3"](cls["conv2"](cls["conv1"](x)))
        logits = bilinear_resize(x.float(), size)
        return logits if return_logits else torch.sigmoid(logits)
