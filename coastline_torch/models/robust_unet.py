"""Robust U-Net, the paper's method (counterpart of `coastline/models/robust_unet.py`).

A four-level encoder of attention-augmented residual blocks (64 -> 512,
channel dropout .1/.1/.2/.2) with 2x2 max-pool downsampling; a bottleneck of
max-pool, the four-branch dilated block (512 -> 1024) and a residual block
(1024, .3); a decoder of k2/s2 transposed convs whose skips pass an attention
gate and are concatenated as `[gated skip, upsampled]`; a 1x1 head. Every
conv the model owns is drawn kaiming-normal fan_out (the transposed convs
keep torch's default), BN gamma = 1, beta = 0. 40,872,223 parameters at
base 64.

Module names follow the reference state_dict (`inc`, `down1`..`down3` and
`bottleneck` as Sequentials whose index 0 is the parameterless max-pool,
`up4`..`up1`, `att4`..`att1`, `dec4`..`dec1`, `outc.0`), so a reference
`.pth` loads with `strict=True`.

`dtype` is the compute dtype (the JAX `dtype=`): the input is cast to it,
parameters stay float32 and are cast at use, and the logits come back as
float32. Activations stay channels_last, so the CBAM kernels and the fused
conv read their NHWC views without a copy. In train mode no kernel runs
(`ops/blocks.py`).

`remat` (`coastline/models/robust_unet.py:35-73`) trades recompute for
activation memory in a train step: False keeps every intermediate; True
checkpoints each residual block, the dilated block and each attention gate
whole (`torch.utils.checkpoint`, recomputed in backward); "conv" keeps only
their convolution outputs and recomputes the elementwise chains between
them (a selective-checkpoint policy). All three give the same numbers and
load the same state_dict. A recompute must not redo what the forward did
once: `_Remat` replays each Dropout2d mask by restoring the block's
generator to where the forward drew it (checkpoint's own RNG restore covers
only the default generators), and keeps a recomputed train-mode BN from
moving its running statistics a second time.
"""

import functools
from typing import Union

import torch
from torch import nn
from torch.utils import checkpoint

from coastline_torch.ops.blocks import AttentionGate, DilatedBlock, Dropout2d, ResidualBlock
from coastline_torch.ops.primitives import Conv, ConvTranspose, MaxPool, Norm

REMAT_FLAVORS = (False, True, "conv")


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """The "conv" policy: must-save every convolution output, recompute the rest."""
    if op == torch.ops.aten.convolution.default:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


class _Remat:
    """One checkpointed call of `block(*args)`. The first call is the
    forward; a later one is a recompute in backward, which draws each
    Dropout2d mask again from the generator state the forward started from,
    leaves the generators as it found them, and moves no BN running
    statistic (`Norm.update_stats`). It touches no tensor itself: under the
    "conv" policy every tensor op of the block is matched against the
    forward's."""

    def __init__(self, block: nn.Module):
        self.block = block
        self.generators = list({id(m.generator): m.generator for m in block.modules()
                                if isinstance(m, Dropout2d) and m.generator is not None
                                }.values())
        self.norms = [m for m in block.modules() if isinstance(m, Norm)]
        self.start = None

    def __call__(self, *args):
        if self.start is None:
            self.start = [g.get_state() for g in self.generators]
            return self.block(*args)
        now = [g.get_state() for g in self.generators]
        for g, state in zip(self.generators, self.start):
            g.set_state(state)
        for m in self.norms:
            m.update_stats = False
        try:
            return self.block(*args)
        finally:
            for g, state in zip(self.generators, now):
                g.set_state(state)
            for m in self.norms:
                del m.update_stats  # back to the class's True


class RobustUNet(nn.Module):
    def __init__(self, n_classes: int = 1, base: int = 64, dtype: torch.dtype = torch.float32,
                 remat: Union[bool, str] = False):
        super().__init__()
        if remat not in REMAT_FLAVORS:
            raise ValueError(f"remat must be one of {REMAT_FLAVORS}, got {remat!r}")
        g = torch.Generator().manual_seed(0)  # the random init is seeded, as JAX's PRNGKey(0)
        self.dtype = dtype
        self.remat = remat
        b = base

        def rb(cin, cout, rate):
            return ResidualBlock(cin, cout, rate, generator=g)

        def down(cin, cout, rate):
            return nn.Sequential(MaxPool(2), rb(cin, cout, rate))

        self.inc = rb(3, b, 0.1)
        self.down1 = down(b, 2 * b, 0.1)
        self.down2 = down(2 * b, 4 * b, 0.2)
        self.down3 = down(4 * b, 8 * b, 0.2)
        self.bottleneck = nn.Sequential(MaxPool(2),
                                        DilatedBlock(8 * b, 16 * b, generator=g),
                                        rb(16 * b, 16 * b, 0.3))
        for level, (cin, rate) in zip((4, 3, 2, 1), ((16 * b, 0.2), (8 * b, 0.2),
                                                     (4 * b, 0.1), (2 * b, 0.1))):
            cout = cin // 2
            setattr(self, f"up{level}", ConvTranspose(cin, cout, generator=g))
            setattr(self, f"att{level}", AttentionGate(cout, cout, cout // 2, generator=g))
            setattr(self, f"dec{level}", rb(cin, cout, rate))
        self.outc = nn.Sequential(Conv(b, n_classes, 1, init="kaiming_out", generator=g))

    def _block(self, block: nn.Module, *args):
        """`block(*args)`, checkpointed as `self.remat` says when autograd
        records a train-mode forward."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return block(*args)
        context_fn = checkpoint.noop_context_fn
        if self.remat == "conv":
            context_fn = functools.partial(checkpoint.create_selective_checkpoint_contexts,
                                           _save_conv_outputs)
        return checkpoint.checkpoint(_Remat(block), *args, use_reentrant=False,
                                     context_fn=context_fn)

    def forward(self, x, return_logits: bool = False):
        """(N, 3, H, W) float -> (N, n_classes, H, W) float32 probabilities, or
        the logits with `return_logits=True`."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x1 = self._block(self.inc, x)
        x2 = self._block(self.down1[1], self.down1[0](x1))
        x3 = self._block(self.down2[1], self.down2[0](x2))
        x4 = self._block(self.down3[1], self.down3[0](x3))
        pool, dilated, res = self.bottleneck
        d = self._block(res, self._block(dilated, pool(x4)))
        for level, skip in ((4, x4), (3, x3), (2, x2), (1, x1)):
            d = getattr(self, f"up{level}")(d)
            gated = self._block(getattr(self, f"att{level}"), d, skip)
            d = self._block(getattr(self, f"dec{level}"), torch.cat([gated, d], dim=1))
        logits = self.outc(d).float()
        return logits if return_logits else torch.sigmoid(logits)
