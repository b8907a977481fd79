"""Weight initializers (counterpart of `coastline/ops/initializers.py:20-68`).

Each fills a torch-layout tensor in place from an explicit `torch.Generator`
(conv weights (out, in, kh, kw), transposed-conv weights (in, out, kh, kw)):

  * PyTorch's layer defaults: conv and transposed-conv weights and biases
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), where a transposed conv's fan_in
    is out * kh * kw, as torch computes it;
  * `kaiming_normal_fanout_`: N(0, sqrt(2 / fan_out)), fan_out = out * kh *
    kw, every conv the Robust U-Net owns (`Main_Final.py:282-288`);
  * `he_normal_`: flax's `he_normal`, a truncated normal on fan_in with std
    sqrt(2 / fan_in) / 0.87962566 cut at +-2 std. The JAX package gives it
    to ChannelAttention's MLP under `kaiming_out` (`ops/blocks.py:94-97`),
    where the reference's init loop would give its 1x1 convs kaiming-normal
    fan_out. The port follows the JAX package, its reference.

The same seed draws other numbers than `jax.random`; parity tests load the
same numpy weights into both packages instead.
"""

import math
from typing import Optional

import torch

# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides by it
_TRUNC_STD = 0.87962566103423978


def _fans(w: torch.Tensor):
    """torch conv layout (out, in, kh, kw) -> (fan_in, fan_out)."""
    receptive = math.prod(w.shape[2:])
    return w.shape[1] * receptive, w.shape[0] * receptive


def uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def torch_conv_kernel_init_(w, generator=None):
    """torch Conv2d default: U(+-1/sqrt(fan_in))."""
    return uniform_(w, 1.0 / math.sqrt(_fans(w)[0]), generator)


def torch_convt_kernel_init_(w, generator=None):
    """torch ConvTranspose2d default on an (in, out, kh, kw) weight: fan_in
    is out * kh * kw."""
    return uniform_(w, 1.0 / math.sqrt(math.prod(w.shape[1:])), generator)


def torch_bias_init_(b, fan_in: int, generator=None):
    """torch layer-default bias: U(+-1/sqrt(fan_in))."""
    return uniform_(b, 1.0 / math.sqrt(fan_in), generator)


def kaiming_normal_fanout_(w, generator=None):
    """He-normal, fan_out mode, ReLU gain: N(0, sqrt(2 / fan_out))."""
    with torch.no_grad():
        return w.normal_(0.0, math.sqrt(2.0 / _fans(w)[1]), generator=generator)


def he_normal_(w, generator=None):
    """flax `he_normal`: truncated normal on fan_in, std sqrt(2 / fan_in) /
    0.87962566, cut at +-2 std."""
    std = math.sqrt(2.0 / _fans(w)[0]) / _TRUNC_STD
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)
