"""The port's int8 ENet vs the JAX package (CPU), on tests/test_quant.py's
fixture (the full-width ENet: the initial block with its pool slice's BN
affine, 13 bottlenecks (downsampling, dilated, asymmetric), two folded 3x3
transposed convs with output padding and a 2x2 transposed head; BN
statistics from one train-mode pass, a (2, 64, 64, 3) input).

Tolerances: the fold and its quantization bit-equal; the float32 float
mode within atol 2e-4 of JAX's probabilities and 2e-3 of its logits; bf16
calibration scales within rtol 2e-2; the int8 forward, with JAX's scales
fed to both sides and JAX run op by op (see test_torch_quant_unet.py),
>= 99% mask agreement and mean |d prob| <= 0.01 under the default and the
all-float-conv policies (the split-cat and gated policies do not touch this
forward).
"""

import pytest
import torch

from test_torch_quant import (POLICIES, agreement, conv_census, float_and_calibration_checks,
                              fold_checks, int8_pair, jax_fixture)

torch.set_num_threads(1)
ARCH = "enet"


@pytest.fixture(scope="module")
def model():
    return jax_fixture(ARCH)


@pytest.fixture(scope="module")
def scales(model):
    v, x = model
    return float_and_calibration_checks(ARCH, v, x, logits_atol=2e-3, probs_atol=2e-4)


def test_enet_fold_and_quantize_bit_equal(model):
    fold_checks(ARCH, model[0])


def test_enet_float_mode_and_calibration_match_jax(scales):
    mids = [f"bn{i}.m2" for i in (7, 11)]
    assert sorted(scales) == sorted(["input", "init.out", "up0.out", "up1.out"] + mids
                                 + [f"bn{i}.{s}" for i in range(13) for s in ("r", "m1", "out")])


@pytest.mark.parametrize("policy", ["default", "all_float_convs"])
def test_enet_int8_forward_matches_jax(model, scales, policy):
    v, x = model
    ref, got = int8_pair(ARCH, v, x, scales, POLICIES[policy])
    agree, dprob = agreement(ARCH, ref, got)
    assert got.shape == (2, 64, 64, 1)
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)


def test_enet_int8_convs_a_forward(model, scales):
    """The convs the default policy puts on the int8 path, all through
    `int8_conv`: bn4's pooled projection (64 -> 128) and up0 (3x3
    transposed, 128 -> 64). Every bottleneck conv inside has 4 to 32
    channels and up1 16 outputs: float path, as in JAX; none that JAX runs
    in int8 takes the float path."""
    v, x = model
    assert conv_census(ARCH, v, x, scales) == dict(
        int8=2, stride2=0, stride4=0,
        transposed2x2=0, transposed3x3=1, transposed4x4=0, cin144=0, leaky=0, missed=[])
