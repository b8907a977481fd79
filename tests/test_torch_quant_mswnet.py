"""The port's int8 MSWNet vs the JAX package (CPU), on tests/test_quant.py's
fixture (the full-width MSWNet: multi-scale blocks (a 5x5 branch, a 3x3/1 max
pool on the codes), the 1024-channel bridge, four 2x2 transposed convs; BN
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
ARCH = "mswnet"


@pytest.fixture(scope="module")
def model():
    return jax_fixture(ARCH)


@pytest.fixture(scope="module")
def scales(model):
    v, x = model
    return float_and_calibration_checks(ARCH, v, x, logits_atol=2e-3, probs_atol=2e-4)


def test_mswnet_fold_and_quantize_bit_equal(model):
    fold_checks(ARCH, model[0])


def test_mswnet_float_mode_and_calibration_match_jax(scales):
    assert sorted(scales) == sorted(["input"]
                                 + [f"ms{i}.out" for i in range(4)]
                                 + [f"c{i}" for i in range(6)]
                                 + [f"up{i}.out" for i in range(4)]
                                 + [f"cat{i}" for i in range(4)])


@pytest.mark.parametrize("policy", ["default", "all_float_convs"])
def test_mswnet_int8_forward_matches_jax(model, scales, policy):
    v, x = model
    ref, got = int8_pair(ARCH, v, x, scales, POLICIES[policy])
    agree, dprob = agreement(ARCH, ref, got)
    assert got.shape == (2, 64, 64, 1)
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)


def test_mswnet_int8_convs_a_forward(model, scales):
    """The convs the default policy puts on the int8 path, all through
    `int8_conv`: ms2's and ms3's four branches, c0..c5 and the four
    transposed convs (ms0's and ms1's branches have 16 and 32 outputs: the
    float path). None that JAX runs in int8 takes the float path."""
    v, x = model
    assert conv_census(ARCH, v, x, scales) == dict(
        int8=18, stride2=0, stride4=0,
        transposed2x2=4, transposed3x3=0, transposed4x4=0, cin144=0, leaky=0, missed=[])
