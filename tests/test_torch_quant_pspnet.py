"""The port's int8 PSPNet vs the JAX package (CPU), on tests/test_quant.py's
fixture (the full-width PSPNet: four stride-2 stem convs, the pyramid's 1x1
convs on adaptive average pools, a float32 bilinear resize of the logits; BN
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
ARCH = "pspnet"


@pytest.fixture(scope="module")
def model():
    return jax_fixture(ARCH)


@pytest.fixture(scope="module")
def scales(model):
    v, x = model
    return float_and_calibration_checks(ARCH, v, x, logits_atol=2e-3, probs_atol=2e-4)


def test_pspnet_fold_and_quantize_bit_equal(model):
    fold_checks(ARCH, model[0])


def test_pspnet_float_mode_and_calibration_match_jax(scales):
    assert sorted(scales) == sorted(["input", "ppm.cat"]
                                 + [f"c{i}" for i in range(5)]
                                 + [f"ppm{k}.in" for k in range(4)])


@pytest.mark.parametrize("policy", ["default", "all_float_convs"])
def test_pspnet_int8_forward_matches_jax(model, scales, policy):
    v, x = model
    ref, got = int8_pair(ARCH, v, x, scales, POLICIES[policy])
    agree, dprob = agreement(ARCH, ref, got)
    assert got.shape == (2, 64, 64, 1)
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)


def test_pspnet_int8_convs_a_forward(model, scales):
    """The convs the default policy puts on the int8 path, all through
    `int8_conv`: c1..c3 at stride 2, the four pyramid convs (on 1x1 to 4x4
    maps here) and c4. None that JAX runs in int8 takes the float path."""
    v, x = model
    assert conv_census(ARCH, v, x, scales) == dict(
        int8=8, stride2=3, stride4=0,
        transposed2x2=0, transposed3x3=0, transposed4x4=0, cin144=0, leaky=0, missed=[])
