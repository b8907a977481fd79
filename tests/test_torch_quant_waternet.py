"""The port's int8 WaterNet vs the JAX package (CPU), on tests/test_quant.py's
fixture (the full-width WaterNet: its water-index head, the bottleneck's CBAM
channel gate pooling the int8 codes, three 2x2 transposed convs; BN statistics
from one train-mode pass, a (2, 64, 64, 3) input).

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
ARCH = "waternet"


@pytest.fixture(scope="module")
def model():
    return jax_fixture(ARCH)


@pytest.fixture(scope="module")
def scales(model):
    v, x = model
    return float_and_calibration_checks(ARCH, v, x, logits_atol=2e-3, probs_atol=2e-4)


def test_waternet_fold_and_quantize_bit_equal(model):
    fold_checks(ARCH, model[0])


def test_waternet_float_mode_and_calibration_match_jax(scales):
    assert sorted(scales) == sorted(["input", "wim.t", "in7", "ca.out"]
                                 + [f"{b}.{s}" for b in ("e1", "e2", "e3", "b", "d3", "d2", "d1")
                                    for s in ("t1", "out")]
                                 + [f"up{i}.out" for i in range(3)]
                                 + [f"cat{i}" for i in range(3)])


@pytest.mark.parametrize("policy", ["default", "all_float_convs"])
def test_waternet_int8_forward_matches_jax(model, scales, policy):
    v, x = model
    ref, got = int8_pair(ARCH, v, x, scales, POLICIES[policy])
    agree, dprob = agreement(ARCH, ref, got)
    assert got.shape == (2, 64, 64, 1)
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)


def test_waternet_int8_convs_a_forward(model, scales):
    """The convs the default policy puts on the int8 path, all through
    `int8_conv`: c1..c13 (c0 reads the 7-channel `in7` site) and the three
    transposed convs. None that JAX runs in int8 takes the float path."""
    v, x = model
    assert conv_census(ARCH, v, x, scales) == dict(
        int8=16, stride2=0, stride4=0,
        transposed2x2=3, transposed3x3=0, transposed4x4=0, cin144=0, leaky=0, missed=[])
