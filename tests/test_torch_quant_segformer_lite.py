"""The port's int8 SegFormer-Lite vs the JAX package (CPU), on
tests/test_quant.py's fixture (the full-width SegFormer-Lite: four GELU
patch embeds, spatial-reduction attention (the stride-8, 4 and 2
reductions) and Mix-FFNs with grouped depthwise 3x3s on three stages, the
all-MLP decoder, a float32 bilinear resize of the logits; BN statistics
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
ARCH = "segformer_lite"


@pytest.fixture(scope="module")
def model():
    return jax_fixture(ARCH)


@pytest.fixture(scope="module")
def scales(model):
    v, x = model
    return float_and_calibration_checks(ARCH, v, x, logits_atol=2e-3, probs_atol=2e-4)


def test_segformer_lite_fold_and_quantize_bit_equal(model):
    fold_checks(ARCH, model[0])


def test_segformer_lite_float_mode_and_calibration_match_jax(scales):
    per_stage = [f"{k}{i}.{s}" for i in range(3)
                 for k, s in (("c", "a"), ("c", "f"), ("esa", "xr"), ("esa", "o"), ("ffn", "h"),
                              ("ffn", "g"))]
    assert sorted(scales) == sorted(["input", "dec.cat", "c4f", "c5h"]
                                 + [f"c{i}" for i in range(4)] + per_stage)


@pytest.mark.parametrize("policy", ["default", "all_float_convs"])
def test_segformer_lite_int8_forward_matches_jax(model, scales, policy):
    v, x = model
    ref, got = int8_pair(ARCH, v, x, scales, POLICIES[policy])
    agree, dprob = agreement(ARCH, ref, got)
    assert got.shape == (2, 64, 64, 1)
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)


def test_segformer_lite_int8_convs_a_forward(model, scales):
    """The convs the default policy puts on the int8 path, all through
    `int8_conv`: the patch embeds c2, c3 (stride 2), stages 2 and 3's
    attention (q, the spatial reductions: 4x4 at stride 4 and 2x2 at stride
    2, kv, proj) and Mix-FFN 1x1s, the decoder projections f4, f3, f2, the
    fusion (C_in = 1024) and head convs. Stage 1 (32 channels), f1 and the
    depthwise 3x3s stay on the float path, as in JAX; none that JAX runs in
    int8 takes the float path."""
    v, x = model
    assert conv_census(ARCH, v, x, scales) == dict(
        int8=19, stride2=3, stride4=1,
        transposed2x2=0, transposed3x3=0, transposed4x4=0, cin144=0, leaky=0, missed=[])
