"""The port's int8 UNet vs the JAX package (CPU), on tests/test_quant.py's
fixture (the full-width 2-class UNet, BN statistics from one train-mode
pass, a (2, 64, 64, 3) input).

Tolerances: the float32 float mode within atol 2e-3 of JAX's logits
(tests/test_quant.py:157); bf16 calibration scales within rtol 2e-2; the
int8 forward, with JAX's scales fed to both sides, >= 99% argmax agreement
and mean |d prob| <= 0.01 under each policy variant of tests/test_quant.py.
JAX runs the int8 forward op by op: the port follows its arithmetic (it
agrees bit for bit here), while XLA's jit contracts the epilogue into FMAs.
"""

import numpy as np
import pytest
import torch

from coastline_torch.infer import quant as tq
from test_torch_quant import (POLICIES, agreement, float_and_calibration_checks, int8_pair,
                              jax_fixture)

torch.set_num_threads(1)
ARCH = "unet"


@pytest.fixture(scope="module")
def model():
    return jax_fixture(ARCH)


@pytest.fixture(scope="module")
def scales(model):
    v, x = model
    return float_and_calibration_checks(ARCH, v, x, logits_atol=2e-3)


def test_unet_float_mode_and_calibration_match_jax(scales):
    assert len(scales) == 27 and all(s > 0 for s in scales.values())


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_unet_int8_forward_matches_jax(model, scales, policy):
    v, x = model
    ref, got = int8_pair(ARCH, v, x, scales, POLICIES[policy])
    agree, dprob = agreement(ARCH, ref, got)
    assert got.shape == (2, 64, 64, 2) and got.dtype == np.float32
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)


def test_unet_quantized_model_is_the_int8_forward(model):
    """`QuantizedModel.from_state_dict` = fold + calibrate + quantize, its
    call the int8 forward on the packed tree."""
    v, x = model
    from coastline_torch.utils.torch_import import unet_state_dict

    sd = unet_state_dict(v)
    qm = tq.QuantizedModel.from_state_dict(sd, x, arch=ARCH, device="cpu")
    folded = tq.fold_unet(sd)
    assert qm.scales == tq.calibrate(folded, torch.from_numpy(x), arch=ARCH)
    direct = tq.int8_forward(tq.quantize_folded(folded), qm.scales, torch.from_numpy(x), arch=ARCH)
    out = qm(x)
    assert torch.equal(out, direct) and torch.equal(qm(x), out)  # the step cache changes nothing
    assert out.shape == (2, 64, 64, 2) and torch.isfinite(out).all()
