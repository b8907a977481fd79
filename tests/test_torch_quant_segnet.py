"""The port's int8 SegNet vs the JAX package (CPU), on tests/test_quant.py's
fixture (the full-width SegNet, BN statistics from one train-mode pass, a
(2, 64, 64, 3) input): its indexed pool and unpool run on the int8 codes.

Tolerances: the float32 float mode within atol 2e-4 of JAX's probabilities
(tests/test_quant.py's zoo test) and 2e-3 of its logits; bf16 calibration
scales within rtol 2e-2; the int8 forward, with JAX's scales fed to both
sides, >= 99% mask agreement and mean |d prob| <= 0.01 under each policy
variant of tests/test_quant.py, JAX run op by op (see
test_torch_quant_unet.py).
"""

import numpy as np
import pytest
import torch

from coastline_torch.infer import quant as tq
from coastline_torch.kernels import unpool
from test_torch_quant import (POLICIES, agreement, float_and_calibration_checks, int8_pair,
                              jax_fixture)

torch.set_num_threads(1)
ARCH = "segnet"


@pytest.fixture(scope="module")
def model():
    return jax_fixture(ARCH)


@pytest.fixture(scope="module")
def scales(model):
    v, x = model
    return float_and_calibration_checks(ARCH, v, x, logits_atol=2e-3, probs_atol=2e-4)


def test_segnet_float_mode_and_calibration_match_jax(scales):
    assert sorted(scales) == sorted(["input"] + [f"c{i}" for i in range(19)])


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_segnet_int8_forward_matches_jax(model, scales, policy):
    v, x = model
    ref, got = int8_pair(ARCH, v, x, scales, POLICIES[policy])
    agree, dprob = agreement(ARCH, ref, got)
    assert got.shape == (2, 64, 64, 1)
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)


def test_segnet_int8_forward_pools_codes(model, scales):
    """The int8 forward hands the pool and unpool int8 codes, four of each."""
    v, x = model
    from coastline_torch.utils.torch_import import segnet_state_dict

    seen = []
    pool, unp = unpool.max_pool_with_indices, unpool.max_unpool

    def spy_pool(t):
        seen.append(("pool", t.dtype))
        return pool(t)

    def spy_unpool(t, c):
        seen.append(("unpool", t.dtype))
        return unp(t, c)

    qp = tq.quantize_folded(tq.fold_segnet(segnet_state_dict(v)))
    try:
        unpool.max_pool_with_indices, unpool.max_unpool = spy_pool, spy_unpool
        tq.int8_forward(qp, scales, torch.from_numpy(x), arch=ARCH)
    finally:
        unpool.max_pool_with_indices, unpool.max_unpool = pool, unp
    assert seen == [("pool", torch.int8)] * 4 + [("unpool", torch.int8)] * 4
