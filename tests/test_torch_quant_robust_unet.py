"""The port's int8 Robust U-Net vs the JAX package (CPU), on
tests/test_quant.py's fixture (the full-width model, BN statistics from
one train-mode pass, a (2, 64, 64, 3) input).

Tolerances: the float32 float mode within atol 2e-4 of JAX's probabilities
and 2e-3 of its logits (tests/test_quant.py:44,53); bf16 calibration
scales within rtol 2e-2; the int8 forward, with JAX's scales fed to both
sides and JAX run op by op (see test_torch_quant_unet.py), >= 99% mask
agreement and mean |d prob| <= 0.01 under each policy variant of
tests/test_quant.py but one.

The exception is the variant that sends every conv to the float path
(`conv_min_ch` 10^9, `convT_int8` False). Its bf16 convs sum in float32 in
another order than XLA's (oneDNN against Eigen): at `rb0.mid`, the first
site whose codes differ, 9 of the conv's 524,288 bf16 outputs (1.7e-5)
differ, and 40 requantizations later 1.2% of this random-init model's masks
(its probabilities sit near 0.5) differ: 98.78% agreement, mean |d prob|
0.0096. That variant is held where the difference arises instead, at
limits set from these readings:

  * the conv at `rb0.mid` (64 -> 64, 3x3, bias 0) on JAX's `rb0.t1` codes:
    each output within one bf16 ulp plus 2^-20 of its terms' magnitude sum
    of JAX's, at most 1.5e-4 of them apart (reading: 37, 7.1e-5);
  * layer by layer: the port quantizes each site from its own input and
    then passes JAX's codes on, so each layer reads what JAX's read; at
    most 1e-4 of any site's codes differ (reading: 3.1e-5, one code of
    `db.out`'s 32,768; no site more than 2), and the output then agrees on
    >= 99% of the masks with mean |d prob| <= 0.01 (reading: 100%). A
    control, the site multiplying by the step's reciprocal instead of
    dividing, must move more than the limit (reading: 1.75e-4 at
    `rb2.out`);
  * free running, at a fixed bound under the reading: >= 98.5% of the
    masks and mean |d prob| <= 0.01.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from coastline.infer import quant as jq
from coastline_torch.infer import quant as tq
from test_torch_quant import (POLICIES, STATE_DICTS, agreement, float_and_calibration_checks,
                              int8_pair, jax_fixture)

torch.set_num_threads(1)
ARCH = "robust_unet"
SITE_LIMIT = 1e-4  # share of a site's codes, layer by layer
_SITE = tq._Ctx.site


@pytest.fixture(scope="module")
def model():
    return jax_fixture(ARCH)


@pytest.fixture(scope="module")
def scales(model):
    v, x = model
    return float_and_calibration_checks(ARCH, v, x, logits_atol=2e-3, probs_atol=2e-4)


def test_robust_unet_float_mode_and_calibration_match_jax(scales):
    assert "rb5.gated" in scales and "cat0" in scales and len(scales) == 62


@pytest.mark.parametrize("policy", sorted(set(POLICIES) - {"all_float_convs"}))
def test_robust_unet_int8_forward_matches_jax(model, scales, policy):
    v, x = model
    ref, got = int8_pair(ARCH, v, x, scales, POLICIES[policy])
    agree, dprob = agreement(ARCH, ref, got)
    assert got.shape == (2, 64, 64, 1)
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)


@pytest.fixture(scope="module")
def all_float(model, scales):
    """JAX's op-by-op forward under the all-float-conv policy with every
    site's (name, codes, step) recorded, its logits, and the port's tree."""
    v, x = model
    policy = POLICIES["all_float_convs"]
    sites, site = [], jq._Ctx.site

    def record(ctx, name, t, optional=False):
        out = site(ctx, name, t, optional)
        sites.append((name, np.asarray(out.q), None if out.step is None else float(out.step)))
        return out

    jqp = jq.quantize_folded(jq.fold_robust_unet(v))
    jq._Ctx.site = record
    try:
        ref = np.asarray(jq.int8_forward(jqp, scales, jnp.asarray(x), return_logits=True,
                                         arch=ARCH, policy=policy))
    finally:
        jq._Ctx.site = site
    tqp = tq.quantize_folded(tq.fold_robust_unet(STATE_DICTS[ARCH](v)))
    return dict(policy=policy, sites=sites, ref=ref, jqp=jqp, tqp=tqp)


def _forced(all_float, scales, x, own_site=_SITE):
    """The port's forward with JAX's codes passed on at every site; each
    site first quantizes its own input with `own_site`. -> (logits, {site:
    share of its codes that differ from JAX's})."""
    sites, shares = all_float["sites"], {}

    def forced(ctx, name, t, optional=False):
        own = own_site(ctx, name, t, optional)
        want, q, step = sites[len(shares)]
        assert want == name and own.step == step, (name, want, own.step, step)
        shares[name] = float((own.q.numpy() != q).mean())
        return tq._QT(torch.from_numpy(q.copy()), step)

    tq._Ctx.site = forced
    try:
        got = tq.int8_forward(all_float["tqp"], scales, torch.from_numpy(x), return_logits=True,
                              arch=ARCH, policy=all_float["policy"])
    finally:
        tq._Ctx.site = _SITE
    assert len(shares) == len(sites)
    return got.numpy(), shares


def _reciprocal_site(ctx, name, t, optional=False):
    """A control: `_Ctx.site` multiplying by the step's reciprocal."""
    out = _SITE(ctx, name, t, optional)
    if out.step is None:
        return out
    inv = 1.0 / torch.tensor(out.step, dtype=torch.float32)
    return tq._QT((t.float() * inv).round_().clamp_(-127, 127).to(torch.int8), out.step)


def test_robust_unet_all_float_convs_rb0_mid_conv_sum_order(model, scales, all_float):
    """The located cause: the float-path bf16 conv of `rb0.c2` on JAX's
    `rb0.t1` codes, bias 0, in both packages: each output within one bf16
    ulp of JAX's plus 2^-20 of its terms' magnitude sum (a float32 sum in
    another order; where the terms cancel that is more than an ulp), and
    at most 1.5e-4 of the outputs apart."""
    name, q, step = next(s for s in all_float["sites"] if s[0] == "rb0.t1")
    w = all_float["jqp"]["rb0"]["c2"]["w"]
    zero = np.zeros(w.shape[-1], np.float32)
    jctx = jq._Ctx(scales, dtype=jnp.bfloat16, policy=all_float["policy"])
    xq = jq._QT(jnp.asarray(q), jnp.float32(step))
    ref = jq._conv(jctx, xq, (w, zero), padding=1)
    tctx = tq._Ctx(scales, dtype=torch.bfloat16, policy=all_float["policy"])
    got = tq._conv(tctx, tq._QT(torch.from_numpy(q.copy()), step),
                   (torch.from_numpy(w), torch.from_numpy(zero)), padding=1)
    a = np.asarray(ref.astype(jnp.float32))
    b = got.float().numpy()
    assert a.shape == b.shape == (2, 64, 64, 64)
    # the magnitude sum of each output's terms, sum |x| |w|, in float64
    xa = torch.from_numpy(np.abs(np.asarray(xq.f(jnp.bfloat16), np.float64))).permute(0, 3, 1, 2)
    wa = torch.from_numpy(np.abs(np.asarray(jnp.asarray(w, jnp.bfloat16), np.float64)))
    terms = F.conv2d(xa, wa.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1).numpy()
    big = np.maximum(np.abs(a), np.abs(b)).astype(ml_dtypes.bfloat16).astype(np.float32)
    ulp = np.spacing(big) * 2.0 ** 16  # float32 spacing -> bfloat16's 7-bit mantissa
    excess = np.abs(a - b) - (ulp + 2.0 ** -20 * terms)
    assert np.all(excess <= 0), float(excess.max())
    apart = a != b
    assert apart.mean() <= 1.5e-4, int(apart.sum())


def test_robust_unet_all_float_convs_layer_by_layer(model, scales, all_float):
    v, x = model
    got, shares = _forced(all_float, scales, x)
    worst = max(shares, key=shares.get)
    assert shares[worst] <= SITE_LIMIT, (worst, shares[worst])
    agree, dprob = agreement(ARCH, all_float["ref"], got)
    assert got.shape == (2, 64, 64, 1)
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)
    _, control = _forced(all_float, scales, x, own_site=_reciprocal_site)
    assert max(control.values()) > SITE_LIMIT, max(control.values())


def test_robust_unet_all_float_convs_free_running(model, scales, all_float):
    v, x = model
    got = tq.int8_forward(all_float["tqp"], scales, torch.from_numpy(x), return_logits=True,
                          arch=ARCH, policy=all_float["policy"]).numpy()
    agree, dprob = agreement(ARCH, all_float["ref"], got)
    assert agree >= 0.985 and dprob <= 0.01, (agree, dprob)
