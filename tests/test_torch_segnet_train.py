"""SegNet in train mode vs the JAX package (CPU): the differentiable pool
and unpool, their gradients at tied maxima, and two Adam steps with `bce`
and `hsv_bce`.

In train mode the port's pool takes `amax` over each 2x2 window, whose
gradient splits evenly among equal maxima as `jax.grad` of the JAX
package's `xw.max(axis=3)` does (`coastline/ops/primitives.py:351-352`),
and the unpool its plain version; the CUDA kernels, which have no
backward, run only at eval.

The model-level cases start from the port's own init (torch's default,
weight seed 0 of its constructor) with every BN bias at 2
(`chip_smoke.shift_bn`), carried to JAX by the JAX package's importer.
Without the shift a pre-ReLU value within rounding of 0, or a pool window
whose top two inputs lie within rounding, takes another branch in one
package: moving the input by 1e-7 of itself moves SegNet's gradients at
32^2 by 0.4-3.6% in the port alone. Two Adam steps at (2, 32, 32) a batch,
wd 1e-4, are held to the JAX package's bounds
(`tests/test_train_parity.py:89-108`): loss 1e-5, parameters atol 3e-5 /
rtol 1e-4, BN statistics atol 2e-5 / rtol 2e-4, at image seed 1 (seeds 4
and 7 put 118-5,353 values a sign flip apart, the rest of 0-7 at most one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import shift_bn
from coastline.models.segnet import SegNet as JaxSegNet
from coastline.ops.primitives import max_pool_with_indices as jax_pool
from coastline.ops.primitives import max_unpool as jax_unpool
from coastline.train import loop as jax_loop
from coastline.utils.torch_import import export_reference_segnet, import_reference_segnet
from coastline_torch.kernels import _build, unpool
from coastline_torch.models import segnet as segnet_module
from coastline_torch.models.segnet import SegNet
from coastline_torch.ops import primitives
from coastline_torch.train.loop import TrainConfig
from test_torch_robust_unet_train import (BN_BIAS, IMAGE_SEED, LR, WD, _batch,
                                          assert_steps_match, jax_two_steps, port_two_steps)

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _tied(seed=0, shape=(2, 6, 8, 5)):
    """Positive maxima tied in twos, threes and fours inside 2x2 windows,
    zero windows (ReLU zeros) and windows without a tie."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    b, h, w, c = shape
    xw = x.reshape(b, h // 2, 2, w // 2, 2, c)
    xw[:, 0, 0, :, 1, :] = xw[:, 0, 0, :, 0, :] = 1.5  # two tied at positions 0, 1
    xw[:, 1, 1, :, 0, :] = xw[:, 1, 1, :, 1, :] = xw[:, 1, 0, :, 1, :] = 2.0  # three tied
    xw[:, 2, :, 0, :, :] = 0.75  # four tied
    xw[:, 2, :, 1, :, :] = 0.0  # a window of ReLU zeros
    return x


def test_train_pool_gradient_splits_ties_as_jax():
    x = _tied()
    r = np.random.default_rng(1).normal(size=(2, 3, 4, 5)).astype(np.float32)

    def jax_loss(x):
        vals, codes = jax_pool(x)
        return (vals * r).sum(), codes

    (_, ref_codes), ref_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(x))
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(ref_grad[:, 0], np.repeat(r[:, 0], 2, 1) / 2, rtol=1e-6)  # halves
    np.testing.assert_allclose(ref_grad[:, 3], np.repeat(r[:, 1], 2, 1) / 3, rtol=1e-6)  # thirds
    xt = _nchw(x).requires_grad_()
    vals, codes = primitives.max_pool_with_indices(xt, train=True)
    (vals * _nchw(r)).sum().backward()
    np.testing.assert_array_equal(codes.permute(0, 2, 3, 1).numpy(), np.asarray(ref_codes))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), ref_grad, atol=1e-7, rtol=1e-6)
    # the eval formulation (a strict-> chain) hands a tie's whole gradient to its first element
    xs = torch.from_numpy(x).requires_grad_()
    (unpool.max_pool_with_indices_plain(xs)[0] * torch.from_numpy(r)).sum().backward()
    assert np.abs(xs.grad.numpy() - ref_grad).max() > 0.1


def test_train_unpool_gradient_matches_jax():
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    codes = rng.integers(0, 4, vals.shape).astype(np.int32)
    r = rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    ref_out, ref_grad = jax.value_and_grad(
        lambda v: (jax_unpool(v, jnp.asarray(codes)) * r).sum())(jnp.asarray(vals))
    vt = _nchw(vals).requires_grad_()
    out = primitives.max_unpool(vt, _nchw(codes).to(torch.int32), train=True)
    loss = (out * _nchw(r)).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_out), rel=1e-6)
    np.testing.assert_allclose(vt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref_grad),
                               atol=1e-7, rtol=1e-6)


def test_train_mode_calls_no_kernel_wrapper(monkeypatch):
    """SegNet in train mode never reaches the pool and unpool wrappers (on
    the card they would launch kernels without a backward); every
    parameter gets a gradient."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel wrapper was called in train mode")

    monkeypatch.setattr(unpool, "max_pool_with_indices", refuse)
    monkeypatch.setattr(unpool, "max_unpool", refuse)
    model = SegNet().train()
    model(torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0)),
          return_logits=True).square().mean().backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0) for p in model.parameters())


def test_kernels_refuse_a_call_that_autograd_would_record():
    """`_build.refuse_grad`, which every wrapper calls before it launches a
    kernel on the card: a tensor that requires grad raises while grad mode
    is on, and passes under `no_grad` and `inference_mode`."""
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="max_unpool has no backward"):
        _build.refuse_grad("max_unpool", torch.ones(3), w)
    _build.refuse_grad("max_unpool", torch.ones(3))
    with torch.no_grad():
        _build.refuse_grad("max_unpool", w)
    with torch.inference_mode():
        _build.refuse_grad("max_unpool", w)


def test_train_gradients_match_jax_at_tied_maxima(monkeypatch):
    """One train-mode gradient of the full-width SegNet on an image of
    constant 8x8 blocks (input seed 3): inside a block, enc1's pixels see
    equal neighbourhoods, so the first pool has thousands of windows of
    four equal positive maxima, in both packages. Every gradient within
    1e-4 of its tensor's largest; a conv bias before a BN, whose gradient
    is 0 up to rounding, within 1e-4 of its weight's largest."""
    rng = np.random.default_rng(3)
    img = np.repeat(np.repeat(rng.normal(size=(2, 4, 4, 3)), 8, 1), 8, 2).astype(np.float32)
    masks = (rng.random((2, 32, 32)) > 0.5).astype(np.float32)
    model = SegNet()
    model.load_state_dict(shift_bn(model.state_dict(), BN_BIAS))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = import_reference_segnet({k: v.numpy() for k, v in sd.items()})

    def loss_fn(params):
        logits, _ = JaxSegNet().apply({"params": params, "batch_stats": variables["batch_stats"]},
                                      jnp.asarray(img), train=True, return_logits=True,
                                      mutable=["batch_stats"])
        l = logits[..., 0]
        return (jnp.maximum(l, 0) - l * masks + jnp.log1p(jnp.exp(-jnp.abs(l)))).mean()

    grads = jax.grad(loss_fn)(jax.tree.map(jnp.asarray, variables["params"]))
    ref = export_reference_segnet({"params": jax.device_get(grads),
                                   "batch_stats": variables["batch_stats"]})
    ties = []
    pool = primitives.max_pool_with_indices

    def spy(t, **kw):
        xw = t.detach().permute(0, 2, 3, 1).reshape(t.shape[0], t.shape[2] // 2, 2,
                                                      t.shape[3] // 2, 2, t.shape[1])
        top = xw.amax((2, 4), keepdim=True)
        ties.append(int((((xw == top).sum((2, 4)) > 1) & (top[:, :, 0, :, 0] > 0)).sum()))
        return pool(t, **kw)

    monkeypatch.setattr(segnet_module, "max_pool_with_indices", spy)
    logits = model.train()(_nchw(img), return_logits=True)
    l = logits[:, 0]
    t = torch.from_numpy(masks)
    (l.clamp_min(0) - l * t + torch.log1p(torch.exp(-l.abs()))).mean().backward()
    assert ties[0] > 1000  # positive tied maxima in the first pool
    for name, p in model.named_parameters():
        r = ref[name]
        before_bn = name.endswith(".bias") and name[:-len("bias")] + "weight" in ref and (
            ref[name[:-len("bias")] + "weight"].ndim == 4 and not name.startswith("dec1.3"))
        scale = np.abs(ref[name[:-len("bias")] + "weight"] if before_bn else r).max()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-4 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("loss", ["bce", "hsv_bce"])
def test_two_adam_steps_match_jax(loss):
    images, masks = _batch(seed=IMAGE_SEED)
    idx, valid = np.array([[0, 1], [2, 3]], np.int32), np.ones((2, 2), np.float32)
    sd = shift_bn({k: v.clone() for k, v in SegNet().state_dict().items()}, BN_BIAS)
    variables = import_reference_segnet({k: v.numpy() for k, v in sd.items()})
    ref_loss, ref = jax_two_steps(JaxSegNet(), variables,
                                  jax_loop.TrainConfig(lr=LR, weight_decay=WD, loss=loss,
                                                       batch_size=2),
                                  images, masks, idx, valid, export_reference_segnet)
    model = SegNet()
    model.load_state_dict(sd, strict=True)
    got_loss, got = port_two_steps(model, TrainConfig(lr=LR, weight_decay=WD, loss=loss,
                                                      batch_size=2),
                                   images, masks, idx, valid)
    assert_steps_match(got_loss, got, ref_loss, ref, steps=2)
