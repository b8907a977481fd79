"""The port's losses, metrics and evaluation epoch vs the JAX package (CPU).

The same numpy-seeded weights, images, masks and batch plan go through
`coastline.train.loop.make_eval_epoch` and the port's. Tolerance: loss and
every mean/std metric to 1e-5. The float32 logits of the two packages agree
to ~2.5e-5 at these sizes, so the thresholded metrics are exact counts once
no logit lies within 1e-4 of the decision boundary, which each test checks
first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.models.robust_unet import RobustUNet as JaxRobustUNet
from coastline.models.segnet import SegNet as JaxSegNet
from coastline.models.unet import UNet as JaxUNet
from coastline.train import loop as jax_loop
from coastline.train import losses as jax_losses
from coastline.train import metrics as jax_metrics
from coastline_torch.models.robust_unet import RobustUNet
from coastline_torch.models.segnet import SegNet
from coastline_torch.models.unet import UNet
from coastline_torch.train import losses, metrics
from coastline_torch.train.loop import (TrainConfig, batch_indices, make_eval_epoch,
                                        normalize_images)
from coastline_torch.utils.torch_import import (random_robust_unet_variables,
                                                random_segnet_variables, random_unet_variables,
                                                robust_unet_state_dict, segnet_state_dict,
                                                unet_state_dict)

torch.set_num_threads(1)


def _probs_and_targets(seed=0, shape=(5, 16, 16)):
    rng = np.random.default_rng(seed)
    probs = rng.random(shape).astype(np.float32)
    targets = (rng.random(shape) < 0.4).astype(np.float32)
    targets[2] = 0.0  # an image with no water: tp = fn = 0
    return probs, targets


def test_per_image_and_aggregate_metrics_match_jax():
    probs, targets = _probs_and_targets()
    ref = jax_metrics.per_image_metrics(jnp.asarray(probs), jnp.asarray(targets), 0.5)
    got = metrics.per_image_metrics(torch.from_numpy(probs), torch.from_numpy(targets), 0.5)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
    ref_agg = jax_metrics.aggregate_metrics(ref)
    got_agg = metrics.aggregate_metrics(got)
    assert list(got_agg) == list(ref_agg)
    for k in ref_agg:
        np.testing.assert_allclose(float(got_agg[k]), float(ref_agg[k]), rtol=1e-6, atol=1e-7)
    nchw = metrics.per_image_metrics(torch.from_numpy(probs)[:, None], torch.from_numpy(targets))
    assert all(torch.equal(nchw[k], got[k]) for k in got)


@pytest.mark.parametrize("pred,targ,want", [(0, 0, 1.0), (1, 0, 0.0), (1, 1, 1.0)])
def test_binary_iou_matches_jax(pred, targ, want):
    p = np.zeros((4, 4), bool)
    t = np.zeros((4, 4), bool)
    p[:2, :2] = bool(pred)
    t[1:3, 1:3] = bool(targ)
    ref = float(jax_metrics.binary_iou(jnp.asarray(p), jnp.asarray(t)))
    got = float(metrics.binary_iou(torch.from_numpy(p), torch.from_numpy(t)))
    assert got == pytest.approx(ref, abs=1e-7)
    if pred == targ == 0 or (pred and not targ):
        assert got == want


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 2, 8, 8)).astype(np.float32)
    classes = rng.integers(0, 2, (2, 8, 8))
    got = float(losses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(classes)))
    ref = float(jax_losses.cross_entropy_loss(jnp.asarray(logits.transpose(0, 2, 3, 1)), classes))
    assert got == pytest.approx(ref, rel=1e-6)
    got = float(losses.bce_loss(torch.from_numpy(logits), torch.from_numpy(logits > 0.5)))
    ref = float(jax_losses.bce_loss(jnp.asarray(logits), jnp.asarray(logits > 0.5)))
    assert got == pytest.approx(ref, rel=1e-6)


def test_batch_indices_and_normalize_match_jax():
    for n, b, shuffle in ((5, 2, False), (7, 3, True), (4, 4, True)):
        got = batch_indices(n, b, shuffle=shuffle, rng=np.random.default_rng(3))
        ref = jax_loop.batch_indices(n, b, shuffle=shuffle, rng=np.random.default_rng(3))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    u8 = np.random.default_rng(4).integers(0, 256, (2, 4, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(normalize_images(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jax_loop.normalize_images(jnp.asarray(u8))))


def _dataset(n=5, size=32, seed=5):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    masks = np.stack([(yy > size / 2 + 4 * np.sin(xx / 3.0 + i)) for i in range(n)]).astype(np.int32)
    return images, masks


def _run_both(jax_model, variables, port_model, config):
    images, masks = _dataset()
    idx, valid = batch_indices(len(images), 2, shuffle=False, rng=np.random.default_rng(0))
    assert valid[-1, -1] == 0.0  # the wrap-around padding is in the plan, marked invalid
    logits = np.asarray(jax_model.apply(variables, jax_loop.normalize_images(jnp.asarray(images)),
                                        train=False, return_logits=True))
    margin = np.abs(logits[..., 1] - logits[..., 0]) if logits.shape[-1] == 2 else np.abs(logits)
    assert margin.min() > 1e-4  # no probability within reach of the threshold
    ref_loss, ref = jax_loop.make_eval_epoch(jax_model, config)(
        variables["params"], variables["batch_stats"], jnp.asarray(images), jnp.asarray(masks),
        jnp.asarray(idx), jnp.asarray(valid))
    loss, got = make_eval_epoch(port_model, config, device="cpu")(images, masks, idx, valid)
    assert isinstance(loss, float) and sorted(got) == sorted(ref)
    assert loss == pytest.approx(float(ref_loss), abs=1e-5)
    for k in ref:
        assert got[k] == pytest.approx(float(ref[k]), abs=1e-5), k
    return got


def test_eval_epoch_bce_matches_jax_robust_unet():
    variables = random_robust_unet_variables(seed=3, base=16)
    model = RobustUNet(base=16)
    model.load_state_dict(robust_unet_state_dict(variables), strict=True)
    got = _run_both(JaxRobustUNet(base=16), variables, model, TrainConfig())
    assert 0.0 < got["mean_accuracy"] < 1.0


def test_eval_epoch_bce_matches_jax_segnet():
    variables = random_segnet_variables(seed=10)
    model = SegNet()
    model.load_state_dict(segnet_state_dict(variables), strict=True)
    got = _run_both(JaxSegNet(), variables, model, TrainConfig())
    assert 0.0 < got["mean_accuracy"] < 1.0


def test_eval_epoch_ce_matches_jax_unet():
    variables = random_unet_variables(seed=4)
    model = UNet()
    model.load_state_dict(unet_state_dict(variables), strict=True)
    _run_both(JaxUNet(), variables, model, TrainConfig(loss="ce"))


def test_eval_epoch_rejects_losses_of_the_training_slice():
    """Every loss of the JAX loop is ported (`hsv_bce` with the comparison
    protocol's training); any other name is refused."""
    make_eval_epoch(RobustUNet(base=16), TrainConfig(loss="hsv_bce"), device="cpu")
    with pytest.raises(ValueError, match="unknown loss"):
        make_eval_epoch(RobustUNet(base=16), TrainConfig(loss="dice"), device="cpu")


def test_eval_epoch_hsv_bce_matches_jax_robust_unet():
    """`hsv_bce` in the eval epoch: each image's BCE plus 0.1 x its HSV
    consistency against `x_u8 / 255` (`coastline/train/loop.py:248-249`)."""
    variables = random_robust_unet_variables(seed=3, base=16)
    model = RobustUNet(base=16)
    model.load_state_dict(robust_unet_state_dict(variables), strict=True)
    got = _run_both(JaxRobustUNet(base=16), variables, model, TrainConfig(loss="hsv_bce"))
    images, masks = _dataset()
    idx, valid = batch_indices(len(images), 2, shuffle=False, rng=np.random.default_rng(0))
    bce_loss, bce = make_eval_epoch(model, TrainConfig(), device="cpu")(images, masks, idx, valid)
    hsv_loss, hsv = make_eval_epoch(model, TrainConfig(loss="hsv_bce"), device="cpu")(
        images, masks, idx, valid)
    assert hsv_loss > bce_loss and hsv == bce == got  # the term moves the loss, not the metrics
