"""The port's HSV-guided loss (`coastline_torch/train/hsv.py`) vs the JAX
package's (`coastline/train/hsv.py`), on the CPU, float32.

Inputs: random RGB in [0, 1] and the edge cases of the hue formula: greys
(max == min, hue 0), black (max == 0, saturation 0), pure primaries and
secondaries (each branch of the hue's `where`), negative hue before the
modulo (magenta-ish reds), and values outside [0, 1] that the prior clips.
Tolerance: atol 1e-6, the same float32 formula op for op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.train import hsv as jax_hsv
from coastline.train import losses as jax_losses
from coastline_torch.train import hsv, losses

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=0)

EDGE = np.array([
    [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.5, 0.5], [0.2, 0.2, 0.2],  # black, greys
    [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],  # primaries
    [1.0, 1.0, 0.0], [0.0, 1.0, 1.0], [1.0, 0.0, 1.0],  # secondaries
    [0.9, 0.1, 0.5], [0.6, 0.2, 0.59], [0.3, 0.3, 0.9], [0.2, 0.6, 0.6],  # hue < 0, ties
    [1e-7, 0.0, 0.0], [0.4, 0.4, 0.40001], [1.3, -0.2, 0.5], [0.1, 0.35, 0.55],
], np.float32)


def _rgb(seed=0, shape=(2, 8, 8)):
    rgb = np.random.default_rng(seed).random(shape + (3,)).astype(np.float32)
    rgb.reshape(-1, 3)[: len(EDGE)] = EDGE
    return rgb


def test_rgb_to_hsv_matches_jax():
    rgb = _rgb()
    got = hsv.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    ref = np.asarray(jax_hsv.rgb_to_hsv(jnp.asarray(rgb)))
    np.testing.assert_allclose(got, ref, **TOL)
    flat = got.reshape(-1, 3)
    assert np.all(flat[:4, 0] == 0) and np.all(flat[:4, 1] == 0)  # greys and black
    assert np.all((got[..., 0] >= 0) & (got[..., 0] < 1))  # the modulo keeps hue in [0, 1)
    np.testing.assert_allclose(flat[4:10, 0], [0, 1 / 3, 2 / 3, 1 / 6, 1 / 2, 5 / 6], atol=1e-6)


def test_water_prior_matches_jax():
    rgb = _rgb(1)
    got = hsv.hsv_water_prior(torch.from_numpy(rgb)).numpy()
    ref = np.asarray(jax_hsv.hsv_water_prior(jnp.asarray(rgb)))
    np.testing.assert_allclose(got, ref, **TOL)
    assert got.min() >= 0 and got.max() <= 1 and got.std() > 0.05


@pytest.mark.parametrize("axes", [None, (1, 2)])
def test_consistency_matches_jax(axes):
    rgb = _rgb(2)
    probs = np.random.default_rng(3).random(rgb.shape[:3]).astype(np.float32)
    got = hsv.hsv_consistency(torch.from_numpy(probs), torch.from_numpy(rgb), axes=axes)
    ref = jax_hsv.hsv_consistency(jnp.asarray(probs), jnp.asarray(rgb), axes=axes)
    assert tuple(got.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("weight", [0.0, 0.1, 0.7])
def test_hsv_guided_bce_matches_jax(weight):
    rgb = _rgb(4)
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, rgb.shape[:3]).astype(np.float32)
    targets = (rng.random(rgb.shape[:3]) > 0.5).astype(np.float32)
    got = hsv.hsv_guided_bce(torch.from_numpy(logits), torch.from_numpy(targets),
                             torch.from_numpy(rgb), weight)
    ref = jax_hsv.hsv_guided_bce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(rgb),
                                 weight)
    np.testing.assert_allclose(float(got), float(ref), **TOL)
    # the port's NCHW logits with one channel give the same value
    nchw = hsv.hsv_guided_bce(torch.from_numpy(logits)[:, None],
                              torch.from_numpy(targets)[:, None], torch.from_numpy(rgb), weight)
    np.testing.assert_allclose(float(nchw), float(ref), **TOL)
    if weight == 0.0:
        assert float(got) == float(losses.bce_loss(torch.from_numpy(logits),
                                                   torch.from_numpy(targets)))


def test_consistency_gradient_flows_through_the_probabilities():
    rgb = torch.from_numpy(_rgb(6))
    probs = torch.rand(rgb.shape[:3], generator=torch.Generator().manual_seed(0),
                       requires_grad=True)
    hsv.hsv_consistency(probs, rgb).backward()
    prior = hsv.hsv_water_prior(rgb)
    want = (2 * prior - 1).abs() * torch.sign(probs.detach() - prior) / probs.numel()
    torch.testing.assert_close(probs.grad, want, atol=1e-9, rtol=1e-6)


def test_loss_registry_matches_jax_names():
    assert set(losses.LOSS_REGISTRY) == set(jax_losses.LOSS_REGISTRY) - {"bce_probs"}
    rgb = torch.from_numpy(_rgb(7))
    logits = torch.randn(rgb.shape[:3], generator=torch.Generator().manual_seed(1))
    targets = (logits > 0).float()
    assert float(losses.LOSS_REGISTRY["hsv_bce"](logits, targets, rgb, 0.3)) == float(
        hsv.hsv_guided_bce(logits, targets, rgb, 0.3))
