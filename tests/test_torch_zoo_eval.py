"""The nine zoo models' eval forwards in the port vs the JAX package (CPU).

Weights: each model's own seeded init in the port, its BN running
statistics taken from one train-mode forward and drawn away from them, BN
affines away from 1 and 0 (`chip_smoke.zoo_state_dict`), carried to JAX by
the JAX package's importer. So every layer's activations keep about unit
scale and the logits' std is O(1): a wrong fold, epsilon, resize or
padding moves them by far more than the bound.

Sizes are the JAX package's own parity sizes (`tests/test_torch_import.py:
175-193`): 96^2 for DeepLabV3+, YOLO-SEG, PSPNet, Fast-SCNN and ENet, 64^2
for WaterNet, MSWNet, HRNet-Water and SegFormer-Lite; batch 2, input seed 2.
Tolerance: float32 atol 2e-4 / rtol 1e-3 (`tests/test_torch_import.py:114`)
on the logits and the probabilities, SegFormer-Lite's `reference_ordering`
probabilities too. On the CPU the fused conv and pool wrappers run their
plain versions. bfloat16 has no JAX bound (its resizes and reductions round
otherwise than XLA's); its forwards must return finite float32 logits of
the right shape whose masks agree with float32's on most pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import zoo_state_dict
from coastline.models import registry as jax_registry
from coastline_torch.models.registry import create_model
from test_torch_zoo import ZOO, jax_variables

torch.set_num_threads(1)
F32 = dict(atol=2e-4, rtol=1e-3)


def _input(hw):
    return np.random.default_rng(2).normal(size=(2, hw, hw, 3)).astype(np.float32)


def _port(name, sd, x, dtype=torch.float32, **kw):
    model = create_model(name, dtype=dtype, **kw)
    model.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        return (model.eval()(xt, return_logits=True).numpy(),
                model(xt).numpy())


@pytest.mark.parametrize("name", list(ZOO))
def test_f32_eval_forward_matches_jax(name):
    sd = zoo_state_dict(name)
    variables = jax_variables(name, sd)
    x = _input(ZOO[name][2])
    jax_model = jax_registry.create_model(name)
    ref_logits = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False,
                                            return_logits=True)).transpose(0, 3, 1, 2)
    ref_probs = np.asarray(jax_model.apply(variables, jnp.asarray(x),
                                           train=False)).transpose(0, 3, 1, 2)
    logits, probs = _port(name, sd, x)
    assert logits.dtype == np.float32 and logits.shape == (2, 1, *x.shape[1:3])
    assert ref_logits.std() > 0.3  # the weights keep the logits on an O(1) scale
    np.testing.assert_allclose(logits, ref_logits, **F32)
    np.testing.assert_allclose(probs, ref_probs, **F32)


def test_segformer_reference_ordering_matches_jax():
    """The reference's sigmoid before the final upsample: probabilities at
    the same bound; the logits keep the default ordering."""
    name = "SegFormer-Lite"
    sd = zoo_state_dict(name)
    variables = jax_variables(name, sd)
    x = _input(ZOO[name][2])
    jax_model = jax_registry.create_model(name, reference_ordering=True)
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False)).transpose(0, 3, 1, 2)
    logits, probs = _port(name, sd, x, reference_ordering=True)
    np.testing.assert_allclose(probs, ref, **F32)
    default_logits, default_probs = _port(name, sd, x)
    np.testing.assert_array_equal(logits, default_logits)
    assert np.abs(probs - default_probs).max() > 1e-4  # the orderings differ at the boundary


@pytest.mark.parametrize("name", list(ZOO))
def test_bf16_eval_forward_runs_near_f32(name):
    sd = zoo_state_dict(name)
    x = _input(64)
    logits16, _ = _port(name, sd, x, dtype=torch.bfloat16)
    logits32, _ = _port(name, sd, x)
    assert logits16.dtype == np.float32 and logits16.shape == logits32.shape
    assert np.isfinite(logits16).all()
    assert ((logits16 > 0) == (logits32 > 0)).mean() > 0.8
