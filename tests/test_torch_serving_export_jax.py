"""The JAX package's serving bundle, served by the port (CPU).

JAX's `save_serving_bundle` of its Robust U-Net at 64^2 (the fixture of
`tests/test_deploy.py`) writes `weights.npz` and `serving_fn.bin`. The port
refuses the directory as a bundle (`serving_fn.bin` is a `jax.export`
program, which it does not load), loads the `.npz`, exports its own program
and serves it, bit-equal to its eager forward on the same weights.

Tolerances. The port's program against JAX's op-by-op forward
(`jq.int8_forward`, no `jax.jit`) on the same `.npz` and input, the forward
the port follows: >= 99% mask agreement and mean |d prob| <= 0.01, the
limits `tests/test_torch_quant_robust_unet.py` holds the default policy to
(reading: 99.16%, 0.0066). Against the fn of JAX's `load_serving_bundle`, the
bundle's smoke test: >= 98% (reading: 98.27%, mean |d prob| 0.0134). JAX
serves its jitted forward, where XLA contracts the float32 epilogues into
FMAs, and that forward agrees with JAX's own op-by-op one on 98.47% of these
masks (mean |d prob| 0.0134), so the 99% that `tests/test_torch_deploy.py`
states for the UNet's two forwards does not hold against it for this model
and input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.infer import deploy as jdeploy
from coastline.infer import quant as jq
from coastline.models.robust_unet import RobustUNet
from coastline_torch.infer import deploy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """tests/test_deploy.py's model: JAX's Robust U-Net from PRNGKey(0),
    calibrated on a (2, 64, 64, 3) normal input from PRNGKey(1); its bundle,
    and on that input the probabilities of JAX's served fn and of its op-by-op
    forward on the bundle's weights."""
    m = RobustUNet(dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 64, 64, 3), jnp.float32)
    v = m.init({"params": rng, "dropout": rng}, x)
    qm = jq.QuantizedModel.from_variables(v, x, batch_size=2, arch="robust_unet")
    d = tmp_path_factory.mktemp("jax_bundle")
    jdeploy.save_serving_bundle(d, qm, batch_size=2, image_size=64)
    fn, jqm = jdeploy.load_serving_bundle(d)
    x = np.array(x)
    op_by_op = jq.int8_forward(jqm.qparams, jqm.scales, jnp.asarray(x), arch=jqm.arch,
                               policy=jqm.policy)
    return d, x, np.asarray(fn(x)), np.asarray(op_by_op)


def test_jax_bundle_weights_serve_in_the_port(jax_bundle, tmp_path):
    d, x, served, op_by_op = jax_bundle
    with pytest.raises(FileNotFoundError, match="serving_fn.bin"):
        deploy.load_serving_bundle(d, device="cpu")
    qm = deploy.load_quantized(d / "weights.npz", device="cpu")
    assert qm.arch == "robust_unet"
    ours = tmp_path / "port_bundle"
    deploy.save_serving_bundle(ours, qm, batch_size=2, image_size=64)
    fn, back = deploy.load_serving_bundle(ours, device="cpu")
    probs = fn(x)
    assert torch.equal(probs, qm(x)) and torch.equal(probs, back(x))
    probs = probs.numpy()
    assert probs.shape == op_by_op.shape == served.shape
    agree = float(((probs > 0.5) == (op_by_op > 0.5)).mean())
    dprob = float(np.abs(probs - op_by_op).mean())
    assert agree >= 0.99 and dprob <= 0.01, (agree, dprob)
    agree = float(((probs > 0.5) == (served > 0.5)).mean())
    assert agree >= 0.98, agree
