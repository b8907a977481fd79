"""The int8 serving artifact between the two packages (CPU):
`coastline_torch/infer/deploy.py` against `coastline/infer/deploy.py`.

Tolerance: none for the artifact. An `.npz` written by either package loads
in the other with bit-equal arrays, the same scales, policy, arch and slim
rule, and serves the same numbers as the model it was written from; the
port and the JAX package write the same keys. The one comparison across the
two forwards (the extractors' masks) allows 1% of pixels: JAX serves its
jitted forward, whose float32 epilogues XLA contracts into FMAs.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.infer import deploy as jdeploy
from coastline.infer import quant as jq
from coastline_torch.infer import deploy as tdeploy
from coastline_torch.infer import quant as tq
from coastline_torch.utils import torch_import as ti
from test_torch_quant import _assert_tree_equal

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def robust():
    """Random Robust U-Net variables (seed 0), a (1, 32, 32, 3) input and
    JAX's calibration on it."""
    v = ti.random_robust_unet_variables(seed=0)
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(np.float32)
    scales = jq.calibrate(jq.fold_robust_unet(v), jnp.asarray(x), batch_size=1)
    return v, x, scales


def _models(v, scales, policy=None):
    jqm = jq.QuantizedModel(jq.quantize_folded(jq.fold_robust_unet(v)), scales,
                            arch="robust_unet", policy=policy)
    tqm = tq.QuantizedModel(tq.quantize_folded(tq.fold_robust_unet(ti.robust_unet_state_dict(v))),
                            scales, arch="robust_unet", policy=policy, device="cpu")
    return jqm, tqm


def _npz(path):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return flat, json.loads(bytes(flat.pop("__meta__")).decode("utf-8"))


@pytest.mark.parametrize("slim", [True, False])
def test_jax_artifact_serves_in_the_port(robust, tmp_path, slim):
    v, x, scales = robust
    jqm, tqm = _models(v, scales)
    path = tmp_path / "jax.npz"
    jdeploy.save_quantized(path, jqm, slim=slim)
    back = tdeploy.load_quantized(path, device="cpu")
    assert back.arch == "robust_unet" and back.scales == scales and back.policy is None
    assert back.device.type == "cpu"
    _assert_tree_equal(jdeploy.load_quantized(path).qparams, back.qparams)
    assert back.qparams["rb4"]["short"] is None
    assert back.qparams["rb0"]["c1"]["wq"].dtype == np.int8
    assert all(isinstance(s, float) for s in back.scales.values())
    assert torch.equal(back(x), tqm(x))


@pytest.mark.parametrize("slim", [True, False])
def test_port_artifact_serves_in_jax(robust, tmp_path, slim):
    v, x, scales = robust
    jqm, tqm = _models(v, scales)
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    tdeploy.save_quantized(ours, tqm, slim=slim)
    jdeploy.save_quantized(theirs, jqm, slim=slim)
    (a, meta_a), (b, meta_b) = _npz(ours), _npz(theirs)
    assert sorted(a) == sorted(b) and meta_a == meta_b
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    back = jdeploy.load_quantized(ours)
    assert back.arch == jqm.arch and back.scales == jqm.scales and back.policy == jqm.policy
    _assert_tree_equal(jdeploy.load_quantized(theirs).qparams, back.qparams)


def test_slim_artifact_smaller_and_exact(robust, tmp_path):
    """The default policy never reads the dropped float32 weights; the loader
    rebuilds them as wq * wstep for any other policy."""
    v, x, scales = robust
    _, tqm = _models(v, scales)
    slim, full = tmp_path / "slim.npz", tmp_path / "full.npz"
    tdeploy.save_quantized(slim, tqm, slim=True)
    tdeploy.save_quantized(full, tqm, slim=False)
    assert slim.stat().st_size < 0.6 * full.stat().st_size
    back = tdeploy.load_quantized(slim, device="cpu")
    assert torch.equal(back(x), tqm(x))
    e = back.qparams["rb4"]["c1"]
    np.testing.assert_allclose(e["w"], e["wq"].astype(np.float32) * e["wstep"][None, None, None, :],
                               rtol=1e-6)
    assert "w" in back.qparams["rb0"]["c1"]  # a 3 -> 64 conv keeps its float32 weights


def test_policy_round_trips(robust, tmp_path):
    v, x, scales = robust
    policy = {"conv_min_ch": 10**9, "convT_int8": False}
    jqm, tqm = _models(v, scales, policy)
    path = tmp_path / "p.npz"
    tdeploy.save_quantized(path, tqm)
    back = tdeploy.load_quantized(path, device="cpu")
    assert back.policy == policy and jdeploy.load_quantized(path).policy == policy
    flat, meta = _npz(path)
    assert meta["slim"] and any(k.endswith("/w") for k in flat)  # nothing runs int8: all kept
    assert torch.equal(back(x), tqm(x))


def test_jax_unet_artifact_serves_in_the_port_extractor(tmp_path):
    """A UNet artifact written by the JAX package serves in the port's
    extractor, and the port's in JAX's, with the same masks."""
    from coastline.infer.extract import CoastlineExtractor as JaxExtractor
    from coastline_torch.infer.extract import CoastlineExtractor

    v = ti.random_unet_variables(seed=0)
    calib = jq.default_calibration(64)
    jqm = jq.QuantizedModel.from_variables(v, calib, batch_size=2, arch="unet")
    path = tmp_path / "unet.npz"
    jdeploy.save_quantized(path, jqm)
    images = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ours = CoastlineExtractor.from_quantized(str(path), image_size=64, device="cpu")
    got = ours.predict_masks_batch(images)
    ref = JaxExtractor.from_quantized(str(path), image_size=64).predict_masks_batch(images)
    assert got.shape == (2, 64, 64) and got.dtype == np.uint8
    assert (got == ref).mean() >= 0.99
    again = tmp_path / "again.npz"
    tdeploy.save_quantized(again, ours.quantized)
    ref2 = JaxExtractor.from_quantized(str(again), image_size=64).predict_masks_batch(images)
    np.testing.assert_array_equal(ref, ref2)


def test_extractor_refuses_a_non_unet_artifact(robust, tmp_path):
    from coastline_torch.infer.extract import CoastlineExtractor

    v, x, scales = robust
    _, tqm = _models(v, scales)
    path = tmp_path / "robust.npz"
    tdeploy.save_quantized(path, tqm)
    with pytest.raises(ValueError, match="expects arch 'unet'"):
        CoastlineExtractor.from_quantized(str(path), image_size=32, device="cpu")
