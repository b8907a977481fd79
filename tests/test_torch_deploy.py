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


@pytest.fixture(scope="module")
def deeplab():
    """JAX DeepLabV3+ variables (init from PRNGKey(0)), a (1, 32, 32, 3)
    input and JAX's calibration on it."""
    import jax

    from coastline.models.deeplabv3p import DeepLabV3Plus

    key = jax.random.PRNGKey(0)
    v = DeepLabV3Plus(dtype=jnp.float32).init({"params": key, "dropout": key},
                                               jnp.zeros((1, 32, 32, 3), jnp.float32))
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                            "batch_stats": v["batch_stats"]})
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(np.float32)
    scales = jq.calibrate(jq.fold_deeplabv3p(v), jnp.asarray(x), batch_size=1, arch="deeplabv3p")
    return v, x, scales


def _deeplab_models(v, scales):
    jqm = jq.QuantizedModel(jq.quantize_folded(jq.fold_deeplabv3p(v)), scales, arch="deeplabv3p")
    tqm = tq.QuantizedModel(tq.quantize_folded(tq.fold_deeplabv3p(ti.deeplabv3plus_state_dict(v))),
                            scales, arch="deeplabv3p", device="cpu")
    return jqm, tqm


def test_slim_deeplabv3p_artifact_keeps_aspp_b4(deeplab, tmp_path):
    """The global ASPP branch reads `aspp_b4`'s float32 weights as a matmul,
    not through the int8 path: a slim artifact keeps them (and drops those of
    the other int8-path convs), and serves bit-equal to the model it was
    written from."""
    v, x, scales = deeplab
    _, tqm = _deeplab_models(v, scales)
    path = tmp_path / "slim.npz"
    tdeploy.save_quantized(path, tqm, slim=True)
    flat, meta = _npz(path)
    assert meta["slim"] and meta["arch"] == "deeplabv3p"
    assert "q/aspp_b4/w" in flat and "q/aspp_b0/w" not in flat and "q/up1/w" not in flat
    assert "q/up2/w" in flat and "q/c0/w" in flat  # float-path convs keep theirs
    np.testing.assert_array_equal(flat["q/aspp_b4/w"], tqm.qparams["aspp_b4"]["w"])
    back = tdeploy.load_quantized(path, device="cpu")
    assert "w" in back.params["aspp_b4"]
    assert torch.equal(back(x), tqm(x))


def test_deeplabv3p_artifact_between_packages(deeplab, tmp_path):
    """DeepLabV3+ both ways: the port writes JAX's keys and arrays (slim
    rule included), JAX's artifact serves in the port bit-equal to the
    port's own model, and the port's loads in JAX as JAX's does."""
    v, x, scales = deeplab
    jqm, tqm = _deeplab_models(v, scales)
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    tdeploy.save_quantized(ours, tqm)
    jdeploy.save_quantized(theirs, jqm)
    (a, meta_a), (b, meta_b) = _npz(ours), _npz(theirs)
    assert sorted(a) == sorted(b) and meta_a == meta_b
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    back = tdeploy.load_quantized(theirs, device="cpu")
    assert back.arch == "deeplabv3p" and back.scales == scales
    assert torch.equal(back(x), tqm(x))
    _assert_tree_equal(jdeploy.load_quantized(theirs).qparams,
                       jdeploy.load_quantized(ours).qparams)


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


#: the last four ported architectures: (JAX module, class, bridge to the port's state_dict)
NEW_ARCHS = {"yoloseg": ("coastline.models.yoloseg", "YOLOSeg", ti.yoloseg_state_dict),
             "fastscnn": ("coastline.models.fastscnn", "FastSCNN", ti.fastscnn_state_dict),
             "enet": ("coastline.models.enet", "ENet", ti.enet_state_dict),
             "segformer_lite": ("coastline.models.segformer_lite", "SegFormerLite",
                                ti.segformer_lite_state_dict)}


@pytest.fixture(scope="module", params=sorted(NEW_ARCHS))
def new_arch(request):
    """JAX variables of one of the last four architectures (init from
    PRNGKey(0)), a (1, 64, 64, 3) input, the port's calibration on it, and
    the two packages' quantized models of those variables and scales."""
    import importlib

    import jax

    arch = request.param
    module, cls, to_sd = NEW_ARCHS[arch]
    key = jax.random.PRNGKey(0)
    m = getattr(importlib.import_module(module), cls)(dtype=jnp.float32)
    v = m.init({"params": key, "dropout": key}, jnp.zeros((1, 64, 64, 3), jnp.float32))
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                            "batch_stats": v["batch_stats"]})
    x = np.random.default_rng(3).standard_normal((1, 64, 64, 3)).astype(np.float32)
    tf = tq.ARCHS[arch][0](to_sd(v))
    scales = tq.calibrate(tf, torch.from_numpy(x), batch_size=1, arch=arch)
    jqm = jq.QuantizedModel(jq.quantize_folded(jq.ARCHS[arch][0](v)), scales, arch=arch)
    tqm = tq.QuantizedModel(tq.quantize_folded(tf), scales, arch=arch, device="cpu")
    return arch, x, scales, jqm, tqm


@pytest.mark.parametrize("slim", [True, False])
def test_new_arch_artifacts_between_packages(new_arch, tmp_path, slim):
    """YOLO-SEG, Fast-SCNN, ENet and SegFormer-Lite, slim and full, both
    ways: the port writes JAX's keys, arrays and metadata (the slim rule
    drops only int8-path `w`s, which no forward reads elsewhere), JAX loads
    the port's file as its own, and JAX's file serves in the port bit-equal
    to the port's model, with the same tree and scales."""
    arch, x, scales, jqm, tqm = new_arch
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    tdeploy.save_quantized(ours, tqm, slim=slim)
    jdeploy.save_quantized(theirs, jqm, slim=slim)
    (a, meta_a), (b, meta_b) = _npz(ours), _npz(theirs)
    assert sorted(a) == sorted(b) and meta_a == meta_b and meta_a["arch"] == arch
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    n_w, n_wq = (sum(k.endswith(leaf) for k in a) for leaf in ("/w", "/wq"))
    assert (n_w < n_wq) if slim else (n_w == n_wq)
    _assert_tree_equal(jdeploy.load_quantized(theirs).qparams,
                       jdeploy.load_quantized(ours).qparams)
    back = tdeploy.load_quantized(theirs, device="cpu")
    assert back.arch == arch and back.scales == scales and back.policy is None
    _assert_tree_equal(tdeploy.load_quantized(ours, device="cpu").qparams, back.qparams)
    assert torch.equal(back(x), tqm(x))
