"""Port Robust U-Net, its blocks, the registry and the weight bridge vs the
JAX package (CPU).

The same numpy-seeded weights and inputs go through the JAX modules and the
port; BN running statistics and affines are drawn away from 0/1 so a wrong
fold or epsilon shows. On the CPU the CBAM kernels and the fused conv run
their plain versions.

Tolerances:
  * float32: atol 2e-4 / rtol 1e-3, the bound the JAX package holds itself
    to against torch (tests/test_torch_import.py:114): the two frameworks
    sum the convolutions in different orders;
  * bfloat16 model: JAX rounds after every op and the fused conv once, the
    7x7 conv and the MLP sum in other orders before a rounding; a few bf16
    ulps a layer compound over 23 conv layers and nine attention tails, so
    the check is on the logits' scale (max error under 10% of the logits'
    std) and on the thresholded mask (>= 95% of pixels agree);
  * the port's fused tail against its own module composition: float32 to
    1e-5; bfloat16 within 2^-5 (|y| + |ref|), the bound of
    tests/test_torch_cbam.py (one bf16 ulp for each of the gates and the
    three rounded ops).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from coastline.models import registry as jax_registry
from coastline.models.robust_unet import RobustUNet as JaxRobustUNet
from coastline.ops.blocks import AttentionGate as JaxAttentionGate
from coastline.ops.blocks import DilatedBlock as JaxDilatedBlock
from coastline.ops.blocks import ResidualBlock as JaxResidualBlock
from coastline.utils.torch_import import (export_reference_robust_unet as
                                          jax_export_reference_robust_unet)
from coastline_torch.kernels.fused_conv import fused_conv3x3_bn_relu
from coastline_torch.models.registry import (available_models, canonical_name, create_model,
                                             model_class)
from coastline_torch.models.robust_unet import RobustUNet
from coastline_torch.models.segnet import SegNet
from coastline_torch.models.unet import UNet
from coastline_torch.ops import blocks
from coastline_torch.ops.blocks import AttentionGate, DilatedBlock, ResidualBlock
from coastline_torch.utils.torch_import import (export_reference_robust_unet,
                                                random_robust_unet_variables,
                                                robust_unet_state_dict)

torch.set_num_threads(1)
F32 = dict(atol=2e-4, rtol=1e-3)
ROBUST_UNET_PARAMS = 40_872_223


@pytest.fixture(scope="module")
def variables():
    return random_robust_unet_variables(seed=0)


@pytest.fixture(scope="module")
def small_variables():
    return random_robust_unet_variables(seed=1, base=16)


@pytest.fixture(scope="module")
def model_f32(variables):
    model = RobustUNet()
    model.load_state_dict(robust_unet_state_dict(variables), strict=True)
    return model.eval()


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def test_bridge_matches_jax_exporter_and_loads_strict(variables):
    ours = export_reference_robust_unet(variables)
    ref = jax_export_reference_robust_unet(variables)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    result = RobustUNet().load_state_dict(robust_unet_state_dict(variables), strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_random_variables_have_the_jax_tree(small_variables):
    init = jax.eval_shape(lambda: JaxRobustUNet(base=16).init(jax.random.PRNGKey(0),
                                                              jnp.zeros((1, 32, 32, 3))))
    want = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), dict(init))
    got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), small_variables)
    assert got == want


def test_full_width_param_count(model_f32):
    assert sum(p.numel() for p in model_f32.parameters()) == ROBUST_UNET_PARAMS


def test_random_init_is_seeded_and_kaiming_fan_out():
    """The port's own init: seeded, convs kaiming-normal fan_out, the
    channel MLP flax he_normal (truncated at 2 std), BN gamma 1 / beta 0."""
    a, b = RobustUNet(base=16), RobustUNet(base=16)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    w = a.dec1.conv2.weight.detach()  # (16, 16, 3, 3): fan_out 144
    assert abs(float(w.std()) - np.sqrt(2 / 144)) < 0.15 * np.sqrt(2 / 144)
    fc = a.down3[1].ca.fc[0].weight.detach()  # (8, 128, 1, 1): fan_in 128
    std = np.sqrt(2 / 128) / 0.87962566103423978
    assert float(fc.abs().max()) <= 2 * std
    assert torch.all(a.inc.bn1.weight == 1) and torch.all(a.inc.bn1.bias == 0)


def test_f32_logits_match_jax(variables, model_f32):
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JaxRobustUNet().apply(variables, x, train=False, return_logits=True))
    with torch.no_grad():
        got = model_f32(_nchw(x), return_logits=True)
        probs = model_f32(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 64, 64)
    np.testing.assert_allclose(_nhwc(got), ref, **F32)
    assert ref.std() > 0.5  # activations O(1): the comparison has something to see
    np.testing.assert_allclose(probs.numpy(), torch.sigmoid(got).numpy(), rtol=1e-6)


def test_bf16_logits_close_to_jax(variables):
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JaxRobustUNet(dtype=jnp.bfloat16).apply(
        variables, x, train=False, return_logits=True), np.float32)
    model = RobustUNet(dtype=torch.bfloat16)
    model.load_state_dict(robust_unet_state_dict(variables))
    before = fused_conv3x3_bn_relu.launches
    with torch.no_grad():
        got = _nhwc(model.eval()(_nchw(x), return_logits=True))
    assert fused_conv3x3_bn_relu.launches == before  # CPU: plain versions, no launch
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 0.1 * ref.std()
    assert np.mean((got > 0) == (ref > 0)) >= 0.95


def _block_state(variables, prefix):
    """The port state_dict of one block, cut out of the bridge's output."""
    sd = robust_unet_state_dict(variables)
    return {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


@pytest.mark.parametrize("index,prefix,cin,cout", [(0, "inc", 3, 16), (4, "bottleneck.2", 256, 256),
                                                   (8, "dec1", 32, 16)])
def test_residual_block_f32_matches_jax(small_variables, index, prefix, cin, cout):
    """With a 1x1 + BN shortcut (in != out) and with the identity."""
    v = {c: small_variables[c][f"ResidualBlock_{index}"] for c in ("params", "batch_stats")}
    size = 4 if cin == 256 else 16
    x = np.random.default_rng(index).normal(size=(2, size, size, cin)).astype(np.float32)
    ref = np.asarray(JaxResidualBlock(cout, conv_init="kaiming_out").apply(v, x))
    block = ResidualBlock(cin, cout)
    block.load_state_dict(_block_state(small_variables, prefix), strict=True)
    assert (block.shortcut is None) == (cin == cout)
    with torch.no_grad():
        got = block.eval()(_nchw(x).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(_nhwc(got), ref, **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_block_fused_tail_equals_module_tail(small_variables, dtype):
    block = ResidualBlock(32, 16)
    block.load_state_dict(_block_state(small_variables, "dec1"), strict=True)
    x = _nchw(np.random.default_rng(3).normal(size=(2, 16, 16, 32))).to(dtype)
    with torch.no_grad():
        y, shortcut = block.eval().body(x.contiguous(memory_format=torch.channels_last))
        got, ref = block.fused_tail(y, shortcut).float(), block.module_tail(y, shortcut).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        assert torch.all((got - ref).abs() <= 2.0 ** -5 * (y.float().abs() + ref.abs()))


def test_attention_gate_f32_matches_jax(small_variables):
    v = {c: small_variables[c]["AttentionGate_3"] for c in ("params", "batch_stats")}
    rng = np.random.default_rng(4)
    g = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
    x = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
    ref = np.asarray(JaxAttentionGate(8, conv_init="kaiming_out").apply(v, g, x))
    gate = AttentionGate(16, 16, 8)
    gate.load_state_dict(_block_state(small_variables, "att1"), strict=True)
    with torch.no_grad():
        got = gate.eval()(_nchw(g), _nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, **F32)


def test_dilated_block_f32_matches_jax(small_variables):
    v = {c: small_variables[c]["DilatedBlock_0"] for c in ("params", "batch_stats")}
    x = np.random.default_rng(5).normal(size=(2, 9, 11, 128)).astype(np.float32)
    ref = np.asarray(JaxDilatedBlock(256, conv_init="kaiming_out").apply(v, x))
    block = DilatedBlock(128, 256)
    block.load_state_dict(_block_state(small_variables, "bottleneck.1"), strict=True)
    with torch.no_grad():
        got = block.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, **F32)


def test_blocks_are_eval_only(small_variables):
    """The blocks' train mode: `ResidualBlock.train()` (module tail,
    mean/amax channel pooling, batch-statistics BN) against the JAX block
    with dropout off, on its output, the updated BN statistics and the
    input and parameter gradients (float32 bounds; the gradients within
    1e-4 of each tensor's largest); then `Dropout2d`'s masks."""
    v = {c: small_variables[c]["ResidualBlock_8"] for c in ("params", "batch_stats")}
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    r = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)

    def loss(params, x):
        y, upd = JaxResidualBlock(16, 0.0, conv_init="kaiming_out").apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
            mutable=["batch_stats"])
        return (y * r).sum(), (y, upd["batch_stats"])

    (_, (ref_y, ref_stats)), (ref_gp, ref_gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    block = ResidualBlock(32, 16, dropout_rate=0.0)
    block.load_state_dict(_block_state(small_variables, "dec1"), strict=True)
    xt = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    y = block.train()(xt)
    (y * _nchw(r)).sum().backward()
    np.testing.assert_allclose(_nhwc(y.detach()), np.asarray(ref_y), **F32)
    want_stats = jax_export_reference_robust_unet(
        {"params": small_variables["params"],
         "batch_stats": {**small_variables["batch_stats"], "ResidualBlock_8": ref_stats}})
    for k, t in block.state_dict().items():
        if ".running_" in k:
            np.testing.assert_allclose(t.numpy(), want_stats[f"dec1.{k}"], atol=2e-5, rtol=2e-4,
                                       err_msg=k)
    gx = np.asarray(ref_gx)
    np.testing.assert_allclose(_nhwc(xt.grad), gx, atol=1e-4 * np.abs(gx).max(), rtol=0)
    want_grads = jax_export_reference_robust_unet(
        {"params": {**small_variables["params"], "ResidualBlock_8": jax.device_get(ref_gp)},
         "batch_stats": small_variables["batch_stats"]})
    for k, p in block.named_parameters():
        g = want_grads[f"dec1.{k}"]
        np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-4 * np.abs(g).max(), rtol=0,
                                   err_msg=k)

    # Dropout2d: whole (sample, channel) maps kept with probability 1 - p and
    # scaled by 1 / (1 - p), drawn from the generator it is handed
    p, shape = 0.3, (64, 256, 3, 5)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1)) + 0.5
    drop = blocks.Dropout2d(p)
    gen = torch.Generator().manual_seed(2)
    blocks.set_dropout_generator(nn.Sequential(drop), gen)
    y = drop.train()(x)
    kept = y.flatten(2).ne(0).all(2)
    assert torch.equal(kept, y.flatten(2).ne(0).any(2))  # a map is kept or dropped whole
    n = kept.numel()
    assert abs(float(kept.float().mean()) - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(y[kept], (x / (1 - p))[kept])
    gen.manual_seed(2)
    assert torch.equal(drop(x), y)  # the masks are a function of the generator
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(blocks.Dropout2d(0.0).train()(x), x)


def test_registry_names_aliases_and_unknown():
    """All twelve names of the JAX registry and its aliases resolve to the
    same display names; an unknown name raises with the full list."""
    jax_registry._populate()
    assert available_models() == jax_registry.available_models()
    assert len(available_models()) == 12
    for alias, name in jax_registry._ALIASES.items():
        assert canonical_name(alias) == name
        assert canonical_name(alias.upper()) == name
        assert model_class(alias).__name__ == jax_registry.MODEL_REGISTRY[name].__name__
    for alias in ("Robust UNet", "robust_unet", "RobustUNet", "ROBUSTUNET"):
        assert canonical_name(alias) == "Robust UNet"
    assert canonical_name("unet") == "UNet" and canonical_name("segnet") == "SegNet"
    assert canonical_name("PSPNet++") == "PSPNet++"  # unknown: passes through
    model = create_model("robust_unet", base=16, dtype=torch.bfloat16)
    assert isinstance(model, RobustUNet) and model.dtype == torch.bfloat16
    assert isinstance(create_model("UNet", n_classes=2), UNet)
    assert isinstance(create_model("SEGNET", dtype=torch.bfloat16), SegNet)
    with pytest.raises(KeyError, match=re.escape(f"available: {available_models()}")):
        create_model("PSPNet++")


@pytest.mark.parametrize("dtype,fused_convs", [(torch.bfloat16, 2), (torch.float32, 0)])
def test_tail_and_fused_conv_inputs_are_channels_last_views(small_variables, monkeypatch,
                                                            dtype, fused_convs):
    """Every kernel input is the NHWC view of a channels_last activation, so
    the kernels read it without a copy: nine fused tails a forward, and in
    bf16 the two 64-channel ResidualBlocks' conv 2 through the fused conv
    with relu=False (base 64: `inc` and `dec1`)."""
    tails, convs = [], []

    def tail_spy(y, shortcut, fc1, fc2, sconv):
        tails.append((y.is_contiguous(), shortcut.is_contiguous(), y.shape[-1]))
        return blocks_fused_cbam_tail(y, shortcut, fc1, fc2, sconv)

    def conv_spy(x, w, scale, bias, relu):
        convs.append((x.is_contiguous(), tuple(x.shape), relu))
        return fused_conv3x3_bn_relu(x, w, scale, bias, relu)

    blocks_fused_cbam_tail = blocks.fused_cbam_tail
    monkeypatch.setattr(blocks, "fused_cbam_tail", tail_spy)
    monkeypatch.setattr(blocks, "fused_conv3x3_bn_relu", conv_spy)
    model = RobustUNet(base=64, dtype=dtype).eval()
    with torch.no_grad():
        model(torch.zeros(1, 3, 32, 32))
    assert [t[:2] for t in tails] == [(True, True)] * 9
    assert [t[2] for t in tails] == [64, 128, 256, 512, 1024, 512, 256, 128, 64]
    assert convs == [(True, (1, 32, 32, 64), False)] * fused_convs
