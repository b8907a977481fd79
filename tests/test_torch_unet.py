"""Port UNet, its layers and the weight bridge vs the JAX package (CPU).

The same numpy-seeded weights and inputs go through the JAX modules and the
port; BN running statistics are drawn away from 0/1 so a wrong fold or
epsilon shows.

Tolerances:
  * float32: atol 2e-4 / rtol 1e-3, the bound the JAX package holds itself
    to against torch (tests/test_torch_import.py:114): the two frameworks
    sum the convolutions in different orders;
  * bfloat16 layers: JAX rounds to bf16 after the conv, the bias add, and
    BN's multiply and add; the fused path rounds once. A few bf16 ulps
    (2^-8 relative each) separate them: |d| <= 2^-5 |ref| + 2^-5;
  * bfloat16 UNet: those differences compound over 18 conv layers, so the
    check is on the logits' scale (max error under 10% of the logits' std)
    and on argmax agreement (>= 95% of pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.models.unet import UNet as JaxUNet
from coastline.ops.blocks import ConvBNAct as JaxConvBNAct
from coastline.ops.primitives import Conv as JaxConv
from coastline.ops.primitives import ConvTranspose as JaxConvTranspose
from coastline.ops.primitives import Norm as JaxNorm
from coastline.ops.primitives import max_pool as jax_max_pool
from coastline.utils.torch_import import export_reference_unet as jax_export_reference_unet
from coastline_torch.kernels.fused_conv import fused_conv3x3_bn_relu
from coastline_torch.models.unet import UNet
from coastline_torch.ops import blocks
from coastline_torch.ops.blocks import ConvBNAct
from coastline_torch.ops.primitives import Conv, ConvTranspose, Norm, max_pool
from coastline_torch.utils.torch_import import (export_reference_unet,
                                                random_unet_variables, unet_state_dict)

torch.set_num_threads(1)
F32 = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def variables():
    return random_unet_variables(seed=0)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _bn_tree(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.normal(0, 0.2, c).astype(np.float32)},
            {"mean": rng.normal(0, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.3, 2.0, c).astype(np.float32)})


def _port_bn(p, s):
    norm = Norm(p["scale"].shape[0])
    norm.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                          "bias": torch.from_numpy(p["bias"]),
                          "running_mean": torch.from_numpy(s["mean"]),
                          "running_var": torch.from_numpy(s["var"]),
                          "num_batches_tracked": torch.tensor(0)})
    return norm.eval()


def test_bridge_matches_jax_exporter_and_loads_strict(variables):
    ours = export_reference_unet(variables)
    ref = jax_export_reference_unet(variables)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    model = UNet()
    result = model.load_state_dict(unet_state_dict(variables), strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_random_variables_have_the_jax_tree(variables):
    init = jax.eval_shape(lambda: JaxUNet().init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 32, 32, 3))))
    want = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), dict(init))
    got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), variables)
    assert got == want


def test_unet_full_width_param_count():
    assert sum(p.numel() for p in UNet(n_classes=2).parameters()) == 31_043_586


def test_unet_f32_logits_match_jax(variables):
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JaxUNet(n_classes=2).apply(variables, x, train=False))
    model = UNet()
    model.load_state_dict(unet_state_dict(variables))
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), ref, **F32)


def test_unet_bf16_logits_close_to_jax(variables):
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JaxUNet(n_classes=2, dtype=jnp.bfloat16).apply(variables, x, train=False),
                     np.float32)
    model = UNet(dtype=torch.bfloat16)
    model.load_state_dict(unet_state_dict(variables))
    before = fused_conv3x3_bn_relu.launches
    with torch.no_grad():
        got = _nhwc(model.eval()(_nchw(x)))
    assert fused_conv3x3_bn_relu.launches == before  # CPU: plain version, no launch
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 0.1 * ref.std()
    assert np.mean(got.argmax(-1) == ref.argmax(-1)) >= 0.95


def test_unet_activations_stay_channels_last(variables):
    """The fused kernel reads activations as NHWC without a copy, so every
    activation reaching a 64->64 ConvBNAct must be channels_last."""
    model = UNet(dtype=torch.bfloat16)
    model.load_state_dict(unet_state_dict(variables))
    seen = []
    for name in ("enc1", "dec1"):
        getattr(model, name).register_forward_pre_hook(
            lambda m, args: seen.append(args[0].is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        model.eval()(torch.zeros(1, 3, 32, 32))
    assert seen == [True, True]


def _convbnact_case(seed, dtype):
    rng = np.random.default_rng(seed)
    bound = np.sqrt(6.0 / (9 * 64))
    conv = {"kernel": rng.uniform(-bound, bound, (3, 3, 64, 64)).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, 64).astype(np.float32)}
    bn_p, bn_s = _bn_tree(rng, 64)
    jv = {"params": {"Conv_0": {"Conv_0": conv}, "Norm_0": {"BatchNorm_0": bn_p}},
          "batch_stats": {"Norm_0": {"BatchNorm_0": bn_s}}}
    x = rng.normal(size=(2, 16, 24, 64)).astype(np.float32)
    ref = np.asarray(JaxConvBNAct(64, 3, padding=1, dtype=dtype).apply(jv, x), np.float32)
    mod = ConvBNAct(64, 64)
    mod.load_state_dict({
        "0.weight": torch.from_numpy(conv["kernel"].transpose(3, 2, 0, 1).copy()),
        "0.bias": torch.from_numpy(conv["bias"]),
        "1.weight": torch.from_numpy(bn_p["scale"]), "1.bias": torch.from_numpy(bn_p["bias"]),
        "1.running_mean": torch.from_numpy(bn_s["mean"]),
        "1.running_var": torch.from_numpy(bn_s["var"]),
        "1.num_batches_tracked": torch.tensor(0)})
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = _nchw(x).to(tdt).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = mod.eval()(xt)
    return ref, got


def test_convbnact_f32_matches_jax():
    ref, got = _convbnact_case(3, jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), ref, **F32)


def test_convbnact_bf16_fold_matches_jax():
    """bf16, 64->64, 3x3: the BN + conv-bias fold feeding the fused conv."""
    ref, got = _convbnact_case(4, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    got = _nhwc(got)
    assert np.all(np.abs(got - ref) <= 2.0 ** -5 * np.abs(ref) + 2.0 ** -5)
    assert got.min() == 0.0


@pytest.mark.parametrize("dtype,calls", [(torch.bfloat16, 2), (torch.float32, 0)])
def test_fused_conv_routes_only_the_full_res_64_layers(variables, monkeypatch, dtype, calls):
    """bf16: exactly `enc1` and `dec1` conv 2 go through the fused conv
    (the kernel's 2 launches a forward on the card); f32: none."""
    seen = []

    def spy(x, w, scale, bias, relu):
        seen.append(tuple(x.shape))
        return fused_conv3x3_bn_relu(x, w, scale, bias, relu)

    monkeypatch.setattr(blocks, "fused_conv3x3_bn_relu", spy)
    model = UNet(dtype=dtype)
    model.load_state_dict(unet_state_dict(variables))
    with torch.no_grad():
        model.eval()(torch.zeros(1, 3, 32, 32))
    assert seen == [(1, 32, 32, 64)] * calls


@pytest.mark.parametrize("cin,cout,k,pad", [(3, 64, 3, 1), (128, 2, 1, 0), (16, 8, 3, 1)])
def test_conv_f32_matches_jax(cin, cout, k, pad):
    rng = np.random.default_rng(cin + cout)
    kern = rng.normal(0, 0.2, (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.2, cout).astype(np.float32)
    x = rng.normal(size=(2, 12, 10, cin)).astype(np.float32)
    ref = np.asarray(JaxConv(cout, k, padding=pad).apply(
        {"params": {"Conv_0": {"kernel": kern, "bias": bias}}}, x))
    mod = Conv(cin, cout, k, padding=pad)
    mod.load_state_dict({"weight": torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                         "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(mod(_nchw(x))), ref, **F32)


def test_conv_transpose_f32_matches_jax():
    """k2/s2 upsampler: the JAX kernel is stored flipped; the bridge's
    un-flip must give torch ConvTranspose2d's weight."""
    from coastline_torch.utils.torch_import import _convT_inv

    rng = np.random.default_rng(5)
    tree = {"kernel": rng.normal(0, 0.2, (2, 2, 32, 16)).astype(np.float32),
            "bias": rng.normal(0, 0.2, 16).astype(np.float32)}
    x = rng.normal(size=(2, 6, 5, 32)).astype(np.float32)
    ref = np.asarray(JaxConvTranspose(16, 2, 2).apply({"params": tree}, x))
    mod = ConvTranspose(32, 16)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in _convT_inv(tree).items()})
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x)))
    assert got.shape == (2, 12, 10, 16)
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_eval_matches_jax(dtype):
    """Scale/shift formed in f32, applied in the compute dtype: bf16 rounds
    where JAX rounds, so the two agree to one bf16 ulp."""
    rng = np.random.default_rng(6)
    p, s = _bn_tree(rng, 32)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(JaxNorm(jdt).apply(
        {"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": s}},
        jnp.asarray(x, jdt)), np.float32)
    with torch.no_grad():
        got = _port_bn(p, s)(_nchw(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(got), ref, atol=1e-6, rtol=1e-6)
    else:
        got = _nhwc(got)
        assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6)


def test_norm_train_mode_raises():
    """Train mode no longer raises: it normalizes with the batch statistics
    and moves the running ones (held against JAX in test_torch_train.py)."""
    norm = Norm(4).train()
    y = norm(torch.arange(16.0).reshape(1, 4, 2, 2))
    assert torch.allclose(y.mean((0, 2, 3)), torch.zeros(4), atol=1e-6)
    assert int(norm.num_batches_tracked) == 1 and float(norm.running_mean[0]) == pytest.approx(0.15)


def test_max_pool_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 8, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(max_pool(_nchw(x))), np.asarray(jax_max_pool(x)))
