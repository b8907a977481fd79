"""The rest of the model zoo in the port vs the JAX package (CPU): parameter
counts, the weight bridge both ways, the zoo's primitives, the fused conv's
routing, and the comparison protocol's default model list.

The nine models (DeepLabV3+, YOLO-SEG, PSPNet, Fast-SCNN, ENet, WaterNet,
MSWNet, HRNet-Water, SegFormer-Lite) are built at full width. Their forward
parity against JAX in eval and in train mode is in
`tests/test_torch_zoo_eval.py` and `tests/test_torch_zoo_train.py`, which
share `ZOO` and `jax_variables` from here.

Tolerance: float32 atol 2e-4 / rtol 1e-3, the bound the JAX package holds
itself to against torch (`tests/test_torch_import.py:114`); the primitives
at atol 1e-5 / rtol 1e-5 (one layer of float32 sums in another order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from chip_smoke import zoo_state_dict
from coastline.models import registry as jax_registry
from coastline.ops import primitives as jax_prims
from coastline.utils import torch_import as jax_import
from coastline_torch.cli import bench_all
from coastline_torch.models.registry import create_model
from coastline_torch.ops import blocks, primitives
from coastline_torch.ops.blocks import ConvBNAct, conv_bn
from coastline_torch.ops.primitives import Conv, ConvTranspose
from coastline_torch.utils import torch_import

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIM = dict(atol=1e-5, rtol=1e-5)

# registry name -> (key in baselines/reference_param_counts.json, JAX importer suffix,
# the JAX package's parity size, `tests/test_torch_import.py:175-193`)
ZOO = {
    "DeepLabV3+": ("DeepLabV3Plus", "deeplabv3plus", 96),
    "YOLO-SEG": ("YOLOSeg", "yoloseg", 96),
    "PSPNet": ("PSPNet", "pspnet", 96),
    "Fast-SCNN": ("FastSCNN", "fastscnn", 96),
    "ENet": ("ENet", "enet", 96),
    "WaterNet": ("WaterNet", "waternet", 64),
    "MSWNet": ("MSWNet", "mswnet", 64),
    "HRNet-Water": ("HRNetWater", "hrnet_water", 64),
    "SegFormer-Lite": ("SegFormerLite", "segformer_lite", 64),
}


def jax_variables(name, sd):
    """A port state_dict -> the JAX model's variables, through the JAX
    package's own importer (which must accept every name)."""
    importer = getattr(jax_import, f"import_reference_{ZOO[name][1]}")
    return importer({k: v.numpy() for k, v in sd.items()})


@pytest.fixture(scope="module")
def reference_counts():
    with open(os.path.join(REPO, "baselines", "reference_param_counts.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(ZOO))
def test_full_width_param_count(name, reference_counts):
    model = create_model(name)
    assert sum(p.numel() for p in model.parameters()) == reference_counts[ZOO[name][0]]
    assert model.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("name", list(ZOO))
def test_bridge_both_ways(name):
    """Port init -> JAX importer (every name accepted, the JAX init's tree),
    the port's exporter equal to JAX's array for array on those variables,
    and `<arch>_state_dict` loading strictly, back to the same tensors."""
    sd = zoo_state_dict(name)
    variables = jax_variables(name, sd)
    init = jax.eval_shape(lambda: jax_registry.create_model(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    for col in ("params", "batch_stats"):
        got = {jax.tree_util.keystr(p): np.shape(v)
               for p, v in jax.tree_util.tree_flatten_with_path(variables[col])[0]}
        want = {jax.tree_util.keystr(p): v.shape
                for p, v in jax.tree_util.tree_flatten_with_path(init[col])[0]}
        assert got == want, col
    ours = getattr(torch_import, f"export_reference_{ZOO[name][1]}")(variables)
    theirs = jax_import.REFERENCE_EXPORTERS[name](variables)
    assert set(ours) == set(theirs) == set(sd)
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(v), err_msg=k)
    state = getattr(torch_import, f"{ZOO[name][1]}_state_dict")(variables)
    model = create_model(name)
    model.load_state_dict(state, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _tensors(tree):
    return {n: torch.from_numpy(np.array(t)) for n, t in tree.items()}


@pytest.mark.parametrize("k,s,p,op", [(2, 2, 0, 0), (4, 2, 1, 0), (3, 2, 1, 1)])
def test_conv_transpose_variants_match_jax_through_the_bridge(k, s, p, op):
    """The JAX layer applies its kernel unflipped to the input-dilated map;
    the bridge's `_convT_inv` flips it into torch's layout."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 7, 9, 6)).astype(np.float32)
    layer = jax_prims.ConvTranspose(5, k, s, padding=p, output_padding=op)
    variables = layer.init(jax.random.PRNGKey(k), jnp.asarray(x))
    ref = np.asarray(layer.apply(variables, jnp.asarray(x)))
    mod = ConvTranspose(6, 5, k, s, p, output_padding=op)
    mod.load_state_dict(_tensors(torch_import._convT_inv(jax.device_get(variables["params"]))))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    size = [(n - 1) * s - 2 * p + k + op for n in (7, 9)]
    assert got.shape == ref.shape == (2, *size, 5)
    np.testing.assert_allclose(got, ref, **PRIM)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=7, stride=4, padding=3),
    dict(kernel_size=3, padding=1, groups=8),
    dict(kernel_size=3, padding=4, dilation=4, use_bias=False),
    dict(kernel_size=(5, 1), padding=(2, 0), use_bias=False),
    dict(kernel_size=4, stride=4),
])
def test_conv_options_match_jax(kw):
    rng = np.random.default_rng(len(kw))
    x = rng.standard_normal((2, 13, 16, 8)).astype(np.float32)

    class Layer(fnn.Module):  # the JAX Conv's `init` field hides Module.init
        @fnn.compact
        def __call__(self, t):
            return jax_prims.Conv(8, **kw)(t)

    variables = Layer().init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(Layer().apply(variables, jnp.asarray(x)))
    kw = dict(kw)
    mod = Conv(8, 8, kw.pop("kernel_size"), **kw)
    mod.load_state_dict(_tensors(torch_import._conv_inv(
        jax.device_get(variables["params"])["Conv_0"]["Conv_0"])))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **PRIM)


def test_conv_init_and_bias_fan_in_follow_groups():
    """torch's default bias bound 1/sqrt(fan_in), fan_in = (in / groups) * kh * kw."""
    conv = Conv(64, 64, 3, padding=1, groups=64, generator=torch.Generator().manual_seed(0))
    assert tuple(conv.weight.shape) == (64, 1, 3, 3)
    bias, weight = conv.bias.detach().abs().max(), conv.weight.detach().abs().max()
    assert float(bias) <= 1 / 3 and float(weight) <= 1 / 3
    assert float(bias) > 0.25  # the bound of fan_in 9, not 576


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("window,stride,padding", [(2, None, 0), (3, 1, 1), (3, 2, 1)])
def test_max_pool_variants_match_jax(window, stride, padding):
    x = np.random.default_rng(window).standard_normal((2, 11, 12, 3)).astype(np.float32)
    ref = np.asarray(jax_prims.max_pool(jnp.asarray(x), window, stride, padding))
    got = primitives.max_pool(_nchw(x), window, stride, padding).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw,k", [((32, 32), 3), ((32, 32), 6), ((6, 6), 2), ((5, 7), 3),
                                  ((4, 4), 6)])
def test_adaptive_pools_match_jax(hw, k):
    """The non-divisible window bounds (PSPNet's levels 3 and 6 at 512^2)."""
    x = np.random.default_rng(k).standard_normal((2, *hw, 4)).astype(np.float32)
    for jfn, fn in ((jax_prims.adaptive_avg_pool, primitives.adaptive_avg_pool),
                    (jax_prims.adaptive_max_pool, primitives.adaptive_max_pool)):
        ref = np.asarray(jfn(jnp.asarray(x), k))
        np.testing.assert_allclose(fn(_nchw(x), k).permute(0, 2, 3, 1).numpy(), ref, **PRIM)


def test_global_and_window_pools_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 10, 4)).astype(np.float32)
    for jfn, fn in ((jax_prims.avg_pool_global, primitives.avg_pool_global),
                    (jax_prims.max_pool_global, primitives.max_pool_global),
                    (lambda t: jax_prims.avg_pool(t, 2), lambda t: primitives.avg_pool(t, 2))):
        got = fn(_nchw(x)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))), **PRIM)


@pytest.mark.parametrize("src,dst", [
    ((1, 1), (6, 6)),      # ASPP's image pool
    ((2, 2), (32, 32)), ((3, 3), (32, 32)), ((6, 6), (32, 32)),  # PSPNet at 512^2
    ((32, 32), (64, 64)),  # Fast-SCNN /16 -> /8, HRNet x2
    ((4, 4), (32, 32)),    # SegFormer /32 -> /4
    ((32, 32), (128, 128)),  # SegFormer /4 -> input
    ((5, 7), (12, 9)),
])
def test_bilinear_resize_matches_jax_f32(src, dst):
    """Every resize ratio the zoo makes: all upsamples, where torch's
    half-pixel bilinear and `jax.image.resize(antialias=False)` are one
    function in float32 (in bf16 they round otherwise; no bound there)."""
    x = np.random.default_rng(sum(dst)).standard_normal((2, *src, 3)).astype(np.float32)
    ref = np.asarray(jax_prims.bilinear_resize(jnp.asarray(x), dst))
    got = primitives.bilinear_resize(_nchw(x), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **PRIM)


def test_nearest_resizes_match_jax():
    x = np.random.default_rng(0).standard_normal((1, 5, 6, 2)).astype(np.float32)
    ref = np.asarray(jax_prims.upsample_nearest(jnp.asarray(x), 3))
    np.testing.assert_array_equal(
        primitives.upsample_nearest(_nchw(x), 3).permute(0, 2, 3, 1).numpy(), ref)
    for size in ((10, 12), (15, 9), (3, 4)):
        ref = np.asarray(jax_prims.nearest_resize(jnp.asarray(x), size))
        np.testing.assert_array_equal(
            primitives.nearest_resize(_nchw(x), size).permute(0, 2, 3, 1).numpy(), ref)


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls `conv_bn` makes to the fused conv kernel's wrapper."""
    calls, real = [], blocks.fused_conv3x3_bn_relu

    def spy(x, w, scale, bias, relu=True):
        calls.append(relu)
        return real(x, w, scale, bias, relu)

    monkeypatch.setattr(blocks, "fused_conv3x3_bn_relu", spy)
    return calls


@pytest.mark.parametrize("kw,act,launches", [
    (dict(), "relu", 1),
    (dict(), "none", 1),
    (dict(stride=2), "relu", 0),
    (dict(groups=2), "relu", 0),
    (dict(groups=64), "none", 0),
    (dict(padding=2, dilation=2), "relu", 0),
    (dict(kernel_size=(3, 1), padding=(1, 0)), "relu", 0),
    (dict(), "leaky", 0),
    (dict(), "gelu", 0),
])
def test_fused_conv_takes_only_its_own_function(fused_calls, kw, act, launches):
    """A bf16 64 -> 64 conv -> BN at eval reaches the fused kernel only as a
    3x3, stride-1, padding-1, undilated, one-group conv followed by a ReLU or
    nothing; every other one (and the result) is the module path's."""
    gen = torch.Generator().manual_seed(0)
    mod = ConvBNAct(64, 64, act=act, generator=gen, **kw).eval()
    x = torch.randn((2, 64, 12, 12), generator=gen).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert blocks._fusable(mod[0], x, act) == bool(launches)
    with torch.no_grad():
        got = conv_bn(mod[0], mod[1], x, act)
        ref = blocks.activation(mod[1](mod[0](x)), act)
    assert len(fused_calls) == launches and fused_calls == [act == "relu"] * launches
    assert got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    assert bool(torch.all(err <= 2.0 ** -5 * ref.float().abs() + 2.0 ** -5))  # one fold, bf16
    if not launches:
        assert torch.equal(got, ref)


def test_fused_conv_never_in_float32_or_train_mode(fused_calls):
    gen = torch.Generator().manual_seed(1)
    mod = ConvBNAct(64, 64, generator=gen)
    x = torch.randn((2, 64, 8, 8), generator=gen)
    with torch.no_grad():
        mod.eval()(x.contiguous(memory_format=torch.channels_last))
        mod.train()(x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
    assert fused_calls == []
    with pytest.raises(ValueError, match="act must be one of"):
        ConvBNAct(64, 64, act="swish")


@pytest.mark.parametrize("name,launches", [("WaterNet", 2), ("HRNet-Water", 1),
                                           ("MSWNet", 0), ("DeepLabV3+", 0), ("Fast-SCNN", 0)])
def test_zoo_fused_conv_launches_a_bf16_forward(fused_calls, name, launches):
    """WaterNet's `enc1`/`dec1` second convs and HRNet-Water's second stem
    conv are the only 64 -> 64 3x3s of the zoo; none in float32."""
    x = torch.randn((1, 3, 64, 64), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        create_model(name).eval()(x)
        assert fused_calls == []
        create_model(name, dtype=torch.bfloat16).eval()(x)
    assert len(fused_calls) == launches


def test_protocol_default_list_trains_and_evaluates_all_eleven(tmp_path, capsys):
    """`python -m coastline_torch.cli.bench_all --synthetic 6 --image-size 32
    --epochs 1 --device cpu` with no `--models`: the JAX CLI's default list
    of eleven models, each trained and evaluated, one results row each."""
    assert bench_all.DEFAULT_BENCH_MODELS == [
        "Robust UNet", "DeepLabV3+", "YOLO-SEG", "SegNet", "PSPNet", "Fast-SCNN", "ENet",
        "WaterNet", "MSWNet", "HRNet-Water", "SegFormer-Lite"]
    rc = bench_all.main(["--synthetic", "6", "--image-size", "32", "--epochs", "1",
                         "--throughput-batch", "4", "--device", "cpu",
                         "--out-dir", str(tmp_path)])
    assert rc == 0
    said = capsys.readouterr().out
    with open(tmp_path / "benchmark_results.json") as f:
        out = json.load(f)
    assert list(out["results"]) == bench_all.DEFAULT_BENCH_MODELS
    with open(os.path.join(REPO, "baselines", "reference_param_counts.json")) as f:
        ref = json.load(f)
    keys = {n: ZOO[n][0] for n in ZOO} | {"Robust UNet": "RobustUNet", "SegNet": "SegNet"}
    assert out["param_counts"] == {n: ref[keys[n]] for n in bench_all.DEFAULT_BENCH_MODELS}
    for name, res in out["results"].items():
        assert 0.0 <= res["mean_iou"] <= 1.0 and res["total_samples"] == 2, name
        assert len(out["histories"][name]["train_loss"]) == 1
        assert np.isfinite(out["histories"][name]["train_loss"][0])
    rows = [line for line in said.splitlines()
            if any(line.startswith(n) for n in bench_all.DEFAULT_BENCH_MODELS)]
    assert len(rows) == 11
