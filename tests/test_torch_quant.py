"""The port's int8 PTQ building blocks vs the JAX package (CPU):
`coastline_torch/infer/quant.py` and the plain version of
`kernels/int8_conv.py` against `coastline/infer/quant.py`.

Tolerance: none. The folds and `quantize_folded` are bit-equal on the same
variables passed through the weight bridge; `int8_conv_plain` is bit-equal
to the int8 branch of JAX's `_conv` (the same int32 sums, the same float32
epilogue in the same order) for every option the twelve forwards use
(stride 2 and 4, the 2x2, 3x3 and 4x4 transposed convs, C_in = 144 among
them), in a float32 and a bfloat16 context; a site's codes and its
dequantized values are bit-equal; the pools and unpool on codes equal the
JAX primitives, ties included. The float path's 4x4 and 3x3 transposed
convs and its grouped convs are held within float32 rounding (rtol and
atol 1e-5) of JAX's lhs-dilated and grouped convs. `leaky_relu` equals
`jax.nn.leaky_relu` bit for bit in both dtypes; `_gelu` equals
`jax.nn.gelu(approximate=False)` bit for bit in bfloat16, and within 5e-6
relative in float32, where torch's erfc is not XLA's polynomial; both
exclude subnormal inputs and outputs (the test says why). JAX runs op by op here (no jit): under jit XLA contracts the
epilogue's multiply and add into an FMA, a rounding the JAX package's own
op-by-op path does not make.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.infer import quant as jq
from coastline.ops import primitives as jax_primitives
from coastline_torch.infer import quant as tq
from coastline_torch.kernels import unpool
from coastline_torch.kernels.int8_conv import (int8_conv, int8_conv_plain, leaky_relu,
                                               pack_weights, packed, parity_taps)
from coastline_torch.utils import torch_import as ti

torch.set_num_threads(1)

#: the policy variants of tests/test_quant.py, by name
POLICIES = {"default": None,
            "all_float_convs": {"conv_min_ch": 10**9, "convT_int8": False},
            "gated_int8": {"gated_int8": True},
            "split_cat": {"split_cat": True},
            "gated_int8_split_cat": {"gated_int8": True, "split_cat": True}}
STATE_DICTS = {"unet": ti.unet_state_dict, "robust_unet": ti.robust_unet_state_dict,
               "segnet": ti.segnet_state_dict, "waternet": ti.waternet_state_dict,
               "mswnet": ti.mswnet_state_dict, "hrnet_water": ti.hrnet_water_state_dict,
               "pspnet": ti.pspnet_state_dict, "deeplabv3p": ti.deeplabv3plus_state_dict,
               "yoloseg": ti.yoloseg_state_dict, "fastscnn": ti.fastscnn_state_dict,
               "enet": ti.enet_state_dict, "segformer_lite": ti.segformer_lite_state_dict}
#: the JAX model classes of the zoo architectures, by ARCHS key
ZOO_MODELS = {"waternet": ("coastline.models.waternet", "WaterNet"),
              "mswnet": ("coastline.models.mswnet", "MSWNet"),
              "hrnet_water": ("coastline.models.hrnet_water", "HRNetWater"),
              "pspnet": ("coastline.models.pspnet", "PSPNet"),
              "deeplabv3p": ("coastline.models.deeplabv3p", "DeepLabV3Plus"),
              "yoloseg": ("coastline.models.yoloseg", "YOLOSeg"),
              "fastscnn": ("coastline.models.fastscnn", "FastSCNN"),
              "enet": ("coastline.models.enet", "ENet"),
              "segformer_lite": ("coastline.models.segformer_lite", "SegFormerLite")}

ARCHS = {"unet": (ti.random_unet_variables, ti.unet_state_dict),
         "robust_unet": (ti.random_robust_unet_variables, ti.robust_unet_state_dict),
         "segnet": (ti.random_segnet_variables, ti.segnet_state_dict)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _assert_tree_equal(a, b, path="q"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype)
        assert np.array_equal(x, y), path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_fold_and_quantize_bit_equal(arch):
    """The folds read the port's state_dict, JAX's read its variables: the
    same float32 arrays (HWIO, the transposed convs flipped back) and the
    same int8 codes and steps."""
    make, to_sd = ARCHS[arch]
    v = make(seed=3)
    ref = jq.ARCHS[arch][0](v)
    got = tq.ARCHS[arch][0](to_sd(v))
    _assert_tree_equal(ref, got)
    _assert_tree_equal(jq.quantize_folded(ref), tq.quantize_folded(got))


def test_fold_reads_a_model_state_dict():
    """A model's own state_dict (tensors, BN counters included) folds as its
    numpy export does."""
    from coastline_torch.models.robust_unet import RobustUNet

    model = RobustUNet()
    sd = model.state_dict()
    a = tq.fold_robust_unet(sd)
    b = tq.fold_robust_unet({k: v.numpy() for k, v in sd.items()})
    _assert_tree_equal(a, b)
    assert a["rb4"]["short"] is None and a["rb0"]["short"] is not None
    assert a["up0"][0].shape == (2, 2, 1024, 512) and a["db"]["b3"][0].shape == (3, 3, 512, 256)


CONV_CASES = {  # (input shape, C_out, kernel, padding, dilation, lhs_dilation, stride)
    "3x3": ((2, 9, 11, 64), 64, 3, 1, 1, None, 1),
    "1x1 widen": ((2, 7, 6, 64), 128, 1, 0, 1, None, 1),
    "dilation 2": ((2, 12, 10, 64), 64, 3, 2, 2, None, 1),
    "dilation 4": ((1, 16, 16, 96), 64, 3, 4, 4, None, 1),
    "transposed": ((2, 5, 7, 128), 64, 2, ((1, 1), (1, 1)), 1, (2, 2), 1),
    "uneven pad": ((1, 8, 9, 64), 64, 3, ((1, 0), (2, 1)), 1, None, 1),
    "stride 2": ((2, 9, 11, 64), 96, 3, 1, 1, None, 2),
    "stride 2 even": ((1, 8, 12, 128), 64, 3, 1, 1, None, 2),
    "transposed 4x4": ((2, 5, 7, 128), 64, 4, ((2, 2), (2, 2)), 1, (2, 2), 1),
    "C_in 144": ((2, 8, 10, 144), 64, 3, 1, 1, None, 1),
    "transposed 3x3": ((2, 5, 7, 128), 64, 3, ((1, 2), (1, 2)), 1, (2, 2), 1),
    "stride 4": ((2, 16, 12, 64), 64, 4, 0, 1, None, 4),
    "stride 2 2x2": ((2, 8, 10, 128), 128, 2, 0, 1, None, 2),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_plain_bit_equal_to_jax(case, dtype):
    shape, cout, k, pad, dil, lhs, stride = CONV_CASES[case]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(len(case))
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    w = (rng.standard_normal((k, k, shape[-1], cout)) * 0.05).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    wq, wstep = jq._quant_w(w)
    step = np.float32(3.7 / 127.0)
    ctx = jq._Ctx({"s": 1.0}, dtype=jdt)
    ref = jq._conv(ctx, jq._QT(jnp.asarray(x), jnp.float32(step)),
                   {"w": w, "b": b, "wq": wq, "wstep": wstep},
                   stride=stride, padding=pad, dilation=dil, lhs_dilation=lhs)
    args = (torch.from_numpy(x), float(step), torch.from_numpy(wstep), torch.from_numpy(b),
            pad, dil, lhs, tdt)
    got = int8_conv_plain(args[0], torch.from_numpy(wq), *args[1:], stride=stride)
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == tdt and got.is_contiguous() and got.shape == ref.shape
    assert np.array_equal(ref.view(np.int32), got.float().numpy().view(np.int32))
    # the wrapper on CPU tensors is the plain version
    wrapped = int8_conv(args[0], packed(torch.from_numpy(wq), lhs is not None), *args[1:],
                        stride=stride)
    assert torch.equal(wrapped, got)


def test_pack_weights_layouts():
    """The kernel's K-major layouts: k = (ky * kw + kx) * C_in + ci for a
    conv; for a transposed conv, sub-problem 2 py + px holds tap (1 - py,
    1 - px)."""
    wq = torch.arange(3 * 3 * 32 * 8, dtype=torch.int32).reshape(3, 3, 32, 8)
    mat = pack_weights(wq)
    assert mat.shape == (8, 288) and mat[5, (2 * 3 + 1) * 32 + 7] == wq[2, 1, 7, 5]
    wt = torch.arange(2 * 2 * 32 * 8, dtype=torch.int32).reshape(2, 2, 32, 8)
    sub = pack_weights(wt, transposed=True)
    assert sub.shape == (4, 8, 32)
    for py in (0, 1):
        for px in (0, 1):
            assert torch.equal(sub[2 * py + px], wt[1 - py, 1 - px].T)


@pytest.mark.parametrize("k", [2, 4, 3])
def test_pack_weights_transposed_parities_equal_jax(k):
    """The kernel's split of a transposed conv (lhs dilation 2, a k x k
    kernel, padding (k // 2, k - k // 2)): parity (py, px) is the dense n x n
    conv (n = (k + 1) // 2; ENet's 3x3 padded with zero taps) of the packed
    sub-matrix over the input grid, with leading padding `parity_taps`,
    written at output stride 2. Replayed here in float64 from the packed
    layout, it equals JAX's int32 lhs-dilated conv bit for bit."""
    import jax

    lo, n = k // 2, (k + 1) // 2
    rng = np.random.default_rng(k)
    x = rng.integers(-127, 128, (2, 5, 7, 32), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, k, 32, 8), dtype=np.int8)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wq), (1, 1), ((lo, k - lo), (lo, k - lo)),
        lhs_dilation=(2, 2), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    mat = pack_weights(torch.from_numpy(wq), transposed=True)
    assert mat.shape == (4, 8, n * n * 32) and ref.shape[1:3] == (10, 14)
    got = torch.zeros(ref.shape, dtype=torch.int32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).double()
    for py in (0, 1):
        for px in (0, 1):
            sub = mat[2 * py + px].reshape(8, n, n, 32).permute(0, 3, 1, 2).double()
            lt, ll = parity_taps(k, py)[1], parity_taps(k, px)[1]
            acc = torch.nn.functional.conv2d(
                torch.nn.functional.pad(xt, (ll, n - 1 - ll, lt, n - 1 - lt)), sub)
            got[:, py::2, px::2] = acc.permute(0, 2, 3, 1).to(torch.int32)
    assert np.array_equal(np.asarray(ref), got.numpy())


def test_float_conv_transposed_4x4_matches_jax():
    """DeepLabV3+'s float-path decoder convs (up2, up3): the 4x4 transposed
    conv as torch's transposed conv, against JAX's lhs-dilated conv in
    float32 (the same products, summed in another order)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((4, 4, 64, 32)) * 0.1).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    pads = ((2, 2), (2, 2))
    ctx = jq._Ctx(None, dtype=jnp.float32)
    ref = jq._conv(ctx, jq._QT(jnp.asarray(x)), (w, b), padding=pads, lhs_dilation=(2, 2))
    got = tq._float_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), pads, 1,
                         (2, 2), torch.float32)
    assert got.shape == (2, 12, 10, 32)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=1e-5, atol=1e-5)


FLOAT_CASES = {  # (input shape, weight HWIO, padding, lhs dilation, stride, groups)
    "transposed 3x3 (ENet up1)": ((2, 6, 5, 64), (3, 3, 64, 16), ((1, 2), (1, 2)), (2, 2), 1, 1),
    "transposed 2x2 (ENet head)": ((2, 6, 5, 16), (2, 2, 16, 1), ((1, 1), (1, 1)), (2, 2), 1, 1),
    "depthwise (Fast-SCNN ds0)": ((2, 9, 8, 32), (3, 3, 1, 32), 1, None, 2, 32),
    "depthwise (Mix-FFN)": ((2, 8, 8, 128), (3, 3, 1, 128), 1, None, 1, 128),
}


@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
def test_float_conv_transposed_and_grouped_match_jax(case):
    """The float path's ENet transposed convs (torch's transposed conv with
    output padding for pads (1, 2)) and the depthwise 3x3s (groups = C)
    against JAX's lhs-dilated and grouped convs in float32."""
    shape, wshape, pads, lhs, stride, groups = FLOAT_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(wshape) * 0.1).astype(np.float32)
    b = rng.standard_normal(wshape[-1]).astype(np.float32)
    ctx = jq._Ctx(None, dtype=jnp.float32)
    ref = jq._conv(ctx, jq._QT(jnp.asarray(x)), (w, b), stride=stride, padding=pads,
                   lhs_dilation=lhs, groups=groups)
    got = tq._float_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                         tq.normalize_padding(pads), 1, lhs, torch.float32, stride, groups)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_leaky_and_gelu_match_jax(dtype):
    """`leaky_relu` (the int8 conv's epilogue and the float path) is
    `jax.nn.leaky_relu(t, 0.1)` bit for bit; `_gelu` is
    `jax.nn.gelu(t, approximate=False)` bit for bit in bfloat16, and in
    float32 within 5e-6 relative: torch's float32 erfc is not XLA's
    polynomial, so 40% of the values are some ulps apart (the most, 3.8e-6,
    in erfc's far tail).
    Subnormals are excluded, inputs and outputs: XLA's CPU code treats a
    subnormal input as zero (leaky_relu(-1e-40) is -1e-40 there), and where
    gelu's output is subnormal the two erfc's underflow apart (about 3e-6
    of these values). F.leaky_relu and F.gelu round otherwise in bf16 (10%
    and 41% of values)."""
    import jax

    jdt, tdt = DTYPES[dtype]
    x = (np.random.default_rng(6).standard_normal(1 << 18) * 4).astype(np.float32)
    x[:4] = [0.0, -0.0, 1e-40, -1e-40]
    jx = jnp.asarray(x).astype(jdt)
    t = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tiny = np.finfo(np.float32).tiny
    xs = np.asarray(jx.astype(jnp.float32))
    normal_in = (xs == 0) | (np.abs(xs) >= tiny)
    ref = np.asarray(jax.nn.leaky_relu(jx, 0.1).astype(jnp.float32))
    got = leaky_relu(t).float().numpy()
    assert np.array_equal(ref[normal_in].view(np.int32), got[normal_in].view(np.int32))
    ref = np.asarray(jax.nn.gelu(jx, approximate=False).astype(jnp.float32))
    got = tq._gelu(t).float().numpy()
    normal = normal_in & (np.abs(ref) >= tiny)
    assert normal.mean() > 0.99
    if tdt == torch.bfloat16:
        assert np.array_equal(ref[normal].view(np.int32), got[normal].view(np.int32))
    else:
        np.testing.assert_allclose(got[normal], ref[normal], rtol=5e-6, atol=0)


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (3, 1, 1), (2, 2, 0)])
@pytest.mark.parametrize("codes", [True, False])
def test_maxpool_equals_jax(window, stride, padding, codes):
    """`_maxpool` against JAX's `_maxpool` (`lax.reduce_window`), on int8
    codes (padded with -128) and on a bf16 tensor (padded with -inf), odd
    sizes, ties and the extremes included: DeepLabV3+'s 3x3/2/1 and
    MSWNet's 3x3/1/1 pools, and the 2x2/2 of the U-Nets."""
    rng = np.random.default_rng(window * 10 + stride)
    x = rng.integers(-127, 128, (2, 9, 7, 16), dtype=np.int8)
    x[0, :3, :3] = -127
    x[1, 4:6, 2:4] = 5
    step = 0.25 if codes else None
    jt = jnp.asarray(x) if codes else jnp.asarray(x, jnp.bfloat16)
    tt = torch.from_numpy(x) if codes else torch.from_numpy(x).to(torch.bfloat16)
    ref = jq._maxpool(jq._QT(jt, None if step is None else jnp.float32(step)), window, stride,
                      padding)
    got = tq._maxpool(tq._QT(tt, step), window, stride, padding)
    assert got.step == step and got.q.dtype == tt.dtype
    assert np.array_equal(np.asarray(ref.q.astype(jnp.float32)), got.q.float().numpy())


def test_int8_conv_wrapper_refusals():
    x = torch.zeros((1, 4, 4, 32), dtype=torch.int8)
    wq = torch.zeros((3, 3, 32, 8), dtype=torch.int8)
    w = packed(wq)
    ws, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(TypeError, match="PackedWeights"):
        int8_conv(x, wq, 1.0, ws, b, 1)
    with pytest.raises(TypeError, match="int8"):
        int8_conv(x.float(), w, 1.0, ws, b, 1)
    with pytest.raises(ValueError, match="C_in"):
        int8_conv(x, packed(wq[:, :, :16].contiguous()), 1.0, ws, b, 1)
    with pytest.raises(ValueError, match=r"\(8,\)"):
        int8_conv(x, w, 1.0, ws[:4], b, 1)
    with pytest.raises(ValueError, match="transposed"):
        int8_conv(x, w, 1.0, ws, b, 1, lhs_dilation=(2, 2))
    with pytest.raises(TypeError, match="out_dtype"):
        int8_conv(x, w, 1.0, ws, b, 1, out_dtype=torch.float16)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_site_codes_and_dequant_bit_equal(dtype):
    """step = float32(scale / 127), codes = clip(round(t / step)) with a true
    division and round half to even; the dequant in the compute dtype."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    t = (rng.standard_normal((2, 16, 16, 64)) * 3).astype(np.float32)
    step = np.float32(7.3 / 127.0)
    t[0, 0, 0, :8] = step * (np.arange(-4, 4) + 0.5).astype(np.float32)  # near halves
    jt = jnp.asarray(t).astype(jdt)
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(tdt)
    ref = jq._Ctx({"s": 7.3}, dtype=jdt).site("s", jt)
    got = tq._Ctx({"s": 7.3}, dtype=tdt).site("s", tt)
    assert got.q.dtype == torch.int8 and np.array_equal(np.asarray(ref.q), got.q.numpy())
    assert float(ref.step) == got.step
    assert np.array_equal(np.asarray(ref.f(jdt).astype(jnp.float32)), got.f(tdt).float().numpy())
    # float mode: the site records the absmax and passes the tensor on in the dtype
    collect = {}
    out = tq._Ctx(None, collect, dtype=tdt).site("s", tt)
    assert out.step is None and out.q.dtype == tdt
    assert float(collect["s"]) == float(np.abs(np.asarray(jt.astype(jnp.float32))).max())


def test_bf16_sigmoid_matches_jax():
    """XLA's bf16 sigmoid rounds each op of 1 / (1 + exp(-x)) to bf16."""
    x = np.linspace(-9, 9, 40001).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    import jax

    ref = np.asarray(jax.nn.sigmoid(jx).astype(jnp.float32))
    got = tq._sigmoid(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16))
    assert np.array_equal(ref, got.float().numpy())


@pytest.mark.parametrize("shape", [(2, 8, 12, 64), (1, 6, 4, 16)])
def test_pool_and_unpool_on_codes_equal_jax(shape):
    """SegNet's int8 pool and unpool (the kernels' plain versions on the CPU)
    on codes with ties everywhere: the first maximum of each window."""
    rng = np.random.default_rng(shape[-1])
    x = rng.integers(-3, 4, shape, dtype=np.int8)
    x[0, 0:2, 0:2, :] = 5  # a window of four equal maxima
    rv, rc = jax_primitives.max_pool_with_indices(jnp.asarray(x))
    vals, codes = unpool.max_pool_with_indices(torch.from_numpy(x))
    assert vals.dtype == torch.int8 and codes.dtype == torch.int32
    assert np.array_equal(np.asarray(rv), vals.numpy())
    assert np.array_equal(np.asarray(rc), codes.numpy())
    assert (codes.numpy()[0, 0, 0] == 0).all()
    up = unpool.max_unpool(vals, codes)
    assert up.dtype == torch.int8
    assert np.array_equal(np.asarray(jax_primitives.max_unpool(rv, rc)), up.numpy())
    mp = tq._maxpool(tq._QT(torch.from_numpy(x), 0.5))
    assert mp.step == 0.5 and np.array_equal(mp.q.numpy(), np.asarray(rv))


PORTED = {"UNet": "unet", "Robust UNet": "robust_unet", "robustunet": "robust_unet",
          "SegNet": "segnet", "WaterNet": "waternet", "MSWNet": "mswnet",
          "HRNet-Water": "hrnet_water", "PSPNet": "pspnet", "DeepLabV3+": "deeplabv3p",
          "deeplab": "deeplabv3p", "YOLO-SEG": "yoloseg", "Fast-SCNN": "fastscnn",
          "ENet": "enet", "SegFormer-Lite": "segformer_lite"}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_quant_arch_for_names_the_ported_eight(name):
    """Registry names and aliases of the ported architectures (all twelve)
    resolve to their `ARCHS` keys, as in the JAX package."""
    assert tq.quant_arch_for(name) == PORTED[name] == jq.quant_arch_for(name)


def test_quant_arch_for_leaves_out_the_other_four():
    """No architecture is left out any more: every registry name and alias
    resolves as in the JAX package, `ARCHS` has JAX's twelve keys, and an
    unknown name (or arch) is refused."""
    from coastline.models import registry as jax_registry

    names = set(jax_registry.MODEL_REGISTRY) | set(jax_registry._ALIASES)
    assert len(jax_registry.MODEL_REGISTRY) == 12
    for name in names | {"not_a_model"}:
        assert tq.quant_arch_for(name) == jq.quant_arch_for(name), name
    assert tq.quant_arch_for("not_a_model") is None
    assert sorted(tq.ARCHS) == sorted(jq.ARCHS) == sorted(set(PORTED.values()))
    with pytest.raises(ValueError, match="ported"):
        tq.QuantizedModel({}, {}, arch="not_a_model", device="cpu")


def test_quantized_robust_unet_alias():
    sd = ti.robust_unet_state_dict(ti.random_robust_unet_variables(seed=1))
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(np.float32)
    qm = tq.QuantizedRobustUNet.from_state_dict(sd, x, batch_size=1, device="cpu")
    assert qm.arch == "robust_unet" and sorted(qm.scales) == sorted(
        tq.calibration_sites(tq.fold_robust_unet(sd), torch.from_numpy(x)))
    out = qm(x)
    assert out.shape == (1, 32, 32, 1) and bool(((out >= 0) & (out <= 1)).all())


def test_default_calibration_equals_jax():
    """The same four synthetic scenes from default_rng(0), normalized alike."""
    ref = np.asarray(jq.default_calibration(64))
    got = tq.default_calibration(64, device="cpu")
    assert got.dtype == torch.float32 and np.array_equal(ref, got.numpy())
    u8 = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    assert np.array_equal(np.asarray(jq.default_calibration(32, u8)),
                          tq.default_calibration(32, u8, device="cpu").numpy())


def test_to_device_packs_only_int8_path_convs():
    """Every conv the policy sends to the int8 path gets its kernel layout
    (on the CPU the matrix is not built) and leaves its float weights on the
    host; the small convs, and every conv the policy keeps off the int8
    path, keep theirs."""
    qp = tq.quantize_folded(tq.fold_unet(ti.unet_state_dict(ti.random_unet_variables(0))))
    tree = tq.to_device(qp, "cpu")
    assert isinstance(tree, tq.DeviceTree) and tq.to_device(tree, "cpu") is tree
    assert tree["up0"]["wq"].transposed and not tree["dc1"]["c1"]["wq"].transposed
    assert tree["dc0"]["c1"]["wq"].hwio.dtype == torch.int8
    assert tree["head"]["b"].dtype == torch.float32 and tree["dc0"]["c2"]["wstep"].shape == (64,)
    assert "w" not in tree["dc0"]["c2"] and "w" not in tree["up0"]
    assert "w" in tree["dc0"]["c1"] and "w" in tree["head"]
    no_convt = tq.to_device(qp, "cpu", {"convT_int8": False})
    assert "w" in no_convt["up0"] and "w" not in no_convt["dc1"]["c1"]
    all_float = tq.to_device(qp, "cpu", POLICIES["all_float_convs"])
    assert all("w" in all_float[k][c] for k in ("dc1", "dc4") for c in ("c1", "c2"))


def test_to_device_keeps_the_float_weights_its_arch_reads():
    """DeepLabV3+'s global ASPP branch multiplies its pooled codes by the
    float `w` of `aspp_b4` (512 -> 256, int8-eligible): `to_device` keeps it
    for that arch (`SLIM_KEEP`) and drops the other eligible convs' `w`."""
    from coastline_torch.models.registry import create_model

    qp = tq.quantize_folded(tq.fold_deeplabv3p(create_model("DeepLabV3+").state_dict()))
    tree = tq.to_device(qp, "cpu", arch="deeplabv3p")
    assert "w" in tree["aspp_b4"] and "w" not in tree["aspp_b0"] and "w" not in tree["up0"]
    assert "w" in tree["up2"] and "w" in tree["c0"]
    assert "w" not in tq.to_device(qp, "cpu")["aspp_b4"]  # no arch: nothing to keep

def test_int8_eligible_is_the_jax_rule():
    pol = dict(tq.DEFAULT_POLICY)
    assert tq.int8_eligible(64, 64, False, pol) and tq.int8_eligible(1024, 512, True, pol)
    assert not tq.int8_eligible(3, 64, False, pol) and not tq.int8_eligible(64, 1, False, pol)
    assert not tq.int8_eligible(128, 64, True, dict(pol, convT_int8=False))
    assert not tq.int8_eligible(128, 64, False, dict(pol, conv_min_ch=10**9))


# ---------------------------------------------------------------------------
# Helpers of the per-architecture parity files (test_torch_quant_*.py)
# ---------------------------------------------------------------------------


def jax_fixture(arch):
    """tests/test_quant.py's fixture: the JAX model at float32, initialised
    from PRNGKey(0), its BN statistics from one train-mode pass over a
    (2, 64, 64, 3) normal input from PRNGKey(1); -> (numpy variables, x).
    The zoo architectures as tests/test_quant.py's `test_more_archs_fold_and_int8`
    builds them."""
    import importlib

    import jax

    from coastline.models.robust_unet import RobustUNet
    from coastline.models.segnet import SegNet
    from coastline.models.unet import UNet

    if arch in ZOO_MODELS:
        module, cls = ZOO_MODELS[arch]
        m = getattr(importlib.import_module(module), cls)(dtype=jnp.float32)
    else:
        m = {"unet": lambda: UNet(n_classes=2, dtype=jnp.float32),
             "robust_unet": lambda: RobustUNet(dtype=jnp.float32),
             "segnet": lambda: SegNet(dtype=jnp.float32)}[arch]()
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 64, 64, 3), jnp.float32)
    v = m.init({"params": key, "dropout": key}, x)
    _, upd = m.apply(v, x, train=True, mutable=["batch_stats"], rngs={"dropout": key})
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": upd["batch_stats"]})
    return v, np.array(x)  # writable: torch.from_numpy shares it


def fold_checks(arch, v):
    """The port's fold of the bridged state_dict and JAX's fold of the same
    variables: bit-equal, and so are their quantized trees."""
    ref = jq.ARCHS[arch][0](v)
    got = tq.ARCHS[arch][0](STATE_DICTS[arch](v))
    _assert_tree_equal(ref, got)
    _assert_tree_equal(jq.quantize_folded(ref), tq.quantize_folded(got))


def conv_census(arch, v, x, scales):
    """One default-policy int8 forward of the port on the CPU: its int8 conv
    calls by kind (all, stride 2 and 4, transposed 2x2, 3x3 and 4x4, C_in =
    144, the leaky-ReLU epilogue), and
    the convs it ran on the float path although JAX's rule (`jq._conv`:
    both channel counts >= 64, groups 1) takes them to the int8 path."""
    qp = tq.quantize_folded(tq.ARCHS[arch][0](STATE_DICTS[arch](v)))
    calls, missed = [], []
    real_int8, real_float = tq.int8_conv, tq._float_conv

    def spy_int8(*args, **kw):
        call = inspect.signature(real_int8).bind(*args, **kw)
        call.apply_defaults()
        a = call.arguments
        calls.append((tuple(a["w"].hwio.shape), a["w"].transposed, a["stride"], a["act"]))
        return real_int8(*args, **kw)

    def spy_float(xf, w, *args, **kw):
        if min(w.shape[2], w.shape[3]) >= tq.DEFAULT_POLICY["conv_min_ch"]:
            missed.append(tuple(w.shape))
        return real_float(xf, w, *args, **kw)

    tq.int8_conv, tq._float_conv = spy_int8, spy_float
    try:
        out = tq.int8_forward(qp, scales, torch.from_numpy(x), arch=arch)
    finally:
        tq.int8_conv, tq._float_conv = real_int8, real_float
    assert torch.isfinite(out).all()
    return dict(int8=len(calls), stride2=sum(s == 2 for _, _, s, _ in calls),
                stride4=sum(s == 4 for _, _, s, _ in calls),
                transposed2x2=sum(t and w[0] == 2 for w, t, _, _ in calls),
                transposed3x3=sum(t and w[0] == 3 for w, t, _, _ in calls),
                transposed4x4=sum(t and w[0] == 4 for w, t, _, _ in calls),
                cin144=sum(w[2] == 144 for w, _, _, _ in calls),
                leaky=sum(a == "leaky" for _, _, _, a in calls), missed=missed)


def masks(arch, logits):
    """The served mask of NHWC logits: the argmax of the 2-class UNet, else
    sigmoid > 0.5; and the water probability."""
    logits = np.asarray(logits, np.float64)
    if arch == "unet":
        z = np.exp(logits - logits.max(-1, keepdims=True))
        return logits.argmax(-1), z[..., 1] / z.sum(-1)
    prob = 1.0 / (1.0 + np.exp(-logits))
    return prob[..., 0] > 0.5, prob[..., 0]


def int8_pair(arch, v, x, scales, policy):
    """The int8 forward's logits of JAX (op by op) and of the port, from the
    same variables, the same input and the same scales."""
    jqp = jq.quantize_folded(jq.ARCHS[arch][0](v))
    ref = jq.int8_forward(jqp, scales, jnp.asarray(x), return_logits=True, arch=arch,
                          policy=policy)
    tqp = tq.quantize_folded(tq.ARCHS[arch][0](STATE_DICTS[arch](v)))
    got = tq.int8_forward(tqp, scales, torch.from_numpy(x), return_logits=True, arch=arch,
                          policy=policy)
    return np.asarray(ref), got.numpy()


def agreement(arch, a, b):
    """(mask agreement, mean |d prob|) of two logits arrays."""
    ma, pa = masks(arch, a)
    mb, pb = masks(arch, b)
    return float((ma == mb).mean()), float(np.abs(pa - pb).mean())


def float_and_calibration_checks(arch, v, x, logits_atol, probs_atol=None):
    """The float32 float mode against JAX's `float_forward` (logits, and
    probabilities for a sigmoid head), and the bf16 calibration: the same
    sorted site names, scales within rtol 2e-2. Returns JAX's scales."""
    import jax

    jf = jq.ARCHS[arch][0](v)
    tf = tq.ARCHS[arch][0](STATE_DICTS[arch](v))
    ref = jax.jit(lambda f, xx: jq.float_forward(f, xx, return_logits=True, dtype=jnp.float32,
                                                 arch=arch))(jf, jnp.asarray(x))
    got = tq.float_forward(tf, torch.from_numpy(x), return_logits=True, dtype=torch.float32,
                           arch=arch)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=logits_atol, rtol=0)
    if probs_atol is not None:
        np.testing.assert_allclose(np.asarray(jax.nn.sigmoid(ref)), torch.sigmoid(got).numpy(),
                                   atol=probs_atol, rtol=0)
    assert tq.calibration_sites(tf, torch.from_numpy(x), arch=arch) == \
        jq.calibration_sites(jf, jnp.asarray(x), arch=arch)
    js = jq.calibrate(jf, jnp.asarray(x), batch_size=2, arch=arch)
    ts = tq.calibrate(tf, torch.from_numpy(x), batch_size=2, arch=arch)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert abs(ts[k] - js[k]) <= 2e-2 * js[k], (k, ts[k], js[k])
    return js
