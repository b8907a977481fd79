"""The port's int8 PTQ building blocks vs the JAX package (CPU):
`coastline_torch/infer/quant.py` and the plain version of
`kernels/int8_conv.py` against `coastline/infer/quant.py`.

Tolerance: none. The folds and `quantize_folded` are bit-equal on the same
variables passed through the weight bridge; `int8_conv_plain` is bit-equal
to the int8 branch of JAX's `_conv` (the same int32 sums, the same float32
epilogue in the same order) for every option the three forwards use, in a
float32 and a bfloat16 context; a site's codes and its dequantized values
are bit-equal; the pool and unpool on codes equal the JAX primitives, ties
included. JAX runs op by op here (no jit): under jit XLA contracts the
epilogue's multiply and add into an FMA, a rounding the JAX package's own
op-by-op path does not make.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.infer import quant as jq
from coastline.ops import primitives as jax_primitives
from coastline_torch.infer import quant as tq
from coastline_torch.kernels import unpool
from coastline_torch.kernels.int8_conv import int8_conv, int8_conv_plain, pack_weights, packed
from coastline_torch.utils import torch_import as ti

torch.set_num_threads(1)

#: the policy variants of tests/test_quant.py, by name
POLICIES = {"default": None,
            "all_float_convs": {"conv_min_ch": 10**9, "convT_int8": False},
            "gated_int8": {"gated_int8": True},
            "split_cat": {"split_cat": True},
            "gated_int8_split_cat": {"gated_int8": True, "split_cat": True}}
STATE_DICTS = {"unet": ti.unet_state_dict, "robust_unet": ti.robust_unet_state_dict,
               "segnet": ti.segnet_state_dict}

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


CONV_CASES = {  # (input shape, C_out, kernel, padding, dilation, lhs_dilation)
    "3x3": ((2, 9, 11, 64), 64, 3, 1, 1, None),
    "1x1 widen": ((2, 7, 6, 64), 128, 1, 0, 1, None),
    "dilation 2": ((2, 12, 10, 64), 64, 3, 2, 2, None),
    "dilation 4": ((1, 16, 16, 96), 64, 3, 4, 4, None),
    "transposed": ((2, 5, 7, 128), 64, 2, ((1, 1), (1, 1)), 1, (2, 2)),
    "uneven pad": ((1, 8, 9, 64), 64, 3, ((1, 0), (2, 1)), 1, None),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_plain_bit_equal_to_jax(case, dtype):
    shape, cout, k, pad, dil, lhs = CONV_CASES[case]
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
                   padding=pad, dilation=dil, lhs_dilation=lhs)
    args = (torch.from_numpy(x), float(step), torch.from_numpy(wstep), torch.from_numpy(b),
            pad, dil, lhs, tdt)
    got = int8_conv_plain(args[0], torch.from_numpy(wq), *args[1:])
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == tdt and got.is_contiguous()
    assert np.array_equal(ref.view(np.int32), got.float().numpy().view(np.int32))
    # the wrapper on CPU tensors is the plain version
    wrapped = int8_conv(args[0], packed(torch.from_numpy(wq), lhs is not None), *args[1:])
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


def test_quant_arch_for_names_the_ported_three():
    assert tq.quant_arch_for("UNet") == "unet"
    assert tq.quant_arch_for("Robust UNet") == "robust_unet"
    assert tq.quant_arch_for("robustunet") == "robust_unet"
    assert tq.quant_arch_for("SegNet") == "segnet"
    for name in ("DeepLabV3+", "enet", "segformer_lite", "not_a_model"):
        assert tq.quant_arch_for(name) is None
    assert sorted(tq.ARCHS) == ["robust_unet", "segnet", "unet"]
    with pytest.raises(ValueError, match="ported"):
        tq.QuantizedModel({}, {}, arch="deeplabv3p", device="cpu")


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
    (2, 64, 64, 3) normal input from PRNGKey(1); -> (numpy variables, x)."""
    import jax

    from coastline.models.robust_unet import RobustUNet
    from coastline.models.segnet import SegNet
    from coastline.models.unet import UNet

    m = {"unet": lambda: UNet(n_classes=2, dtype=jnp.float32),
         "robust_unet": lambda: RobustUNet(dtype=jnp.float32),
         "segnet": lambda: SegNet(dtype=jnp.float32)}[arch]()
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 64, 64, 3), jnp.float32)
    v = m.init({"params": key, "dropout": key}, x)
    _, upd = m.apply(v, x, train=True, mutable=["batch_stats"], rngs={"dropout": key})
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": upd["batch_stats"]})
    return v, np.array(x)  # writable: torch.from_numpy shares it


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
