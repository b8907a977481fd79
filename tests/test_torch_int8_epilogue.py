"""Sites quantized in the int8 conv's epilogue (CPU): the codes mode of
`kernels/int8_conv.py` and `_Ctx.conv_site` of `infer/quant.py` against the
JAX package's `_conv` followed by `_Ctx.site` (`coastline/infer/quant.py`).

Tolerance: none. The plain codes mode is the kernel's arithmetic (the
float32 epilogue, the cast, the ReLU, a true division by the step, round
half to even, the clamp), bit-equal to JAX's op-by-op `_conv` and
`_Ctx.site`; crafted outputs land exactly on .5 after the division and past
the clamp. A forward whose fused sites take their codes from the epilogue
(as on the card) equals, site by site and in its logits, the same forward
with every site quantized by `_Ctx.site` (as on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.infer import quant as jq
from coastline_torch.infer import quant as tq
from coastline_torch.kernels.int8_conv import int8_conv, int8_conv_plain, packed
from coastline_torch.utils import torch_import as ti
from test_torch_quant import CONV_CASES, DTYPES

torch.set_num_threads(1)

STEP = np.float32(2.0 ** -6)  # a power of two: y / STEP is exact, bf16 values tie often
SCALE = float(STEP) * 127.0   # the site's absmax: float32(SCALE / 127) == STEP


def _crafted(case):
    """The conv's int8 inputs, with image 0 all zeros so its outputs are the
    bias, set to exact ties (k + 0.5) * STEP and to values past +-127 steps."""
    shape, cout, k, pad, dil, lhs, stride = CONV_CASES[case]
    rng = np.random.default_rng(len(case) + 7)
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    x[0] = 0
    w = (rng.standard_normal((k, k, shape[-1], cout)) * 0.05).astype(np.float32)
    ties = (np.arange(cout) % 64 - 32 + 0.5).astype(np.float32)
    ties[::7] = 300.0 * np.sign(ties[::7])  # beyond the clamp
    b = (ties * STEP).astype(np.float32)
    wq, wstep = jq._quant_w(w)
    return x, w, b, wq, wstep, pad, dil, lhs, stride


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_codes_mode_bit_equal_to_jax_conv_then_site(case, dtype, relu):
    jdt, tdt = DTYPES[dtype]
    x, w, b, wq, wstep, pad, dil, lhs, stride = _crafted(case)
    x_step = np.float32(3.7 / 127.0)
    ctx = jq._Ctx({"s": SCALE}, dtype=jdt)
    y = jq._conv(ctx, jq._QT(jnp.asarray(x), jnp.float32(x_step)),
                 {"w": w, "b": b, "wq": wq, "wstep": wstep},
                 stride=stride, padding=pad, dilation=dil, lhs_dilation=lhs)
    if relu:
        y = jax.nn.relu(y)
    ref = ctx.site("s", y)
    assert float(ref.step) == float(STEP)
    ref_q = np.asarray(ref.q)
    args = (torch.from_numpy(x), float(x_step), torch.from_numpy(wstep), torch.from_numpy(b),
            pad, dil, lhs, tdt)
    act = "relu" if relu else "none"
    got = int8_conv_plain(args[0], torch.from_numpy(wq), *args[1:], act=act,
                          out_step=float(STEP), stride=stride)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert np.array_equal(ref_q, got.numpy())
    # the crafted image holds exact ties of both parities and clamped codes
    y0 = np.asarray(y.astype(jnp.float32))[0] / STEP
    assert (np.abs(y0 - np.floor(y0) - 0.5) == 0).sum() >= 8
    assert (np.abs(y0) > 127).any() and (np.abs(ref_q) == 127).any()
    # the wrapper on CPU tensors is the plain version, and values mode is relu(_conv)
    wrapped = int8_conv(args[0], packed(torch.from_numpy(wq), lhs is not None), *args[1:],
                        act=act, out_step=float(STEP), stride=stride)
    assert torch.equal(wrapped, got)
    values = int8_conv_plain(args[0], torch.from_numpy(wq), *args[1:], act=act, stride=stride)
    assert np.array_equal(np.asarray(y.astype(jnp.float32)).view(np.int32),
                          values.float().numpy().view(np.int32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_leaky_epilogue_bit_equal_to_jax_conv_then_site(case, dtype):
    """The leaky-ReLU epilogue (YOLO-SEG's sites): `jax.nn.leaky_relu(_conv,
    0.1)` and then `_Ctx.site` in JAX, against the plain version's values
    and codes modes, bit for bit; the negative half lands on exact ties
    after the slope too."""
    jdt, tdt = DTYPES[dtype]
    x, w, b, wq, wstep, pad, dil, lhs, stride = _crafted(case)
    b[1::2] *= -1  # negative biases: the slope acts on image 0 too
    x_step = np.float32(3.7 / 127.0)
    ctx = jq._Ctx({"s": SCALE}, dtype=jdt)
    y = jax.nn.leaky_relu(jq._conv(ctx, jq._QT(jnp.asarray(x), jnp.float32(x_step)),
                                   {"w": w, "b": b, "wq": wq, "wstep": wstep}, stride=stride,
                                   padding=pad, dilation=dil, lhs_dilation=lhs), 0.1)
    ref = ctx.site("s", y)
    args = (torch.from_numpy(x), float(x_step), torch.from_numpy(wstep), torch.from_numpy(b),
            pad, dil, lhs, tdt)
    values = int8_conv_plain(args[0], torch.from_numpy(wq), *args[1:], act="leaky",
                             stride=stride)
    yf = np.asarray(y.astype(jnp.float32))
    assert (yf < 0).mean() > 0.2
    assert np.array_equal(yf.view(np.int32), values.float().numpy().view(np.int32))
    got = int8_conv(args[0], packed(torch.from_numpy(wq), lhs is not None), *args[1:],
                    act="leaky", out_step=float(STEP), stride=stride)
    assert got.dtype == torch.int8 and np.array_equal(np.asarray(ref.q), got.numpy())


def _bridged(make, to_sd):
    return lambda: to_sd(make(seed=2))


def _constructed(name):
    from coastline_torch.models.registry import create_model

    return lambda: create_model(name).state_dict()


# arch -> (its state_dict, the input's side)
FORWARDS = {"unet": (_bridged(ti.random_unet_variables, ti.unet_state_dict), 32),
            "robust_unet": (_bridged(ti.random_robust_unet_variables,
                                     ti.robust_unet_state_dict), 32),
            "segnet": (_bridged(ti.random_segnet_variables, ti.segnet_state_dict), 32),
            "yoloseg": (_constructed("YOLO-SEG"), 64), "fastscnn": (_constructed("Fast-SCNN"), 64),
            "enet": (_constructed("ENet"), 64),
            "segformer_lite": (_constructed("SegFormer-Lite"), 64)}
# sites of one forward: (quantized by `_Ctx.site` before fusion, after: eager, fused)
SITES = {"unet": (27, 6, 21), "robust_unet": (53, 25, 28), "segnet": (20, 2, 18),
         "yoloseg": (13, 5, 8), "fastscnn": (34, 23, 11), "enet": (45, 44, 1),
         "segformer_lite": (26, 20, 6)}


@pytest.fixture(scope="module", params=sorted(FORWARDS))
def quantized(request):
    arch = request.param
    state_dict, side = FORWARDS[arch]
    folded = tq.ARCHS[arch][0](state_dict())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, side, side, 3))
                         .astype(np.float32))
    scales = tq.calibrate(folded, x, batch_size=1, arch=arch)
    return arch, tq.to_device(tq.quantize_folded(folded), "cpu"), scales, x


def _recorded(arch, tree, scales, x, in_kernel: bool):
    """The int8 forward's logits, every site's (name, codes, step, how) --
    how is "fused" for a site that `conv_site` made, else "eager" -- and the
    count of quantizations `_Ctx.site` made."""
    sites, calls, site, fused = [], [], tq._Ctx.site, tq._Ctx.fused_codes

    def record(ctx, name, t, optional=False):
        out = site(ctx, name, t, optional)
        if out.step is not None:
            sites.append([name, out.q.clone(), out.step, "eager"])
            calls.append(name)
        return out

    def record_fused(ctx, name, codes):
        if sites and sites[-1][0] == name:  # the CPU path quantized it through `site`
            sites.pop()
        sites.append([name, codes.q.clone(), codes.step, "fused"])
        return codes

    codes_in_kernel = tq._codes_in_kernel
    tq._Ctx.site, tq._Ctx.fused_codes = record, record_fused
    tq._codes_in_kernel = lambda t: in_kernel
    try:
        logits = tq.int8_forward(tree, scales, x, return_logits=True, arch=arch)
    finally:
        tq._Ctx.site, tq._Ctx.fused_codes = site, fused
        tq._codes_in_kernel = codes_in_kernel
    return logits, sites, len(calls)


def test_fused_forward_equals_the_all_site_forward(quantized):
    """Codes from the conv's epilogue (the card's path, here the plain codes
    mode) against every site through `_Ctx.site`: the same sites in the same
    order, the same codes and steps, the same logits, bit for bit."""
    arch, tree, scales, x = quantized
    ref_logits, ref_sites, _ = _recorded(arch, tree, scales, x, in_kernel=False)
    got_logits, got_sites, _ = _recorded(arch, tree, scales, x, in_kernel=True)
    assert [s[0] for s in got_sites] == [s[0] for s in ref_sites]
    for (name, q, step, _), (_, rq, rstep, _) in zip(got_sites, ref_sites):
        assert step == rstep and q.dtype == torch.int8 and torch.equal(q, rq), name
    assert torch.equal(got_logits, ref_logits)
    assert torch.isfinite(got_logits).all()


def test_eager_site_quantizations_a_forward(quantized):
    """Quantizations `_Ctx.site` makes a forward with every site through it
    (the CPU's path, and every path before the fusion) and with the codes
    from the epilogue (the card's): the UNet 27 -> 6 (the input, `dc0.t1`
    behind the RGB stem, `cat0..3`), SegNet 20 -> 2 (the input and `c0`),
    the Robust U-Net 53 -> 25, YOLO-SEG 13 -> 5 (the input, the float-path
    c0, c1, up2, up3), Fast-SCNN 34 -> 23 (the pointwise 1x1s of ds2..ds12
    fused), ENet 45 -> 44 (only `up0.out`), SegFormer-Lite 26 -> 20 (stages
    2 and 3's `esa.xr` and `ffn.h`, `c4f`, `c5h`: the GELU sites stay
    eager)."""
    arch, tree, scales, x = quantized
    before, eager, fused = SITES[arch]
    _, all_site, all_calls = _recorded(arch, tree, scales, x, in_kernel=False)
    _, sites, calls = _recorded(arch, tree, scales, x, in_kernel=True)
    assert len(all_site) == len(sites) == all_calls == before
    hows = [s[3] for s in sites]
    assert (calls, hows.count("eager"), hows.count("fused")) == (eager, eager, fused)
