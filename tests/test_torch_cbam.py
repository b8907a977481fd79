"""CBAM tail of the port vs the JAX package's TPU kernels (CPU, small sizes).

On the CPU the kernel wrappers run their plain PyTorch versions; those are
held here against `coastline/pallas/cbam.py` and `pallas/pools.py` in
interpret mode and against the JAX module composition. The CUDA kernels are
held against the same plain versions on the card (tests/test_torch_cuda.py
and `chip_smoke.py`).

Tolerances:
  * max: exact (a max of the same values; both sides round z = x * gate to
    the dtype identically, a bf16 x bf16 product being exact in float32);
  * mean, float32: rtol 1e-5 / atol 1e-6 (float32 sums taken in another
    order), the bound tests/test_pallas.py holds the kernels to;
  * mean, bfloat16: one bf16 ulp, |d| <= 2^-7 |ref| + 1e-6: the same float32
    sum in another order can land on the other side of a bf16 rounding.
    `cbam.avg_max_pool` with C < 128 is the exception: it lane-packs k =
    128 / C pixel groups, rounds each group's mean to bf16 and averages
    those, so it sits up to half a bf16 ulp of the largest group mean
    further off: |d| <= 2^-8 max_g |mean_g| + 2^-7 |ref| + 1e-6. And
    `cbam.gated_spatial_stats` in bf16, compiled whole by XLA on the CPU,
    keeps z = x * gate unrounded inside its mean (excess precision; its max
    is unaffected), each z up to half a bf16 ulp off: |d| <= 2^-9 mean_c|z|
    + 2^-7 |ref| + 1e-6. The port rounds z as the module path does and
    agrees with that path to one ulp;
  * tail, float32: rtol 1e-5 / atol 1e-5, as tests/test_pallas.py;
  * tail, bfloat16: the channel gate, the spatial gate and the three
    rounded ops of the tail may each differ by one bf16 ulp (another
    summation order in the MLP and the 7x7 conv before a rounding), so
    |d| <= 3 ulps of |y| + 1 ulp of |ref| <= 2^-5 (|y| + |ref|);
  * conv -> BN without bias or ReLU, bfloat16: JAX rounds after the conv and
    after BN's multiply and add, the fused path once: |d| <= 2^-5 |ref| +
    2^-5, the bound tests/test_torch_unet.py holds ConvBNAct to.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from coastline.ops.blocks import ChannelAttention as JaxChannelAttention
from coastline.ops.blocks import SpatialAttention as JaxSpatialAttention
from coastline.ops.primitives import Conv as JaxConv
from coastline.ops.primitives import Norm as JaxNorm
from coastline.pallas.cbam import avg_max_pool as jax_avg_max_pool
from coastline.pallas.cbam import fused_cbam_tail as jax_fused_cbam_tail
from coastline.pallas.cbam import gated_spatial_stats as jax_gated_spatial_stats
from coastline.pallas.pools import fused_avg_max_pool as jax_fused_avg_max_pool
from coastline_torch.kernels import cbam
from coastline_torch.kernels.cbam import (avg_max_pool, avg_max_pool_plain, cbam_tail_apply,
                                          fused_cbam_tail, gated_spatial_stats, pool_geometry)
from coastline_torch.kernels.fused_conv import fused_conv3x3_bn_relu
from coastline_torch.kernels.pools import fused_avg_max_pool
from coastline_torch.ops.blocks import conv_bn
from coastline_torch.ops.primitives import Conv, Norm

torch.set_num_threads(1)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
POOL_SHAPES = [(2, 16, 128, 64), (1, 32, 256, 32), (2, 24, 128, 128)]
STATS_SHAPES = [(2, 16, 128, 64), (2, 24, 128, 128)]


def _act(shape, dtype, seed=0):
    """numpy float32 activation, already representable in `dtype`."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, DTYPES[dtype][0]), np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(DTYPES[dtype][1])


def _j(a, dtype):
    return jnp.asarray(a, DTYPES[dtype][0])


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _assert_mean(got, ref, dtype, slack=0.0):
    got, ref = _f32(got), _f32(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6 + slack)


def _lane_pack_slack(x):
    """Half a bf16 ulp of the largest lane-pack group mean of
    `cbam.avg_max_pool` (pixel w belongs to group w % k), per (b, c)."""
    c = x.shape[-1]
    if c >= 128:
        return 0.0
    k = 128 // c
    groups = np.stack([x[:, :, g::k].mean((1, 2)) for g in range(k)])
    return 2.0 ** -8 * np.abs(groups).max(0)


def _assert_tail(got, ref, y, dtype):
    got, ref = _f32(got), _f32(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - ref) <= 2.0 ** -5 * (np.abs(_f32(y)) + np.abs(ref)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_avg_max_pool_matches_both_tpu_kernels(shape, dtype):
    x = _act(shape, dtype)
    packed = _lane_pack_slack(x) if dtype == "bfloat16" else 0.0
    for port, tpu, slack in ((avg_max_pool, jax_avg_max_pool, packed),
                             (fused_avg_max_pool, jax_fused_avg_max_pool, 0.0)):
        before = port.launches
        avg, mx = port(_t(x, dtype))
        assert port.launches == before  # CPU: the plain version, no launch
        ref_avg, ref_mx = tpu(_j(x, dtype), interpret=True)
        assert avg.dtype == DTYPES[dtype][1] and avg.shape == (shape[0], shape[3])
        _assert_mean(avg, ref_avg, dtype, slack)
        np.testing.assert_array_equal(_f32(mx), _f32(ref_mx))
    _assert_mean(avg, jnp.mean(_j(x, dtype), axis=(1, 2)), dtype)  # the module path


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_avg_max_pool_odd_shape_and_negative_channels(dtype):
    """Any B, H, W, C (no `fits` gate): an odd shape with all-negative
    channels, against the JAX module path's reductions."""
    x = _act((3, 37, 53, 48), dtype) - 5.0
    avg, mx = avg_max_pool(_t(x, dtype))
    _assert_mean(avg, jnp.mean(_j(x, dtype), axis=(1, 2)), dtype)
    np.testing.assert_array_equal(_f32(mx), _f32(jnp.max(_j(x, dtype), axis=(1, 2))))
    assert _f32(mx).max() < 0


def test_avg_max_pool_keeps_nan():
    x = torch.zeros(2, 4, 5, 8)
    x[1, 2, 3, 5] = float("nan")
    avg, mx = avg_max_pool(x)
    assert torch.isnan(mx[1, 5]) and torch.isnan(avg[1, 5])
    assert not torch.isnan(mx[0]).any() and torch.isnan(mx).sum() == 1


def _gate(b, c, dtype, seed=1):
    g = 1.0 / (1.0 + np.exp(-np.random.default_rng(seed).normal(size=(b, c))))
    return np.asarray(jnp.asarray(g.astype(np.float32), DTYPES[dtype][0]), np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_gated_spatial_stats_matches_tpu_kernel(shape, dtype):
    b, h, w, c = shape
    x, gate = _act(shape, dtype), _gate(b, c, dtype)
    before = gated_spatial_stats.launches
    got = gated_spatial_stats(_t(x, dtype), _t(gate, dtype))
    assert gated_spatial_stats.launches == before
    ref = jax_gated_spatial_stats(_j(x, dtype), _j(gate, dtype), interpret=True)
    assert got.shape == (b, 2, h, w) and got.dtype == DTYPES[dtype][1]
    z = _j(x, dtype) * _j(gate, dtype)[:, None, None, :]
    excess = 2.0 ** -9 * np.abs(_f32(z)).mean(-1) if dtype == "bfloat16" else 0.0
    _assert_mean(got[:, 0], ref[:, 0], dtype, excess)
    np.testing.assert_array_equal(_f32(got[:, 1]), _f32(ref[:, 1]))
    _assert_mean(got[:, 0], jnp.mean(z, axis=-1), dtype)  # the module path


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gated_spatial_stats_odd_shape(dtype):
    b, h, w, c = 3, 37, 53, 48
    x, gate = _act((b, h, w, c), dtype), _gate(b, c, dtype)
    got = gated_spatial_stats(_t(x, dtype), _t(gate, dtype))
    z = _j(x, dtype) * _j(gate, dtype)[:, None, None, :]
    _assert_mean(got[:, 0], jnp.mean(z, axis=-1), dtype)
    np.testing.assert_array_equal(_f32(got[:, 1]), _f32(jnp.max(z, axis=-1)))


def _tail_params(c, seed=2):
    rng = np.random.default_rng(seed)
    hidden = c // 16
    fc1 = rng.normal(0, np.sqrt(2.0 / c), (c, hidden)).astype(np.float32)
    fc2 = rng.normal(0, np.sqrt(2.0 / hidden), (hidden, c)).astype(np.float32)
    sconv = rng.normal(0, np.sqrt(2.0 / 98), (7, 7, 2, 1)).astype(np.float32)
    return fc1, fc2, sconv


class _JaxTail(nn.Module):
    """ChannelAttention -> SpatialAttention -> relu(+ shortcut), the JAX
    package's module composition (`ops/blocks.py:203-207`)."""

    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, y, s):
        out = JaxChannelAttention(dtype=self.dtype, name="ChannelAttention_0")(y, False)
        out = JaxSpatialAttention(dtype=self.dtype, name="SpatialAttention_0")(out)
        return nn.relu(out + s)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_cbam_tail_matches_tpu_orchestrator_and_modules(dtype):
    shape = (2, 16, 128, 64)
    y, s = _act(shape, dtype, 3), _act(shape, dtype, 4)
    fc1, fc2, sconv = _tail_params(shape[-1])
    counts = [f.launches for f in (avg_max_pool, gated_spatial_stats, cbam_tail_apply)]
    got = fused_cbam_tail(_t(y, dtype), _t(s, dtype), *(torch.from_numpy(a) for a in (fc1, fc2, sconv)))
    assert counts == [f.launches for f in (avg_max_pool, gated_spatial_stats, cbam_tail_apply)]
    assert got.dtype == DTYPES[dtype][1] and got.shape == shape
    ref = jax_fused_cbam_tail(_j(y, dtype), _j(s, dtype), fc1, fc2, sconv, interpret=True)
    _assert_tail(got, ref, y, dtype)
    params = {"ChannelAttention_0": {"Dense_0": {"kernel": fc1}, "Dense_1": {"kernel": fc2}},
              "SpatialAttention_0": {"Conv_0": {"Conv_0": {"kernel": sconv}}}}
    ref_mod = _JaxTail(DTYPES[dtype][0]).apply({"params": params}, _j(y, dtype), _j(s, dtype))
    _assert_tail(got, ref_mod, y, dtype)
    assert _f32(got).min() == 0.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_cbam_tail_odd_shape(dtype):
    """An odd shape the TPU dispatch would refuse (`fits`), against the JAX
    module composition."""
    shape = (3, 9, 13, 48)
    y, s = _act(shape, dtype, 5), _act(shape, dtype, 6)
    fc1, fc2, sconv = _tail_params(shape[-1], 7)
    got = fused_cbam_tail(_t(y, dtype), _t(s, dtype), *(torch.from_numpy(a) for a in (fc1, fc2, sconv)))
    params = {"ChannelAttention_0": {"Dense_0": {"kernel": fc1}, "Dense_1": {"kernel": fc2}},
              "SpatialAttention_0": {"Conv_0": {"Conv_0": {"kernel": sconv}}}}
    ref = _JaxTail(DTYPES[dtype][0]).apply({"params": params}, _j(y, dtype), _j(s, dtype))
    _assert_tail(got, ref, y, dtype)


def test_wrappers_check_their_inputs():
    x = torch.zeros(2, 4, 4, 8)
    with pytest.raises(TypeError):
        avg_max_pool(x.half())
    with pytest.raises(ValueError):
        avg_max_pool(x[0])
    with pytest.raises(ValueError, match="empty"):
        fused_avg_max_pool(x[:, :0])
    with pytest.raises(ValueError):
        gated_spatial_stats(x, torch.zeros(2, 7))
    with pytest.raises(TypeError):
        gated_spatial_stats(x, torch.zeros(2, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        cbam_tail_apply(x, x, torch.zeros(2, 8), torch.zeros(2, 2, 4, 4), torch.zeros(7, 7, 1, 1))
    with pytest.raises(ValueError, match="device"):
        avg_max_pool(x.to("meta"))


# the Robust U-Net's ResidualBlock outputs at batch 8, 512^2 as (B, H * W, C),
# read 8 (bf16) or 4 (f32) channels a load; the fourth is WaterNet's bottleneck
LEVELS = [(8, 512 * 512, 64), (8, 256 * 256, 128), (8, 128 * 128, 256), (8, 64 * 64, 512),
          (8, 32 * 32, 1024)]
GEOMETRY_CASES = [(8, 512 * 512, 64, 8), (8, 32 * 32, 1024, 8), (8, 512 * 512, 64, 4),
                  (2, 16, 1024, 4), (3, 37 * 53, 48, 8), (1, 1, 3, 1), (5, 7, 5000, 1)]


@pytest.mark.parametrize("b,hw,c,vec", GEOMETRY_CASES + [
    (b, hw, c, vec) for vec in (8, 4) for b, hw, c in LEVELS])
def test_pool_geometry_covers_every_pixel_once(b, hw, c, vec):
    """Every channel in one chunk and every pixel in one CTA of its cluster,
    none empty; the launch within the kernel's and CUDA's limits. At each
    level the grid fills a 132-SM H100 with one CTA an SM (128 of 132):
    measured there, that grid came within 8% of the fastest geometry at
    every level and beat every larger grid in bf16 at 512^2 and 64^2
    (PERF.md), so it exceeds one an SM only where even one-CTA clusters give
    more (float32 at 32^2 x 1024: 256 chunks)."""
    geo = pool_geometry(b, hw, c, vec, sms=132)
    groups = c // vec
    chunks = -(-groups // geo.groups)
    assert geo.groups & (geo.groups - 1) == 0 and geo.threads % geo.groups == 0
    assert geo.threads % 32 == 0 and geo.threads <= 512
    src = (Path(cbam.__file__).parents[1] / "csrc" / "avg_max_pool.cu").read_text()
    assert 1 <= geo.cluster <= 8 or (  # 8: CUDA's portable cluster size
        geo.cluster <= cbam.MAX_CLUSTER == 16  # the H100's non-portable limit, set on launch
        and "cudaFuncAttributeNonPortableClusterSizeAllowed" in src)
    assert geo.grid == b * chunks * geo.cluster <= 2 ** 31 - 1
    assert (chunks - 1) * geo.groups < groups <= chunks * geo.groups
    assert (geo.cluster - 1) * geo.px < hw <= geo.cluster * geo.px
    if (b, hw, c) in LEVELS:
        assert 0.95 * 132 <= geo.grid and (geo.grid <= 132 or geo.cluster == 1)


@pytest.mark.parametrize("b,hw,c,vec", [(3, 37 * 53, 48, 8), (2, 16, 1024, 4), (1, 1, 3, 1),
                                        (5, 7, 5000, 1), (2, 300, 200, 4), (8, 32 * 32, 1024, 8),
                                        (1, 64 * 64, 64, 8)])
def test_pool_geometry_index_map_reads_and_writes_each_element_once(b, hw, c, vec):
    """The kernel's index arithmetic (`csrc/avg_max_pool.cu`) replayed on the
    geometry: each (image, pixel, channel group) is read by one thread of one
    CTA, and each (image, channel) written by one thread of one cluster rank."""
    geo = pool_geometry(b, hw, c, vec, sms=132)
    groups, gw, k = c // vec, geo.groups, geo.cluster
    chunks, lanes, width = -(-groups // gw), geo.threads // gw, gw * vec
    share = -(-width // k)
    tid = np.arange(geo.threads)
    gl, lane = tid % gw, tid // gw
    reads = np.zeros((b, hw, groups), np.int64)
    writes = np.zeros((b, c), np.int64)
    for cta in range(geo.grid):
        cid, rank = divmod(cta, k)
        img, chunk = divmod(cid, chunks)
        p0 = rank * geo.px
        p1 = min(p0 + geo.px, hw)
        steps = np.arange(-(-max(p1 - p0, 0) // lanes))
        p = p0 + lane[:, None] + steps[None, :] * lanes
        g = np.broadcast_to((chunk * gw + gl)[:, None], p.shape)
        hit = (p < p1) & (g < groups)
        np.add.at(reads, (img, p[hit], g[hit]), 1)
        kk = rank * share + np.arange(share)
        ch = chunk * width + kk
        np.add.at(writes, (img, ch[(kk < width) & (ch < c)]), 1)
    assert np.all(reads == 1) and np.all(writes == 1)


def test_plain_pool_is_the_float32_sum_over_hw():
    x = torch.from_numpy(_act((2, 3, 5, 4), "bfloat16")).to(torch.bfloat16)
    avg, mx = avg_max_pool_plain(x)
    ref = (x.float().sum((1, 2)) / 15).to(torch.bfloat16)
    assert torch.equal(avg, ref) and torch.equal(mx, x.amax((1, 2)))


def _conv_bn_tree(rng, c=64):
    bound = np.sqrt(6.0 / (9 * c))
    kern = rng.uniform(-bound, bound, (3, 3, c, c)).astype(np.float32)
    bn_p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(0, 0.2, c).astype(np.float32)}
    bn_s = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
            "var": rng.uniform(0.3, 2.0, c).astype(np.float32)}
    return kern, bn_p, bn_s


class _JaxConvBN(nn.Module):
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, x):
        x = JaxConv(64, 3, padding=1, use_bias=False, dtype=self.dtype)(x)
        return JaxNorm(self.dtype)(x, False)


def test_conv_bn_without_bias_or_relu_matches_jax_bf16(monkeypatch):
    """ResidualBlock conv 2 (64 -> 64, no bias) -> BN, no ReLU: the fold
    bias' = beta - mean * scale and the fused conv with relu=False."""
    rng = np.random.default_rng(8)
    kern, bn_p, bn_s = _conv_bn_tree(rng)
    x = rng.normal(size=(2, 16, 24, 64)).astype(np.float32)
    variables = {"params": {"Conv_0": {"Conv_0": {"kernel": kern}}, "Norm_0": {"BatchNorm_0": bn_p}},
                 "batch_stats": {"Norm_0": {"BatchNorm_0": bn_s}}}
    ref = _f32(_JaxConvBN(jnp.bfloat16).apply(variables, jnp.asarray(x, jnp.bfloat16)))
    conv, norm = Conv(64, 64, 3, padding=1, use_bias=False), Norm(64)
    assert "bias" not in conv.state_dict()
    conv.load_state_dict({"weight": torch.from_numpy(kern.transpose(3, 2, 0, 1).copy())}, strict=True)
    norm.load_state_dict({"weight": torch.from_numpy(bn_p["scale"]),
                          "bias": torch.from_numpy(bn_p["bias"]),
                          "running_mean": torch.from_numpy(bn_s["mean"]),
                          "running_var": torch.from_numpy(bn_s["var"]),
                          "num_batches_tracked": torch.tensor(0)})
    seen = []

    def spy(x, w, scale, bias, relu):
        seen.append(relu)
        return fused_conv3x3_bn_relu(x, w, scale, bias, relu)

    monkeypatch.setattr("coastline_torch.ops.blocks.fused_conv3x3_bn_relu", spy)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad():
        got = conv_bn(conv, norm.eval(), xt.contiguous(memory_format=torch.channels_last), "none")
    assert seen == [False] and got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert np.all(np.abs(got - ref) <= 2.0 ** -5 * np.abs(ref) + 2.0 ** -5)
    assert got.min() < 0  # no ReLU
