"""CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import neither jax
nor `coastline`, so they run on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: dilation is exact; the int8 conv is bit-equal to its plain
version (exact int32 sums, the same float32 epilogue); the int8 models on
the card agree with the CPU on >= 99.5% (UNet) or 99% of mask pixels (bf16
float convs sum in another order, and a requantization turns an ulp into a
code step); the fused conv may differ from its plain
version by one bf16 ulp (2^-7 relative) + 1e-3, the same float32 sums taken
in another order before one bf16 rounding. CBAM kernels: every max is exact;
a mean is a float32 sum in another order, so |d| <= 1e-5 |ref| (float32) or
one bf16 ulp, 2^-7 |ref| (bfloat16), plus 1e-5 of the mean magnitude summed
(cancellation); the tail's attention map is a 98-tap float32 sum in another
order before its roundings: |d| <= 1e-5 (|y| + |ref|) + 1e-6 in float32 and
2^-6 (|y| + |ref|) in bfloat16.
"""

import os

import numpy as np
import pytest
import torch

from coastline_torch.infer.morphology import elliptical_kernel
from coastline_torch.kernels import cbam
from coastline_torch.kernels.pools import fused_avg_max_pool
from coastline_torch.kernels.fused_conv import (fused_conv3x3_bn_relu,
                                                fused_conv3x3_bn_relu_plain)
from coastline_torch.kernels.morphology import dilate_disk, dilate_disk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels do not run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,size", [((8, 512, 512), 20), ((3, 97, 301), 41),
                                        ((1, 64, 10980), 20), ((2, 40, 40), 1),
                                        ((1, 130, 129), 2), ((2, 5, 7), 9),
                                        ((3, 37, 61), 20), ((3, 40, 66), 2), ((2, 33, 131), 5),
                                        ((3, 13, 21), 1), ((2, 29, 203), 41), ((4, 7, 3), 20)])
def test_dilate_kernel_matches_plain(dev, shape, size):
    """Also widths = 1, 2, 3 mod 4 (the packed words' ragged ends), even
    sizes (asymmetric reach) and batch slices whose base is not 4-byte
    aligned (H * W odd): the kernel's word staging takes every legal view."""
    rng = np.random.default_rng(size)
    ker = elliptical_kernel(size)
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    slices = (x[1], x[-1], x[1:]) if len(x) > 1 else ()
    for t in (x, (x > 250).to(torch.uint8), x.float(), x[0], *slices):
        before = dilate_disk.launches
        got = dilate_disk(t, ker)
        torch.cuda.synchronize()
        assert dilate_disk.launches == before + 1
        assert got.dtype == t.dtype and got.shape == t.shape
        assert torch.equal(got.cpu(), dilate_disk_plain(t.cpu(), ker))


def test_dilate_kernel_non_nested_se(dev):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (2, 70, 150), dtype=np.uint8)).to(dev)
    skew = np.array([[1, 1, 0, 0, 0], [0, 0, 1, 1, 1], [0, 1, 1, 0, 0]], np.uint8)
    assert torch.equal(dilate_disk(x, skew).cpu(), dilate_disk_plain(x.cpu(), skew))


def _conv_case(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)).to(dev)
    scale = torch.from_numpy((rng.standard_normal(c) * 0.1 + 1).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32)).to(dev)
    return x, w, scale, bias


@pytest.mark.parametrize("shape", [(2, 16, 128, 64), (1, 7, 45, 64), (3, 33, 17, 64),
                                   (1, 9, 65, 64), (2, 5, 127, 64), (1, 6, 130, 64),
                                   (2, 1, 70, 64), (2, 33, 1, 64), (1, 1, 1, 64),
                                   (1, 512, 512, 64), (2, 67, 200, 64)])
@pytest.mark.parametrize("relu", [True, False])
def test_fused_conv_kernel_matches_plain(dev, shape, relu):
    """Also widths that are no multiple of the 64-pixel tile, one row, one
    column, one pixel, batch 1 at full size and a tile-straddling shape: the
    TMA box's zero fill and the clipped TMA store at every edge."""
    x, w, scale, bias = _conv_case(shape, dev)
    before = fused_conv3x3_bn_relu.launches
    got = fused_conv3x3_bn_relu(x, w, scale, bias, relu=relu)
    torch.cuda.synchronize()
    assert fused_conv3x3_bn_relu.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    ref = fused_conv3x3_bn_relu_plain(x.cpu(), w.cpu(), scale.cpu(), bias.cpu(), relu=relu)
    got, ref = got.float().cpu(), ref.float()
    assert torch.all((got - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-3)


def test_fused_conv_kernel_takes_an_aligned_slice_and_rejects_a_misaligned_one(dev):
    x, w, scale, bias = _conv_case((2, 12, 70, 64), dev)
    buf = torch.zeros(x.numel() + 16, dtype=torch.bfloat16, device=dev)
    aligned = buf[8:8 + x.numel()].view(x.shape)  # 16 bytes into the buffer
    aligned.copy_(x)
    got = fused_conv3x3_bn_relu(aligned, w, scale, bias)
    ref = fused_conv3x3_bn_relu_plain(x, w, scale, bias).float()
    assert torch.all((got.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-3)
    misaligned = buf[1:1 + x.numel()].view(x.shape)  # 2 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        fused_conv3x3_bn_relu(misaligned, w, scale, bias)


def test_fused_conv_rejects_non_contiguous(dev):
    x, w, scale, bias = _conv_case((1, 8, 16, 64), dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv3x3_bn_relu(x.transpose(1, 2), w, scale, bias)


@pytest.mark.parametrize("batch,tta,forwards", [(2, False, 1), (1, False, 1), (2, True, 8)])
def test_unet_bf16_on_card_launches_the_fused_conv_twice(dev, batch, tta, forwards):
    """Two launches a forward (8 forwards with the square-input TTA, whose
    flipped and transposed inputs must still reach the kernel as NHWC)."""
    from coastline_torch.infer.extract import CoastlineExtractor
    from coastline_torch.utils.torch_import import random_unet_variables

    v = random_unet_variables(seed=0)
    x = np.random.default_rng(1).integers(0, 256, (batch, 64, 64, 3), dtype=np.uint8)
    gpu = CoastlineExtractor(variables=v, dtype=torch.bfloat16, image_size=64, tta=tta)
    cpu = CoastlineExtractor(variables=v, dtype=torch.bfloat16, image_size=64, tta=tta,
                             device="cpu")
    before = fused_conv3x3_bn_relu.launches
    got = gpu.predict_masks_batch(x)
    assert fused_conv3x3_bn_relu.launches == before + 2 * forwards
    assert np.mean(got == cpu.predict_masks_batch(x)) >= 0.95


CBAM_SHAPES = [(2, 16, 128, 64), (2, 4, 4, 1024), (3, 37, 53, 48), (1, 7, 45, 64),
               (2, 5, 6, 3), (1, 9, 300, 200)]
DTYPES = [torch.float32, torch.bfloat16]


def _mean_ok(got, ref, absmean, dtype):
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    got, ref = got.float().cpu(), ref.float().cpu()
    return bool(torch.all((got - ref).abs() <= rel * ref.abs() + 1e-5 * absmean.float().cpu()))


def _tail_ok(got, ref, y, dtype):
    got, ref, y = got.float().cpu(), ref.float().cpu(), y.float().cpu().abs()
    if dtype == torch.float32:
        return bool(torch.all((got - ref).abs() <= 1e-5 * (y + ref.abs()) + 1e-6))
    return bool(torch.all((got - ref).abs() <= 2.0 ** -6 * (y + ref.abs())))


def _cbam_case(shape, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
    gate = torch.sigmoid(torch.from_numpy(rng.normal(size=(b, c)).astype(np.float32))).to(dev, dtype)
    return x, gate


# the pool also at the Robust U-Net's five levels at batch 8, 512^2 (the fourth,
# (8, 64, 64, 512), is WaterNet's bottleneck), and one image of one pixel
LEVEL_SHAPES = [(8, 512, 512, 64), (8, 256, 256, 128), (8, 128, 128, 256), (8, 64, 64, 512),
                (8, 32, 32, 1024)]
POOL_SHAPES = CBAM_SHAPES + LEVEL_SHAPES + [(1, 1, 1, 64)]


def _pool_ok(x, avg, mx, dtype):
    ref_avg, ref_mx = cbam.avg_max_pool_plain(x)
    assert avg.dtype == dtype and avg.shape == (x.shape[0], x.shape[3]) == mx.shape
    assert torch.equal(mx, ref_mx)
    assert _mean_ok(avg, ref_avg, x.float().abs().mean((1, 2)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_avg_max_pool_kernel_matches_plain(dev, shape, dtype):
    x, _ = _cbam_case(shape, dtype, dev)
    x[0, 0, 0, 0] = -100.0  # a channel whose max is far from its mean
    for fn in (cbam.avg_max_pool, fused_avg_max_pool):
        before = fn.launches
        avg, mx = fn(x)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _pool_ok(x, avg, mx, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 37, 53, 48), (2, 64, 64, 512), (1, 1, 1, 64)])
def test_avg_max_pool_kernel_unaligned_takes_the_scalar_path(dev, shape, dtype):
    """x one element past a 16-byte boundary: the scalar (vec = 1) path."""
    b, h, w, c = shape
    flat, _ = _cbam_case((b * h * w * c + 1, 1, 1, 1), dtype, dev)
    x = flat.view(-1)[1:].view(shape)
    assert x.data_ptr() % 16 != 0 and cbam._vec(c, x) == 1
    avg, mx = cbam.avg_max_pool(x)
    torch.cuda.synchronize()
    _pool_ok(x, avg, mx, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEVEL_SHAPES + [(3, 37, 53, 48), (5, 3, 7, 5000)])
def test_avg_max_pool_kernel_is_deterministic_and_both_wrappers_agree(dev, shape, dtype):
    """Two calls give the same bits (no atomics, every fold in a fixed
    order), and `fused_avg_max_pool` is `avg_max_pool` bit for bit."""
    x, _ = _cbam_case(shape, dtype, dev, 5)
    first = [t.clone() for t in cbam.avg_max_pool(x)]
    again = cbam.avg_max_pool(x)
    fused = fused_avg_max_pool(x)
    torch.cuda.synchronize()
    for a, b, f in zip(first, again, fused):
        assert torch.equal(a, b) and torch.equal(a, f)


def test_avg_max_pool_is_one_kernel_launch(dev):
    """One call launches exactly one CUDA kernel, the class `chip_smoke.py`'s
    profiles count as `avg_max_pool (ours)`. The first profiler session of a
    process starts CUPTI's activity tracing, and a kernel launched while it
    starts can go unrecorded (this test, alone in its process, once saw no
    CUDA event at all): a first session over a warm-up call comes before the
    two that count."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _KERNEL_CLASSES

    keys = dict(_KERNEL_CLASSES)["avg_max_pool (ours)"]
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for shape in ((8, 64, 64, 512), (8, 512, 512, 64)):
        x, _ = _cbam_case(shape, torch.bfloat16, dev)
        with profile(activities=activities):  # warm-up: the tracer's start, uncounted
            cbam.avg_max_pool(x)
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            cbam.avg_max_pool(x)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        assert [e.count for e in kernels] == [1], [(e.key, e.count) for e in kernels]
        assert any(k in kernels[0].key for k in keys), kernels[0].key


def test_avg_max_pool_kernel_keeps_nan_and_negative_max(dev):
    x = -torch.rand(2, 9, 10, 64, device=dev) - 1.0
    x[1, 3, 4, 7] = float("nan")
    avg, mx = cbam.avg_max_pool(x)
    assert torch.isnan(mx[1, 7]) and torch.isnan(avg[1, 7]) and int(torch.isnan(mx).sum()) == 1
    assert float(mx[0].max()) < -1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CBAM_SHAPES)
def test_gated_spatial_stats_kernel_matches_plain(dev, shape, dtype):
    x, gate = _cbam_case(shape, dtype, dev, 1)
    before = cbam.gated_spatial_stats.launches
    got = cbam.gated_spatial_stats(x, gate)
    torch.cuda.synchronize()
    assert cbam.gated_spatial_stats.launches == before + 1
    ref = cbam.gated_spatial_stats_plain(x, gate)
    assert got.shape == (shape[0], 2) + shape[1:3] and got.dtype == dtype
    assert torch.equal(got[:, 1], ref[:, 1])
    z = (x * gate[:, None, None, :]).float().abs().mean(-1)
    assert _mean_ok(got[:, 0], ref[:, 0], z, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CBAM_SHAPES)
def test_cbam_tail_kernel_matches_plain(dev, shape, dtype):
    y, gate = _cbam_case(shape, dtype, dev, 2)
    s, _ = _cbam_case(shape, dtype, dev, 3)
    stats = cbam.gated_spatial_stats_plain(y, gate)
    w = torch.from_numpy(np.random.default_rng(4).normal(0, 0.15, (7, 7, 2, 1))
                         .astype(np.float32)).to(dev)
    before = cbam.cbam_tail_apply.launches
    got = cbam.cbam_tail_apply(y, s, gate, stats, w)
    torch.cuda.synchronize()
    assert cbam.cbam_tail_apply.launches == before + 1
    assert got.dtype == dtype and got.shape == y.shape
    assert _tail_ok(got, cbam.cbam_tail_apply_plain(y, s, gate, stats, w), y, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("halo", [3, 0])
@pytest.mark.parametrize("shape", [(8, 256, 512, 64), (2, 16, 128, 64), (3, 37, 53, 48),
                                   (1, 2, 45, 64)])
def test_cbam_tail_kernel_with_a_stats_halo_matches_plain(dev, shape, halo, dtype):
    """The tail of a rank that holds some rows of the image (a mesh's
    'space' axis): stats carry `halo` rows above and below y's, and the
    kernel reads them where it reads zeros without them."""
    y, gate = _cbam_case(shape, dtype, dev, 2)
    s, _ = _cbam_case(shape, dtype, dev, 3)
    b, h, w_, _ = shape
    stats = torch.from_numpy(np.random.default_rng(5).normal(size=(b, 2, h + 2 * halo, w_))
                             .astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(np.random.default_rng(4).normal(0, 0.15, (7, 7, 2, 1))
                         .astype(np.float32)).to(dev)
    before = cbam.cbam_tail_apply.launches
    got = cbam.cbam_tail_apply(y, s, gate, stats, w, halo=halo)
    torch.cuda.synchronize()
    assert cbam.cbam_tail_apply.launches == before + 1
    ref = cbam.cbam_tail_apply_plain(y, s, gate, stats, w, halo)
    assert _tail_ok(got, ref, y, dtype)
    if halo:  # the halo rows are read: zeroing them moves the edge rows
        cut = stats.clone()
        cut[:, :, :halo] = 0
        assert not torch.equal(cbam.cbam_tail_apply(y, s, gate, cut, w, halo=halo)[:, 0],
                               got[:, 0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 256, 512, 64), (8, 16, 32, 1024), (3, 37, 53, 48),
                                   (1, 1, 1, 64)])
def test_avg_max_pool_partials_match_plain(dev, shape, dtype):
    """The pool's partials mode (a rank's rows of an image): float32 sums,
    undivided, and float32 maxima, one launch, counted."""
    x, _ = _cbam_case(shape, dtype, dev, 6)
    before = cbam.avg_max_pool.launches
    total, mx = cbam.avg_max_pool(x, partials=True)
    torch.cuda.synchronize()
    assert cbam.avg_max_pool.launches == before + 1
    assert total.dtype == mx.dtype == torch.float32
    ref_total, ref_mx = cbam.avg_max_pool_plain(x, partials=True)
    assert torch.equal(mx, ref_mx)
    area = shape[1] * shape[2]
    assert _mean_ok(total / area, ref_total / area, x.float().abs().mean((1, 2)), torch.float32)


def test_cbam_kernels_reject_non_contiguous(dev):
    x, gate = _cbam_case((2, 8, 8, 64), torch.bfloat16, dev)
    xt = x.transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cbam.avg_max_pool(xt)
    with pytest.raises(ValueError, match="contiguous"):
        cbam.gated_spatial_stats(xt, gate)


@pytest.mark.parametrize("dtype,fused_convs", [(torch.bfloat16, 2), (torch.float32, 0)])
def test_robust_unet_on_card_launches_the_cbam_kernels(dev, dtype, fused_convs):
    """Nine pool, stats and tail launches a forward, two fused convs in bf16;
    the card's logits agree with the CPU path's."""
    from coastline_torch.models.robust_unet import RobustUNet
    from coastline_torch.utils.torch_import import (random_robust_unet_variables,
                                                    robust_unet_state_dict)

    sd = robust_unet_state_dict(random_robust_unet_variables(seed=0))
    cpu, gpu = RobustUNet(dtype=dtype), RobustUNet(dtype=dtype)
    cpu.load_state_dict(sd)
    gpu.load_state_dict(sd)
    gpu = gpu.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32))
    fns = (cbam.avg_max_pool, cbam.gated_spatial_stats, cbam.cbam_tail_apply,
           fused_conv3x3_bn_relu)
    before = [f.launches for f in fns]
    with torch.inference_mode():
        got = gpu(x.to(dev), return_logits=True).cpu()
        ref = cpu.eval()(x, return_logits=True)
    assert [f.launches - b for f, b in zip(fns, before)] == [9, 9, 9, fused_convs]
    assert torch.isfinite(got).all()
    err, std = float((got - ref).abs().max()), float(ref.std())
    if dtype == torch.float32:
        assert err <= 1e-3 * max(1.0, std)
    else:
        assert err <= 0.1 * std and float(((got > 0) == (ref > 0)).float().mean()) >= 0.95


def _tie_input(shape, dtype, dev, seed=0, nonfinite=False):
    """ReLU zeros (whole windows of them), equal pairs at window positions 0
    and 3, negated channels (-0.0 ties), zeros of random sign, and with
    `nonfinite` two NaNs in one window (the first wins) and +-inf."""
    gen = torch.Generator().manual_seed(seed)
    b, h, w, c = shape
    x = torch.relu(torch.randn(shape, generator=gen))
    if h % 2 == 0 and w % 2 == 0:
        xw = x.view(b, h // 2, 2, w // 2, 2, c)
        xw[:, :, 1, :, 1, ::3] = xw[:, :, 0, :, 0, ::3]
    x[..., 1::5] = -x[..., 1::5]
    x[..., 2::7] = torch.where(torch.rand(shape, generator=gen) < 0.5, 0.0, -0.0)[..., 2::7]
    if nonfinite:
        x[0, 0, 1, 0] = x[0, 1, 1, 0] = float("nan")
        x[-1, 0, 0, -1], x[-1, 1, 0, -1] = float("inf"), float("-inf")
    return x.to(dev, dtype)


def _bits_equal(a, b):
    """Bit for bit (signs of zero included), any NaN equal to any NaN."""
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.view(ints)[~nan], b.view(ints)[~nan])


UNPOOL_SHAPES = [(2, 16, 128, 64), (3, 38, 54, 20), (2, 8, 8, 512), (1, 6, 10, 1), (2, 4, 6, 21)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", UNPOOL_SHAPES)
def test_max_pool_with_indices_kernel_matches_plain(dev, shape, dtype):
    from coastline_torch.kernels import unpool

    x = _tie_input(shape, dtype, dev, nonfinite=True)
    before = unpool.max_pool_with_indices.launches
    vals, codes = unpool.max_pool_with_indices(x)
    torch.cuda.synchronize()
    assert unpool.max_pool_with_indices.launches == before + 1
    r_vals, r_codes = unpool.max_pool_with_indices_plain(x.cpu())
    assert _bits_equal(codes, r_codes) and _bits_equal(vals, r_vals)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", UNPOOL_SHAPES)
def test_max_unpool_kernel_matches_plain(dev, shape, dtype):
    from coastline_torch.kernels import unpool

    v = _tie_input(shape, dtype, dev, seed=1, nonfinite=True)
    k = torch.randint(0, 4, shape, generator=torch.Generator().manual_seed(2), dtype=torch.int32)
    before = unpool.max_unpool.launches
    out = unpool.max_unpool(v, k.to(dev))
    torch.cuda.synchronize()
    assert unpool.max_unpool.launches == before + 1
    assert _bits_equal(out, unpool.max_unpool_plain(v.cpu(), k))


def test_unpool_kernels_reject_non_contiguous(dev):
    from coastline_torch.kernels import unpool

    x = _tie_input((2, 8, 8, 64), torch.bfloat16, dev)
    with pytest.raises(ValueError, match="contiguous"):
        unpool.max_pool_with_indices(x.transpose(1, 2))
    vals, codes = unpool.max_pool_with_indices(x)
    with pytest.raises(ValueError, match="contiguous"):
        unpool.max_unpool(vals.transpose(1, 2), codes.transpose(1, 2))


@pytest.mark.parametrize("dtype,fused_convs", [(torch.bfloat16, 2), (torch.float32, 0)])
def test_segnet_on_card_launches_the_unpool_kernels(dev, dtype, fused_convs):
    """Four pool and four unpool launches a forward, two fused convs in bf16;
    in f32 the card's logits agree with the CPU path's on 99.9% of them (a
    pool window near a tie may pick another position)."""
    from coastline_torch.kernels import unpool
    from coastline_torch.models.segnet import SegNet
    from coastline_torch.utils.torch_import import random_segnet_variables, segnet_state_dict

    sd = segnet_state_dict(random_segnet_variables(seed=0))
    cpu, gpu = SegNet(dtype=dtype), SegNet(dtype=dtype)
    cpu.load_state_dict(sd)
    gpu.load_state_dict(sd)
    gpu = gpu.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32))
    fns = (unpool.max_pool_with_indices, unpool.max_unpool, fused_conv3x3_bn_relu)
    before = [f.launches for f in fns]
    with torch.inference_mode():
        got = gpu(x.to(dev), return_logits=True).cpu()
        ref = cpu.eval()(x, return_logits=True)
    assert [f.launches - b for f, b in zip(fns, before)] == [4, 4, fused_convs]
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        tol = 1e-3 * max(1.0, float(ref.std()))
        assert float(((got - ref).abs() <= tol).float().mean()) >= 0.999


ZOO = ("DeepLabV3+", "YOLO-SEG", "PSPNet", "Fast-SCNN", "ENet", "WaterNet", "MSWNet",
       "HRNet-Water", "SegFormer-Lite")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ZOO)
def test_zoo_on_card_launches_its_kernels(dev, name, dtype):
    """Each zoo model's eval forward on the card launches the kernels
    `chip_smoke.zoo_want` lists (the fused conv twice in WaterNet, once in
    HRNet-Water, in bf16; `fused_avg_max_pool` once in WaterNet) and no
    other; in f32 every logit is within 1e-3 x max(1, std) of the CPU path's."""
    from chip_smoke import launch_counts, launches_since, zoo_state_dict, zoo_want
    from coastline_torch.models.registry import create_model

    sd = zoo_state_dict(name)
    cpu, gpu = create_model(name, dtype=dtype), create_model(name, dtype=dtype)
    cpu.load_state_dict(sd)
    gpu.load_state_dict(sd)
    gpu = gpu.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32))
    before = launch_counts()
    with torch.inference_mode():
        got = gpu(x.to(dev), return_logits=True).cpu()
        ref = cpu.eval()(x, return_logits=True)
    assert launches_since(before) == zoo_want(name, dtype)
    assert torch.isfinite(got).all() and got.dtype == torch.float32
    if dtype == torch.float32:
        assert float((got - ref).abs().max()) <= 1e-3 * max(1.0, float(ref.std()))


def test_f32_train_steps_on_card_match_cpu(dev):
    """`chip_smoke.train_card_vs_cpu`: two f32 Adam steps of the full-width
    UNet at (2, 64, 64) a batch, wd 0.1, on the card (TF32 off,
    deterministic) against the CPU path, at the JAX package's bounds: loss
    1e-5 relative, parameters atol 5e-5 / rtol 1e-4, BN statistics 2e-5 /
    2e-4. Its docstring says why the BN biases are shifted."""
    from chip_smoke import train_card_vs_cpu
    from coastline_torch.models.unet import UNet

    assert train_card_vs_cpu(dev, UNet().state_dict())["ok"]


def test_bf16_train_steps_on_card_match_cpu(dev):
    """The same two steps in bf16, which rounds at other places on the card
    than on the CPU and so flips the sign-like first Adam steps of weights
    with small gradients: the loss within 2e-3 relative and 98% of the
    values within the f32 bounds."""
    from chip_smoke import shift_bn
    from coastline_torch.models.unet import UNet
    from coastline_torch.train.loop import TrainConfig, create_train_state, make_train_epoch

    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    masks = (rng.random((4, 64, 64)) > 0.5).astype(np.uint8)
    sd = shift_bn(UNet().state_dict())
    cfg = TrainConfig(lr=1e-4, weight_decay=0.1, loss="ce", batch_size=2)
    runs = []
    for d in (torch.device("cpu"), dev):
        model = UNet(dtype=torch.bfloat16)
        model.load_state_dict(sd)
        state = create_train_state(model, cfg, device=d)
        state, loss = make_train_epoch(model, cfg, device=d)(
            state, images, masks, np.array([[0, 1], [2, 3]]), np.ones((2, 2), np.float32))
        runs.append((loss, {k: v.cpu() for k, v in model.state_dict().items()}))
    (l_cpu, ref), (l_dev, got) = runs
    assert state.step == 2 and abs(l_dev - l_cpu) <= 2e-3 * abs(l_cpu)
    within, total = 0, 0
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 2
            continue
        atol, rtol = (2e-5, 2e-4) if ".running_" in k else (5e-5, 1e-4)
        ok = (got[k] - r).abs() <= atol + rtol * r.abs()
        within, total = within + int(ok.sum()), total + ok.numel()
    assert within >= 0.98 * total


def test_train_mode_takes_no_fused_conv(dev):
    """A bf16 UNet in train mode runs every conv through cuDNN (forward and
    backward); back in eval mode it launches the fused conv twice."""
    from coastline_torch.models.unet import UNet

    model = UNet(dtype=torch.bfloat16).to(dev)
    x = torch.randn(2, 3, 32, 32, device=dev)
    before = fused_conv3x3_bn_relu.launches
    model.train()(x).sum().backward()
    torch.cuda.synchronize()
    assert fused_conv3x3_bn_relu.launches == before
    assert all(p.grad is not None for p in model.parameters())
    with torch.inference_mode():
        model.eval()(x)
    assert fused_conv3x3_bn_relu.launches == before + 2


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """A train state on the card saved and restored into a fresh one: the
    parameters, BN statistics, Adam moments, plateau, step and the device
    generator come back bit for bit, on the card."""
    from coastline_torch.data.augment import make_augment_fn
    from coastline_torch.models.unet import UNet
    from coastline_torch.train.checkpoint import CheckpointManager
    from coastline_torch.train.loop import TrainConfig, create_train_state, make_train_epoch

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    masks = (rng.random((2, 32, 32)) > 0.5).astype(np.uint8)
    cfg = TrainConfig(lr=1e-3, weight_decay=0.0, loss="ce", batch_size=2)
    model = UNet(dtype=torch.bfloat16)
    state = create_train_state(model, cfg, device=dev)
    state, _ = make_train_epoch(model, cfg, make_augment_fn(), device=dev)(
        state, images, masks, np.array([[0, 1]]), np.ones((1, 2), np.float32))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, state)
    fresh = create_train_state(UNet(dtype=torch.bfloat16, seed=5), cfg, device=dev)
    back = ckpt.restore(fresh, step=1)
    a, b = state.model.state_dict(), back.model.state_dict()
    assert all(torch.equal(a[k], b[k]) and b[k].device == a[k].device for k in a)
    oa, ob = state.optimizer.state_dict()["state"], back.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i][m].cpu(), ob[i][m].cpu()) for i in oa
               for m in ("step", "exp_avg", "exp_avg_sq"))
    assert ob[0]["exp_avg"].device.type == "cuda"
    assert back.plateau == state.plateau and back.step == state.step == 1
    assert torch.equal(back.generator.get_state(), state.generator.get_state())
    assert back.generator.device.type == "cuda"


def test_segnet_train_gradients_on_card_match_cpu(dev):
    """`chip_smoke.train_card_vs_cpu` for the full-width SegNet with BCE, as
    `chip_smoke.protocol_path` runs it (`CARD_VS_CPU`): every parameter
    holds a gradient on the card (train mode takes the differentiable pool
    and unpool, not the kernels), and two f32 Adam steps at (2, 64, 64)
    equal the CPU path's within the JAX package's bounds (BN biases shifted
    off the ReLU's kink, deterministic mode)."""
    from chip_smoke import CARD_VS_CPU, train_card_vs_cpu
    from coastline_torch.models.segnet import SegNet

    init, beta, seed, batch = CARD_VS_CPU["SegNet"]
    assert init == "ctor"
    out = train_card_vs_cpu(dev, SegNet().state_dict(), model_fn=SegNet, loss="bce",
                            label="segnet", beta=beta, seed=seed, batch=batch)
    assert out["params_without_grad_on_card"] == [] and out["ok"]


@pytest.mark.parametrize("name", ["SegNet", "Robust UNet", "WaterNet", "HRNet-Water"])
def test_train_mode_launches_no_kernel(dev, name):
    """A bf16 train-mode forward and backward launches none of the seven
    kernels and leaves a gradient on every parameter; back at eval, under
    inference_mode, the model launches its kernels again."""
    from chip_smoke import launch_counts, launches_since
    from coastline_torch.models.registry import create_model

    kw = {"base": 16} if name == "Robust UNet" else {}
    model = create_model(name, dtype=torch.bfloat16, **kw).to(dev)
    x = torch.randn(2, 3, 32, 32, device=dev)
    before = launch_counts()
    model.train()(x, return_logits=True).float().square().mean().backward()
    torch.cuda.synchronize()
    assert not any(launches_since(before).values())
    assert all(p.grad is not None for p in model.parameters())
    with torch.inference_mode():
        model.eval()(x)
    assert sum(launches_since(before).values()) > 0


def test_kernel_wrappers_refuse_autograd(dev):
    """Each wrapper raises on a CUDA input that requires grad while grad
    mode is on (the kernels have no backward), and launches under no_grad."""
    from coastline_torch.infer.morphology import elliptical_kernel
    from coastline_torch.kernels import unpool

    x = torch.randn(2, 8, 8, 64, device=dev)
    xb = x.to(torch.bfloat16)
    gate = torch.rand(2, 64, device=dev)
    stats = torch.randn(2, 2, 8, 8, device=dev)
    w7 = torch.randn(7, 7, 2, 1, device=dev)
    w3 = torch.randn(3, 3, 64, 64, device=dev)
    ones = torch.ones(64, device=dev)
    codes = torch.zeros(2, 4, 4, 64, dtype=torch.int32, device=dev)
    small = x[:, :4, :4].contiguous()
    calls = {  # name: (input that will require grad, call)
        "avg_max_pool": (x, cbam.avg_max_pool),
        "fused_avg_max_pool": (x, fused_avg_max_pool),
        "gated_spatial_stats": (x, lambda t: cbam.gated_spatial_stats(t, gate)),
        "cbam_tail": (x, lambda t: cbam.cbam_tail_apply(t, x, gate, stats, w7)),
        "max_pool_with_indices": (x, unpool.max_pool_with_indices),
        "max_unpool": (small, lambda t: unpool.max_unpool(t, codes)),
        "fused_conv3x3_bn_relu": (xb, lambda t: fused_conv3x3_bn_relu(t, w3, ones, ones)),
        "dilate_disk": (x[..., 0].contiguous(), lambda t: dilate_disk(t, elliptical_kernel(3))),
    }
    for name, (src, call) in calls.items():
        leaf = src.clone().requires_grad_()
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(leaf)
        with torch.no_grad():
            call(leaf)


def test_dropout2d_on_card(dev):
    from chip_smoke import dropout_check

    assert dropout_check(dev)["ok"]


@pytest.mark.parametrize("shape,batch,overlap,dilation", [((300, 410, 3), 4, 16, 20),
                                                          ((70, 1101, 3), 3, 8, 5),
                                                          ((50, 60, 3), 8, 16, 20)])
def test_scene_pipeline_on_card_matches_host_path(dev, shape, batch, overlap, dilation):
    """The device scene pipeline on the card (pinned upload, tiles cut and
    stitched there, band by the dilation kernel) equals the host tiling path
    bit for bit, its band equals the CPU band of its mask, and one scene
    launches the dilation once (widths 1 and 1101 mod 4 = 1)."""
    from coastline_torch.infer.extract import CoastlineExtractor
    from coastline_torch.infer.morphology import coastline_band

    ex = CoastlineExtractor(dtype=torch.bfloat16, image_size=128, device=dev)
    scene = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    before = (dilate_disk.launches, fused_conv3x3_bn_relu.launches)
    mask, band = ex.predict_scene(scene, batch=batch, overlap=overlap, with_band=dilation)
    ny, nx = (-(-(n - overlap) // (128 - overlap)) for n in shape[:2])
    assert (dilate_disk.launches - before[0],
            fused_conv3x3_bn_relu.launches - before[1]) == (1, 2 * -(-ny * nx // batch))
    host_mask, host_band = ex.predict_scene(scene, batch=batch, overlap=overlap,
                                            device_pipeline=False, with_band=dilation)
    np.testing.assert_array_equal(mask, host_mask)
    np.testing.assert_array_equal(band, host_band)
    np.testing.assert_array_equal(band, coastline_band(mask, dilation, device="cpu").numpy())


def test_extract_scenes_on_card_pipelined_matches_sequential(dev, tmp_path):
    """Pinned, non-blocking downloads queued before the next scene's work:
    the pipelined run equals the sequential one, artifacts included."""
    from PIL import Image

    from coastline_torch.infer.extract import CoastlineExtractor

    ex = CoastlineExtractor(image_size=64, device=dev)
    rng = np.random.default_rng(2)
    paths = []
    for i, shape in enumerate([(200, 300, 3), (200, 300, 3), (180, 90, 3)]):
        paths.append(str(tmp_path / f"s{2019 + i}.png"))
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(paths[-1])
    seq = ex.extract_scenes(paths, str(tmp_path / "a"), 5, batch=4, pipeline_depth=1)
    piped = ex.extract_scenes(paths, str(tmp_path / "b"), 5, batch=4, pipeline_depth=2)
    for a, b in zip(seq, piped):
        np.testing.assert_array_equal(a["water_mask"], b["water_mask"])
        np.testing.assert_array_equal(a["coastline_mask"], b["coastline_mask"])
        assert a["coastlines"] == b["coastlines"]
    assert sorted(os.listdir(tmp_path / "a")) == sorted(os.listdir(tmp_path / "b"))


INT8_CONV_CASES = [  # (input shape, C_out, kernel, padding, dilation, lhs_dilation, stride)
    ((2, 9, 11, 64), 64, 3, 1, 1, None, 1),
    ((1, 7, 5, 32), 40, 1, 0, 1, None, 1),          # ragged tiles in M and N
    ((2, 16, 16, 96), 128, 3, 4, 4, None, 1),       # the bottleneck's dilation 4
    ((3, 13, 17, 128), 72, 3, 2, 2, None, 1),
    ((2, 8, 8, 64), 64, 2, ((1, 1), (1, 1)), 1, (2, 2), 1),  # a transposed conv
    ((1, 3, 5, 1024), 512, 2, ((1, 1), (1, 1)), 1, (2, 2), 1),
    ((1, 1, 1, 64), 64, 3, 1, 1, None, 1),          # one pixel: every tap but one in the padding
    ((2, 33, 130, 64), 128, 3, ((1, 0), (2, 1)), 1, None, 1),
    ((2, 9, 11, 64), 96, 3, 1, 1, None, 2),         # stride 2: odd H and W, C_out 96
    ((3, 14, 18, 96), 192, 3, 1, 1, None, 2),       # HRNet-Water's c6 widths
    ((1, 1, 1, 128), 64, 3, 1, 1, None, 2),         # stride 2 on a 1x1 map
    ((2, 5, 7, 128), 64, 4, ((2, 2), (2, 2)), 1, (2, 2), 1),  # DeepLabV3+'s 4x4 transposed
    ((2, 4, 4, 256), 128, 4, ((2, 2), (2, 2)), 1, (2, 2), 1),
    ((1, 1, 1, 64), 96, 4, ((2, 2), (2, 2)), 1, (2, 2), 1),   # one pixel, C_out 96
    ((2, 9, 7, 144), 64, 3, 1, 1, None, 1),         # HRNet-Water's C_in 144
    ((1, 3, 1, 144), 96, 3, 1, 1, None, 1),
    ((8, 3, 3, 512), 128, 1, 0, 1, None, 1),        # PSPNet's pyramid: a 3x3 map
    ((2, 8, 8, 128), 64, 3, ((1, 2), (1, 2)), 1, (2, 2), 1),  # ENet's 3x3 transposed
    ((2, 5, 7, 64), 96, 3, ((1, 2), (1, 2)), 1, (2, 2), 1),   # odd sizes, C_out 96
    ((1, 1, 1, 64), 64, 3, ((1, 2), (1, 2)), 1, (2, 2), 1),   # one pixel: row a + 1 past H
    ((2, 16, 16, 64), 64, 4, 0, 1, None, 4),        # SegFormer-Lite's stride-4 reduction
    ((1, 9, 13, 64), 128, 4, 0, 1, None, 4),        # ragged: 2x3 outputs, a tail of 1
    ((1, 20, 300, 64), 64, 1, 0, 1, None, 4),       # a 1x1 at stride 4: 64-wide tiles
    ((2, 6, 6, 128), 128, 2, 0, 1, None, 2),        # SegFormer-Lite's 2x2 at stride 2
    ((2, 16, 16, 1024), 256, 1, 0, 1, None, 1),     # SegFormer-Lite's fusion: C_in 1024
]


@pytest.mark.parametrize("mode", ["values", "values_relu", "codes", "codes_relu",
                                  "values_leaky", "codes_leaky"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(INT8_CONV_CASES)))
def test_int8_conv_kernel_matches_plain(dev, case, dtype, mode):
    """Bit for bit, every mode. Codes mode at two steps: 2^-6, where about
    half the bf16 values land on an exact .5 after the division and the
    values beyond +-1.98 clamp, and 0.0371, a step whose division rounds."""
    from coastline_torch.kernels.int8_conv import int8_conv, int8_conv_plain, packed

    shape, cout, k, pad, dil, lhs, stride = INT8_CONV_CASES[case]
    rng = np.random.default_rng(case)
    x = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, shape[-1], cout), dtype=np.int8)).to(dev)
    ws = torch.from_numpy((rng.random(cout) * 1e-3).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dev)
    act = mode.split("_")[1] if "_" in mode else "none"
    steps = (2.0 ** -6, 0.0371) if mode.startswith("codes") else (None,)
    for step in steps:
        before = int8_conv.launches
        got = int8_conv(x, packed(wq, lhs is not None), 0.0123, ws, b, pad, dil, lhs, dtype,
                        act=act, out_step=step, stride=stride)
        torch.cuda.synchronize()
        assert int8_conv.launches == before + 1
        ref = int8_conv_plain(x.cpu(), wq.cpu(), 0.0123, ws.cpu(), b.cpu(), pad, dil, lhs, dtype,
                              act=act, out_step=step, stride=stride)
        if step is None:
            assert _bits_equal(got, ref)
        else:
            assert got.dtype == torch.int8 and torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("step", [2.0 ** -6, 0.0371, 1e-3, float(np.float32(7.3 / 127))])
def test_int8_conv_codes_every_bf16_value(dev, step):
    """Codes mode's division (a double product, rounded to float) against
    the true float division on every bf16 value but NaN, and on 131,072
    float32 values of random bits: a zero input makes each output its bias."""
    from coastline_torch.kernels.int8_conv import int8_conv, int8_conv_plain, packed

    bits = np.arange(2 ** 16, dtype=np.uint32) << 16
    bf16 = bits.view(np.float32)
    rng = np.random.default_rng(11)
    f32 = rng.integers(0, 2 ** 32, 2 ** 17, dtype=np.uint64).astype(np.uint32).view(np.float32)
    cout = 2048
    x = torch.zeros((1, 1, 1, 32), dtype=torch.int8, device=dev)
    wq = torch.zeros((1, 1, 32, cout), dtype=torch.int8, device=dev)
    w = packed(wq)
    ws = torch.ones(cout, device=dev)
    for values, dtype in ((bf16, torch.bfloat16), (f32, torch.float32)):
        values = values[~np.isnan(values)]
        values = np.concatenate([values, np.zeros(-len(values) % cout, np.float32)])
        for chunk in values.reshape(-1, cout):
            b = torch.from_numpy(chunk.copy()).to(dev)
            got = int8_conv(x, w, 1.0, ws, b, out_dtype=dtype, out_step=step)
            ref = int8_conv_plain(x, wq, 1.0, ws, b, out_dtype=dtype, out_step=step)
            assert torch.equal(got, ref), (dtype, step)


def test_int8_conv_wrapper_refusals_on_card(dev):
    from coastline_torch.kernels.int8_conv import PackedWeights, int8_conv, packed

    x = torch.zeros((1, 4, 4, 64), dtype=torch.int8, device=dev)
    wq = torch.zeros((3, 3, 64, 64), dtype=torch.int8, device=dev)
    w = packed(wq)
    ws, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(TypeError, match="PackedWeights"):
        int8_conv(x, wq, 1.0, ws, b, 1)
    with pytest.raises(ValueError, match="kernel layout"):
        int8_conv(x, PackedWeights(wq, None, False), 1.0, ws, b, 1)
    with pytest.raises(ValueError, match="one device"):
        int8_conv(x, packed(wq.cpu()), 1.0, ws, b, 1)
    with pytest.raises(ValueError, match="one device"):
        int8_conv(x.cpu(), packed(wq.cpu()), 1.0, ws, b.cpu(), 1)
    with pytest.raises(ValueError, match="C_in % 16"):
        int8_conv(x[..., :40].contiguous(), packed(wq[:, :, :40].contiguous()), 1.0, ws, b, 1)
    with pytest.raises(ValueError, match="stride 1, 2 or 4"):
        int8_conv(x, w, 1.0, ws, b, 1, stride=3)
    w4 = packed(torch.zeros((4, 4, 64, 64), dtype=torch.int8, device=dev), transposed=True)
    with pytest.raises(ValueError, match="transposed"):
        int8_conv(x, w4, 1.0, ws, b, ((1, 1), (1, 1)), lhs_dilation=(2, 2))
    w3 = packed(torch.zeros((3, 3, 64, 64), dtype=torch.int8, device=dev), transposed=True)
    with pytest.raises(ValueError, match="transposed"):
        int8_conv(x, w3, 1.0, ws, b, ((1, 1), (1, 1)), lhs_dilation=(2, 2))
    with pytest.raises(ValueError, match="act"):
        int8_conv(x, w, 1.0, ws, b, 1, act="gelu")
    with pytest.raises(ValueError, match="C_out % 8"):
        int8_conv(x, packed(wq[..., :60].contiguous()), 1.0, ws[:60], b[:60], 1)
    with pytest.raises(RuntimeError, match="int8_conv has no backward"):
        int8_conv(x, w, 1.0, ws.clone().requires_grad_(), b, 1)
    buf = torch.zeros(x.numel() + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        int8_conv(buf[1:].view(x.shape), w, 1.0, ws, b, 1)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv(x.transpose(1, 2), w, 1.0, ws, b, 1)
    with pytest.raises(ValueError, match="transposed"):
        int8_conv(x, w, 1.0, ws, b, 1, lhs_dilation=(2, 2))


@pytest.mark.parametrize("shape", [(2, 16, 128, 64), (3, 38, 54, 20), (1, 6, 10, 1)])
def test_unpool_kernels_on_int8_codes(dev, shape):
    """SegNet's int8 forward pools and unpools codes: ties everywhere."""
    from coastline_torch.kernels import unpool

    rng = np.random.default_rng(shape[-1])
    x = torch.from_numpy(rng.integers(-3, 4, shape, dtype=np.int8)).to(dev)
    vals, codes = unpool.max_pool_with_indices(x)
    out = unpool.max_unpool(vals, codes)
    torch.cuda.synchronize()
    r_vals, r_codes = unpool.max_pool_with_indices_plain(x.cpu())
    assert vals.dtype == torch.int8 and torch.equal(vals.cpu(), r_vals)
    assert torch.equal(codes.cpu(), r_codes)
    assert torch.equal(out.cpu(), unpool.max_unpool_plain(r_vals, r_codes))


@pytest.mark.parametrize("arch,want,limit", [("unet", 21, 0.995), ("robust_unet", 38, 0.99),
                                             ("segnet", 18, 0.99), ("waternet", 16, 0.99),
                                             ("mswnet", 18, 0.99), ("hrnet_water", 6, 0.99),
                                             ("pspnet", 8, 0.99), ("deeplabv3p", 10, 0.99),
                                             ("yoloseg", 8, 0.99), ("fastscnn", 13, 0.99),
                                             ("enet", 2, 0.99), ("segformer_lite", 19, 0.99)])
def test_quantized_model_on_card_matches_cpu(dev, arch, want, limit):
    """One int8 model, its tree on the card and on the CPU, the same scales:
    the int8 conv launched for every conv on the int8 path, SegNet's pool
    and unpool on codes, and the masks within `limit` of the CPU's. The
    zoo models from their seeded constructors."""
    from coastline_torch.infer import quant
    from coastline_torch.kernels import unpool
    from coastline_torch.kernels.int8_conv import int8_conv
    from coastline_torch.models.registry import create_model
    from coastline_torch.utils import torch_import as ti

    makers = {"unet": (ti.random_unet_variables, ti.unet_state_dict),
              "robust_unet": (ti.random_robust_unet_variables, ti.robust_unet_state_dict),
              "segnet": (ti.random_segnet_variables, ti.segnet_state_dict)}
    if arch in makers:
        make, to_sd = makers[arch]
        sd = to_sd(make(seed=0))
    else:
        sd = create_model(arch).state_dict()
    folded = quant.ARCHS[arch][0](sd)
    calib = quant.default_calibration(64, device="cpu")
    scales = quant.calibrate(folded, calib, arch=arch)
    qp = quant.quantize_folded(folded)
    cpu = quant.QuantizedModel(qp, scales, arch=arch, device="cpu")
    card = quant.QuantizedModel(qp, scales, arch=arch, device=dev)
    before = (int8_conv.launches, unpool.max_pool_with_indices.launches,
              unpool.max_unpool.launches)
    got = card(calib[:2], return_logits=True)
    torch.cuda.synchronize()
    pools = 4 if arch == "segnet" else 0
    assert (int8_conv.launches - before[0], unpool.max_pool_with_indices.launches - before[1],
            unpool.max_unpool.launches - before[2]) == (want, pools, pools)
    ref = cpu(calib[:2], return_logits=True)
    got = got.cpu()
    if arch == "unet":
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean()
    else:
        agree = ((got > 0) == (ref > 0)).float().mean()
    assert torch.isfinite(got).all() and agree >= limit, float(agree)


def test_quantized_extractor_on_card(dev, tmp_path):
    """quantize() on the card: its artifact serves the same masks through
    from_quantized, the scene path equals the host tiling path, and the
    fused float conv never runs."""
    from coastline_torch.infer.extract import CoastlineExtractor
    from coastline_torch.kernels.int8_conv import int8_conv

    npz = str(tmp_path / "q.npz")
    ex = CoastlineExtractor(image_size=64, dtype=torch.bfloat16, device=dev).quantize(save_to=npz)
    served = CoastlineExtractor.from_quantized(npz, image_size=64, device=dev)
    images = np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    before = (int8_conv.launches, fused_conv3x3_bn_relu.launches)
    masks = served.predict_masks_batch(images)
    assert (int8_conv.launches - before[0], fused_conv3x3_bn_relu.launches - before[1]) == (21, 0)
    np.testing.assert_array_equal(masks, ex.predict_masks_batch(images))
    scene = np.random.default_rng(4).integers(0, 256, (150, 170, 3), dtype=np.uint8)
    mask, band = served.predict_scene(scene, batch=4, with_band=5)
    host = served.predict_scene(scene, batch=4, with_band=5, device_pipeline=False)
    np.testing.assert_array_equal(mask, host[0])
    np.testing.assert_array_equal(band, host[1])


def test_custom_ops_on_card_match_plain(dev):
    """Each custom op's CUDA registration (one kernel launch, counted)
    against its plain version at one int8 shape, bit for bit, and its fake
    against the real output (`torch.library.opcheck`)."""
    from coastline_torch.kernels import unpool
    from coastline_torch.kernels.int8_conv import (int8_conv, int8_conv_op, int8_conv_plain,
                                                   pack_weights)

    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 16, 16, 64), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 64, 64), dtype=np.int8))
    ws = torch.from_numpy((rng.random(64) * 1e-3).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    geom = (3, 3, [1, 1, 1, 1], 1, 1, None, 0.0123, "relu", torch.bfloat16, 0.0371)
    args = (x.to(dev), pack_weights(wq.to(dev)), ws.to(dev), b.to(dev)) + geom
    before = int8_conv.launches
    got = int8_conv_op(*args)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 1
    ref = int8_conv_plain(x, wq, 0.0123, ws, b, 1, 1, None, torch.bfloat16, "relu", 0.0371)
    assert got.dtype == torch.int8 and torch.equal(got.cpu(), ref)
    assert set(torch.library.opcheck(int8_conv_op, args).values()) == {"SUCCESS"}

    codes = torch.from_numpy(rng.integers(-3, 4, (2, 16, 128, 64), dtype=np.int8))
    before = (unpool.max_pool_with_indices.launches, unpool.max_unpool.launches)
    vals, idx = unpool.max_pool_with_indices_op(codes.to(dev))
    out = unpool.max_unpool_op(vals, idx)
    torch.cuda.synchronize()
    assert (unpool.max_pool_with_indices.launches - before[0],
            unpool.max_unpool.launches - before[1]) == (1, 1)
    r_vals, r_idx = unpool.max_pool_with_indices_plain(codes)
    assert torch.equal(vals.cpu(), r_vals) and torch.equal(idx.cpu(), r_idx)
    assert torch.equal(out.cpu(), unpool.max_unpool_plain(r_vals, r_idx))
    for op, op_args in ((unpool.max_pool_with_indices_op, (codes.to(dev),)),
                        (unpool.max_unpool_op, (vals, idx))):
        assert set(torch.library.opcheck(op, op_args).values()) == {"SUCCESS"}


@pytest.mark.parametrize("arch,want,pools", [("unet", 21, 0), ("segnet", 18, 4)])
def test_exported_int8_forward_on_card(dev, arch, want, pools, tmp_path):
    """`export_serving` on the card at 128^2, batch 2: the program on the
    serving weights is bit-equal to the eager forward and launches the same
    kernels (the launch counters move in the ops' CUDA registrations); a
    batch of 1 raises; the bundle round trip is bit-equal too."""
    from coastline_torch.infer import deploy, quant
    from coastline_torch.kernels import unpool
    from coastline_torch.kernels.int8_conv import int8_conv
    from coastline_torch.utils import torch_import as ti

    make, to_sd = {"unet": (ti.random_unet_variables, ti.unet_state_dict),
                   "segnet": (ti.random_segnet_variables, ti.segnet_state_dict)}[arch]
    calib = quant.default_calibration(128, n_scenes=2, device=dev)
    qm = quant.QuantizedModel.from_state_dict(to_sd(make(seed=0)), calib, arch=arch, device=dev)
    ref = qm(calib)
    fn = deploy.load_serving(deploy.export_serving(qm, 2, 128))
    weights = deploy.serving_weights(qm)
    before = (int8_conv.launches, unpool.max_pool_with_indices.launches,
              unpool.max_unpool.launches)
    got = fn(weights, calib)
    torch.cuda.synchronize()
    assert (int8_conv.launches - before[0], unpool.max_pool_with_indices.launches - before[1],
            unpool.max_unpool.launches - before[2]) == (want, pools, pools)
    assert _bits_equal(got, ref)
    with pytest.raises(Exception):
        fn(weights, calib[:1])
    deploy.save_serving_bundle(tmp_path / "b", qm, 2, 128)
    served, _ = deploy.load_serving_bundle(tmp_path / "b", device=dev)
    assert _bits_equal(served(calib), ref)


def test_custom_ops_on_card_refuse_what_the_kernels_cannot_read(dev):
    """Each op's CUDA registration refuses a strided view and tensors on two
    devices itself, so a program that calls the op directly is held to the
    wrapper's checks: the kernels read raw NHWC pointers."""
    from coastline_torch.kernels import unpool
    from coastline_torch.kernels.int8_conv import int8_conv_op, pack_weights

    x = torch.zeros((2, 16, 16, 64), dtype=torch.int8, device=dev)
    w = pack_weights(torch.zeros((3, 3, 64, 64), dtype=torch.int8, device=dev))
    ws, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    geom = (3, 3, [1, 1, 1, 1], 1, 1, None, 0.0123, "relu", torch.bfloat16, None)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv_op(x.transpose(1, 2), w, ws, b, *geom)
    with pytest.raises(ValueError, match="one device"):
        int8_conv_op(x, w, ws.cpu(), b, *geom)
    with pytest.raises(ValueError, match="contiguous"):
        unpool.max_pool_with_indices_op(x.transpose(1, 2))
    vals, idx = unpool.max_pool_with_indices_op(x)
    with pytest.raises(ValueError, match="contiguous"):
        unpool.max_unpool_op(vals, idx.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="one device"):
        unpool.max_unpool_op(vals, idx.cpu())
