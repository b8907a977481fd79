#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`coastline_torch`).

    python3 chip_smoke.py [--out results.json]

Needs one NVIDIA H100 and the CUDA toolkit; builds the kernels from
`coastline_torch/csrc/` into `build/coastline_torch/` on first use. Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version at its paths'
     shapes and time kernel, plain version and a library yardstick with
     CUDA events: the fused conv (with and without ReLU, at the serving
     shape and eight ragged ones), the dilation, the
     three CBAM kernels (pool, gated stats, tail) at the five Robust U-Net
     level shapes, (2, 4, 4, 1024) and an odd shape, and SegNet's indexed
     pool and unpool at its four levels and an odd shape, on inputs full of
     ties (ReLU zeros, equal pairs, +0/-0, NaN and inf), bit for bit, in
     bf16 and f32;
  4. the serving path at full width: the 31,043,586-parameter 2-class UNet
     (random weights from a numpy seed, through the weight bridge) in bf16
     behind `serve(batch_size=8)` answers 16 concurrent 512^2 requests, the
     coastline band of every mask is taken and one synthetic shoreline is
     traced to contours; the launch counters must show both kernels ran,
     and the masks are compared with a float32 run of the same extractor;
     a second server then times 64 requests once its thread is warm, and
     torch.profiler breaks the bf16 batch-8 forward down by kernel;
  5. one 64-channel ResidualBlock at (8, 512, 512, 64) bf16: the fused
     CBAM tail against its module composition (ChannelAttention, which
     launches `fused_avg_max_pool`, SpatialAttention, residual ReLU);
  6. the Robust U-Net eval path at full width: the 40,872,223-parameter
     model from `create_model` (random weights from a numpy seed, through
     the weight bridge), its logits against the port's CPU path at 64^2,
     then `make_eval_epoch` over 16 synthetic 512^2 tiles at batch 8 in
     bf16 and in f32; the launch counters must show 9 pool, 9 stats and 9
     tail launches a forward and, in bf16, 2 fused convs; the two epochs'
     losses and mean metrics must agree within 5e-3 and their masks on 95%
     of pixels; the forward is timed at batch 8 and profiled by kernel;
  7. the SegNet eval path the same way: the 15,278,593-parameter model, its
     logits against the CPU path at 64^2 (a share of the logits, since a
     near-tie in a pool window may pick another position on the card), then
     `make_eval_epoch` in bf16 and f32 with 4 pool, 4 unpool and, in bf16,
     2 fused-conv launches a forward; losses and mean metrics within 5e-3,
     masks on 85% of pixels (`segnet_path` says why);
  8. the production training path at full width: the 2-class UNet (random
     weights from a numpy seed, through the weight bridge) trained by
     `WaterSegmentationTrainer` for 3 epochs over 32 synthetic 512^2 tiles
     at batch 8 in bf16 with augmentation, validating on 8 tiles after each
     epoch and saving a resume point each epoch; the train loss must fall,
     the fused conv must launch twice a validation forward and never in a
     train step, the best export must load strictly into a UNet and an
     extractor, and the restored state must equal the saved one bit for
     bit. Then two f32 Adam steps at (2, 64, 64) a batch on the card against
     the CPU path (BN biases shifted off the ReLU's kink, `shift_bn`), a 2 + 1
     epoch resume against 3 straight epochs under
     `torch.use_deterministic_algorithms(True)`, step times in bf16 and f32,
     epoch rates, peak memory and a profile of one bf16 train step;
  9. a `kernels` JSON line, the card line and the last line:
     {"ok": true, "device": {...}}.

Float32 convolutions run with cuDNN's TF32 off, so every float32 number
here is a true float32 result. Any failure raises and exits non-zero.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from coastline_torch.infer.contours import extract_contours
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.infer.morphology import coastline_band, elliptical_kernel
from coastline_torch.kernels import _build, cbam, unpool
from coastline_torch.kernels.fused_conv import (fused_conv3x3_bn_relu,
                                                fused_conv3x3_bn_relu_plain)
from coastline_torch.kernels.morphology import dilate_disk, dilate_disk_plain, se_row_groups
from coastline_torch.kernels.pools import fused_avg_max_pool
from coastline_torch.models import segnet as segnet_module
from coastline_torch.models.registry import create_model
from coastline_torch.ops.blocks import ResidualBlock
from coastline_torch.ops.primitives import Conv, ConvTranspose
from coastline_torch.data.augment import make_augment_fn
from coastline_torch.data.pipeline import DeviceDataset
from coastline_torch.models.unet import UNet
from coastline_torch.train import trainer as trainer_module
from coastline_torch.train.checkpoint import CheckpointManager
from coastline_torch.train.loop import (TrainConfig, batch_indices, create_train_state,
                                        make_eval_epoch, make_train_epoch, normalize_images)
from coastline_torch.train.trainer import TrainerConfig, WaterSegmentationTrainer
from coastline_torch.utils.torch_import import (random_robust_unet_variables,
                                                random_segnet_variables, random_unet_variables,
                                                robust_unet_state_dict, segnet_state_dict,
                                                unet_state_dict)

# Published H100 SXM peaks (NVIDIA data sheet, dense): the roofs for bound_ms.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_OPS = 67e12  # non-tensor float32 rate; integer/float max runs on the same units
UNET_PARAMS = 31_043_586
ROBUST_UNET_PARAMS = 40_872_223
SEGNET_PARAMS = 15_278_593
CONV_SHAPE = (8, 512, 512, 64)
# widths off the 64-pixel tile, one row, one column, one pixel, batch 1, a straddling tile
RAGGED_CONV_SHAPES = [(1, 9, 65, 64), (2, 5, 127, 64), (1, 6, 130, 64), (2, 1, 70, 64),
                      (2, 33, 1, 64), (1, 1, 1, 64), (1, 512, 512, 64), (2, 67, 200, 64)]
# the Robust U-Net's ResidualBlock outputs at batch 8, 512^2: the CBAM kernels' shapes
LEVEL_SHAPES = [(8, 512, 512, 64), (8, 256, 256, 128), (8, 128, 128, 256),
                (8, 64, 64, 512), (8, 32, 32, 1024)]
CBAM_SHAPES = LEVEL_SHAPES + [(2, 4, 4, 1024), (3, 37, 53, 48)]
DILATE_CASES = [((8, 512, 512), 20), ((8, 512, 512), 5), ((8, 512, 512), 41),
                ((1, 2048, 2048), 20), ((1, 64, 10980), 20)]  # first = serving shape
# SegNet at batch 8, 512^2: the pools' inputs (enc1..enc4 outputs) and the unpools'
# value inputs (dec4..dec1), then one odd shape (C = 20: bf16 takes the scalar path)
POOL_SHAPES = [(8, 512, 512, 64), (8, 256, 256, 128), (8, 128, 128, 256), (8, 64, 64, 512),
               (3, 38, 54, 20)]
UNPOOL_SHAPES = [(8, 32, 32, 512), (8, 64, 64, 256), (8, 128, 128, 128), (8, 256, 256, 64),
                 (3, 19, 27, 20)]


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of `fn` over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds of `fn` on the device alone: CUDA events around
    `iters` back-to-back calls queued behind a kernel that keeps the card
    busy until all of them are enqueued, so the wrapper's host path, which
    back-to-back `cuda_ms` reads once a kernel is shorter than it, is hidden.
    The sleep doubles until the queue was still full when the last call was
    enqueued."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 22
    for _ in range(8):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise AssertionError("could not queue the calls ahead of the card")


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_fused_conv(dev, rng):
    b, h, w, c = CONV_SHAPE
    x = torch.from_numpy(rng.standard_normal(CONV_SHAPE, np.float32)).to(dev, torch.bfloat16)
    wt = torch.from_numpy(rng.uniform(-1, 1, (3, 3, c, c)).astype(np.float32)
                          * np.float32(np.sqrt(6.0 / (9 * c)))).to(dev)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)).to(dev)
    errs, ok = {}, True
    for shape in [CONV_SHAPE] + RAGGED_CONV_SHAPES:
        xs = x if shape == CONV_SHAPE else x[:shape[0], :shape[1], :shape[2]].contiguous()
        for relu in (True, False):  # the UNet's and SegNet's layers, the Robust U-Net's conv 2
            got = fused_conv3x3_bn_relu(xs, wt, scale, bias, relu=relu).float()
            torch.cuda.synchronize()
            ref = fused_conv3x3_bn_relu_plain(xs, wt, scale, bias, relu=relu).float()
            err = (got - ref).abs()
            # same float32 sums in another order, one bf16 rounding: 1 bf16 ulp (2^-7 rel) + 1e-3
            ok = ok and bool(torch.all(err <= 2.0 ** -7 * ref.abs() + 1e-3))
            errs[f"{'x'.join(map(str, shape))}_relu_{relu}"] = float(err.max())
            del got, ref, err
    xl = x.permute(0, 3, 1, 2)  # channels_last view
    wl = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    s16, b16 = scale.to(torch.bfloat16)[:, None, None], bias.to(torch.bfloat16)[:, None, None]
    ms = cuda_ms(lambda: fused_conv3x3_bn_relu(x, wt, scale, bias), 20)
    dev_ms = device_ms(lambda: fused_conv3x3_bn_relu(x, wt, scale, bias))
    plain_ms = cuda_ms(lambda: fused_conv3x3_bn_relu_plain(x, wt, scale, bias), 3, 1)
    library_ms = cuda_ms(lambda: torch.relu(F.conv2d(xl, wl, padding=1) * s16 + b16), 20)
    flops = 2.0 * b * h * w * c * 9 * c
    nbytes = 2 * x.numel() * 2 + wt.numel() * 2 + 2 * c * 4
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    result = dict(max_abs_err=max(errs.values()), max_abs_err_by_case=errs, ms=ms,
                  device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                  bound_by=bound_by, share_of_bound=bound_ms / dev_ms, shape=list(CONV_SHAPE),
                  tflops=flops / dev_ms / 1e9,
                  library="channels_last F.conv2d bf16 (cuDNN) + bf16 scale/bias/ReLU")
    log("fused_conv3x3_bn_relu", json.dumps(result))
    if not ok:
        raise AssertionError(f"fused conv disagrees with its plain version: {result}")
    return result


def conv_threshold_dilate(m: torch.Tensor, ker: np.ndarray) -> torch.Tensor:
    """Library yardstick: binary dilation as an f32 convolution with the SE
    and a threshold (the JAX package's XLA formulation); binary masks only."""
    kh, kw = ker.shape
    xp = F.pad(m.float()[:, None], (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2))
    k = torch.from_numpy(ker.astype(np.float32)).to(m.device)[None, None]
    return (F.conv2d(xp, k)[:, 0] > 0).to(m.dtype)


def check_dilate(dev, rng):
    cases = []
    for shape, size in DILATE_CASES:
        ker = elliptical_kernel(size)
        m = torch.from_numpy((rng.random(shape) < 0.02).astype(np.uint8)).to(dev)
        gray = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        errs = []
        for t in (m, gray, gray.float()):
            got = dilate_disk(t, ker)
            torch.cuda.synchronize()
            errs.append(float((got.float() - dilate_disk_plain(t, ker).float()).abs().max()))
        lib_equal = bool(torch.equal(conv_threshold_dilate(m, ker), dilate_disk(m, ker)))
        iters = 50 if m.numel() <= 4 << 20 else 20
        ms = cuda_ms(lambda: dilate_disk(m, ker), iters)
        dev_ms = device_ms(lambda: dilate_disk(m, ker), iters)
        plain_ms = cuda_ms(lambda: dilate_disk_plain(m, ker), 5, 1)
        library_ms = cuda_ms(lambda: conv_threshold_dilate(m, ker), 3, 1)
        groups = se_row_groups(ker)
        # per pixel: the widest row group's window grown once, one max per SE row
        ops_px = max(hi - lo for (lo, hi), _ in groups) + sum(len(s) for _, s in groups)
        bound_ms, bound_by = bound(2 * m.numel(), ops_px * m.numel(), PEAK_F32_OPS)
        case = dict(shape=list(shape), size=size, max_abs_err=max(errs),
                    max_abs_err_binary_u8_gray_u8_gray_f32=errs,
                    conv_threshold_equal=lib_equal, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                    share_of_bound=bound_ms / dev_ms)
        log("dilate_disk", json.dumps(case))
        if max(errs) != 0.0 or not lib_equal:
            raise AssertionError(f"dilate_disk is not exact: {case}")
        cases.append(case)
    return cases


def _mean_ok(got, ref, absmean, dt):
    """A mean is a float32 sum taken in another order: 1e-5 relative in f32
    or one bf16 ulp (2^-7 relative), plus 1e-5 of the mean magnitude summed
    (cancellation)."""
    rel = 1e-5 if dt == torch.float32 else 2.0 ** -7
    return bool(torch.all((got.float() - ref.float()).abs()
                          <= rel * ref.float().abs() + 1e-5 * absmean))


def _tail_ok(got, ref, y, dt):
    """The attention map is a 98-tap f32 sum in another order before its
    roundings: 1e-5 (|y| + |ref|) + 1e-6 in f32, 2^-6 (|y| + |ref|) in bf16
    (one bf16 ulp of the gate and of each rounded product)."""
    d, scale = (got.float() - ref.float()).abs(), y.float().abs() + ref.float().abs()
    if dt == torch.float32:
        return bool(torch.all(d <= 1e-5 * scale + 1e-6))
    return bool(torch.all(d <= 2.0 ** -6 * scale))


def _cbam_inputs(shape, dt, dev, gen):
    b, h, w, c = shape
    x = torch.randn(shape, device=dev, generator=gen).to(dt)
    s = torch.randn(shape, device=dev, generator=gen).to(dt)
    gate = torch.sigmoid(torch.randn((b, c), device=dev, generator=gen)).to(dt)
    sconv = torch.randn((7, 7, 2, 1), device=dev, generator=gen) * 0.15
    return x, s, gate, sconv


def check_cbam(dev):
    """The three CBAM kernels against their plain versions at every listed
    shape in bf16 and f32; times at (8, 512, 512, 64) bf16."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases, errs = [], {"avg_max_pool": 0.0, "gated_spatial_stats": 0.0, "cbam_tail": 0.0}
    for dt in (torch.bfloat16, torch.float32):
        for shape in CBAM_SHAPES:
            x, s, gate, sconv = _cbam_inputs(shape, dt, dev, gen)
            avg, mx = cbam.avg_max_pool(x)
            fa, fm = fused_avg_max_pool(x)
            stats = cbam.gated_spatial_stats(x, gate)
            tail = cbam.cbam_tail_apply(x, s, gate, stats, sconv)
            torch.cuda.synchronize()
            r_avg, r_mx = cbam.avg_max_pool_plain(x)
            r_stats = cbam.gated_spatial_stats_plain(x, gate)
            r_tail = cbam.cbam_tail_apply_plain(x, s, gate, stats, sconv)
            z_abs = (x * gate[:, None, None, :]).float().abs().mean(-1)
            case = dict(
                shape=list(shape), dtype=str(dt).split(".")[-1],
                pool_max_exact=bool(torch.equal(mx, r_mx) and torch.equal(fm, r_mx)),
                pool_mean_ok=_mean_ok(avg, r_avg, x.float().abs().mean((1, 2)), dt)
                and bool(torch.equal(fa, avg)),
                stats_max_exact=bool(torch.equal(stats[:, 1], r_stats[:, 1])),
                stats_mean_ok=_mean_ok(stats[:, 0], r_stats[:, 0], z_abs, dt),
                tail_ok=_tail_ok(tail, r_tail, x, dt),
                pool_err=float((avg.float() - r_avg.float()).abs().max()),
                stats_err=float((stats.float() - r_stats.float()).abs().max()),
                tail_err=float((tail.float() - r_tail.float()).abs().max()))
            errs["avg_max_pool"] = max(errs["avg_max_pool"], case["pool_err"])
            errs["gated_spatial_stats"] = max(errs["gated_spatial_stats"], case["stats_err"])
            errs["cbam_tail"] = max(errs["cbam_tail"], case["tail_err"])
            cases.append(case)
            log("cbam_check", json.dumps(case))
            if not all(v for k, v in case.items() if k.endswith(("_exact", "_ok"))):
                raise AssertionError(f"a CBAM kernel disagrees with its plain version: {case}")
            del x, s, gate, stats, tail, r_stats, r_tail

    b, h, w, c = shape = LEVEL_SHAPES[0]
    x, s, gate, sconv = _cbam_inputs(shape, torch.bfloat16, dev, gen)
    stats = cbam.gated_spatial_stats(x, gate)
    xl = x.permute(0, 3, 1, 2)  # the channels_last NCHW view
    w16 = sconv.to(torch.bfloat16).permute(3, 2, 0, 1)
    n, px = x.numel(), b * h * w
    timings = {
        "avg_max_pool": (lambda: cbam.avg_max_pool(x), lambda: cbam.avg_max_pool_plain(x),
                         lambda: (xl.mean((2, 3)), xl.amax((2, 3))),
                         "channels_last x.mean((2,3)) + x.amax((2,3))",
                         2 * n + 2 * b * c * 2, 2 * n),
        "gated_spatial_stats": (
            lambda: cbam.gated_spatial_stats(x, gate),
            lambda: cbam.gated_spatial_stats_plain(x, gate),
            lambda: (lambda z: (z.mean(-1), z.amax(-1)))(x * gate[:, None, None, :]),
            "z = x * gate, then z.mean(-1) and z.amax(-1)",
            2 * n + 2 * b * c + 2 * 2 * px, 3 * n),
        "cbam_tail": (
            lambda: cbam.cbam_tail_apply(x, s, gate, stats, sconv),
            lambda: cbam.cbam_tail_apply_plain(x, s, gate, stats, sconv),
            lambda: torch.relu(x * gate[:, None, None, :] * torch.sigmoid(
                F.conv2d(stats, w16, padding=3)).permute(0, 2, 3, 1) + s),
            "F.conv2d(stats, w, padding=3) bf16 + sigmoid + the eager chain",
            3 * 2 * n + 2 * b * c + 2 * 2 * px + 98 * 4, 4 * n + 2 * 98 * px),
    }
    out = {}
    for name, (kern, plain, lib, lib_name, nbytes, ops) in timings.items():
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 5, 1)
        library_ms = cuda_ms(lib, 20)
        bound_ms, bound_by = bound(nbytes, ops, PEAK_F32_OPS)
        out[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                         gb_per_s=nbytes / ms / 1e6, shape=list(shape), dtype="bfloat16",
                         library=lib_name)
        log(name, json.dumps(out[name]))
    return out, cases


def _tie_input(shape, dt, dev, gen, nonfinite=False):
    """An activation with the ties a ReLU network makes: ReLU zeros (whole
    windows of them), channels 0::3 with equal non-zero values at window
    positions 0 and 3, channels 1::5 negated (-0.0 ties, negative maxima),
    channels 2::7 zeros of random sign. `nonfinite` adds NaN (two in one
    window: the first must win), +inf and -inf."""
    b, h, w, c = shape
    x = torch.relu(torch.randn(shape, device=dev, generator=gen)).to(dt)
    if h % 2 == 0 and w % 2 == 0:
        xw = x.view(b, h // 2, 2, w // 2, 2, c)
        xw[:, :, 1, :, 1, ::3] = xw[:, :, 0, :, 0, ::3]
    x[..., 1::5] = -x[..., 1::5]
    signs = torch.rand(shape, device=dev, generator=gen) < 0.5
    x[..., 2::7] = torch.where(signs, 0.0, -0.0).to(dt)[..., 2::7]
    if nonfinite:
        x[0, 0, 1, 0] = x[0, 1, 1, 0] = x[-1, 2, 2, 1] = float("nan")
        x[0, 2, 3, 0], x[1, 0, 0, -1] = float("inf"), float("-inf")
    return x


def _bits_equal(a, b) -> bool:
    """Equal bit for bit (the sign of a zero included), any NaN equal to any NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    return bool(torch.equal(a.view(ints)[~nan], b.view(ints)[~nan]))


def _finite_err(a, b) -> float:
    """Largest |a - b| over the elements finite in both."""
    a, b = a.float(), b.float()
    finite = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b)[finite].abs().max()) if bool(finite.any()) else 0.0


def check_unpool(dev):
    """SegNet's indexed pool and unpool against their plain versions at the
    four levels and an odd shape, in bf16 and f32, on inputs full of ties:
    codes, values and the unpooled output bit for bit. Times at the top
    level, bf16."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cases, errs = [], {"max_pool_with_indices": 0.0, "max_unpool": 0.0}
    for dt in (torch.bfloat16, torch.float32):
        for shape, vshape in zip(POOL_SHAPES, UNPOOL_SHAPES):
            odd = shape[0] == 3
            x = _tie_input(shape, dt, dev, gen, nonfinite=odd)
            vals, codes = unpool.max_pool_with_indices(x)
            torch.cuda.synchronize()
            r_vals, r_codes = unpool.max_pool_with_indices_plain(x)
            v = _tie_input(vshape, dt, dev, gen, nonfinite=odd)
            k = torch.randint(0, 4, vshape, device=dev, generator=gen, dtype=torch.int32)
            out = unpool.max_unpool(v, k)
            torch.cuda.synchronize()
            r_out = unpool.max_unpool_plain(v, k)
            case = dict(pool_shape=list(shape), unpool_shape=list(vshape),
                        dtype=str(dt).split(".")[-1],
                        codes_exact=_bits_equal(codes, r_codes),
                        values_exact=_bits_equal(vals, r_vals),
                        unpool_exact=_bits_equal(out, r_out),
                        roundtrip_exact=_bits_equal(unpool.max_unpool(vals, codes),
                                                    unpool.max_unpool_plain(r_vals, r_codes)),
                        zero_max_share=float((r_vals == 0).float().mean()),
                        pool_err=max(_finite_err(vals, r_vals), _finite_err(codes, r_codes)),
                        unpool_err=_finite_err(out, r_out))
            errs["max_pool_with_indices"] = max(errs["max_pool_with_indices"], case["pool_err"])
            errs["max_unpool"] = max(errs["max_unpool"], case["unpool_err"])
            cases.append(case)
            log("unpool_check", json.dumps(case))
            if not all(v for k, v in case.items() if k.endswith("_exact")):
                raise AssertionError(f"a SegNet pool kernel disagrees with its plain version: {case}")
            del x, vals, codes, r_vals, r_codes, v, k, out, r_out

    x = _tie_input(POOL_SHAPES[0], torch.bfloat16, dev, gen)
    vals, codes = unpool.max_pool_with_indices(x)
    xl = x.permute(0, 3, 1, 2)  # the channels_last NCHW view
    lib_vals, lib_idx = F.max_pool2d(xl, 2, return_indices=True)
    n_in, n_out = x.numel(), vals.numel()
    timings = {
        "max_pool_with_indices": (
            lambda: unpool.max_pool_with_indices(x), lambda: unpool.max_pool_with_indices_plain(x),
            lambda: F.max_pool2d(xl, 2, return_indices=True),
            "F.max_pool2d(return_indices=True), int64 flat indices, bf16 channels_last",
            2 * n_in + 2 * n_out + 4 * n_out, 3 * n_out, list(x.shape)),
        "max_unpool": (
            lambda: unpool.max_unpool(vals, codes), lambda: unpool.max_unpool_plain(vals, codes),
            lambda: F.max_unpool2d(lib_vals, lib_idx, 2),
            "F.max_unpool2d, int64 flat indices, bf16 channels_last",
            2 * n_out + 4 * n_out + 2 * n_in, 4 * n_out, list(vals.shape)),
    }
    out = {}
    for name, (kern, plain, lib, lib_name, nbytes, ops, shape) in timings.items():
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 5, 1)
        library_ms = cuda_ms(lib, 20)
        bound_ms, bound_by = bound(nbytes, ops, PEAK_F32_OPS)
        out[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, gb_per_s=nbytes / ms / 1e6,
                         shape=shape, dtype="bfloat16", library=lib_name)
        log(name, json.dumps(out[name]))
    return out, cases


def residual_block_check(dev, shape=(8, 512, 512, 64)):
    """One ResidualBlock(64) at (8, 512, 512, 64) bf16: the fused tail
    against the module composition, whose ChannelAttention launches
    `fused_avg_max_pool`."""
    b, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(1)
    block = ResidualBlock(c, c, generator=torch.Generator().manual_seed(1)).to(dev).eval()
    x = torch.randn((b, c, h, w), device=dev, generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        y, shortcut = block.body(x)
        before = fused_avg_max_pool.launches
        ref = block.module_tail(y, shortcut).float()
        fused_launches = fused_avg_max_pool.launches - before
        got = block.fused_tail(y, shortcut).float()
        torch.cuda.synchronize()
        d = (got - ref).abs()
        # one bf16 ulp for each of the gates and the three rounded ops (tests/test_torch_cbam.py)
        ok = bool(torch.all(d <= 2.0 ** -5 * (y.float().abs() + ref.abs())))
        fused_ms = cuda_ms(lambda: block.fused_tail(y, shortcut), 10)
        module_ms = cuda_ms(lambda: block.module_tail(y, shortcut), 10)
    result = dict(shape=list(shape), max_abs_err=float(d.max()),
                  fused_avg_max_pool_launches=fused_launches, fused_tail_ms=fused_ms,
                  module_tail_ms=module_ms)
    log("residual_block_64", json.dumps(result))
    if not ok or fused_launches != 1:
        raise AssertionError(f"ResidualBlock fused tail disagrees with its modules: {result}")
    return result


def logits_check(variables, dev):
    """Small-input reference: CUDA logits vs the port's CPU path (plain
    versions) on the same weights and input."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32))
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cpu = CoastlineExtractor(variables=variables, dtype=dt, image_size=64, device="cpu")
        gpu = CoastlineExtractor(variables=variables, dtype=dt, image_size=64)
        with torch.inference_mode():
            ref = cpu.model(x)
            got = gpu.model(x.to(dev)).cpu()
        assert torch.isfinite(got).all()
        err = float((got - ref).abs().max())
        agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
        out[name] = dict(max_abs_err=err, logit_std=float(ref.std()), argmax_agree=agree)
    log("logits_vs_cpu", json.dumps(out))
    if out["f32"]["max_abs_err"] > 1e-3 * max(1.0, out["f32"]["logit_std"]):
        raise AssertionError(f"f32 CUDA logits disagree with the CPU path: {out}")
    if out["bf16"]["max_abs_err"] > 0.1 * out["bf16"]["logit_std"] or out["bf16"]["argmax_agree"] < 0.95:
        raise AssertionError(f"bf16 CUDA logits disagree with the CPU path: {out}")
    return out


def shoreline_mask(h=512, w=512):
    """A smooth synthetic coast: water below a gently winding line."""
    yy, xx = np.mgrid[0:h, 0:w]
    line = h / 2 + 40 * np.sin(xx / 60.0) + 15 * np.sin(xx / 17.0 + 1.0)
    return (yy > line).astype(np.uint8)


def serving_path(variables, dev, rng, size=512):
    images = rng.integers(0, 256, (16, size, size, 3), dtype=np.uint8)
    ex = CoastlineExtractor(variables=variables, dtype=torch.bfloat16, image_size=size)
    n_params = sum(p.numel() for p in ex.model.parameters())
    if n_params != UNET_PARAMS:
        raise AssertionError(f"UNet has {n_params} parameters, expected {UNET_PARAMS}")
    ex.predict_masks_batch(images[:8])  # warm-up (cuDNN plans), outside the counted run
    torch.cuda.synchronize()

    forwards = []
    predict = ex.predict_masks_batch
    ex.predict_masks_batch = lambda batch: forwards.append(len(batch)) or predict(batch)

    fused_conv3x3_bn_relu.launches = 0
    dilate_disk.launches = 0
    t0 = time.perf_counter()
    with ex.serve(batch_size=8) as srv:
        futs = [srv.submit(im) for im in images]
        masks = [f.result(timeout=600) for f in futs]
    t_serve = time.perf_counter() - t0
    stacked = torch.from_numpy(np.stack(masks)).to(dev)
    bands = [coastline_band(stacked[i:i + 8], 20) for i in range(0, 16, 8)]
    shore_band = coastline_band(shoreline_mask(size, size), 20)
    torch.cuda.synchronize()
    launches = {"fused_conv3x3_bn_relu": fused_conv3x3_bn_relu.launches,
                "dilate_disk": dilate_disk.launches}
    n_band_calls = len(bands) + 1
    del ex.predict_masks_batch  # stop counting forwards
    lines = extract_contours(shore_band)

    m = np.stack(masks)
    if m.shape != (16, size, size) or m.dtype != np.uint8 or not set(np.unique(m)) <= {0, 1}:
        raise AssertionError(f"bad masks: {m.shape} {m.dtype} {np.unique(m)}")
    for i, band in enumerate(bands):
        ref = coastline_band(stacked[8 * i:8 * i + 8].cpu(), 20, device="cpu")
        if not torch.equal(band.cpu(), ref):
            raise AssertionError("served coastline band differs from the CPU path")
    if not lines or max(len(p) for p in lines) < 3:
        raise AssertionError(f"no shoreline traced from the synthetic coast: {lines}")
    if len(forwards) < 2 or launches["fused_conv3x3_bn_relu"] != 2 * len(forwards):
        raise AssertionError(f"fused conv launched {launches} for {len(forwards)} forwards")
    if launches["dilate_disk"] != n_band_calls:
        raise AssertionError(f"dilate_disk launched {launches} for {n_band_calls} band calls")

    x8 = torch.from_numpy(images[:8]).to(dev)
    fwd_bf16_ms = cuda_ms(lambda: ex.predict_masks_batch_async(x8), 10)
    band_ms = cuda_ms(lambda: coastline_band(stacked[:8], 20), 20)
    # steady state: the server thread is warm, 64 requests = 8 full batches
    with ex.serve(batch_size=8) as srv:
        srv.predict_many(list(images[:8]))
        t0 = time.perf_counter()
        srv.predict_many(list(np.concatenate([images] * 4)))
        steady_s = time.perf_counter() - t0

    ex32 = CoastlineExtractor(variables=variables, dtype=torch.float32, image_size=size)
    m32 = np.concatenate([ex32.predict_masks_batch(images[:8]),
                          ex32.predict_masks_batch(images[8:])])
    fwd_f32_ms = cuda_ms(lambda: ex32.predict_masks_batch_async(x8), 5)
    agree = float(np.mean(m32 == m))
    result = dict(requests=len(masks), batches=forwards, launches=launches,
                  band_calls=n_band_calls, serve_s=t_serve, img_per_s=len(masks) / t_serve,
                  steady_img_per_s=64 / steady_s,
                  forward_b8_bf16_ms=fwd_bf16_ms, forward_b8_f32_ms=fwd_f32_ms,
                  band_b8_ms=band_ms, water_fraction=float(m.mean()),
                  bf16_vs_f32_mask_agreement=agree,
                  shoreline_polylines=len(lines),
                  shoreline_points=[len(p) for p in lines])
    log("serving_path", json.dumps(result))
    result["profile"] = profile_forward(lambda: ex.predict_masks_batch_async(x8),
                                        "profile_unet_forward_b8_bf16")
    if agree < 0.95:
        raise AssertionError(f"bf16 masks agree with f32 on only {agree:.4f} of pixels")
    return result


_KERNEL_CLASSES = (  # (class, substrings of the CUDA kernel name), first match wins
    ("fused_conv3x3_bn_relu (ours)", ("fused_conv_kernel",)),
    ("dilate_disk (ours)", ("dilate_kernel",)),
    ("avg_max_pool (ours)", ("cbam_avg_max",)),
    ("gated_spatial_stats (ours)", ("cbam_gated_stats",)),
    ("cbam_tail (ours)", ("cbam_tail_kernel",)),
    ("max_pool_with_indices (ours)", ("max_pool_idx_kernel",)),
    ("max_unpool (ours)", ("max_unpool_kernel",)),
    ("elementwise: bias, BN affine, ReLU, casts", ("elementwise",)),
    ("concat", ("CatArray",)),
    ("max pool", ("max_pool",)),
    ("argmax / softmax", ("reduce", "softmax", "argmax")),
    ("cuDNN conv and transposed conv", ("conv", "xmma", "gemm", "cudnn", "sm90", "cutlass",
                                        "nhwc", "nchw", "dgrad", "fprop", "implicit")),
    ("cuBLAS GEMM (nvjet)", ("nvjet",)),
)


def profile_forward(forward, label: str, steps: int = 3, classes=_KERNEL_CLASSES):
    """Device time by kernel class (`classes`) over `steps` calls of
    `forward` (a batch-8 forward or train step; torch.profiler), and the
    device's idle share of that window."""
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    by_class, other = {}, []
    for e in kernels:
        cls = next((c for c, keys in classes if any(k in e.key for k in keys)), "other")
        ms, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + e.self_device_time_total / 1e3 / steps, n + e.count / steps)
        if cls == "other":
            other.append(e)
    busy_ms = sum(ms for ms, _ in by_class.values())

    def rows(events, n):
        return [dict(kernel=e.key[:100], ms_per_forward=e.self_device_time_total / 1e3 / steps,
                     launches_per_forward=e.count / steps) for e in events[:n]]

    result = dict(steps=steps, wall_ms_per_forward=wall_ms / steps,
                  device_ms_per_forward=busy_ms, idle_share=1 - busy_ms * steps / wall_ms,
                  classes={c: dict(ms_per_forward=ms, launches_per_forward=n)
                           for c, (ms, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0])},
                  top=rows(kernels, 10), top_other=rows(other, 6))
    log(label, json.dumps(result))
    return result


def logits_vs_cpu(model_name, sd, dev, limits):
    """Small-input reference: logits on the card vs the port's CPU path
    (plain versions) on the same weights and input. For each dtype the share
    of logits within the tolerance (1e-3 x max(1, std) in f32, 0.1 x std in
    bf16) and the share of agreeing masks must reach `limits[dtype]`."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32))
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cpu, gpu = create_model(model_name, dtype=dt), create_model(model_name, dtype=dt)
        cpu.load_state_dict(sd, strict=True)
        gpu.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            ref = cpu.eval()(x, return_logits=True)
            got = gpu.to(dev).eval()(x.to(dev), return_logits=True).cpu()
        assert torch.isfinite(got).all()
        std, err = float(ref.std()), (got - ref).abs()
        tol = 1e-3 * max(1.0, std) if dt == torch.float32 else 0.1 * std
        out[name] = dict(max_abs_err=float(err.max()), logit_std=std, tolerance=tol,
                         within=float((err <= tol).float().mean()),
                         mask_agree=float(((got > 0) == (ref > 0)).float().mean()))
    log(f"{model_name.lower().replace(' ', '_')}_logits_vs_cpu", json.dumps(out))
    for name, (min_within, min_agree) in limits.items():
        if out[name]["within"] < min_within or out[name]["mask_agree"] < min_agree:
            raise AssertionError(f"{name} {model_name} logits disagree with the CPU path: {out}")
    return out


def conv_flops(model, x) -> float:
    """Multiply-adds x 2 of every convolution and transposed convolution in
    one forward of `model` on `x`, counted from the layer shapes."""
    total = []

    def hook(mod, args, out):
        k = mod.weight.shape[-1] * mod.weight.shape[-2]
        cin = args[0].shape[1]
        total.append(2.0 * out.numel() * cin * k / (4 if isinstance(mod, ConvTranspose) else 1))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, ConvTranspose))]
    with torch.inference_mode():
        model(x, return_logits=True)
    for h in hooks:
        h.remove()
    return sum(total)


def eval_path(model_name, sd, dev, n_params, counters, want, limits, min_mask_agree,
              max_gap=5e-3, size=512, n_images=16, batch=8):
    """An eval path at full width: `create_model` + the weight bridge's
    state_dict `sd`, its logits against the CPU path (`limits`), then
    `make_eval_epoch` over synthetic tiles in bf16 and f32. `want(dtype)`
    gives each counter's launches a forward; the bf16 and f32 epochs' masks
    must agree on `min_mask_agree` of the pixels, and their losses and mean
    metrics within `max_gap`."""
    logits = logits_vs_cpu(model_name, sd, dev, limits)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (n_images, size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    masks = np.stack([yy > size / 2 + 40 * np.sin(xx / 60.0 + i) + 15 * np.sin(xx / 17.0)
                      for i in range(n_images)]).astype(np.int32)
    idx, valid = batch_indices(n_images, batch, shuffle=False, rng=rng)
    x8 = torch.from_numpy(images[:batch]).to(dev)
    label = model_name.lower().replace(" ", "_")
    result, probs = dict(logits_vs_cpu=logits, epochs={}), {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = create_model(model_name, dtype=dt)
        model.load_state_dict(sd, strict=True)
        count = sum(p.numel() for p in model.parameters())
        if count != n_params:
            raise AssertionError(f"{model_name} has {count} parameters, expected {n_params}")
        eval_epoch = make_eval_epoch(model, TrainConfig(), device=dev)
        eval_epoch(images[:batch], masks[:batch], idx[:1], valid[:1])  # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        loss, agg = eval_epoch(images, masks, idx, valid)
        epoch_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        forwards, per_forward = len(idx), want(dt)
        if any(launches[k] != n * forwards for k, n in per_forward.items()):
            raise AssertionError(f"{name}: launches {launches} for {forwards} forwards, "
                                 f"want {per_forward} a forward")
        if not (np.isfinite(loss) and all(np.isfinite(v) for v in agg.values())):
            raise AssertionError(f"{name}: non-finite eval results {loss} {agg}")
        x = normalize_images(x8).permute(0, 3, 1, 2)
        with torch.inference_mode():
            probs[name] = model(x).cpu()
            fwd_ms = cuda_ms(lambda: model(x, return_logits=True), 5 if dt == torch.float32 else 10)
        result["epochs"][name] = dict(loss=loss, metrics=agg, launches=launches, forwards=forwards,
                                      epoch_s=epoch_s, images_per_s=n_images / epoch_s,
                                      forward_b8_ms=fwd_ms)
        log(f"{label}_eval_epoch_{name}", json.dumps(result["epochs"][name]))
        if dt == torch.bfloat16:
            with torch.inference_mode():
                result["profile"] = profile_forward(lambda: model(x, return_logits=True),
                                                    f"profile_{label}_forward_b8_bf16")
            flops = conv_flops(model, x)
            result["conv_gflop_b8"] = flops / 1e9
            result["conv_bound_ms_b8"] = flops / PEAK_BF16_FLOPS * 1e3
        del model, eval_epoch
        torch.cuda.empty_cache()
    agree = float(((probs["bf16"] > 0.5) == (probs["f32"] > 0.5)).float().mean())
    result["bf16_vs_f32_mask_agreement"] = agree
    result["water_fraction_f32"] = float((probs["f32"] > 0.5).float().mean())
    e16, e32 = result["epochs"]["bf16"], result["epochs"]["f32"]
    gaps = {"loss": abs(e16["loss"] - e32["loss"])}
    gaps.update((k, abs(e16["metrics"][k] - e32["metrics"][k]))
                for k in e32["metrics"] if k.startswith("mean_"))
    result["bf16_vs_f32_gaps"] = gaps
    log(f"{label}_path", json.dumps({k: v for k, v in result.items()
                                     if k not in ("profile", "epochs", "logits_vs_cpu")}))
    if agree < min_mask_agree:
        raise AssertionError(f"bf16 masks agree with f32 on only {agree:.4f} of pixels")
    if max(gaps.values()) > max_gap:
        raise AssertionError(f"bf16 and f32 epochs disagree: {gaps}")
    return result


ROBUST_COUNTERS = {"avg_max_pool": cbam.avg_max_pool, "gated_spatial_stats": cbam.gated_spatial_stats,
                   "cbam_tail": cbam.cbam_tail_apply, "fused_conv3x3_bn_relu": fused_conv3x3_bn_relu,
                   "fused_avg_max_pool": fused_avg_max_pool}
SEGNET_COUNTERS = {"max_pool_with_indices": unpool.max_pool_with_indices,
                   "max_unpool": unpool.max_unpool, "fused_conv3x3_bn_relu": fused_conv3x3_bn_relu}


def robust_unet_path(dev, **kw):
    """The Robust U-Net eval path: 9 pool, stats and tail launches a forward
    and, in bf16, 2 fused convs. Same weights and tiles: the recorded runs
    (PERF.md) moved the loss by 1.5e-3 and each mean metric by at most
    1.1e-3 between the dtypes; the 5e-3 limit leaves room for another cuDNN
    algorithm and catches a shift that flips few masks."""
    return eval_path(
        "Robust UNet", robust_unet_state_dict(random_robust_unet_variables(seed=0)), dev,
        ROBUST_UNET_PARAMS, ROBUST_COUNTERS,
        lambda dt: {"avg_max_pool": 9, "gated_spatial_stats": 9, "cbam_tail": 9,
                    "fused_conv3x3_bn_relu": 2 if dt == torch.bfloat16 else 0,
                    "fused_avg_max_pool": 0},
        limits={"f32": (1.0, 0.0), "bf16": (1.0, 0.95)}, min_mask_agree=0.95, **kw)


def segnet_code_flips(sd, dev):
    """Pool windows whose code differs between the card and the CPU path, by
    level, on `logits_vs_cpu`'s input and weights, in f32 and bf16."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32))
    pool, out = segnet_module.max_pool_with_indices, {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        codes = []

        def spy(t):
            vals, c = pool(t)
            codes.append(c.cpu())
            return vals, c

        segnet_module.max_pool_with_indices = spy
        try:
            for d in ("cpu", dev):
                model = create_model("SegNet", dtype=dt)
                model.load_state_dict(sd, strict=True)
                with torch.inference_mode():
                    model.to(d).eval()(x.to(d))
        finally:
            segnet_module.max_pool_with_indices = pool
        out[name] = [int((a != b).sum()) for a, b in zip(codes[:4], codes[4:])]
    out["windows"] = [c.numel() for c in codes[:4]]
    log("segnet_code_flips_vs_cpu", json.dumps(out))
    return out


def segnet_path(dev, **kw):
    """The SegNet eval path: 4 pool and 4 unpool launches a forward and, in
    bf16, 2 fused convs (`enc1` conv 2, `dec1` conv 0).

    The model-level limits allow for near-ties: a pool window whose top two
    inputs differ by less than the card's and the CPU's rounding differences
    may pick another position, which moves an O(1) value to a neighbouring
    pixel and on through the decoder (the kernels themselves are held bit
    for bit in `check_unpool`). In f32 no window flipped at 2x64^2 (PERF.md,
    PR 3): 99.9% of the logits within the tolerance and 99.5% of the masks.
    In bf16, where rounding makes ties and near-ties common, 211 of the
    245,760 windows flipped (0, 3, 85 and 123 by level), 53% of the logits
    stayed within 0.1 std and 95.1% of the masks agreed; the bf16 and f32
    epochs' masks agreed on 89.7% of pixels, their loss and mean metrics
    within 2.0e-3."""
    sd = segnet_state_dict(random_segnet_variables(seed=0))
    result = eval_path(
        "SegNet", sd, dev, SEGNET_PARAMS, SEGNET_COUNTERS,
        lambda dt: {"max_pool_with_indices": 4, "max_unpool": 4,
                    "fused_conv3x3_bn_relu": 2 if dt == torch.bfloat16 else 0},
        limits={"f32": (0.999, 0.995), "bf16": (0.4, 0.9)}, min_mask_agree=0.85, **kw)
    result["code_flips_vs_cpu"] = segnet_code_flips(sd, dev)
    return result


TRAIN_SIZE, TRAIN_BATCH, TRAIN_TILES, VAL_TILES, TRAIN_EPOCHS = 512, 8, 32, 8, 3
_TRAIN_CLASSES = (  # kernel classes of a train step, first match wins
    ("fused_conv3x3_bn_relu (ours)", ("fused_conv_kernel",)),
    ("Adam (foreach)", ("multi_tensor_apply",)),
    ("cuDNN conv backward (dgrad, wgrad)", ("dgrad", "wgrad", "bprop", "backward")),
    ("cuDNN conv and transposed conv forward", ("conv", "xmma", "gemm", "cudnn", "sm90", "cutlass",
                                                "nhwc", "nchw", "fprop", "implicit")),
    ("BN statistics and loss reductions", ("reduce",)),
    ("max pool forward and backward", ("max_pool",)),
    ("concat", ("CatArray",)),
    ("augmentation gathers", ("index",)),
    ("elementwise: casts, BN affine, ReLU and their gradients", ("elementwise", "vectorized")),
    ("cuBLAS GEMM (nvjet)", ("nvjet",)),
)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def coast_tiles(n, size, seed):
    """`n` (image, mask) tiles and the route that made them: the port's
    `synthetic_dataset_arrays` (PIL's polygon fill) where Pillow imports,
    else numpy alone, with `eval_path`'s winding shoreline as the mask and
    dark noisy water under it, brighter land above."""
    try:
        from coastline_torch.data.synthetic import synthetic_dataset_arrays

        images, masks = synthetic_dataset_arrays(n, size, seed)
        return images, masks, "synthetic_dataset_arrays (Pillow rasterizer)"
    except ImportError:
        pass
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    masks = np.stack([yy > size / 2 + 40 * np.sin(xx / 60.0 + rng.uniform(0, 2 * np.pi))
                      + 15 * np.sin(xx / 17.0) for _ in range(n)]).astype(np.uint8)
    water = rng.normal((35.0, 55.0, 95.0), 8.0, (n, size, size, 3))
    land = rng.normal((120.0, 110.0, 90.0), 12.0, (n, size, size, 3))
    images = np.where(masks[..., None] > 0, water, land).clip(0, 255).astype(np.uint8)
    return images, masks, "numpy (no Pillow on this machine)"


def states_equal(a, b) -> dict:
    """Which parts of two TrainStates are equal bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return dict(
        params_and_bn_stats=sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
        adam=oa["param_groups"] == ob["param_groups"] and oa["state"].keys() == ob["state"].keys()
        and all(torch.equal(oa["state"][i][m], ob["state"][i][m])
                for i in oa["state"] for m in ("step", "exp_avg", "exp_avg_sq")),
        plateau=a.plateau == b.plateau, step=a.step == b.step,
        generator=torch.equal(a.generator.get_state(), b.generator.get_state()))


def make_trainer(save_dir, epochs, dev, sd, dtype="bfloat16", size=TRAIN_SIZE, batch=TRAIN_BATCH):
    cfg = TrainerConfig(epochs=epochs, batch_size=batch, lr=1e-3, image_size=size,
                        save_dir=save_dir, viz_every=0, augment=True, dtype=dtype,
                        checkpoint_every=1)
    trainer = WaterSegmentationTrainer(cfg, device=dev)
    trainer.model.load_state_dict(sd, strict=True)
    return trainer


def counted_train(trainer, train_ds, val_ds, dev, **kw):
    """`trainer.train` with each train epoch and validation timed on the
    host clock (ending in a synchronize) and the fused conv's launches
    inside each counted."""
    rec = {"train": [], "validate": []}

    def timed(kind, fn, idx_arg):
        def wrapped(*args, **kwargs):
            sync(dev)
            before, t0 = fused_conv3x3_bn_relu.launches, time.perf_counter()
            out = fn(*args, **kwargs)
            sync(dev)
            rec[kind].append(dict(s=time.perf_counter() - t0, batches=len(args[idx_arg]),
                                  fused_conv_launches=fused_conv3x3_bn_relu.launches - before))
            return out
        return wrapped

    make_epoch, make_validate = trainer_module.make_train_epoch, trainer._make_validate
    trainer_module.make_train_epoch = lambda *a, **k: timed("train", make_epoch(*a, **k), 3)
    trainer._make_validate = lambda: timed("validate", make_validate(), 2)
    try:
        hist = trainer.train(train_ds, val_ds, **kw)
    finally:
        trainer_module.make_train_epoch = make_epoch
        del trainer._make_validate
    return hist, rec


def shift_bn(sd, beta=6.0):
    """`sd` with every BN bias set to `beta`: each BN output is then about
    N(beta, gamma^2), so no value lies near the ReLU's kink, where two
    float32 paths that round differently can take opposite sides."""
    return {k: torch.full_like(v, beta) if k.endswith(".bias") and
            k[:-len("bias")] + "running_mean" in sd else v for k, v in sd.items()}


def train_card_vs_cpu(dev, sd, size=64):
    """One `make_train_epoch` of 2 Adam steps at (2, size, size) a batch,
    f32, wd 0.1, lr 1e-4, no augmentation, on the card and on the CPU path
    from the same weights and batches (cuDNN TF32 off). The JAX package's
    bounds for f32 conv-gradient noise through Adam
    (`tests/test_train_parity.py:89-108,186-189`): the loss to 1e-5
    relative, every parameter to atol 5e-5 / rtol 1e-4, every BN statistic
    to atol 2e-5 / rtol 2e-4.

    The weights are `sd` with its BN biases at 6 (`shift_bn`). Adam's first
    steps are about lr * sign(g), so a weight whose gradient the two paths
    round to opposite signs moves 2 * lr apart, and a pre-ReLU value within
    rounding of 0 that takes the ReLU's other side moves its channel's
    gradients enough to flip many such signs. Measured on an H100 with BN
    biases as drawn: 2,408 of the 31M values outside the bounds (up to
    2.2e-4) from the main path's weights here, 32 from the torch-default
    init at (2, 32, 32); shifted, that one put 1 outside (a rounding-level
    sign flip) and this check none, so the card also runs in deterministic
    mode, one sum order from run to run."""
    sd = shift_bn(sd)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    masks = (rng.random((4, size, size)) > 0.5).astype(np.uint8)
    idx, valid = np.array([[0, 1], [2, 3]], np.int32), np.ones((2, 2), np.float32)
    cfg = TrainConfig(lr=1e-4, weight_decay=0.1, loss="ce", batch_size=2)
    runs = {}
    for d in (torch.device("cpu"), dev):
        model = UNet()
        model.load_state_dict(sd, strict=True)
        state = create_train_state(model, cfg, device=d)
        with deterministic() if d.type == "cuda" else contextlib.nullcontext():
            state, loss = make_train_epoch(model, cfg, device=d)(state, images, masks, idx, valid)
        runs[d.type] = (loss, {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (l_cpu, ref), (l_dev, got) = runs["cpu"], runs[dev.type]
    out = dict(shape=[2, size, size, 3], steps=2, loss_cpu=l_cpu, loss_card=l_dev,
               loss_rel_err=abs(l_dev - l_cpu) / abs(l_cpu), tensors_out_of_bound={},
               elements_out_of_bound=0, max_abs_err_params=0.0, max_abs_err_bn_stats=0.0)
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        stat = ".running_" in k
        atol, rtol = (2e-5, 2e-4) if stat else (5e-5, 1e-4)
        err = (got[k] - r).abs()
        key = "max_abs_err_bn_stats" if stat else "max_abs_err_params"
        out[key] = max(out[key], float(err.max()))
        bad = int((err > atol + rtol * r.abs()).sum())
        if bad:
            out["tensors_out_of_bound"][k] = bad
            out["elements_out_of_bound"] += bad
    out["ok"] = out["loss_rel_err"] <= 1e-5 and out["elements_out_of_bound"] == 0
    log("unet_train_card_vs_cpu_f32", json.dumps(out))
    return out


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms(True)` inside the block (cuDNN's
    deterministic algorithms: one sum order from run to run)."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def resume_check(dev, sd, train_ds, val_ds, size=TRAIN_SIZE, batch=TRAIN_BATCH):
    """A 2-epoch run resumed for a third epoch against 3 straight epochs,
    under `torch.use_deterministic_algorithms(True)`: every parameter, BN
    statistic, Adam moment, the plateau, the generator and the histories
    must be equal bit for bit."""
    with deterministic():
        with tempfile.TemporaryDirectory() as tmp:
            straight = make_trainer(os.path.join(tmp, "a"), 3, dev, sd, size=size, batch=batch)
            hist_a = straight.train(train_ds, val_ds, verbose=False)
            make_trainer(os.path.join(tmp, "b"), 2, dev, sd, size=size,
                         batch=batch).train(train_ds, val_ds, verbose=False)
            resumed = make_trainer(os.path.join(tmp, "b"), 3, dev, sd, size=size, batch=batch)
            hist_b = resumed.train(train_ds, val_ds, verbose=False, resume=True)
    out = states_equal(straight.state, resumed.state)
    out["histories"] = all(hist_a[k] == hist_b[k] for k in
                           ("train_losses", "val_losses", "accuracies", "iou_scores",
                            "learning_rates", "best_model_epoch"))
    out["train_losses"] = hist_a["train_losses"]
    log("unet_train_resume_deterministic", json.dumps(out))
    return out


def train_step_times(dev, sd, train_ds, batch=TRAIN_BATCH):
    """One train step (gather, augment, forward, loss, backward, Adam) at
    batch 8 timed with CUDA events in bf16 and f32; the bf16 one profiled
    by kernel class."""
    out = {}
    idx, valid = batch_indices(batch, batch, shuffle=False, rng=np.random.default_rng(0))
    cfg = TrainConfig(lr=1e-4, weight_decay=0.0, loss="ce", batch_size=batch)
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = UNet(dtype=dt)
        model.load_state_dict(sd, strict=True)
        state = create_train_state(model, cfg, device=dev)
        epoch = make_train_epoch(model, cfg, make_augment_fn(), device=dev)

        def step():
            return epoch(state, train_ds.images, train_ds.masks, idx, valid, per_step=True)

        before = fused_conv3x3_bn_relu.launches
        out[f"step_b{batch}_{name}_ms"] = cuda_ms(step, 10 if dt == torch.bfloat16 else 5)
        out[f"fused_conv_launches_{name}_steps"] = fused_conv3x3_bn_relu.launches - before
        if dt == torch.bfloat16:
            out["profile"] = profile_forward(step, "unet_train_profile_step_b8_bf16",
                                             classes=_TRAIN_CLASSES)
        del model, state, epoch
        torch.cuda.empty_cache()
    return out


def train_path(dev, size=TRAIN_SIZE, batch=TRAIN_BATCH, n_train=TRAIN_TILES, n_val=VAL_TILES):
    """The production training path at full width: `WaterSegmentationTrainer`
    on the 31,043,586-parameter UNet (random weights from a numpy seed,
    through the bridge), bf16, batch 8, augmentation on, 3 epochs at lr 1e-3
    with a resume point every epoch, then the checks in the module
    docstring. Returns the results; raises when a check fails."""
    sd = unet_state_dict(random_unet_variables(seed=0))
    images, masks, route = coast_tiles(n_train + n_val, size, seed=0)
    log("unet_train_data", json.dumps(dict(route=route, train=n_train, val=n_val, size=size,
                                           water_fraction=float(masks.mean()))))
    train_ds = DeviceDataset.from_numpy(images[:n_train], masks[:n_train], device=dev)
    val_ds = DeviceDataset.from_numpy(images[n_train:], masks[n_train:], device=dev)
    result, failures = dict(route=route), []
    with tempfile.TemporaryDirectory() as save_dir:
        trainer = make_trainer(save_dir, TRAIN_EPOCHS, dev, sd, size=size, batch=batch)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        if n_params != UNET_PARAMS:
            raise AssertionError(f"UNet has {n_params} parameters, expected {UNET_PARAMS}")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        fused_conv3x3_bn_relu.launches = 0
        hist, rec = counted_train(trainer, train_ds, val_ds, dev)
        launches = fused_conv3x3_bn_relu.launches
        peak_gb = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None
        val_forwards = sum(r["batches"] for r in rec["validate"])
        val_launches = sum(r["fused_conv_launches"] for r in rec["validate"])
        train_launches = sum(r["fused_conv_launches"] for r in rec["train"])
        warm = rec["train"][1:]
        result.update(
            train_losses=hist["train_losses"], val_losses=hist["val_losses"],
            val_iou=hist["iou_scores"], val_accuracy=hist["accuracies"],
            learning_rates=hist["learning_rates"], best_epoch=hist["best_model_epoch"],
            fused_conv_launches=dict(total=launches, validate=val_launches,
                                     train_steps=train_launches, validation_forwards=val_forwards),
            epoch_s=[r["s"] for r in rec["train"]], validate_s=[r["s"] for r in rec["validate"]],
            train_img_per_s_warm=n_train * len(warm) / sum(r["s"] for r in warm),
            val_img_per_s=n_val * len(rec["validate"]) / sum(r["s"] for r in rec["validate"]),
            peak_memory_gb=peak_gb, training_time_s=hist["training_time"])
        log("unet_train_epochs", json.dumps(result))
        if not all(np.isfinite(hist["train_losses"] + hist["val_losses"])):
            failures.append("non-finite losses")
        if not hist["train_losses"][-1] < hist["train_losses"][0]:
            failures.append(f"train loss did not fall: {hist['train_losses']}")
        if train_launches != 0 or val_launches != 2 * val_forwards or launches != val_launches:
            failures.append(f"fused conv launches {result['fused_conv_launches']}: want 2 a "
                            "validation forward and none in the train steps")

        best = trainer.load_best()
        fresh = UNet(dtype=torch.bfloat16)
        fresh.load_state_dict(best, strict=True)
        ex = CoastlineExtractor(torch_checkpoint=os.path.join(save_dir, "best", "model.pth"),
                                dtype=torch.bfloat16, image_size=size, device=dev)
        pred = ex.predict_masks_batch(images[n_train:])
        result["best_export"] = dict(strict_load=True, mask_shape=list(pred.shape),
                                     mask_accuracy_vs_labels=float((pred == masks[n_train:]).mean()))
        template = create_train_state(UNet(dtype=torch.bfloat16),
                                      TrainConfig(lr=1e-3, weight_decay=0.0, loss="ce"), device=dev)
        ckpt = CheckpointManager(save_dir)
        result["resume_point_step"] = ckpt.latest_step()
        restored = ckpt.restore(template, step=ckpt.latest_step())
        result["restored_equals_saved"] = states_equal(restored, trainer.state)
        log("unet_train_checkpoint", json.dumps({k: result[k] for k in
                                                 ("best_export", "resume_point_step",
                                                  "restored_equals_saved")}))
        if pred.shape != (n_val, size, size) or not set(np.unique(pred)) <= {0, 1}:
            failures.append(f"bad masks from the best export: {pred.shape}")
        if not all(result["restored_equals_saved"].values()):
            failures.append(f"restored state differs: {result['restored_equals_saved']}")
        del trainer, ex, fresh, restored, template
    torch.cuda.empty_cache()

    result["card_vs_cpu_f32"] = train_card_vs_cpu(dev, UNet().state_dict())
    if not result["card_vs_cpu_f32"]["ok"]:
        failures.append("f32 train steps on the card disagree with the CPU path")
    result["resume"] = resume_check(dev, sd, train_ds, val_ds, size=size, batch=batch)
    if not all(v for k, v in result["resume"].items() if k != "train_losses"):
        failures.append(f"resumed run differs from the straight one: {result['resume']}")
    timing = train_step_times(dev, sd, train_ds, batch=batch)
    result["profile"] = timing.pop("profile")
    result.update(timing)
    if timing["fused_conv_launches_bf16_steps"] or timing["fused_conv_launches_f32_steps"]:
        failures.append(f"a train step launched the fused conv: {timing}")
    log("unet_train_timing", json.dumps(dict(timing, peak_memory_gb=result["peak_memory_gb"],
                                             train_img_per_s_warm=result["train_img_per_s_warm"],
                                             val_img_per_s=result["val_img_per_s"])))
    if failures:
        raise AssertionError("train path: " + "; ".join(failures))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args(argv)
    # cuBLAS reads this when it first starts; the deterministic resume check needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build {build_s:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(0)
    conv = check_fused_conv(dev, rng)
    dil = check_dilate(dev, rng)
    cbam_times, cbam_cases = check_cbam(dev)
    unpool_times, unpool_cases = check_unpool(dev)
    variables = random_unet_variables(seed=0)
    logits = logits_check(variables, dev)
    serving = serving_path(variables, dev, rng)
    block = residual_block_check(dev)
    robust = robust_unet_path(dev)
    segnet = segnet_path(dev)
    train = train_path(dev)

    def path_launches(path, name):
        return sum(e["launches"][name] for e in path["epochs"].values())

    main_dil = dil[0]
    conv_paths = {"serving": serving["launches"]["fused_conv3x3_bn_relu"],
                  "robust_unet_eval": path_launches(robust, "fused_conv3x3_bn_relu"),
                  "segnet_eval": path_launches(segnet, "fused_conv3x3_bn_relu"),
                  "unet_train_validate": train["fused_conv_launches"]["validate"]}
    kernels = [
        dict(name="fused_conv3x3_bn_relu", route="cuda",
             source="coastline_torch/csrc/fused_conv3x3_bn_relu.cu",
             replaces="coastline/pallas/fused_conv.py:107",
             launches=sum(conv_paths.values()), launches_by_path=conv_paths,
             max_abs_err=conv["max_abs_err"], ms=conv["ms"], plain_ms=conv["plain_ms"],
             bound_ms=conv["bound_ms"], bound_by=conv["bound_by"],
             library_ms=conv["library_ms"], device_ms=conv["device_ms"],
             share_of_bound=conv["share_of_bound"],
             tflops=conv["tflops"], shape=conv["shape"]),
        dict(name="dilate_disk", route="cuda", source="coastline_torch/csrc/dilate_disk.cu",
             replaces="coastline/pallas/morphology.py:262",
             launches=serving["launches"]["dilate_disk"],
             max_abs_err=max(c["max_abs_err"] for c in dil), ms=main_dil["ms"],
             plain_ms=main_dil["plain_ms"], bound_ms=main_dil["bound_ms"],
             bound_by=main_dil["bound_by"], library_ms=main_dil["library_ms"],
             device_ms=main_dil["device_ms"], share_of_bound=main_dil["share_of_bound"],
             shape=main_dil["shape"], size=main_dil["size"],
             library="conv-threshold: F.conv2d f32 with the SE, then > 0", cases=dil),
    ]
    for name, source, replaces in (
            ("avg_max_pool", "avg_max_pool.cu",
             "coastline/pallas/cbam.py:141 (and coastline/pallas/pools.py:56)"),
            ("gated_spatial_stats", "gated_spatial_stats.cu", "coastline/pallas/cbam.py:213"),
            ("cbam_tail", "cbam_tail.cu", "coastline/pallas/cbam.py:328")):
        t = cbam_times[name]
        entry = dict(name=name, route="cuda", source=f"coastline_torch/csrc/{source}",
                     replaces=replaces, launches=path_launches(robust, name),
                     max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
                     bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                     library_ms=t["library_ms"], shape=t["shape"], library=t["library"])
        if name == "avg_max_pool":
            entry["fused_avg_max_pool_launches_residual_block"] = block["fused_avg_max_pool_launches"]
        kernels.append(entry)
    for name, replaces in (("max_pool_with_indices", "coastline/pallas/unpool.py:67"),
                           ("max_unpool", "coastline/pallas/unpool.py:94")):
        t = unpool_times[name]
        kernels.append(dict(name=name, route="cuda", source="coastline_torch/csrc/unpool.cu",
                            replaces=replaces, launches=path_launches(segnet, name),
                            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                            library_ms=t["library_ms"], shape=t["shape"], library=t["library"]))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, build_s=build_s, kernels=kernels, logits=logits,
                           serving=serving, cbam_cases=cbam_cases, residual_block=block,
                           robust_unet=robust, unpool_cases=unpool_cases, segnet=segnet,
                           unet_train=train),
                      f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
