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
     shape and eight ragged ones, and at HRNet-Water's stem shape
     (8, 256, 256, 64) with a conv bias folded into its BN), the dilation,
     the three CBAM kernels (pool, gated stats, tail) at the five Robust
     U-Net level shapes (the fourth, (8, 64, 64, 512), also WaterNet's
     bottleneck, where `fused_avg_max_pool` runs and is timed), (2, 4, 4,
     1024) and an odd shape (the pool's max bit for bit, two calls and the
     two pool wrappers bit-identical; the pool timed at every level
     shape), and SegNet's indexed
     pool and unpool at its four levels and an odd shape, on inputs full of
     ties (ReLU zeros, equal pairs, +0/-0, NaN and inf), bit for bit, in
     bf16 and f32, and in int8 on codes in -3..3 (the int8 SegNet's);
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
     tail launches a forward and, in bf16, 2 fused convs, and the profiled
     bf16 forward 9 pool kernels (one a call); the two epochs'
     losses and mean metrics must agree within 5e-3 and their masks on 95%
     of pixels; the forward is timed at batch 8 and profiled by kernel;
  7. the SegNet eval path the same way: the 15,278,593-parameter model, its
     logits against the CPU path at 64^2 (a share of the logits, since a
     near-tie in a pool window may pick another position on the card), then
     `make_eval_epoch` in bf16 and f32 with 4 pool, 4 unpool and, in bf16,
     2 fused-conv launches a forward; losses and mean metrics within 5e-3,
     masks on 85% of pixels (`segnet_path` says why);
  8. the zoo's nine other models the same way (`zoo_path`): DeepLabV3+,
     YOLO-SEG, PSPNet, Fast-SCNN, ENet, WaterNet, MSWNet, HRNet-Water and
     SegFormer-Lite at full width (exact parameter counts; their seeded
     init with BN statistics drawn from a forward, `zoo_state_dict`), f32
     logits against the CPU path on every logit, bf16 at the UNet's limits,
     `make_eval_epoch` in bf16 and f32 with the fused conv launched twice
     (WaterNet) or once (HRNet-Water) a bf16 forward and nowhere else, and
     `fused_avg_max_pool` once a WaterNet forward;
  9. the production training path at full width: the 2-class UNet (random
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
  10. the comparison protocol (`protocol_path`): `cli/bench_all.main` with
     no `--models` trains and evaluates the default list of eleven models
     at full width (random init from their constructors' seeds) for 2 bf16
     epochs over 16 synthetic 512^2 tiles at batch 2, validating on 4, and
     times them at batch 2 and 64; the parameter counts must equal
     `baselines/reference_param_counts.json`, every train loss must fall,
     every bf16 eval forward must launch its model's kernels (`PROTOCOL_WANT`:
     9/9/9 CBAM kernels and 2 fused convs in the Robust U-Net, 4/4
     pool/unpool and 2 fused convs in SegNet, 2 fused convs and one
     `fused_avg_max_pool` in WaterNet, 1 fused conv in HRNet-Water, none in
     the rest), and no train step any kernel. Then two f32 Adam steps of
     each model at (2, 64, 64) on the card against the CPU path
     (`CARD_VS_CPU`; every parameter with a gradient on the card), batch-8
     bf16 train steps at 512^2 (every model, the Robust U-Net under each
     `remat` flavor) with peak memory and profiles, the `remat` flavors
     bit-equal after one deterministic step with dropout on, and
     Dropout2d's mask statistics on the card;
  11. the extraction path (`extraction_path`), serving the best checkpoint
     of phase 9: a bf16 `CoastlineExtractor(checkpoint_dir=)` predicts a
     10980^2 synthetic granule (a Sentinel-2 L1C tile) through
     `predict_scene(batch=8, with_band=20)` with 158 fused-conv launches
     and one dilation, equal bit for bit to the host tiling path; the
     dilation at (1, 10980, 10980), size 20, equal to its plain version and
     timed against its bound; the native contour tracer (built with g++) on
     the band; the f32 scene path against the CPU on a 700x900 scene at
     128^2 tiles (masks on >= 99.9% of pixels, the band exact);
     `extract_scenes` over three 2048^2 scenes pipelined against
     sequential; and the convert, predict (image, --batch, --scene), change
     and export CLIs as subprocesses with their artifacts, the exported
     .pth serving the checkpoint's masks;
  12. the int8 PTQ path (`int8_path`, serving phase 9's checkpoint): the
     UNet `quantize`d to an .npz, 16 requests through `serve()` at batch 8,
     512^2 (21 int8 conv launches a forward, no fused conv, one dilation a
     band call), `from_quantized` serving the same masks bit for bit, the
     card against the CPU path at 128^2 (>= 99.5% of mask pixels), int8 and
     bf16 forward times; an int8 2048^2 scene equal to the host tiling path;
     the Robust U-Net's, SegNet's, WaterNet's, MSWNet's, HRNet-Water's,
     PSPNet's, DeepLabV3+'s, YOLO-SEG's, Fast-SCNN's, ENet's and
     SegFormer-Lite's int8 forwards at batch 8, 512^2, full width
     (`INT8_CONVS`: 38, 18, 16, 18, 6, 8, 10, 8, 13, 2 and 19 int8 convs;
     stride 2 and 4, the 3x3 and 4x4 transposed convs, the leaky-ReLU
     epilogue, C_in = 144 and 1024 among them; SegNet's 4 pools and unpools
     on codes; no plain conv on the card; the sites fused and eager,
     `INT8_SITES`) beside the bf16 models' forwards, against the CPU at
     128^2 layer by layer (>= 99% of mask pixels, <= 1e-5 of any site's
     codes, a limit that two controls must exceed; `forced_card_vs_cpu`
     says why); then the int8 conv at every configuration those twelve
     forwards take and at the modes none takes (`EXTRA_INT8_CONFIGS`), bit
     for bit against its plain version, timed against its bound and
     cuDNN's bf16 conv. The int8 CLIs (predict --int8
     --save-quantized, predict --batch --quantized, export --quantized-out
     --calib-images) run in phase 11's subprocess pool. Then the AOT
     serving export (`int8_export`) of the same twelve models: each
     `export_serving` on the card at batch 8, 512^2 (seconds, `.pt2`
     bytes), `load_serving`, and the program on the eager forward's input
     bit-equal to it, with the same kernel launches, a batch of 9 refused,
     and its events ms and device ms beside the eager forward's; the UNet
     also through `save_serving_bundle` / `load_serving_bundle`;
  13. the multi-device phase (`multi_device_path`): two gloo ranks sharing
     cuda:0 (`parallel/launch.py`) train the full-width UNet with DDP, two
     bf16 steps at global batch 8 and 512^2 and a validation pass, against
     the single-process card run (losses within 2^-8, parameters as
     `MD_LOSS_REL`'s comment says); run SegNet's sample-sharded
     `evaluate_model`; and serve a 2048^2 scene through
     `predict_scene(mesh=)` in bf16 and int8 with the band, bit-identical to
     one process. The fused conv, SegNet's pool and unpool, the dilation and
     the int8 conv are counted on each rank and held against their plain
     versions at a rank's shapes. Then `cli.train --data-parallel 1
     --sharded-data` through the launcher (one NCCL rank) and torchrun;
  14. the space phase (`space_path`): two gloo ranks sharing cuda:0 under
     `make_mesh(2, space=2)`, each holding half the rows of every image,
     against one process on the card: the full-width Robust U-Net's bf16
     and f32 eval forwards at batch 8, 512^2 (9 CBAM pools, stats and tails
     and, in bf16, 2 fused convs on each rank; f32 logits within atol 2e-4
     / rtol 1e-3; bf16 masks as close to the f32 ones as one process's
     bf16 masks, within 0.1%: `SP_BF16_MARGIN`), SegNet's bf16 forward (4 pools, 4
     unpools, 2 fused convs; masks >= 95%), every kernel call held against
     its plain version on its own (halo'd) inputs; 3 bf16 Robust U-Net
     train steps, rank 0's parameters within Adam's 2 x lr x steps x 1.1 of
     one process and each rank's peak memory under 0.7 of one process's;
     a 2048^2 scene through `predict_scene(mesh=)` (masks >= 99.9%, the band
     the dilation of the mask); then the CBAM tail with a 3-row stats halo
     and the pool's float32 partials against their plain versions;
  15. the tools phase (`tools_path`): the port's bench
     (`coastline_torch.bench.run`) in-process with short loops, its line
     holding the root bench's keys, a positive headline and "platform":
     "gpu", every bf16 eval forward of it launching 9 CBAM pools, stats and
     tails and 2 fused convs, every int8 forward 38 int8 convs, its train
     forwards none, and its bf16 batch-8 output bit-equal to a direct call;
     the outputs of its timing loops' warm calls at batch 1 and at its
     largest bf16 and int8 batches against the plain-version forward on the
     card on the same input (bf16 logits at the eval paths' tolerance, int8
     masks at the int8 evals' limit), which so holds every kernel of the
     bench at the shapes the bench times;
     `trace()` around a bf16 forward writing a Chrome trace that names those
     kernels; the dispatch round trip; and the GUI's compute
     (`process_images` on two 512^2 PNG tiles with phase 9's checkpoint,
     `drain_queue`, `save_extraction_result`), each band from one
     `dilate_disk` launch and equal to the plain version's;
  16. a `kernels` JSON line, the card line and the last line:
     {"ok": true, "device": {...}}.

Float32 convolutions run with cuDNN's TF32 off, so every float32 number
here is a true float32 result. Any failure raises and exits non-zero.
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from coastline_torch.infer.contours import extract_contours
from coastline_torch.infer import deploy as quant_deploy
from coastline_torch.infer import quant
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.infer.morphology import coastline_band, elliptical_kernel
from coastline_torch.infer.scene import build_scene_fn
from coastline_torch.kernels import _build, cbam, unpool
from coastline_torch.kernels import fused_conv as fused_conv_module
from coastline_torch.kernels import int8_conv as int8_conv_module
from coastline_torch.kernels.fused_conv import (fused_conv3x3_bn_relu,
                                                fused_conv3x3_bn_relu_plain)
from coastline_torch.kernels.int8_conv import (int8_conv, int8_conv_plain, normalize_padding,
                                               pack_weights, packed, quantize_codes)
from coastline_torch.kernels.morphology import dilate_disk, dilate_disk_plain, se_row_groups
from coastline_torch.kernels.pools import fused_avg_max_pool
from coastline_torch.models import segnet as segnet_module
from coastline_torch.models.registry import create_model, model_class
from coastline_torch.ops import blocks as blocks_module
from coastline_torch.ops.blocks import Dropout2d, ResidualBlock, fold_bn
from coastline_torch.ops.primitives import Conv, Norm
from coastline_torch.parallel import collectives
from coastline_torch.data.augment import make_augment_fn
from coastline_torch.data.pipeline import DeviceDataset
from coastline_torch.data.synthetic import make_scene
from coastline_torch.models.unet import UNet
from coastline_torch.train import trainer as trainer_module
from coastline_torch.train.checkpoint import CheckpointManager
from coastline_torch.cli import bench_all
from coastline_torch.train.loop import (Evaluator, TrainConfig, batch_indices, create_train_state,
                                        make_eval_epoch, make_train_epoch, normalize_images)
from coastline_torch.train.trainer import TrainerConfig, WaterSegmentationTrainer
from coastline_torch.utils.torch_import import (random_robust_unet_variables,
                                                random_segnet_variables, random_unet_variables,
                                                robust_unet_state_dict, segnet_state_dict,
                                                unet_state_dict)
from coastline_torch.utils.profiling import _KERNEL_CLASSES, conv_flops, device_time_by_class

# Published H100 SXM peaks (NVIDIA data sheet, dense): the roofs for bound_ms.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_OPS = 67e12  # non-tensor float32 rate; integer/float max runs on the same units
UNET_PARAMS = 31_043_586
ROBUST_UNET_PARAMS = 40_872_223
SEGNET_PARAMS = 15_278_593
# the zoo's other nine models, the comparison protocol's baselines, in the default list's order
ZOO_MODELS = ("DeepLabV3+", "YOLO-SEG", "PSPNet", "Fast-SCNN", "ENet", "WaterNet", "MSWNet",
              "HRNet-Water", "SegFormer-Lite")
CONV_SHAPE = (8, 512, 512, 64)
HRNET_STEM_SHAPE = (8, 256, 256, 64)  # HRNet-Water's second stem conv at batch 8, 512^2
# widths off the 64-pixel tile, one row, one column, one pixel, batch 1, a straddling tile
RAGGED_CONV_SHAPES = [(1, 9, 65, 64), (2, 5, 127, 64), (1, 6, 130, 64), (2, 1, 70, 64),
                      (2, 33, 1, 64), (1, 1, 1, 64), (1, 512, 512, 64), (2, 67, 200, 64)]
# the Robust U-Net's ResidualBlock outputs at batch 8, 512^2: the CBAM kernels' shapes
# ((8, 64, 64, 512) is also WaterNet's bottleneck, where fused_avg_max_pool runs)
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


def label(name: str) -> str:
    """A registry name as a log label: "Robust UNet" -> robust_unet, "DeepLabV3+" -> deeplabv3p."""
    return name.lower().replace(" ", "_").replace("-", "_").replace("+", "p")


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


def _conv_ok(got, ref) -> bool:
    """The fused conv against its plain version: the same float32 sums in
    another order, one bf16 rounding: 1 bf16 ulp (2^-7 relative) + 1e-3."""
    return bool(torch.all((got.float() - ref.float()).abs() <= 2.0 ** -7 * ref.float().abs() + 1e-3))


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
            ok = ok and _conv_ok(got, ref)
            errs[f"{'x'.join(map(str, shape))}_relu_{relu}"] = float(err.max())
            del got, ref, err
    # HRNet-Water's second stem conv: a 64 -> 64 conv with bias and its BN,
    # folded as `conv_bn` folds them, at its shape
    gen = torch.Generator().manual_seed(4)
    conv, norm = Conv(64, 64, 3, padding=1, generator=gen), Norm(64)
    with torch.no_grad():
        norm.weight.uniform_(0.8, 1.2, generator=gen)
        norm.bias.normal_(0.0, 0.1, generator=gen)
        norm.running_mean.normal_(0.0, 0.1, generator=gen)
        norm.running_var.uniform_(0.5, 1.5, generator=gen)
        stem = tuple(t.to(dev) for t in fold_bn(conv, norm.eval()))
    xh = x[:, :HRNET_STEM_SHAPE[1], :HRNET_STEM_SHAPE[2]].contiguous()
    got = fused_conv3x3_bn_relu(xh, *stem).float()
    torch.cuda.synchronize()
    ref = fused_conv3x3_bn_relu_plain(xh, *stem).float()
    err = (got - ref).abs()
    ok = ok and _conv_ok(got, ref)
    errs["x".join(map(str, HRNET_STEM_SHAPE)) + "_hrnet_stem_folded_bias"] = float(err.max())
    hrnet_ms = cuda_ms(lambda: fused_conv3x3_bn_relu(xh, *stem), 20)
    hrnet_bound_ms, _ = bound(2 * xh.numel() * 2 + wt.numel() * 2 + 2 * c * 4,
                              2.0 * xh.numel() * 9 * c, PEAK_BF16_FLOPS)
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
                  tflops=flops / dev_ms / 1e9, hrnet_stem_ms=hrnet_ms,
                  hrnet_stem_bound_ms=hrnet_bound_ms,
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
            again = cbam.avg_max_pool(x)
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
                pool_run_to_run_exact=bool(torch.equal(again[0], avg)
                                           and torch.equal(again[1], mx)),
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
            del x, s, gate, stats, tail, r_stats, r_tail, again

    levels = time_pool_levels(dev, gen)
    b, h, w, c = shape = LEVEL_SHAPES[0]
    x, s, gate, sconv = _cbam_inputs(shape, torch.bfloat16, dev, gen)
    stats = cbam.gated_spatial_stats(x, gate)
    xl = x.permute(0, 3, 1, 2)  # the channels_last NCHW view
    w16 = sconv.to(torch.bfloat16).permute(3, 2, 0, 1)
    n, px = x.numel(), b * h * w
    timings = {
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
    out = {"avg_max_pool": dict(levels[0], max_abs_err=errs["avg_max_pool"], levels=levels)}
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
    # `fused_avg_max_pool` (the same kernel under its own wrapper) at WaterNet's
    # bottleneck, (8, 64, 64, 512) bf16, where its one launch a forward runs
    shape = LEVEL_SHAPES[3]
    x = _cbam_inputs(shape, torch.bfloat16, dev, gen)[0]
    xl = x.permute(0, 3, 1, 2)
    n = x.numel()
    nbytes = 2 * n + 2 * shape[0] * shape[3] * 2
    bound_ms, bound_by = bound(nbytes, 2 * n, PEAK_F32_OPS)
    fused = out["fused_avg_max_pool"] = dict(
        ms=cuda_ms(lambda: fused_avg_max_pool(x), 20),
        device_ms=device_ms(lambda: fused_avg_max_pool(x), 20),
        plain_ms=cuda_ms(lambda: cbam.avg_max_pool_plain(x), 5, 1),
        library_ms=cuda_ms(lambda: (xl.mean((2, 3)), xl.amax((2, 3))), 20),
        bound_ms=bound_ms, bound_by=bound_by, shape=list(shape), dtype="bfloat16",
        library=POOL_LIBRARY)
    fused["share_of_bound"] = bound_ms / fused["device_ms"]
    log("fused_avg_max_pool", json.dumps(fused))
    return out, cases


POOL_LIBRARY = "channels_last x.mean((2,3)) + x.amax((2,3))"


def time_pool_levels(dev, gen) -> list:
    """`avg_max_pool` at each of the five `LEVEL_SHAPES` in bf16: CUDA events
    ms over back-to-back calls (`ms`, the wrapper's host path included),
    device ms (`device_ms`), the plain version, the library yardstick and
    the byte bound; the kernel's geometry (`cbam.pool_geometry`)."""
    levels = []
    for shape in LEVEL_SHAPES:
        b, h, w, c = shape
        x = _cbam_inputs(shape, torch.bfloat16, dev, gen)[0]
        xl = x.permute(0, 3, 1, 2)  # the channels_last NCHW view
        n = x.numel()
        bound_ms, bound_by = bound(2 * n + 2 * b * c * 2, 2 * n, PEAK_F32_OPS)
        row = dict(shape=list(shape), dtype="bfloat16",
                   ms=cuda_ms(lambda: cbam.avg_max_pool(x), 20),
                   device_ms=device_ms(lambda: cbam.avg_max_pool(x), 20),
                   plain_ms=cuda_ms(lambda: cbam.avg_max_pool_plain(x), 5, 1),
                   library_ms=cuda_ms(lambda: (xl.mean((2, 3)), xl.amax((2, 3))), 20),
                   bound_ms=bound_ms, bound_by=bound_by, library=POOL_LIBRARY,
                   geometry=cbam.pool_geometry(b, h * w, c, cbam._vec(c, x),
                                               cbam._sm_count(x.device.index))._asdict())
        row["share_of_bound"] = bound_ms / row["device_ms"]
        row["gb_per_s"] = (2 * n + 4 * b * c) / row["device_ms"] / 1e6
        log("avg_max_pool_level", json.dumps(row))
        levels.append(row)
        del x, xl
    return levels


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


def _tie_codes(shape, dev, gen):
    """Int8 codes full of ties, as a requantized ReLU activation holds them:
    values in -3..3, channels 0::3 with equal codes at window positions 0
    and 3, one channel of the first window all -128 (below every code the
    sites make) and the extreme codes -127 and 127."""
    b, h, w, c = shape
    x = torch.randint(-3, 4, shape, device=dev, generator=gen, dtype=torch.int8)
    if h % 2 == 0 and w % 2 == 0:
        xw = x.view(b, h // 2, 2, w // 2, 2, c)
        xw[:, :, 1, :, 1, ::3] = xw[:, :, 0, :, 0, ::3]
    x[0, :2, :2, 0] = -128
    x[-1, -1, -1, :], x[0, -1, 0, :] = 127, -127
    return x


def check_unpool(dev):
    """SegNet's indexed pool and unpool against their plain versions at the
    four levels and an odd shape, in bf16, f32 and int8 (the int8 SegNet
    pools and unpools codes), on inputs full of ties: codes, values and the
    unpooled output bit for bit. Times at the top level, bf16, and beside
    them int8."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cases, errs = [], {"max_pool_with_indices": 0.0, "max_unpool": 0.0}
    for dt in (torch.bfloat16, torch.float32, torch.int8):
        for shape, vshape in zip(POOL_SHAPES, UNPOOL_SHAPES):
            odd = shape[0] == 3
            if dt == torch.int8:
                x, v = _tie_codes(shape, dev, gen), _tie_codes(vshape, dev, gen)
            else:
                x = _tie_input(shape, dt, dev, gen, nonfinite=odd)
                v = _tie_input(vshape, dt, dev, gen, nonfinite=odd)
            vals, codes = unpool.max_pool_with_indices(x)
            torch.cuda.synchronize()
            r_vals, r_codes = unpool.max_pool_with_indices_plain(x)
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

    out = {}
    for dt in (torch.bfloat16, torch.int8):
        x = (_tie_codes(POOL_SHAPES[0], dev, gen) if dt == torch.int8
             else _tie_input(POOL_SHAPES[0], dt, dev, gen))
        vals, codes = unpool.max_pool_with_indices(x)
        xl = x.permute(0, 3, 1, 2)  # the channels_last NCHW view
        lib_vals, lib_idx = (F.max_pool2d(xl, 2, return_indices=True) if dt != torch.int8
                             else (None, None))  # no int8 max pool in PyTorch on CUDA
        n_in, n_out, size = x.numel(), vals.numel(), x.element_size()
        timings = {
            "max_pool_with_indices": (
                lambda: unpool.max_pool_with_indices(x), lambda: unpool.max_pool_with_indices_plain(x),
                lambda: F.max_pool2d(xl, 2, return_indices=True),
                "F.max_pool2d(return_indices=True), int64 flat indices, bf16 channels_last",
                size * n_in + size * n_out + 4 * n_out, 3 * n_out, list(x.shape)),
            "max_unpool": (
                lambda: unpool.max_unpool(vals, codes), lambda: unpool.max_unpool_plain(vals, codes),
                lambda: F.max_unpool2d(lib_vals, lib_idx, 2),
                "F.max_unpool2d, int64 flat indices, bf16 channels_last",
                size * n_out + 4 * n_out + size * n_in, 4 * n_out, list(vals.shape)),
        }
        for name, (kern, plain, lib, lib_name, nbytes, ops, shape) in timings.items():
            ms = cuda_ms(kern, 20)
            plain_ms = cuda_ms(plain, 5, 1)
            bound_ms, bound_by = bound(nbytes, ops, PEAK_F32_OPS)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       gb_per_s=nbytes / ms / 1e6, shape=shape, dtype=str(dt).split(".")[-1])
            if dt == torch.int8:
                out[name]["int8"] = row
            else:
                out[name] = dict(row, max_abs_err=errs[name], library_ms=cuda_ms(lib, 20),
                                 library=lib_name)
            log(name, json.dumps(row))
        del x, vals, codes, xl, lib_vals, lib_idx
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


def profile_forward(forward, label: str, steps: int = 3, classes=_KERNEL_CLASSES):
    """`device_time_by_class` of `steps` calls of `forward`, logged under `label`."""
    result = device_time_by_class(forward, steps, classes)
    log(label, json.dumps(result))
    return result


def compare_logits(got, ref, dt) -> dict:
    """Float32 logits `got` against `ref` on one device: the largest error,
    the share within the tolerance (1e-3 x max(1, std) in f32, 0.1 x std in
    bf16, std of `ref`) and the share of agreeing masks (logit > 0)."""
    std, err = float(ref.std()), (got - ref).abs()
    tol = 1e-3 * max(1.0, std) if dt == torch.float32 else 0.1 * std
    return dict(max_abs_err=float(err.max()), logit_std=std, tolerance=tol,
                within=float((err <= tol).float().mean()),
                mask_agree=float(((got > 0) == (ref > 0)).float().mean()))


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
        out[name] = compare_logits(got, ref, dt)
    log(f"{label(model_name)}_logits_vs_cpu", json.dumps(out))
    for name, (min_within, min_agree) in limits.items():
        if out[name]["within"] < min_within or out[name]["mask_agree"] < min_agree:
            raise AssertionError(f"{name} {model_name} logits disagree with the CPU path: {out}")
    return out


def eval_path(model_name, sd, dev, n_params, counters, want, limits, min_mask_agree,
              max_gap=5e-3, size=512, n_images=16, batch=8):
    """An eval path at full width: `create_model` + the weight bridge's
    state_dict `sd`, its logits against the CPU path (`limits`), then
    `make_eval_epoch` over synthetic tiles in bf16 and f32. `want(dtype)`
    gives each counter's launches a forward; the bf16 and f32 epochs' masks
    must agree on `min_mask_agree` of the pixels, and their losses and mean
    metrics within `max_gap` (None: reported only)."""
    logits = logits_vs_cpu(model_name, sd, dev, limits)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (n_images, size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    masks = np.stack([yy > size / 2 + 40 * np.sin(xx / 60.0 + i) + 15 * np.sin(xx / 17.0)
                      for i in range(n_images)]).astype(np.int32)
    idx, valid = batch_indices(n_images, batch, shuffle=False, rng=rng)
    x8 = torch.from_numpy(images[:batch]).to(dev)
    tag = label(model_name)
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
        log(f"{tag}_eval_epoch_{name}", json.dumps(result["epochs"][name]))
        if dt == torch.bfloat16:
            with torch.inference_mode():
                result["profile"] = profile_forward(lambda: model(x, return_logits=True),
                                                    f"profile_{tag}_forward_b8_bf16")
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
    log(f"{tag}_path", json.dumps({k: v for k, v in result.items()
                                     if k not in ("profile", "epochs", "logits_vs_cpu")}))
    if agree < min_mask_agree:
        raise AssertionError(f"bf16 masks agree with f32 on only {agree:.4f} of pixels")
    if max_gap is not None and max(gaps.values()) > max_gap:
        raise AssertionError(f"bf16 and f32 epochs disagree: {gaps}")
    return result


ALL_COUNTERS = {"fused_conv3x3_bn_relu": fused_conv3x3_bn_relu, "dilate_disk": dilate_disk,
                "avg_max_pool": cbam.avg_max_pool, "fused_avg_max_pool": fused_avg_max_pool,
                "gated_spatial_stats": cbam.gated_spatial_stats, "cbam_tail": cbam.cbam_tail_apply,
                "max_pool_with_indices": unpool.max_pool_with_indices,
                "max_unpool": unpool.max_unpool, "int8_conv": int8_conv}
ROBUST_COUNTERS = {"avg_max_pool": cbam.avg_max_pool, "gated_spatial_stats": cbam.gated_spatial_stats,
                   "cbam_tail": cbam.cbam_tail_apply, "fused_conv3x3_bn_relu": fused_conv3x3_bn_relu,
                   "fused_avg_max_pool": fused_avg_max_pool}
SEGNET_COUNTERS = {"max_pool_with_indices": unpool.max_pool_with_indices,
                   "max_unpool": unpool.max_unpool, "fused_conv3x3_bn_relu": fused_conv3x3_bn_relu}


# the Robust U-Net's logits limits (`logits_vs_cpu`): share within the tolerance, mask agreement
ROBUST_UNET_LIMITS = {"f32": (1.0, 0.0), "bf16": (1.0, 0.95)}


def robust_unet_path(dev, **kw):
    """The Robust U-Net eval path: 9 pool, stats and tail launches a forward
    and, in bf16, 2 fused convs; the bf16 forward's profile must show 9
    kernels of class `avg_max_pool (ours)` (one a pool call). Same weights
    and tiles: the recorded runs (PERF.md) moved the loss by 1.5e-3 and each
    mean metric by at most 1.1e-3 between the dtypes; the 5e-3 limit leaves
    room for another cuDNN algorithm and catches a shift that flips few
    masks."""
    result = eval_path(
        "Robust UNet", robust_unet_state_dict(random_robust_unet_variables(seed=0)), dev,
        ROBUST_UNET_PARAMS, ROBUST_COUNTERS,
        lambda dt: {"avg_max_pool": 9, "gated_spatial_stats": 9, "cbam_tail": 9,
                    "fused_conv3x3_bn_relu": 2 if dt == torch.bfloat16 else 0,
                    "fused_avg_max_pool": 0},
        limits=ROBUST_UNET_LIMITS, min_mask_agree=0.95, **kw)
    pool = result["profile"]["classes"].get("avg_max_pool (ours)", {})
    result["pool_launches_profiled"] = pool.get("launches_per_forward", 0)
    if result["pool_launches_profiled"] != 9:
        raise AssertionError(f"avg_max_pool ran {result['pool_launches_profiled']} kernels a "
                             "profiled bf16 Robust U-Net forward, want 9 (one a call)")
    return result


def segnet_code_flips(sd, dev):
    """Pool windows whose code differs between the card and the CPU path, by
    level, on `logits_vs_cpu`'s input and weights, in f32 and bf16."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 64, 64)).astype(np.float32))
    pool, out = segnet_module.max_pool_with_indices, {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        codes = []

        def spy(t, **kw):
            vals, c = pool(t, **kw)
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


def zoo_want(name, dt) -> dict:
    """Each kernel's launches a forward of zoo model `name` in dtype `dt`:
    the fused conv twice in WaterNet (`enc1`/`dec1` conv 2) and once in
    HRNet-Water (stem conv 2), in bf16 only; `fused_avg_max_pool` once in
    WaterNet (its bottleneck's ChannelAttention); every other kernel never."""
    want = dict.fromkeys(ALL_COUNTERS, 0)
    if dt == torch.bfloat16:
        want["fused_conv3x3_bn_relu"] = {"WaterNet": 2, "HRNet-Water": 1}.get(name, 0)
    want["fused_avg_max_pool"] = int(name == "WaterNet")
    return want


def zoo_path(dev, models=ZOO_MODELS, **kw):
    """The eval path of each of the nine zoo models at full width
    (`eval_path`: `create_model`, weights from `zoo_state_dict`, the exact
    parameter count, then `make_eval_epoch` over 16 tiles of 512^2 at batch
    8 in bf16 and f32, launches a forward as `zoo_want` says, a profile of
    the bf16 forward), at the UNet's limits: float32 logits within 1e-3 x
    max(1, std) of the CPU path on every logit, bf16 ones within 0.1 std
    with 95% of the masks agreeing, and the bf16 and f32 epochs' masks on 95%
    of the pixels. Their losses and mean metrics are reported, not bound:
    the random weights' predictions make them a measure of the weights
    (ENet's logits have a std near 15, whose bf16 rounding moves the BCE
    by 0.2%; Fast-SCNN's masks are 1% water, whose precision a few
    thousand pixels move; PERF.md)."""
    with open(os.path.join(REPO, "baselines", "reference_param_counts.json")) as f:
        counts = json.load(f)
    out = {}
    for name in models:
        out[name] = eval_path(name, zoo_state_dict(name), dev, counts[PARAM_COUNT_KEYS[name]],
                              ALL_COUNTERS, lambda dt, n=name: zoo_want(n, dt),
                              limits={"f32": (1.0, 0.0), "bf16": (1.0, 0.95)},
                              min_mask_agree=0.95, max_gap=None, **kw)
        torch.cuda.empty_cache()
    return out


TRAIN_SIZE, TRAIN_BATCH, TRAIN_TILES, VAL_TILES, TRAIN_EPOCHS = 512, 8, 32, 8, 3
_TRAIN_CLASSES = (  # kernel classes of a train step, first match wins
    ("fused_conv3x3_bn_relu (ours)", ("fused_conv_kernel",)),
    ("int8_conv (ours)", ("int8_conv_kernel",)),
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


def zoo_state_dict(name, seed=0, size=64, batch=2):
    """Random weights for a zoo model at full width: its constructor's
    seeded init, each BN's running statistics taken from one train-mode
    forward of a seeded N(0, 1) input at (batch, 3, size, size) with dropout
    off (the batch statistics, so every layer's activations keep about unit
    scale, as a trained model's do), then drawn away from them: mean +
    N(0, 0.1) x std, var x U(0.5, 1.5); BN affines U(0.8, 1.2) and
    N(0, 0.1). A wrong fold, epsilon or statistic then shows in the logits."""
    model = create_model(name)
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0  # the running statistics become the batch's
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.eval()
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, 3, size, size), np.float32))
    with torch.no_grad():
        model(x)
    rng = np.random.default_rng(seed + 1)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k in sd:
        if k.endswith(".running_mean"):
            p, c = k[:-len("running_mean")], sd[k].numel()

            def draw(fn, *a):
                return torch.from_numpy(fn(*a, c).astype(np.float32))

            sd[p + "running_mean"] += draw(rng.normal, 0.0, 0.1) * sd[p + "running_var"].sqrt()
            sd[p + "running_var"] *= draw(rng.uniform, 0.5, 1.5)
            sd[p + "weight"] = draw(rng.uniform, 0.8, 1.2)
            sd[p + "bias"] = draw(rng.normal, 0.0, 0.1)
            sd[p + "num_batches_tracked"].zero_()
    return sd


def train_card_vs_cpu(dev, sd, size=64, model_fn=UNet, loss="ce", label="unet", beta=6.0,
                      seed=3, batch=2):
    """One `make_train_epoch` of 2 Adam steps at (batch, size, size) a batch,
    f32, wd 0.1, lr 1e-4, no augmentation, on the card and on the CPU path
    from the same weights and batches (cuDNN TF32 off), for the model
    `model_fn()` makes (its dropout off) with `loss`. The JAX package's
    bounds for f32 conv-gradient noise through Adam
    (`tests/test_train_parity.py:89-108,186-189`): the loss to 1e-5
    relative, every parameter to atol 5e-5 / rtol 1e-4, every BN statistic
    to atol 2e-5 / rtol 2e-4. Every parameter must hold a gradient on the
    card after the last backward (a kernel without a backward in the path
    would leave the ones below it at None).

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
    sd = shift_bn(sd, beta)
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (2 * batch, size, size, 3), dtype=np.uint8)
    masks = (rng.random((2 * batch, size, size)) > 0.5).astype(np.uint8)
    idx = np.arange(2 * batch, dtype=np.int32).reshape(2, batch)
    valid = np.ones((2, batch), np.float32)
    cfg = TrainConfig(lr=1e-4, weight_decay=0.1, loss=loss, batch_size=batch)
    runs = {}
    for d in (torch.device("cpu"), dev):
        model = without_dropout(model_fn())
        model.load_state_dict(sd, strict=True)
        state = create_train_state(model, cfg, device=d)
        with deterministic() if d.type == "cuda" else contextlib.nullcontext():
            state, loss = make_train_epoch(model, cfg, device=d)(state, images, masks, idx, valid)
        runs[d.type] = (loss, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                        [n for n, p in model.named_parameters() if p.grad is None])
    (l_cpu, ref, _), (l_dev, got, no_grad) = runs["cpu"], runs[dev.type]
    out = dict(shape=[batch, size, size, 3], steps=2, bn_bias=beta, image_seed=seed,
               loss_cpu=l_cpu, loss_card=l_dev,
               loss_rel_err=abs(l_dev - l_cpu) / abs(l_cpu), tensors_out_of_bound={},
               elements_out_of_bound=0, max_abs_err_params=0.0, max_abs_err_bn_stats=0.0,
               params_without_grad_on_card=no_grad)
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
    out["ok"] = (out["loss_rel_err"] <= 1e-5 and out["elements_out_of_bound"] == 0
                 and not no_grad)
    log(f"{label}_train_card_vs_cpu_f32", json.dumps(out))
    return out


def without_dropout(model):
    """`model` with every Dropout2d's rate at 0 (the Robust U-Net's blocks)."""
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.rate = 0.0
    return model


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
    result, failures = dict(route=route, save_dir=TRAIN_DIR), []
    save_dir = fresh_dir(TRAIN_DIR)  # extraction_path serves its best checkpoint
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


REPO = os.path.dirname(os.path.abspath(__file__))
PROTOCOL_DIR = os.path.join(REPO, "build", "protocol_path")  # listed in .gitignore
PROTOCOL_ARGS = ["--synthetic", "20", "--epochs", "2", "--image-size", "512",
                 "--dtype", "bfloat16"]  # no --models: the default list of eleven
# each kernel's launches a bf16 eval forward of the protocol's models; every other kernel 0
PROTOCOL_WANT = {"Robust UNet": {"avg_max_pool": 9, "gated_spatial_stats": 9, "cbam_tail": 9,
                                 "fused_conv3x3_bn_relu": 2},
                 "SegNet": {"max_pool_with_indices": 4, "max_unpool": 4,
                            "fused_conv3x3_bn_relu": 2}}
PROTOCOL_WANT.update((name, {k: n for k, n in zoo_want(name, torch.bfloat16).items() if n})
                     for name in ZOO_MODELS)
PARAM_COUNT_KEYS = {"Robust UNet": "RobustUNet", "SegNet": "SegNet", "UNet": "UNet",
                    "DeepLabV3+": "DeepLabV3Plus", "YOLO-SEG": "YOLOSeg", "PSPNet": "PSPNet",
                    "Fast-SCNN": "FastSCNN", "ENet": "ENet", "WaterNet": "WaterNet",
                    "MSWNet": "MSWNet", "HRNet-Water": "HRNetWater",
                    "SegFormer-Lite": "SegFormerLite"}


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in ALL_COUNTERS.items()}


def launches_since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


class CountingEvaluator(Evaluator):
    """The protocol's `Evaluator` with the kernel launches of every
    eval-mode forward of its model (forward hooks) and of every train epoch
    (train steps: gather, forward, loss, backward, Adam) recorded, and each
    train epoch timed on the host clock, ending in a synchronize."""

    made = []

    def __init__(self, model, config, augment_fn=None, device="cuda", **kw):
        super().__init__(model, config, augment_fn, device, **kw)
        self.arch = next(n for n in bench_all.DEFAULT_BENCH_MODELS
                         if isinstance(model, model_class(n)))
        self.eval_forwards, self.train_epochs, self._before = [], [], None
        model.register_forward_pre_hook(self._pre)
        model.register_forward_hook(self._post)
        CountingEvaluator.made.append(self)

    def _pre(self, module, args):
        if not module.training:
            self._before = launch_counts()

    def _post(self, module, args, out):
        if not module.training:
            self.eval_forwards.append(launches_since(self._before))

    def _run_train_epoch(self, state, ds, idx, valid):
        torch.cuda.synchronize()
        before, t0 = launch_counts(), time.perf_counter()
        out = super()._run_train_epoch(state, ds, idx, valid)
        torch.cuda.synchronize()
        self.train_epochs.append(dict(s=time.perf_counter() - t0, steps=len(idx),
                                      launches=launches_since(before)))
        return out


def protocol_cli(dev):
    """(a) and (b): `cli/bench_all.main` on 20 synthetic 512^2 tiles (16
    train, 4 val), both models at full width, 2 epochs, bf16, batch 2,
    throughput batch 64, with every launch counter at 0 just before."""
    os.makedirs(PROTOCOL_DIR, exist_ok=True)
    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    CountingEvaluator.made.clear()
    bench_all.Evaluator = CountingEvaluator
    try:
        t0 = time.perf_counter()
        rc = bench_all.main(PROTOCOL_ARGS + ["--out-dir", PROTOCOL_DIR, "--device", str(dev)])
        run_s = time.perf_counter() - t0
    finally:
        bench_all.Evaluator = Evaluator
    launches = launch_counts()
    failures = [] if rc == 0 else [f"bench_all exited {rc}"]
    with open(os.path.join(PROTOCOL_DIR, "benchmark_results.json")) as f:
        bench = json.load(f)
    with open(os.path.join(REPO, "baselines", "reference_param_counts.json")) as f:
        reference_counts = json.load(f)
    result = dict(args=PROTOCOL_ARGS, rc=rc, run_s=run_s, launches=launches, models={})
    accounted = dict.fromkeys(launches, 0)
    for ev in CountingEvaluator.made:
        name = ev.arch
        want = dict.fromkeys(launches, 0) | PROTOCOL_WANT[name]
        hist, res = bench["histories"][name], bench["results"][name]
        n_params, n_ref = bench["param_counts"][name], reference_counts[PARAM_COUNT_KEYS[name]]
        bad_forwards = [f for f in ev.eval_forwards if f != want]
        train_launches = {k: sum(e["launches"][k] for e in ev.train_epochs) for k in launches}
        for k in launches:
            accounted[k] += train_launches[k] + sum(f[k] for f in ev.eval_forwards)
        steps = sum(e["steps"] for e in ev.train_epochs)
        warm = ev.train_epochs[1:]
        result["models"][name] = dict(
            params=n_params, reference_params=n_ref, train_loss=hist["train_loss"],
            val_loss=hist["val_loss"], val_iou=hist["val_iou"], results=res,
            eval_forwards=len(ev.eval_forwards), launches_per_eval_forward=want,
            eval_forwards_off_count=len(bad_forwards), train_steps=steps,
            train_epoch_launches=train_launches, epoch_s=[e["s"] for e in ev.train_epochs],
            train_img_per_s_warm=(sum(e["steps"] for e in warm) * ev.config.batch_size
                                  / sum(e["s"] for e in warm) if warm else None))
        log(f"protocol_{label(name)}", json.dumps(result["models"][name]))
        if n_params != n_ref:
            failures.append(f"{name} has {n_params} parameters, the reference {n_ref}")
        if not all(np.isfinite(hist["train_loss"] + hist["val_loss"])):
            failures.append(f"{name}: non-finite losses {hist}")
        if not hist["train_loss"][-1] < hist["train_loss"][0]:
            failures.append(f"{name}: train loss did not fall: {hist['train_loss']}")
        if bad_forwards or not ev.eval_forwards:
            failures.append(f"{name}: {len(bad_forwards)} of {len(ev.eval_forwards)} eval "
                            f"forwards launched other than {want}: {bad_forwards[:2]}")
        if any(train_launches.values()) or steps == 0:
            failures.append(f"{name}: kernels launched in {steps} train steps: {train_launches}")
    if (list(result["models"]) != bench_all.DEFAULT_BENCH_MODELS
            or list(bench["results"]) != bench_all.DEFAULT_BENCH_MODELS):
        failures.append(f"benchmark_results.json holds {list(bench['results'])}")
    if accounted != launches:
        failures.append(f"launches outside the counted forwards and epochs: {launches} "
                        f"vs {accounted}")
    result["failures"] = failures
    return result


def protocol_step_times(dev, sds, images, masks, batch=8):
    """(d) One protocol train step (gather, forward, BCE, backward, Adam with
    wd 1e-4) at batch 8, 512^2, bf16, for SegNet, the Robust U-Net under
    each `remat` flavor and the nine other zoo models: CUDA events over
    back-to-back steps, peak memory, the kernel launches in them (none may
    run), and a profile of one step by kernel class, whose idle share shows
    how much of a step's cost is the host's (the "conv" policy dispatches
    every op through Python)."""
    idx, valid = batch_indices(batch, batch, shuffle=False, rng=np.random.default_rng(0))
    cfg = TrainConfig(batch_size=batch)
    out = {}
    runs = [("SegNet", None), ("Robust UNet", False), ("Robust UNet", True),
            ("Robust UNet", "conv")] + [(name, None) for name in ZOO_MODELS]
    for name, remat in runs:
        tag = label(name) + ("" if remat is None else f"_remat_{remat}")
        model = create_model(name, dtype=torch.bfloat16,
                             **({} if remat is None else {"remat": remat}))
        model.load_state_dict(sds[name], strict=True)
        state = create_train_state(model, cfg, device=dev)
        epoch = make_train_epoch(model, cfg, device=dev)

        def step():
            return epoch(state, images, masks, idx, valid, per_step=True)

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        ms = cuda_ms(step, 10, warmup=1)
        entry = dict(step_b8_bf16_ms=ms, train_img_per_s=batch / ms * 1e3,
                     peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
                     kernel_launches=sum(launches_since(before).values()))
        entry["profile"] = profile_forward(step, f"{tag}_train_profile_step_b8_bf16",
                                           classes=_TRAIN_CLASSES)
        out[tag] = entry
        log(f"{tag}_train_step", json.dumps({k: v for k, v in entry.items() if k != "profile"}))
        del model, state, epoch
        torch.cuda.empty_cache()
    return out


def remat_bit_equal(dev, sd, images, masks, batch=8):
    """(d) One bf16 step of the full-width Robust U-Net at batch 8, 512^2,
    dropout on (the default rates), under `torch.use_deterministic_algorithms`
    for each `remat` flavor from the same weights and generator seed: the
    parameters, BN statistics and generator after it must equal
    `remat=False`'s bit for bit (a recompute that drew new masks or moved BN
    statistics again would not)."""
    idx, valid = batch_indices(batch, batch, shuffle=False, rng=np.random.default_rng(0))
    cfg = TrainConfig(batch_size=batch)
    runs = {}
    with deterministic():
        for remat in (False, True, "conv"):
            model = create_model("Robust UNet", dtype=torch.bfloat16, remat=remat)
            model.load_state_dict(sd, strict=True)
            state = create_train_state(model, cfg, device=dev)
            make_train_epoch(model, cfg, device=dev)(state, images, masks, idx, valid)
            runs[remat] = ({k: v.clone() for k, v in model.state_dict().items()},
                           state.generator.get_state())
            del model, state
            torch.cuda.empty_cache()
    ref, ref_gen = runs[False]
    out = {f"remat_{r}": dict(state_dict_bit_equal=all(torch.equal(runs[r][0][k], ref[k])
                                                       for k in ref),
                              generator_equal=torch.equal(runs[r][1], ref_gen))
           for r in (True, "conv")}
    log("robust_unet_remat_bit_equal", json.dumps(out))
    return out


def dropout_check(dev, p=0.2, shape=(64, 512, 32, 32)):
    """(e) Dropout2d on the card: whole (sample, channel) maps kept or
    zeroed, the kept share within 4 sigma of 1 - p, the kept maps equal
    x / (1 - p)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(shape, device=dev, generator=gen) + 0.5
    drop = Dropout2d(p).train()
    drop.generator = gen
    y = drop(x)
    nonzero = (y != 0).flatten(2)
    kept = nonzero.all(2)
    share, sigma = float(kept.float().mean()), float(np.sqrt(p * (1 - p) / kept.numel()))
    out = dict(shape=list(shape), rate=p, kept_share=share, sigma=sigma,
               whole_maps=bool(torch.equal(kept, nonzero.any(2))),
               kept_scaled=bool(torch.equal(y[kept], (x / (1 - p))[kept])))
    out["ok"] = out["whole_maps"] and out["kept_scaled"] and abs(share - (1 - p)) <= 4 * sigma
    log("dropout2d_on_card", json.dumps(out))
    return out


# The card-vs-CPU f32 check for each protocol model: (weights, BN shift, image
# seed, images a step), from `card_vs_cpu_scan` (PERF.md §6). The Robust U-Net
# with the main path's bridge weights, BN biases at 6 (5 of 6 image seeds inside
# every bound; its kaiming fan_out constructor init 2 of 18 seed and shift
# pairs); SegNet with its constructor's torch-default init, BN biases at 3 (4 of
# 6; at 6, BN statistics below the last unpool fell outside at every seed). The
# zoo's nine with `zoo_state_dict`'s weights: BN biases at 6 (all 6 seeds inside
# for DeepLabV3+, YOLO-SEG, ENet, WaterNet and MSWNet, 5 for Fast-SCNN), at 2
# for HRNet-Water and SegFormer-Lite (6 of 6; at 6, 4 of 6); PSPNet at 0 with 8
# images a step (6 of 6): with 2 its pyramid's level-1 BN normalises two values
# a channel, and at every shift 597 to 7,206 values fell outside, and BN biases
# at 2 or 6 raise the pooled features' mean over their spread, which the BN's
# float32 E[x^2] - mean^2 turns into noise (at 8 images, 1 to 255 outside).
CARD_VS_CPU = {"Robust UNet": ("bridge", 6.0, 3, 2), "SegNet": ("ctor", 3.0, 3, 2),
               "DeepLabV3+": ("zoo", 6.0, 3, 2), "YOLO-SEG": ("zoo", 6.0, 3, 2),
               "PSPNet": ("zoo", 0.0, 3, 8), "Fast-SCNN": ("zoo", 6.0, 3, 2),
               "ENet": ("zoo", 6.0, 3, 2), "WaterNet": ("zoo", 6.0, 3, 2),
               "MSWNet": ("zoo", 6.0, 3, 2), "HRNet-Water": ("zoo", 2.0, 3, 2),
               "SegFormer-Lite": ("zoo", 2.0, 3, 2)}


def init_state_dict(name, init):
    """A protocol model's weights: its constructor's init ("ctor"), the
    bridge's random JAX-layout weights ("bridge"; Robust U-Net and SegNet) or
    `zoo_state_dict` ("zoo")."""
    if init == "ctor":
        return create_model(name).state_dict()
    if init == "zoo":
        return zoo_state_dict(name)
    return {"Robust UNet": lambda: robust_unet_state_dict(random_robust_unet_variables(seed=0)),
            "SegNet": lambda: segnet_state_dict(random_segnet_variables(seed=0))}[name]()


def card_vs_cpu_scan(dev=None, seeds=range(6), models=None, betas=(2.0, 3.0, 6.0), batch=2,
                     out_path=None):
    """`train_card_vs_cpu` for each protocol model (`models`, default all of
    `CARD_VS_CPU`) from each of its inits (the Robust U-Net's and SegNet's
    constructor and bridge weights, the zoo's `zoo_state_dict`), with BN
    biases at each of `betas` and each image seed, `batch` images a step:
    how often two f32 Adam steps on the card stay inside the JAX package's
    bounds; the rows go to
    `out_path` (default `build/card_vs_cpu_scan.json`). Not run by `main`;
    on the card: `python -c "import chip_smoke; chip_smoke.card_vs_cpu_scan()"`."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before cuBLAS starts
    dev = dev or torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for name in models or CARD_VS_CPU:
        for init in (("zoo",) if name in ZOO_MODELS else ("ctor", "bridge")):
            sd = init_state_dict(name, init)
            for beta in betas:
                for seed in seeds:
                    out = train_card_vs_cpu(dev, sd, model_fn=lambda n=name: create_model(n),
                                            loss="bce", label=label(name), beta=beta, seed=seed,
                                            batch=batch)
                    rows.append(dict(model=name, init=init, beta=beta, seed=seed, batch=batch,
                                     out_of_bound=out["elements_out_of_bound"],
                                     tensors=out["tensors_out_of_bound"],
                                     loss_rel_err=out["loss_rel_err"], ok=out["ok"]))
    out_path = out_path or os.path.join(REPO, "build", "card_vs_cpu_scan.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def protocol_path(dev, size=512, batch=8, check_size=64, dropout_shape=(64, 512, 32, 32)):
    """The comparison protocol at full width: (a) `cli/bench_all.main` on
    the default list of eleven models, (b) their kernel launches, (c) two
    f32 Adam steps of each at (2, check_size, check_size) on the card
    against the CPU path, (d) batch-8 bf16 train steps at size^2 (the Robust
    U-Net under each `remat` flavor) and `remat`'s bit-equality, (e)
    Dropout2d on the card."""
    result = protocol_cli(dev)
    failures = result.pop("failures")
    sds = {name: init_state_dict(name, "zoo" if name in ZOO_MODELS else "bridge")
           for name in bench_all.DEFAULT_BENCH_MODELS}
    result["card_vs_cpu_f32"] = {}
    for name, (init, beta, seed, check_batch) in CARD_VS_CPU.items():
        check = train_card_vs_cpu(dev, init_state_dict(name, init), size=check_size,
                                  model_fn=lambda n=name: create_model(n), loss="bce",
                                  label=label(name), beta=beta, seed=seed, batch=check_batch)
        result["card_vs_cpu_f32"][name] = check
        if not check["ok"]:
            failures.append(f"{name}: f32 train steps on the card disagree with the CPU path "
                            f"or leave parameters without a gradient")
    images, masks, route = coast_tiles(batch, size, seed=3)
    images = torch.from_numpy(images).to(dev)
    masks = torch.from_numpy(masks).to(dev)
    result["train_steps"] = protocol_step_times(dev, sds, images, masks, batch=batch)
    if any(e["kernel_launches"] for e in result["train_steps"].values()):
        failures.append("a protocol train step launched a kernel")
    result["remat"] = remat_bit_equal(dev, sds["Robust UNet"], images, masks, batch=batch)
    if not all(all(v.values()) for v in result["remat"].values()):
        failures.append(f"remat flavors differ from remat=False: {result['remat']}")
    result["dropout"] = dropout_check(dev, shape=dropout_shape)
    if not result["dropout"]["ok"]:
        failures.append(f"Dropout2d on the card: {result['dropout']}")
    log("protocol_path", json.dumps(dict(
        run_s=result["run_s"], launches=result["launches"],
        train_steps={k: {m: v for m, v in e.items() if m != "profile"}
                     for k, e in result["train_steps"].items()})))
    if failures:
        raise AssertionError("protocol path: " + "; ".join(failures))
    return result


GRANULE = 10980  # a Sentinel-2 L1C tile: 109.8 km at 10 m, 120.6 Mpx
TRAIN_DIR = os.path.join(REPO, "build", "train_path")  # listed in .gitignore
EXTRACT_DIR = os.path.join(REPO, "build", "extraction_path")


def fresh_dir(path):
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def tiled_scene(size, seed, tile=512, n_unique=24):
    """A size^2 synthetic scene and its ground-truth water mask, assembled
    from the port's `make_scene` tiles as `scripts/bench_scene_e2e.py`
    assembles its 2048^2 one; at most `n_unique` distinct tiles repeat over
    the grid, so that a granule takes seconds to build."""
    rng = np.random.default_rng(seed)
    k = -(-size // tile)
    pairs = [make_scene(rng, tile)[:2] for _ in range(min(n_unique, k * k))]
    scene = np.empty((k * tile, k * tile, 3), np.uint8)
    truth = np.empty((k * tile, k * tile), np.uint8)
    for r in range(k):
        for c in range(k):
            img, m = pairs[(r * k + c) % len(pairs)]
            scene[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = img
            truth[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = m
    return np.ascontiguousarray(scene[:size, :size]), np.ascontiguousarray(truth[:size, :size])


def write_five_band_tif(path, img, rng):
    """A 5-band uint8 GeoTIFF (PIL, no geotransform) whose NIR-R-G
    combination (bands 4, 3, 2) is `img`'s RGB."""
    from PIL import Image

    bands = [rng.integers(0, 255, img.shape[:2], dtype=np.uint8), img[..., 1], img[..., 2],
             img[..., 1], img[..., 0]]
    frames = [Image.fromarray(b) for b in bands]
    frames[0].save(path, save_all=True, append_images=frames[1:])


def granule_check(ex, dev, size, batch, dilation, seed=7):
    """The extractor's `predict_scene` over one size^2 scene with the band
    on, counted, timed and held against the host tiling path; then the
    dilation at the granule's shape against its plain version, and the
    native tracer on the band."""
    scene, truth = tiled_scene(size, seed)
    tile = ex.image_size
    overlap = tile // 8
    n_side = -(-(size - overlap) // (tile - overlap))
    n_chunks = -(-n_side * n_side // batch)
    ex.predict_masks_batch(np.zeros((batch, tile, tile, 3), np.uint8))  # warm-up, uncounted
    sync(dev)
    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mask, band = ex.predict_scene(scene, batch=batch, with_band=dilation)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None
    want = dict.fromkeys(launches, 0) | {"fused_conv3x3_bn_relu": 2 * n_chunks, "dilate_disk": 1}
    t0 = time.perf_counter()
    host_mask, host_band = ex.predict_scene(scene, batch=batch, with_band=dilation,
                                            device_pipeline=False)
    host_s = time.perf_counter() - t0
    host_equal = bool(np.array_equal(mask, host_mask) and np.array_equal(band, host_band))
    del host_mask, host_band

    # device times with the scene already on the card (no transfers)
    scene_dev = torch.from_numpy(scene).to(dev)
    run = build_scene_fn(ex._predict_fn, size, size, 3, tile, overlap, batch,
                         band_dilation=dilation)
    pipeline_ms = cuda_ms(lambda: run(scene_dev), 1, 0)
    chunk = scene_dev[:tile, :tile][None].expand(batch, -1, -1, -1).contiguous()
    forwards_ms = cuda_ms(lambda: ex._predict_fn(chunk), 5) * n_chunks
    cut_and_stitch = build_scene_fn(lambda c: c[..., 0].contiguous(), size, size, 3, tile,
                                    overlap, batch)
    tile_stitch_ms = cuda_ms(lambda: cut_and_stitch(scene_dev), 2, 1)
    mask_dev = torch.from_numpy(mask).to(dev)
    band_ms = cuda_ms(lambda: coastline_band(mask_dev, dilation, device=dev), 5)
    del scene_dev, chunk

    # the kernel at the granule's shape, against its plain version
    ker = elliptical_kernel(dilation)
    binary = (mask_dev > 0).to(torch.uint8)[None].contiguous()
    got = dilate_disk(binary, ker)
    sync(dev)
    ref = dilate_disk_plain(binary, ker)
    dilate_equal = bool(torch.equal(got, ref))
    groups = se_row_groups(ker)
    ops_px = max(hi - lo for (lo, hi), _ in groups) + sum(len(s) for _, s in groups)
    dil_bound_ms, dil_bound_by = bound(2 * binary.numel(), ops_px * binary.numel(), PEAK_F32_OPS)
    dilate = dict(shape=list(binary.shape), size=dilation, equal_to_plain=dilate_equal,
                  max_abs_err=float((got.float() - ref.float()).abs().max()),
                  ms=cuda_ms(lambda: dilate_disk(binary, ker), 20),
                  device_ms=device_ms(lambda: dilate_disk(binary, ker), 20),
                  plain_ms=cuda_ms(lambda: dilate_disk_plain(binary, ker), 2, 1),
                  library_ms=cuda_ms(lambda: conv_threshold_dilate(binary, ker), 2, 1),
                  bound_ms=dil_bound_ms, bound_by=dil_bound_by,
                  byte_bound_ms=2 * binary.numel() / PEAK_BYTES_PER_S * 1e3)
    dilate["share_of_bound"] = dil_bound_ms / dilate["device_ms"]
    del got, ref, binary, mask_dev
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lines = extract_contours(band, backend="native")
    contour_s = time.perf_counter() - t0
    inter = np.logical_and(mask > 0, truth > 0).sum()
    union = np.logical_or(mask > 0, truth > 0).sum()
    out = dict(scene=[size, size], tile=tile, overlap=overlap, batch=batch, chunks=n_chunks,
               dilation=dilation, dtype=str(ex.model.dtype),
               upload_mb=scene.nbytes / 1e6, launches=launches, want_launches=want,
               wall_s=wall_s, host_path_s=host_s, host_path_equal=host_equal,
               pipeline_device_ms=pipeline_ms, forwards_ms=forwards_ms,
               tile_and_stitch_ms=tile_stitch_ms, band_ms=band_ms, peak_memory_gb=peak_gb,
               contour_s=contour_s, contours=len(lines),
               contour_points=int(sum(len(p) for p in lines)),
               band_pixels=int(band.sum()), water_fraction=float(mask.mean()),
               iou_vs_truth=float(inter / max(union, 1)), dilate_granule=dilate)
    log("extraction_granule", json.dumps(out))
    failures = []
    if launches != want:
        failures.append(f"granule launches {launches}, want {want}")
    if mask.shape != (size, size) or band.shape != (size, size) or not set(np.unique(mask)) <= {0, 1}:
        failures.append(f"bad granule mask {mask.shape} or band {band.shape}")
    if not host_equal:
        failures.append("the device scene pipeline differs from the host tiling path")
    if not dilate_equal:
        failures.append(f"dilate_disk at {dilate['shape']} differs from its plain version")
    if not lines:
        failures.append("no contour traced from the granule's band")
    return out, failures


def scene_card_vs_cpu(save_dir, dev, shape=(700, 900), tile=128, overlap=16, dilation=20,
                      seed=11):
    """The f32 scene path on the card against the port's CPU path (TF32
    off): masks on >= 99.9% of pixels (float32 sums in another order flip
    near ties), the card's band equal to the CPU band of the card's mask."""
    scene = tiled_scene(max(shape), seed)[0][:shape[0], :shape[1]].copy()
    card = CoastlineExtractor(checkpoint_dir=save_dir, image_size=tile, device=dev)
    mask, band = card.predict_scene(scene, batch=8, overlap=overlap, with_band=dilation)
    cpu = CoastlineExtractor(checkpoint_dir=save_dir, image_size=tile, device="cpu")
    t0 = time.perf_counter()
    cpu_mask = cpu.predict_scene(scene, batch=8, overlap=overlap)
    cpu_s = time.perf_counter() - t0
    out = dict(shape=list(shape), tile=tile, overlap=overlap,
               mask_agreement=float(np.mean(mask == cpu_mask)),
               band_equal=bool(np.array_equal(
                   band, coastline_band(mask, dilation, device="cpu").numpy())),
               water_fraction=float(mask.mean()), cpu_s=cpu_s)
    log("extraction_card_vs_cpu", json.dumps(out))
    failures = []
    if out["mask_agreement"] < 0.999 or not out["band_equal"]:
        failures.append(f"scene on the card against the CPU path: {out}")
    return out, failures


def scene_pipelining(ex, root, size, batch, dilation, years=(2019, 2021, 2024)):
    """`extract_scenes` over three same-size scenes, pipelined (depth 2)
    against sequential (depth 1): equal results, both wall times."""
    from PIL import Image

    paths = []
    for i, year in enumerate(years):
        paths.append(os.path.join(root, f"scene_{year}.png"))
        Image.fromarray(tiled_scene(size, 20 + i)[0]).save(paths[-1])
    runs = {}
    for depth in (1, 2):
        out = os.path.join(root, f"depth{depth}")
        sync(ex.device)
        t0 = time.perf_counter()
        results = ex.extract_scenes(paths, out, dilation, batch=batch, pipeline_depth=depth)
        runs[depth] = (time.perf_counter() - t0, results, out)
    seq, piped = runs[1][1], runs[2][1]
    equal = all(a is not None and b is not None and np.array_equal(a["water_mask"], b["water_mask"])
                and np.array_equal(a["coastline_mask"], b["coastline_mask"])
                and a["coastlines"] == b["coastlines"] for a, b in zip(seq, piped))
    out = dict(scenes=len(paths), size=size, sequential_s=runs[1][0], pipelined_s=runs[2][0],
               equal=equal, coastlines=[r["coastline_count"] for r in piped if r])
    log("extraction_pipelining", json.dumps(out))
    return out, runs[2][2], ([] if equal else ["pipelined extract_scenes differs from sequential"])


def run_clis(jobs, log_dir, timeout=600):
    """Run `python -m <module> <args>` for every job at once, from the repo
    root; {name: {"rc", "s"}}. Every process is stopped before returning."""
    procs, out = {}, {}
    t0 = time.perf_counter()
    try:
        for name, argv in jobs.items():
            f = open(os.path.join(log_dir, f"{name}.log"), "w")
            procs[name] = (subprocess.Popen([sys.executable, "-m", *argv], cwd=REPO, stdout=f,
                                            stderr=subprocess.STDOUT, text=True), f)
        while len(out) < len(procs):
            for name, (p, f) in procs.items():
                if name not in out and p.poll() is not None:
                    out[name] = dict(rc=p.returncode, s=time.perf_counter() - t0)
            if time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.05)
    finally:
        for name, (p, f) in procs.items():
            if p.poll() is None:
                p.kill()
                p.wait()
                out.setdefault(name, dict(rc="killed", s=time.perf_counter() - t0))
            f.close()
    return out


def cli_checks(save_dir, dev, root, scene_dir, dilation, years, scene_size, tile=512,
               cli_scene=(1500, 2048)):
    """The four CLIs end to end as subprocesses: convert on a 5-band TIFF
    year tree, predict on one PNG, a --batch directory of 8 and a --scene
    TIFF, change over the pipelined scenes' dated polylines, export of the
    trainer's checkpoint, then predict --torch-checkpoint of the export,
    whose masks must equal --checkpoint's; and the int8 runs: predict --int8
    --save-quantized on the PNG, export --quantized-out --calib-images on
    the directory, then predict --batch --quantized of the saved .npz."""
    import importlib.util

    from PIL import Image

    rng = np.random.default_rng(5)
    for year in (2021, 2022):
        os.makedirs(os.path.join(root, "tifs", str(year)))
        write_five_band_tif(os.path.join(root, "tifs", str(year), f"coast_{year}.tif"),
                            tiled_scene(600, year)[0][:, :500], rng)
    os.makedirs(os.path.join(root, "batch"))
    for i in range(8):
        Image.fromarray(tiled_scene(512, 40 + i)[0]).save(os.path.join(root, "batch", f"t{i}.png"))
    Image.fromarray(tiled_scene(512, 50)[0]).save(os.path.join(root, "single.png"))
    write_five_band_tif(os.path.join(root, "granule_cut.tif"),
                        tiled_scene(max(cli_scene), 51)[0][:cli_scene[0], :cli_scene[1]], rng)
    logs = fresh_dir(os.path.join(root, "logs"))

    def out(name):
        return os.path.join(root, name)

    predict = ["coastline_torch.cli.predict", "--dilation", str(dilation), "--image-size",
               str(tile), "--device", str(dev)]
    shorelines = [os.path.join(scene_dir, f"scene_{y}_coastlines.json") for y in years]
    jobs = {
        "convert": ["coastline_torch.cli.convert", "--input", out("tifs"), "--output",
                    out("converted")],
        "predict_single": predict + [out("single.png"), "--checkpoint", save_dir, "--output",
                                     out("single_out")],
        "predict_batch": predict + [out("batch"), "--batch", "--checkpoint", save_dir,
                                    "--output", out("batch_out")],
        "predict_scene": predict + [out("granule_cut.tif"), "--scene", "--checkpoint", save_dir,
                                    "--output", out("scene_out")],
        "change": ["coastline_torch.cli.change", *shorelines, "--baseline",
                   f"0,{scene_size // 2} {scene_size - 1},{scene_size // 2}",
                   "--spacing", "128", "--length", "1000", "--output-dir", out("change_out")],
        "export": ["coastline_torch.cli.export", "--checkpoint-dir", save_dir, "--out",
                   out("model.pth"), "--device", str(dev)],
        "predict_int8": predict + [out("single.png"), "--checkpoint", save_dir, "--int8",
                                   "--save-quantized", out("cli_int8.npz"), "--output",
                                   out("int8_out")],
        "export_int8": ["coastline_torch.cli.export", "--checkpoint-dir", save_dir,
                        "--quantized-out", out("export_int8.npz"), "--calib-images",
                        out("batch"), "--image-size", str(tile), "--device", str(dev)],
    }
    runs = run_clis(jobs, logs)
    runs.update(run_clis({
        "predict_batch_pth": predict + [out("batch"), "--batch", "--torch-checkpoint",
                                        out("model.pth"), "--output", out("batch_pth_out")],
        "predict_batch_quantized": predict + [out("batch"), "--batch", "--quantized",
                                              out("cli_int8.npz"), "--output",
                                              out("batch_int8_out")]}, logs))
    figures = importlib.util.find_spec("matplotlib") is not None  # the figures need it

    def extraction_set(base):
        return [f"{base}_water_mask.png", f"{base}_coastline_mask.png",
                f"{base}_coastlines.json"] + ([f"{base}_analysis.png"] if figures else [])

    want = {
        "convert": ["converted/coast_2021.png", "converted/coast_2022.png",
                    "metadata/coast_2021.json", "metadata/coast_2022.json",
                    "conversion_summary.json"],
        "predict_single": extraction_set("single"),
        "predict_batch": [f for i in range(8) for f in extraction_set(f"t{i}")],
        "predict_scene": extraction_set("granule_cut"),
        "change": ["shoreline_change.json"] + (["shoreline_change.png"] if figures else []),
        "predict_batch_pth": [f for i in range(8) for f in extraction_set(f"t{i}")],
        "predict_int8": extraction_set("single") + ["../cli_int8.npz"],
        "export_int8": ["export_int8.npz"],
        "predict_batch_quantized": [f for i in range(8) for f in extraction_set(f"t{i}")],
    }
    dirs = {"convert": "converted", "predict_single": "single_out", "predict_batch": "batch_out",
            "predict_scene": "scene_out", "change": "change_out",
            "predict_batch_pth": "batch_pth_out", "predict_int8": "int8_out", "export_int8": ".",
            "predict_batch_quantized": "batch_int8_out"}
    failures = [f"cli {name} exited {r['rc']}: see {os.path.join(logs, name + '.log')}"
                for name, r in runs.items() if r["rc"] != 0]
    for name, files in want.items():
        missing = [f for f in files if not os.path.exists(os.path.join(out(dirs[name]), f))]
        runs[name]["artifacts"] = len(files) - len(missing)
        if missing:
            failures.append(f"cli {name} did not write {missing}")
    if not failures:
        sd = torch.load(out("model.pth"), map_location="cpu", weights_only=True)
        UNet(n_classes=2).load_state_dict(sd, strict=True)
        same = [np.array_equal(*(np.asarray(Image.open(os.path.join(out(d), f"t{i}_water_mask.png")))
                                 for d in ("batch_out", "batch_pth_out"))) for i in range(8)]
        runs["export"]["pth_masks_equal_checkpoint_masks"] = all(same)
        scene_mask = np.asarray(Image.open(os.path.join(out("scene_out"),
                                                        "granule_cut_water_mask.png")))
        runs["predict_scene"]["mask_shape"] = list(scene_mask.shape)
        with open(os.path.join(out("converted"), "conversion_summary.json")) as f:
            runs["convert"]["converted_files"] = json.load(f)["converted_files"]
        with open(os.path.join(out("change_out"), "shoreline_change.json")) as f:
            change = json.load(f)
        runs["change"].update(transects=len(change["transects"]),
                              with_rate=change["n_transects_with_rate"])
        exported = quant_deploy.load_quantized(out("export_int8.npz"), device="cpu")
        runs["export_int8"]["arch"] = exported.arch
        runs["export_int8"]["sites"] = len(exported.scales)
        if exported.arch != "unet":
            failures.append(f"export --quantized-out wrote arch {exported.arch!r}")
        if not all(same):
            failures.append("the exported .pth serves other masks than its checkpoint")
        if scene_mask.shape != tuple(cli_scene):
            failures.append(f"--scene mask {scene_mask.shape}, want the TIFF's {cli_scene}")
        if runs["convert"]["converted_files"] != 2 or not change["transects"]:
            failures.append(f"convert or change produced nothing: {runs}")
    runs["figures"] = figures
    log("extraction_clis", json.dumps(runs))
    return runs, failures


def extraction_path(dev, save_dir=TRAIN_DIR, size=GRANULE, tile=512, batch=8, dilation=20,
                    check_shape=(700, 900), check_tile=128, pipe_size=2048,
                    cli_scene=(1500, 2048)):
    """The extraction path on the card, serving `train_path`'s best
    checkpoint: (1) a bf16 `CoastlineExtractor(checkpoint_dir=)` predicts a
    size^2 granule through `predict_scene(batch=8, with_band=20)`, counted,
    against the host tiling path, with the dilation at the granule's shape
    against its plain version and the native tracer on the band; (2) the f32
    scene path against the CPU; (3) `extract_scenes` pipelined against
    sequential over three 2048^2 scenes; (4) the CLIs as subprocesses. No
    check depends on how well the checkpoint learned."""
    t0 = time.perf_counter()
    root = fresh_dir(EXTRACT_DIR)
    ex = CoastlineExtractor(checkpoint_dir=save_dir, dtype=torch.bfloat16, image_size=tile,
                            device=dev)
    result, failures = {}, []
    result["granule"], fails = granule_check(ex, dev, size, batch, dilation)
    failures += fails
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result["card_vs_cpu"], fails = scene_card_vs_cpu(save_dir, dev, check_shape, check_tile,
                                                     check_tile // 8, dilation)
    failures += fails
    years = (2019, 2021, 2024)
    result["pipelining"], scene_dir, fails = scene_pipelining(ex, root, pipe_size, batch, dilation,
                                                              years)
    failures += fails
    del ex
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result["clis"], fails = cli_checks(save_dir, dev, root, scene_dir, dilation, years,
                                       pipe_size, tile, cli_scene)
    failures += fails
    result["s"] = time.perf_counter() - t0
    log(f"extraction_path {result['s']:.1f} s")
    if failures:
        raise AssertionError("extraction path: " + "; ".join(failures))
    return result


INT8_DIR = os.path.join(REPO, "build", "int8_path")  # listed in .gitignore
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate
# int8 conv launches a forward under the default policy (`infer/quant.py`)
INT8_CONVS = {"unet": 21, "robust_unet": 38, "segnet": 18, "waternet": 16, "mswnet": 18,
              "hrnet_water": 6, "pspnet": 8, "deeplabv3p": 10, "yoloseg": 8, "fastscnn": 13,
              "enet": 2, "segformer_lite": 19}
# sites a forward quantizes in an int8 conv's epilogue and eagerly (`site_counts`)
INT8_SITES = {"unet": dict(fused=21, eager=6), "robust_unet": dict(fused=28, eager=25),
              "segnet": dict(fused=18, eager=2), "waternet": dict(fused=16, eager=8),
              "mswnet": dict(fused=10, eager=9), "hrnet_water": dict(fused=6, eager=6),
              "pspnet": dict(fused=4, eager=7), "deeplabv3p": dict(fused=6, eager=5),
              "yoloseg": dict(fused=8, eager=5), "fastscnn": dict(fused=11, eager=23),
              "enet": dict(fused=1, eager=44), "segformer_lite": dict(fused=6, eager=20)}
# the int8 eval forwards of `int8_path` (the UNet's is its serving path), by
# registry name, with the card-vs-CPU mask limit of `int8_eval`
INT8_EVAL = {"robust_unet": ("Robust UNet", 0.99), "segnet": ("SegNet", 0.99),
             "waternet": ("WaterNet", 0.99), "mswnet": ("MSWNet", 0.99),
             "hrnet_water": ("HRNet-Water", 0.99), "pspnet": ("PSPNet", 0.99),
             "deeplabv3p": ("DeepLabV3+", 0.99), "yoloseg": ("YOLO-SEG", 0.99),
             "fastscnn": ("Fast-SCNN", 0.99), "enet": ("ENet", 0.99),
             "segformer_lite": ("SegFormer-Lite", 0.99)}


def _config(x, w, padding, lhs, dtype, act, codes, stride=1, dilation=1):
    """A key of `int8_conv_configs`."""
    return (x, w, json.dumps(normalize_padding(padding)), dilation, lhs, str(dtype), act, codes,
            stride)


# modes of the kernel that no forward takes, held beside the forwards' own
# configurations (at the shapes of the forward whose conv they vary): the
# leaky epilogue in values mode (YOLO-SEG's c2, bf16 and float32), ENet's 3x3
# transposed conv and SegFormer-Lite's stride-4 reduction in values mode
EXTRA_INT8_CONFIGS = [
    _config((8, 128, 128, 64), (3, 3, 64, 128), 1, None, torch.bfloat16, "leaky", False),
    _config((8, 128, 128, 64), (3, 3, 64, 128), 1, None, torch.float32, "leaky", False),
    _config((8, 64, 64, 128), (3, 3, 128, 64), ((1, 2), (1, 2)), (2, 2), torch.bfloat16,
            "relu", False),
    _config((8, 64, 64, 64), (4, 4, 64, 64), 0, None, torch.bfloat16, "none", False, stride=4),
]


def int8_conv_configs(forwards):
    """{config: {arch: calls a forward}} over one call of each `forwards[arch]`:
    the distinct (input shape, weight shape, padding, dilation, lhs dilation,
    output dtype, activation, codes, stride) the int8 forwards hand the
    kernel; codes is True where the kernel quantizes to a site's codes
    (`out_step`)."""
    configs, real = {}, quant.int8_conv

    def spy(x, w, x_step, w_step, bias, padding=0, dilation=1, lhs_dilation=None,
            out_dtype=torch.float32, act="none", out_step=None, stride=1):
        key = _config(tuple(x.shape), tuple(w.hwio.shape), padding,
                      None if lhs_dilation is None else tuple(lhs_dilation), out_dtype, act,
                      out_step is not None, stride, dilation)
        per = configs.setdefault(key, {})
        per[arch] = per.get(arch, 0) + 1
        return real(x, w, x_step, w_step, bias, padding, dilation, lhs_dilation, out_dtype,
                    act=act, out_step=out_step, stride=stride)

    quant.int8_conv = spy
    try:
        for arch, fn in forwards.items():
            fn()
    finally:
        quant.int8_conv = real
    return configs


def check_int8_conv(dev, configs, iters=10):
    """The int8 conv at every configuration of `configs`, in its mode
    (values, or codes of a site; no activation, ReLU or leaky ReLU):
    bit-equal to its plain version (float64 cuDNN on the codes, then the
    same epilogue, activation and site arithmetic); events ms, device ms,
    the plain version's ms, and the library yardstick: the same conv in bf16
    through cuDNN with the float32 epilogue, what the float path runs there,
    and the eager activation and, in codes mode, site chain it replaces. Codes mode is held at two steps: a
    power of two near max|y| / 100, where bf16 values land on exact .5 ties
    (the kernel's exact path) and past the clamp, and float32(max|y| / 127),
    a step as calibration makes it, at which it is timed. Where the
    configuration is a plain GEMM (a 1x1 conv, the
    transposed convs' parity sub-GEMMs) `torch._int_mm` at (M, K) x (K, N)
    is timed too, the int8 tensor-core yardstick. Bound: each input byte
    read once, the output written once (1 byte a code), against 2 * M * N *
    K int8 operations (a transposed conv's K is the taps that reach an
    output pixel, k^2 / 4 * C_in on average: not the 3x3's zero taps)."""
    rng = np.random.default_rng(9)
    cases, failures = [], []
    for (xs, ws, pad_json, dil, lhs, dt_name, act, codes, stride), per in configs.items():
        dt = torch.bfloat16 if dt_name == "torch.bfloat16" else torch.float32
        pad = json.loads(pad_json)
        pad = pad if isinstance(pad, int) else tuple(tuple(p) for p in pad)
        kh, kw, cin, cout = ws
        x = torch.from_numpy(rng.integers(-127, 128, xs, dtype=np.int8)).to(dev)
        wq = torch.from_numpy(rng.integers(-127, 128, ws, dtype=np.int8)).to(dev)
        wstep = torch.from_numpy((rng.random(cout) * 2e-3 + 1e-4).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32)).to(dev)
        wp = packed(wq, lhs is not None)
        step = 0.0371
        out_steps = [None]
        if codes:
            ymax = float(int8_conv_plain(x, wq, step, wstep, bias, pad, dil, lhs, dt,
                                         stride=stride).abs().max())
            out_steps = [2.0 ** math.floor(math.log2(ymax / 100)), float(np.float32(ymax / 127))]

        def kernel(out_step):
            return int8_conv(x, wp, step, wstep, bias, pad, dil, lhs, dt, act=act,
                             out_step=out_step, stride=stride)

        def plain(out_step):
            return int8_conv_plain(x, wq, step, wstep, bias, pad, dil, lhs, dt, act=act,
                                   out_step=out_step, stride=stride)

        equal, err = True, 0.0
        for out_step in out_steps:  # the last one is timed
            got = kernel(out_step)
            sync(dev)
            ref = plain(out_step)
            if codes:
                equal &= got.dtype == torch.int8 and bool(torch.equal(got, ref))
            else:
                bits = torch.int16 if dt == torch.bfloat16 else torch.int32
                equal &= bool(torch.equal(got.view(bits), ref.view(bits)))
            err = max(err, float((got.float() - ref.float()).abs().max()))
        # the library yardstick: the float path's bf16 cuDNN conv + float32
        # epilogue, then the activation and the site's eager quantization it replaces
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wf = wq.to(torch.bfloat16)
        scale = (torch.tensor(step, device=dev) * wstep)[:, None, None]
        step_t = torch.tensor(out_step or 1.0, dtype=torch.float32, device=dev)

        def timed():
            return kernel(out_step)

        def finish(y):
            v = int8_conv_module.activation((y.float() * scale + bias[:, None, None]).to(dt), act)
            return quantize_codes(v, step_t) if codes else v

        if lhs is not None:
            wt = wf.flip(0, 1).permute(2, 3, 0, 1).contiguous()
            lo, hi = normalize_padding(pad)[0]

            def library():
                return finish(F.conv_transpose2d(xb, wt, stride=2, padding=kh - 1 - lo,
                                                 output_padding=hi - lo))
        else:
            (pt, pb), (pl, pr) = normalize_padding(pad)
            wo = wf.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

            def library():
                return finish(F.conv2d(F.pad(xb, (pl, pr, pt, pb)), wo, stride=stride,
                                       dilation=dil))
        m = got.shape[0] * got.shape[1] * got.shape[2]
        k = kh * kw * cin / 4 if lhs is not None else kh * kw * cin
        ops = 2.0 * m * cout * k
        nbytes = x.numel() + wq.numel() + 8 * cout + got.numel() * got.element_size()
        b_ms, b_by = bound(nbytes, ops, PEAK_INT8_OPS)
        case = dict(x=list(xs), w=list(ws), padding=pad, dilation=dil, stride=stride,
                    lhs_dilation=None if lhs is None else list(lhs), out=dt_name, act=act,
                    codes=codes, out_steps=out_steps, per_forward=per, bit_equal=equal,
                    max_abs_err=err, ms=cuda_ms(timed, iters), device_ms=device_ms(timed, iters),
                    plain_ms=cuda_ms(lambda: plain(out_step), 1, 0),
                    library_ms=cuda_ms(library, iters), bound_ms=b_ms, bound_by=b_by,
                    gop=ops / 1e9, int_mm_ms=None)
        if (lhs is not None and kh == 2) or ((kh, kw) == (1, 1) and stride == 1):
            # a plain GEMM (a 1x1, the 2x2 transposed conv's parities): cuBLASLt's int8 GEMM
            a_mat = x.view(-1, cin)
            # (K, N) column-major, N = sub-GEMMs x C_out
            b_mat = pack_weights(wq, lhs is not None).view(-1, cin).t()
            try:
                case["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(a_mat, b_mat), iters)
            except RuntimeError as e:  # a yardstick only: record why it did not run
                case["int_mm_error"] = str(e).splitlines()[0][:200]
        case["share_of_bound"] = b_ms / case["device_ms"]
        cases.append(case)
        if not equal:
            failures.append(f"int8_conv differs from its plain version at {case}")
        del x, wq, got, ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log("int8_conv_cases", json.dumps(cases))
    return cases, failures


def mask_agreement(arch, a, b) -> float:
    """Masks of two NHWC outputs: the UNet's argmax, else probability > 0.5."""
    if arch == "unet":
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())
    return float(((a > 0.5) == (b > 0.5)).float().mean())


# forced_card_vs_cpu's limit on the share of a site's codes that differ, set
# from readings (PERF.md, int8 findings): sound runs move at most 4.8e-7 (one
# code of a 2 Mi-code site; SegNet's `c0`, the Robust U-Net's `rb0.t1`), the
# control `reciprocal_site` moves 3.7e-4 (SegNet `c2`) and 1.0e-3 (Robust
# U-Net `rb0.short`) on the CPU at the same size. One code of the smallest
# site (131,072 codes at 128^2, batch 2) is 7.6e-6.
SITE_CODES_LIMIT = 1e-5


def reciprocal_site(ctx, name, t, optional=False):
    """A control for `forced_card_vs_cpu`: `_Ctx.site` multiplying by the
    step's reciprocal instead of dividing, a rounding that the check must
    see."""
    out = _SITE(ctx, name, t, optional)
    if out.step is None:
        return out
    inv = 1.0 / ctx.steps[(name, t.device)][1]
    return quant._QT((t.float() * inv).round_().clamp_(-127, 127).to(torch.int8), out.step)


# Archs whose calibrated steps make `reciprocal_site` round as the true
# division at every site, so that control cannot show the check's
# sensitivity there (PERF.md, Findings): DeepLabV3+'s eleven steps come from
# absmax values whose bf16 mantissas have large odd factors (43, 139, 251,
# ...), so no bf16 value lands on a half-integer code; the CPU against
# itself moves 0 codes at each of them. `float32_epilogue_conv` holds them.
RECIPROCAL_BLIND = {"deeplabv3p"}


def float32_epilogue_conv(*args, out_step=None, **kw):
    """A second control for `forced_card_vs_cpu`: a fused site's codes
    quantized from the kernel's float32 values, an epilogue that skips the
    rounding to the compute dtype before the quantization (args as
    `_Ctx.conv_site` passes them: out_dtype is the ninth)."""
    if out_step is None:
        return int8_conv(*args, **kw)
    y = int8_conv(*args[:8], torch.float32, *args[9:], **kw)
    return quantize_codes(y, torch.tensor(out_step, dtype=torch.float32, device=y.device))


def reciprocal_conv(*args, out_step=None, **kw):
    """The control's sites fused into a conv: the kernel in values mode,
    then the codes by the step's reciprocal (as `reciprocal_site`)."""
    y = int8_conv(*args, **kw)
    if out_step is None:
        return y
    inv = 1.0 / torch.tensor(out_step, dtype=torch.float32, device=y.device)
    return (y.float() * inv).round_().clamp_(-127, 127).to(torch.int8)


_SITE = quant._Ctx.site


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set `attrs` on `obj` for the block, then restore them."""
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


PLAIN_CHUNK = 16  # images the plain int8 conv takes at once: its float64 tensors are large


def int8_conv_plain_packed(x, w, *args, **kw):
    """`int8_conv`'s plain version with its call (the packed weights' HWIO
    codes), `PLAIN_CHUNK` images at a time: its float64 sums of codes are
    exact, so the chunks give the bits that one call would."""
    return torch.cat([int8_conv_plain(x[i:i + PLAIN_CHUNK], w.hwio, *args, **kw)
                      for i in range(0, x.shape[0], PLAIN_CHUNK)])


@contextlib.contextmanager
def plain_kernels():
    """For the block, every kernel wrapper that a float or int8 forward calls
    replaced by its plain version, which runs on any device: a forward on
    the card then launches none of the port's kernels."""
    with patched(cbam, avg_max_pool=cbam.avg_max_pool_plain,
                 gated_spatial_stats=cbam.gated_spatial_stats_plain,
                 cbam_tail_apply=cbam.cbam_tail_apply_plain), \
            patched(blocks_module, fused_conv3x3_bn_relu=fused_conv3x3_bn_relu_plain,
                    fused_avg_max_pool=cbam.avg_max_pool_plain), \
            patched(quant, int8_conv=int8_conv_plain_packed):
        yield


@contextlib.contextmanager
def held_kernels(record):
    """For the block, every kernel wrapper that a float or int8 forward calls
    launches its kernel, runs its plain version on the same inputs and holds
    the two to the kernel checks' criteria (`check_fused_conv`, `check_cbam`,
    `check_int8_conv`), then passes the kernel's result on: each call is held
    on the kernel's own inputs, at the forward's shapes. `record[name]`
    gathers the calls, the calls that failed, the largest error and the
    input shapes."""
    def hold(name, x, got, ref, ok):
        r = record.setdefault(name, dict(calls=0, failed=0, max_abs_err=0.0, shapes=[]))
        r["calls"] += 1
        r["failed"] += not ok
        r["max_abs_err"] = max(r["max_abs_err"], float((got.float() - ref.float()).abs().max()))
        if list(x.shape) not in r["shapes"]:
            r["shapes"].append(list(x.shape))

    def pool(kernel, name):
        def held(x):
            got, ref = kernel(x), cbam.avg_max_pool_plain(x)
            ok = (torch.equal(got[1], ref[1])
                  and _mean_ok(got[0], ref[0], x.float().abs().mean((1, 2)), x.dtype))
            hold(name, x, torch.stack(got), torch.stack(ref), ok)
            return got
        return held

    def stats(x, gate):
        got, ref = stats_kernel(x, gate), cbam.gated_spatial_stats_plain(x, gate)
        z_abs = (x * gate[:, None, None, :]).float().abs().mean(-1)
        ok = torch.equal(got[:, 1], ref[:, 1]) and _mean_ok(got[:, 0], ref[:, 0], z_abs, x.dtype)
        hold("gated_spatial_stats", x, got, ref, ok)
        return got

    def tail(y, shortcut, gate, st, w):
        got = tail_kernel(y, shortcut, gate, st, w)
        ref = cbam.cbam_tail_apply_plain(y, shortcut, gate, st, w)
        hold("cbam_tail", y, got, ref, _tail_ok(got, ref, y, y.dtype))
        return got

    def conv(x, w, scale, bias, relu=True):
        got = conv_kernel(x, w, scale, bias, relu)
        ref = fused_conv3x3_bn_relu_plain(x, w, scale, bias, relu)
        hold("fused_conv3x3_bn_relu", x, got, ref, _conv_ok(got, ref))
        return got

    def int8(x, w, *args, **kw):
        got, ref = int8_kernel(x, w, *args, **kw), int8_conv_plain_packed(x, w, *args, **kw)
        hold("int8_conv", x, got, ref, _bits_equal(got, ref))
        return got

    stats_kernel, tail_kernel = cbam.gated_spatial_stats, cbam.cbam_tail_apply
    conv_kernel, int8_kernel = blocks_module.fused_conv3x3_bn_relu, quant.int8_conv
    cbam_pool = pool(cbam.avg_max_pool, "avg_max_pool")
    # A CBAM wrapper counts its launch on the name its module looks up, here
    # the held function: these comparison launches count there, not in the
    # kernels' counts.
    for fn in (cbam_pool, stats, tail):
        fn.launches = 0
    with patched(cbam, avg_max_pool=cbam_pool, gated_spatial_stats=stats, cbam_tail_apply=tail), \
            patched(blocks_module, fused_conv3x3_bn_relu=conv,
                    fused_avg_max_pool=pool(blocks_module.fused_avg_max_pool,
                                            "fused_avg_max_pool")), \
            patched(quant, int8_conv=int8):
        yield


def site_counts(forward) -> dict:
    """Sites one call of `forward` quantizes: `fused` in an int8 conv's
    epilogue (`_Ctx.fused_codes`), `eager` by `_Ctx.site` on a float tensor.
    On the CPU a fused site's plain version also goes through `_Ctx.site`:
    it counts as fused only."""
    eager, fused = set(), set()

    def site(ctx, name, t, optional=False):
        out = _SITE(ctx, name, t, optional)
        if out.step is not None:
            eager.add(name)
        return out

    def fused_codes(ctx, name, codes):
        fused.add(name)
        return codes

    with patched(quant._Ctx, site=site, fused_codes=fused_codes):
        forward()
    return dict(fused=len(fused), eager=len(eager - fused))


def forced_card_vs_cpu(arch, card, cpu, x, card_site=_SITE, card_conv=None):
    """The int8 forward on the card against the CPU path, layer by layer:
    the card's forward records every site's codes, those `card_site`
    quantizes and those an int8 conv's epilogue makes (`_Ctx.fused_codes`;
    `card_conv` stands in for the kernel where given); the CPU forward then
    quantizes each site from its own input (the plain conv's values through
    `_Ctx.site` for a fused one) but passes the card's codes on, so every
    CPU layer reads what the card's layer read. Returns the largest share
    of codes that a site would have quantized otherwise, that site, the
    mask agreement of the two outputs (`mask_agreement`), and the count of
    fused sites it held.

    Free-running, one code that rounds otherwise early in a random-init
    model (a float-path conv summed in another order by cuDNN than by
    oneDNN) spreads through every later requantization; this comparison
    holds each layer instead."""
    rec, fused = [], []

    def record(ctx, name, t, optional=False):
        out = card_site(ctx, name, t, optional)
        rec.append((name, out.q.cpu(), out.step))
        return out

    def record_fused(ctx, name, codes):
        if rec and rec[-1][0] == name:  # a CPU forward's plain path went through `site`
            rec.pop()
        rec.append((name, codes.q.cpu(), codes.step))
        fused.append(name)
        return codes

    def forced(ctx, name, t, optional=False):
        own = _SITE(ctx, name, t, optional)
        want, q, step = rec[len(seen)]
        if want != name or step != own.step:
            raise AssertionError(f"site order differs: {name} against the card's {want}")
        seen[name] = float((own.q != q).float().mean())
        return quant._QT(q, step)

    seen = {}
    with patched(quant._Ctx, site=record, fused_codes=record_fused), \
            patched(quant, int8_conv=card_conv or quant.int8_conv):
        a = card(x.to(card.device)).cpu()
    with patched(quant._Ctx, site=forced):
        b = cpu(x)
    if len(seen) != len(rec):
        raise AssertionError(f"the CPU forward held {len(seen)} sites, the card's made {len(rec)}")
    worst = max(seen, key=seen.get)
    return seen[worst], worst, mask_agreement(arch, a, b), len(fused)


def int8_eval(arch, dev, size, batch, check_size, check_batch, limit):
    """One int8 model at (batch, size, size), bf16: launches of one counted
    forward (and no call of the plain conv on the card), its device and
    events ms beside the bf16 float model's on the same weights, and its
    masks on the card against the CPU path (the same tree and scales) at
    (check_batch, check_size, check_size): layer by layer
    (`forced_card_vs_cpu`) within `limit` of the masks and `SITE_CODES_LIMIT`
    of every site's codes, which the controls `float32_epilogue_conv` and
    (but for `RECIPROCAL_BLIND`) `reciprocal_site` must exceed, and
    free-running beside the bf16 float model's own card-vs-CPU agreement
    (reported). `s`: the seconds it took."""
    t0 = time.perf_counter()
    name = INT8_EVAL[arch][0]
    sd = zoo_state_dict(name)  # seeded init, BN statistics from one forward
    qm = quant.QuantizedModel.from_state_dict(sd, quant.default_calibration(size, device=dev),
                                              arch=arch, device=dev)
    images, _, _ = coast_tiles(batch, size, 30)
    x = normalize_images(torch.from_numpy(images).to(dev))
    qm(x)  # warm-up, uncounted
    sync(dev)
    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    plain_calls = []
    with patched(int8_conv_module, int8_conv_plain=lambda *a, **k: plain_calls.append(1)
                 or int8_conv_plain(*a, **k)):
        probs = qm(x)
        sync(dev)
    launches = {k: n for k, n in launch_counts().items() if n}
    want = {"int8_conv": INT8_CONVS[arch]}
    if arch == "segnet":
        want.update(max_pool_with_indices=4, max_unpool=4)
    model = create_model(name, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    model.to(dev).eval()
    xc = x.permute(0, 3, 1, 2)
    with torch.inference_mode():
        fwd = {"int8": (lambda: qm(x)), "bf16": (lambda: model(xc))}
        profiles = {k: profile_forward(f, f"profile_{arch}_{k}_forward_b{batch}")
                    for k, f in fwd.items()}
        times = {k: dict(forward_ms=cuda_ms(f, 5),
                         forward_device_ms=profiles[k].get("device_ms_per_forward"))
                 for k, f in fwd.items()}
        float_probs = model(xc).permute(0, 2, 3, 1)
    profile = profiles["int8"]
    cpu = quant.QuantizedModel(qm.qparams, qm.scales, arch=arch, device="cpu")
    small = normalize_images(torch.from_numpy(coast_tiles(check_batch, check_size, 31)[0]))
    free = mask_agreement(arch, qm(small).cpu(), cpu(small))
    site_share, site_name, card_vs_cpu, fused_held = forced_card_vs_cpu(arch, qm, cpu, small)
    control_share, control_site, _, _ = forced_card_vs_cpu(
        arch, qm, cpu, small, card_site=reciprocal_site, card_conv=reciprocal_conv)
    f32_share, f32_site, _, _ = forced_card_vs_cpu(arch, qm, cpu, small,
                                                   card_conv=float32_epilogue_conv)
    sites = site_counts(lambda: qm(x))
    bf16_cpu = create_model(name, dtype=torch.bfloat16)
    bf16_cpu.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        bf16_free = mask_agreement(arch, model(small.permute(0, 3, 1, 2).to(dev)).cpu(),
                                   bf16_cpu.eval()(small.permute(0, 3, 1, 2)))
    out = dict(arch=arch, batch=batch, size=size, launches=launches, want_launches=want,
               times=times, int8_vs_bf16_mask_agreement=mask_agreement(arch, probs, float_probs),
               card_vs_cpu_mask_agreement=card_vs_cpu, card_vs_cpu_site_codes=site_share,
               card_vs_cpu_worst_site=site_name, site_codes_limit=SITE_CODES_LIMIT,
               card_vs_cpu_fused_sites=fused_held, sites=sites,
               control_reciprocal_site_codes=control_share, control_worst_site=control_site,
               control_float32_epilogue_site_codes=f32_share,
               control_float32_epilogue_worst_site=f32_site,
               card_vs_cpu_free_running=free,
               bf16_card_vs_cpu_free_running=bf16_free, check=[check_batch, check_size],
               plain_conv_calls_on_card=len(plain_calls),
               finite=bool(torch.isfinite(probs).all()), s=time.perf_counter() - t0,
               profile=profile)
    log(f"int8_eval_{arch}", json.dumps({k: v for k, v in out.items() if k != "profile"}))
    failures = []
    if launches != want or plain_calls:
        failures.append(f"{arch} int8 forward launched {launches}, want {want}; the plain "
                        f"conv ran {len(plain_calls)} times on the card")
    if sites != INT8_SITES[arch] or fused_held != INT8_SITES[arch]["fused"]:
        failures.append(f"{arch} int8 sites {sites} (layer by layer {fused_held} fused), want "
                        f"{INT8_SITES[arch]}")
    if card_vs_cpu < limit or site_share > SITE_CODES_LIMIT or not out["finite"]:
        failures.append(f"{arch} int8 on the card against the CPU, layer by layer: masks "
                        f"{card_vs_cpu:.5f} (limit {limit}), codes {site_share:.2e} at {site_name} "
                        f"(limit {SITE_CODES_LIMIT})")
    if control_share <= SITE_CODES_LIMIT and arch not in RECIPROCAL_BLIND:
        failures.append(f"{arch}: the layer-by-layer check does not see a reciprocal site "
                        f"({control_share:.2e} at {control_site}, limit {SITE_CODES_LIMIT})")
    if f32_share <= SITE_CODES_LIMIT:
        failures.append(f"{arch}: the layer-by-layer check does not see a float32 epilogue "
                        f"({f32_share:.2e} at {f32_site}, limit {SITE_CODES_LIMIT})")
    return out, qm, failures


def tensor_bytes(node) -> int:
    """Bytes of every tensor in a nested tree of dicts and tuples."""
    if isinstance(node, torch.Tensor):
        return node.numel() * node.element_size()
    if isinstance(node, dict):
        return sum(tensor_bytes(v) for v in node.values())
    if isinstance(node, (tuple, list)):
        return sum(tensor_bytes(v) for v in node)
    return 0


def int8_serving(dev, save_dir, root, size, batch, check_size, check_batch):
    """The UNet int8 serving path from `train_path`'s checkpoint: `quantize`
    to an .npz, 16 counted requests through `serve()` (21 int8 convs a
    forward, no fused conv, one dilation a band call), `from_quantized`
    serving the same masks bit for bit, the card against the CPU path on the
    same .npz, and the int8 and bf16 forwards' times and masks."""
    npz = os.path.join(root, "unet_int8.npz")
    ex_f = CoastlineExtractor(checkpoint_dir=save_dir, dtype=torch.bfloat16, image_size=size,
                              device=dev)
    ex = CoastlineExtractor(checkpoint_dir=save_dir, dtype=torch.bfloat16, image_size=size,
                            device=dev)
    t0 = time.perf_counter()
    ex.quantize(save_to=npz)
    quantize_s = time.perf_counter() - t0
    images, _, _ = coast_tiles(16, size, 40)
    ex.predict_masks_batch(images[:batch])  # warm-up, uncounted
    sync(dev)
    forwards = []
    predict = ex.predict_masks_batch
    ex.predict_masks_batch = lambda b: forwards.append(len(b)) or predict(b)
    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with ex.serve(batch_size=batch) as srv:
        masks = np.stack(srv.predict_many(list(images)))
    serve_s = time.perf_counter() - t0
    stacked = torch.from_numpy(masks).to(dev)
    bands = [coastline_band(stacked[i:i + batch], 20, device=dev)
             for i in range(0, len(masks), batch)]
    sync(dev)
    launches = {k: n for k, n in launch_counts().items() if n}
    del ex.predict_masks_batch
    want = {"int8_conv": INT8_CONVS["unet"] * len(forwards), "dilate_disk": len(bands)}

    served = CoastlineExtractor.from_quantized(npz, image_size=size, device=dev)
    reloaded = np.concatenate([served.predict_masks_batch(images[i:i + batch])
                               for i in range(0, len(images), batch)])
    float_masks = np.concatenate([ex_f.predict_masks_batch(images[i:i + batch])
                                  for i in range(0, len(images), batch)])
    small = coast_tiles(check_batch, check_size, 41)[0]
    card = CoastlineExtractor.from_quantized(npz, image_size=check_size, device=dev)
    cpu = CoastlineExtractor.from_quantized(npz, image_size=check_size, device="cpu")
    card_vs_cpu = float(np.mean(card.predict_masks_batch(small) == cpu.predict_masks_batch(small)))

    # the forward alone (events ms, and device ms from the profiler: its ~250
    # launches fill the launch queue, so `device_ms` cannot queue 10 of them),
    # and the predict function around it (normalize, forward, argmax)
    x8 = torch.from_numpy(images[:batch]).to(dev)
    xn = normalize_images(x8)
    times, profiles = {}, {}
    with torch.inference_mode():
        for name, e, fwd in (("int8", ex, lambda: ex.quantized(xn)),
                             ("bf16", ex_f, lambda: ex_f.model(xn.permute(0, 3, 1, 2)))):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            e.predict_masks_batch_async(x8)
            sync(dev)
            peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None
            profiles[name] = profile_forward(fwd, f"profile_unet_{name}_forward_b{batch}")
            times[name] = dict(forward_ms=cuda_ms(fwd, 10),
                               forward_device_ms=profiles[name].get("device_ms_per_forward"),
                               predict_ms=cuda_ms(lambda e=e: e.predict_masks_batch_async(x8), 10),
                               peak_memory_gb=peak)
    profile = profiles["int8"]
    sites = site_counts(lambda: ex.quantized(xn))
    out = dict(requests=len(masks), batches=forwards, launches=launches, want_launches=want,
               sites=sites,
               quantize_s=quantize_s, serve_s=serve_s, img_per_s=len(masks) / serve_s,
               npz_mb=os.path.getsize(npz) / 1e6,
               device_tree_mb=tensor_bytes(ex.quantized.params) / 1e6,
               bf16_params_mb=tensor_bytes(list(ex_f.model.state_dict().values())) / 1e6,
               reload_equal=bool(np.array_equal(masks, reloaded)),
               card_vs_cpu_mask_agreement=card_vs_cpu, check=[check_batch, check_size],
               int8_vs_bf16_mask_agreement=float(np.mean(masks == float_masks)),
               water_fraction=float(masks.mean()), times=times, profile=profile)
    log("int8_serving", json.dumps({k: v for k, v in out.items() if k != "profile"}))
    failures = []
    if launches != want:
        failures.append(f"int8 serving launched {launches}, want {want}")
    if sites != INT8_SITES["unet"]:
        failures.append(f"int8 UNet sites {sites}, want {INT8_SITES['unet']}")
    if masks.shape != (16, size, size) or not set(np.unique(masks)) <= {0, 1}:
        failures.append(f"bad int8 masks {masks.shape} {np.unique(masks)}")
    if not out["reload_equal"]:
        failures.append("from_quantized serves other masks than quantize()")
    if card_vs_cpu < 0.995:
        failures.append(f"int8 UNet on the card against the CPU: {card_vs_cpu:.5f} < 0.995")
    return out, ex, failures


def int8_scene(ex, dev, size, batch, dilation=20):
    """`predict_scene` of a size^2 scene with the int8 forward, with the
    band: the device path against the host tiling path, bit for bit."""
    scene, _ = tiled_scene(size, 12)
    tile = ex.image_size
    n_side = -(-(size - tile // 8) // (tile - tile // 8))
    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    mask, band = ex.predict_scene(scene, batch=batch, with_band=dilation)
    sync(dev)
    launches = {k: n for k, n in launch_counts().items() if n}
    host_mask, host_band = ex.predict_scene(scene, batch=batch, with_band=dilation,
                                            device_pipeline=False)
    want = {"int8_conv": INT8_CONVS["unet"] * -(-n_side * n_side // batch), "dilate_disk": 1}
    out = dict(scene=[size, size], tile=tile, batch=batch, launches=launches, want_launches=want,
               equal=bool(np.array_equal(mask, host_mask) and np.array_equal(band, host_band)),
               water_fraction=float(mask.mean()))
    log("int8_scene", json.dumps(out))
    failures = []
    if launches != want:
        failures.append(f"int8 scene launched {launches}, want {want}")
    if not out["equal"]:
        failures.append("the int8 device scene path differs from the host tiling path")
    return out, failures


def int8_forwards(result) -> dict:
    """Per model, a batch-8 int8 forward beside the bf16 float model's:
    device ms, its `int8_conv` and elementwise ms and launches (profiler),
    and the sites quantized in the conv epilogue and eagerly."""
    out = {}
    for arch in INT8_CONVS:
        r = result["serving" if arch == "unet" else arch]
        classes = r["profile"].get("classes", {})
        conv = classes.get("int8_conv (ours)", {})
        elem = classes.get("elementwise: bias, BN affine, ReLU, casts", {})
        out[arch] = dict(
            int8_device_ms=r["times"]["int8"]["forward_device_ms"],
            bf16_device_ms=r["times"]["bf16"]["forward_device_ms"],
            int8_conv_ms=conv.get("ms_per_forward"),
            int8_conv_launches=conv.get("launches_per_forward"),
            elementwise_ms=elem.get("ms_per_forward"),
            elementwise_launches=elem.get("launches_per_forward"),
            idle_share=r["profile"].get("idle_share"), **r["sites"])
    log("int8_forwards", json.dumps(out))
    return out


def int8_export(dev, models, x, root):
    """The AOT serving export of every int8 model in `models` (arch ->
    `QuantizedModel` on `dev`) at x's shape: `export_serving` (seconds,
    `.pt2` bytes) and `load_serving`; one counted call of the program on the
    serving weights, bit-equal to the eager forward on `x` and with its
    kernel launches (`INT8_CONVS`, SegNet's 4 pools and unpools); a batch
    of one more refused; events ms and the profiled device ms of the
    program beside the eager forward's. The UNet's also goes through
    `save_serving_bundle` / `load_serving_bundle` under `root`, bit-equal
    to the eager forward."""
    out, failures = {}, []
    batch, size = x.shape[0], x.shape[1]
    bigger = torch.cat([x, x[:1]])
    for arch, qm in models.items():
        t0 = time.perf_counter()
        data = quant_deploy.export_serving(qm, batch, size)
        export_s = time.perf_counter() - t0
        fn = quant_deploy.load_serving(data)
        weights = quant_deploy.serving_weights(qm)
        eager = qm(x)
        fn(weights, x)  # warm-up, uncounted
        sync(dev)
        for counter in ALL_COUNTERS.values():
            counter.launches = 0
        got = fn(weights, x)
        sync(dev)
        launches = {k: n for k, n in launch_counts().items() if n}
        want = {"int8_conv": INT8_CONVS[arch]}
        if arch == "segnet":
            want.update(max_pool_with_indices=4, max_unpool=4)
        try:
            fn(weights, bigger)
            refused = None
        except Exception as e:  # the refusal this checks for
            refused = f"{type(e).__name__}: {str(e)[:160]}"
        forwards = {"program": lambda: fn(weights, x), "eager": lambda: qm(x)}
        profiles = {k: profile_forward(f, f"profile_{arch}_int8_{k}_b{batch}")
                    for k, f in forwards.items()}
        times = {k: dict(forward_ms=cuda_ms(f, 5),
                         forward_device_ms=profiles[k].get("device_ms_per_forward"),
                         idle_share=profiles[k].get("idle_share"))
                 for k, f in forwards.items()}
        r = dict(export_s=export_s, pt2_mb=len(data) / 1e6, launches=launches,
                 want_launches=want, equal=_bits_equal(got, eager),
                 batch_plus_one_refused=refused, times=times)
        log(f"int8_export_{arch}", json.dumps(r))
        out[arch] = r
        if launches != want:
            failures.append(f"{arch} exported program launched {launches}, want {want}")
        if not r["equal"]:
            failures.append(f"{arch} exported program differs from the eager int8 forward")
        if refused is None:
            failures.append(f"{arch} exported program ran a batch of {batch + 1}")
        if len(data) >= 4e6:
            failures.append(f"{arch} serving program is {len(data) / 1e6:.2f} MB, not < 4 MB")
    if "unet" in models:
        qm = models["unet"]
        bundle = os.path.join(root, "unet_bundle")
        t0 = time.perf_counter()
        quant_deploy.save_serving_bundle(bundle, qm, batch, size)
        fn, _ = quant_deploy.load_serving_bundle(bundle, device=dev)
        got = fn(x)
        sync(dev)
        out["unet_bundle"] = dict(
            s=time.perf_counter() - t0, equal=_bits_equal(got, qm(x)),
            files={f: os.path.getsize(os.path.join(bundle, f)) for f in sorted(os.listdir(bundle))})
        log("int8_export_unet_bundle", json.dumps(out["unet_bundle"]))
        if not out["unet_bundle"]["equal"]:
            failures.append("the UNet's serving bundle differs from the eager int8 forward")
    return out, failures


def int8_path(dev, save_dir=TRAIN_DIR, size=512, batch=8, check_size=128, check_batch=2,
              scene_size=2048):
    """The int8 PTQ path on the card: the int8 conv at every configuration
    of the twelve int8 forwards at (batch, size, size), the UNet's int8
    serving from `train_path`'s checkpoint, the other eleven's int8 eval
    forwards (`INT8_EVAL`), an int8 scene, and the AOT serving export of
    all twelve (`int8_export`)."""
    t0 = time.perf_counter()
    root = fresh_dir(INT8_DIR)
    result, failures = {}, []
    result["serving"], ex, fails = int8_serving(dev, save_dir, root, size, batch, check_size,
                                                check_batch)
    failures += fails
    result["scene"], fails = int8_scene(ex, dev, scene_size, batch)
    failures += fails
    models = {"unet": ex.quantized}
    for arch, (_, limit) in INT8_EVAL.items():
        result[arch], models[arch], fails = int8_eval(arch, dev, size, batch, check_size,
                                                      check_batch, limit)
        failures += fails
    # every conv configuration of the eight forwards, from one forward each
    x = normalize_images(torch.from_numpy(coast_tiles(batch, size, 32)[0]).to(dev))
    configs = int8_conv_configs({a: (lambda m=m: m(x)) for a, m in models.items()})
    result["export"], fails = int8_export(dev, models, x, root)
    failures += fails
    del models, ex, x
    for key in EXTRA_INT8_CONFIGS:
        configs.setdefault(key, {})
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    per_arch = {a: sum(per.get(a, 0) for per in configs.values()) for a in INT8_CONVS}
    if per_arch != INT8_CONVS:
        failures.append(f"int8 conv calls a forward {per_arch}, want {INT8_CONVS}")
    result["conv_cases"], fails = check_int8_conv(dev, configs)
    failures += fails
    result["forwards"] = int8_forwards(result)
    result["s"] = time.perf_counter() - t0
    log(f"int8_path {result['s']:.1f} s")
    if failures:
        raise AssertionError("int8 path: " + "; ".join(failures))
    return result


MULTI_DIR = os.path.join(REPO, "build", "multi_device")  # listed in .gitignore
MD_RANKS, MD_SIZE, MD_BATCH, MD_SCENE = 2, 512, 8, 2048
# the two-rank run against one process: each step's loss and the validation
# loss within MD_LOSS_REL (one bf16 rounding, relative); the first step's
# gradient (DDP's average against one process's) within MD_GRAD_REL in
# relative L2 norm; rank 0's parameters after two Adam steps at lr 1e-4
# within 2 x lr x steps (Adam's largest move, 1.1 x for its bias
# correction), and the two ranks' parameters equal
MD_LOSS_REL, MD_GRAD_REL = 2.0 ** -8, 0.05
MD_COUNTERS = ("fused_conv3x3_bn_relu", "max_pool_with_indices", "max_unpool", "dilate_disk",
               "int8_conv")


def md_flags():
    """The numerics flags `main` sets, on a rank too."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def md_zero():
    for fn in ALL_COUNTERS.values():
        fn.launches = 0


def md_counts() -> dict:
    return {k: n for k, n in launch_counts().items() if k in MD_COUNTERS}


def md_train(dev, mesh=None, steps=2):
    """Two bf16 Adam steps of the full-width 2-class UNet (the trainer's loss,
    augmentation on) at 512^2, global batch 8, then one validation pass over
    8 tiles: on one device, or on this rank's rows of every batch with
    `mesh`. Then two more steps, timed (the first two include cuDNN's plan
    choice). The launch counters are read around the train steps and
    around the validation."""
    sd = unet_state_dict(random_unet_variables(seed=0))
    images, masks, _ = coast_tiles(steps * MD_BATCH, MD_SIZE, 21)
    vimages, vmasks, _ = coast_tiles(MD_BATCH, MD_SIZE, 22)
    model = UNet(n_classes=2, dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    cfg = TrainConfig(batch_size=MD_BATCH, eval_batch_size=MD_BATCH, lr=1e-4, weight_decay=0.0,
                      loss="ce", seed=0)
    epoch = make_train_epoch(model, cfg, make_augment_fn(), dev, mesh=mesh)
    state = create_train_state(model, cfg, device=dev)
    idx, valid = batch_indices(len(images), MD_BATCH, shuffle=False, rng=np.random.default_rng(0))
    grads = []  # the first step's gradient, as Adam receives it (DDP's average on a mesh)

    def first_grad(opt, *_):
        if not grads:
            grads.append(torch.cat([p.grad.reshape(-1).float() for p in model.parameters()]).cpu())

    hook = state.optimizer.register_step_pre_hook(first_grad)
    md_zero()
    state, losses = epoch(state, images, masks, idx, valid, per_step=True)
    hook.remove()
    losses = losses.tolist()
    train_launches = md_counts()
    params = {k: v.detach().float().cpu() for k, v in model.named_parameters()}
    flat = torch.cat([v.reshape(-1) for v in params.values()]).double()
    checksum = [float(flat.sum()), float((flat * flat).sum())]
    vidx, vvalid = batch_indices(MD_BATCH, MD_BATCH, shuffle=False, rng=np.random.default_rng(0))
    md_zero()
    val_loss, agg = make_eval_epoch(model, cfg, dev, mesh=mesh)(vimages, vmasks, vidx, vvalid)
    val_launches = md_counts()
    sync(dev)
    t0 = time.perf_counter()
    epoch(state, images, masks, idx, valid)
    sync(dev)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    return dict(losses=losses, val_loss=val_loss, val_metrics=agg, params=params,
                grad=grads[0], checksum=checksum, train_launches=train_launches,
                val_launches=val_launches, step_ms=step_ms,
                rows_per_rank=MD_BATCH // (1 if mesh is None else mesh.size()))


def md_segnet(dev, mesh=None):
    """SegNet's `evaluate_model` at full width, bf16, over 16 tiles of 512^2
    at batch 8 and a throughput batch of 8: on one device, or on two ranks
    with the tiles sample-sharded (each rank its 8). Counts its eval
    forwards (a hook) and the kernel launches."""
    sd = segnet_state_dict(random_segnet_variables(seed=0))
    model = create_model("SegNet", dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    images, masks, _ = coast_tiles(2 * MD_BATCH, MD_SIZE, 23)
    cfg = TrainConfig(batch_size=MD_BATCH, eval_batch_size=MD_BATCH, loss="bce")
    if mesh is None:
        ds = DeviceDataset.from_numpy(images, masks, device=dev)
    else:
        from coastline_torch.parallel.mesh import shard_device_dataset

        ds = shard_device_dataset(mesh, images, masks)
    ev = Evaluator(model, cfg, device=dev, mesh=mesh, sharded_data=mesh is not None)
    forwards = []
    model.register_forward_pre_hook(lambda m, a: forwards.append(a[0].shape[0]))
    md_zero()
    res = ev.evaluate_model(ds, state=create_train_state(ev.model, cfg, device=dev),
                            throughput_batch=MD_BATCH)
    sync(dev)
    return dict(results=res, launches=md_counts(), forwards=len(forwards),
                rows=sorted(set(forwards)), stored_rows=int(ds.images.shape[0]))


def md_scene(dev, mesh=None):
    """`predict_scene(batch=8, with_band=20)` of a 2048^2 scene with the
    full-width bf16 UNet and then its int8 `quantize()`d forward: on one
    device or split over the mesh's ranks. Each is run twice, the second
    timed, with the counters read over it."""
    ex = CoastlineExtractor(variables=random_unet_variables(seed=0), dtype=torch.bfloat16,
                            image_size=MD_SIZE, device=dev)
    scene, _ = tiled_scene(MD_SCENE, 13)
    out = {}
    for kind in ("bf16", "int8"):
        if kind == "int8":
            ex.quantize()
        ex.predict_scene(scene, batch=MD_BATCH, with_band=20, mesh=mesh)
        sync(dev)
        md_zero()
        t0 = time.perf_counter()
        mask, band = ex.predict_scene(scene, batch=MD_BATCH, with_band=20, mesh=mesh)
        sync(dev)
        out[kind] = dict(mask=mask, band=band, s=time.perf_counter() - t0, launches=md_counts())
    return out


def multi_device_rank():
    """One rank of the multi-device phase (two gloo ranks on `cuda:0`)."""
    from coastline_torch.parallel.launch import local_device
    from coastline_torch.parallel.mesh import make_mesh

    md_flags()
    dev = local_device()
    mesh = make_mesh(MD_RANKS)
    out = dict(rank=torch.distributed.get_rank(), device=str(dev),
               train=md_train(dev, mesh), segnet=md_segnet(dev, mesh),
               scene=md_scene(dev, mesh))
    if out["rank"]:  # rank 0's are compared; the checksums show the replicas equal
        del out["train"]["params"], out["train"]["grad"]
    return out


def hold_md_kernels(dev):
    """Every kernel the ranks launch, against its plain version at the
    shapes a rank gives it: the fused conv at (4, 512, 512, 64) bf16 (the
    UNet's enc1/dec1 conv 2 on a rank's half of batch 8), SegNet's pool and
    unpool at its first level on 4 tiles (tie-heavy bf16 inputs, bit for
    bit), the dilation at the scene's (1, 2048, 2048) with size 20, and the
    int8 conv at every configuration the int8 UNet hands it in a rank's
    scene forward (its rows of two chunks: batch 8)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    b = MD_BATCH // MD_RANKS
    out, failures = {}, []
    x = torch.randn((b, MD_SIZE, MD_SIZE, 64), device=dev, generator=gen).to(torch.bfloat16)
    wt = torch.randn((3, 3, 64, 64), device=dev, generator=gen) * math.sqrt(2.0 / (9 * 64))
    scale = torch.rand(64, device=dev, generator=gen) + 0.5
    bias = torch.randn(64, device=dev, generator=gen) * 0.2
    got, ref = fused_conv3x3_bn_relu(x, wt, scale, bias).float(), \
        fused_conv3x3_bn_relu_plain(x, wt, scale, bias).float()
    err = (got - ref).abs()
    xl = x.permute(0, 3, 1, 2)
    wl = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    s16, b16 = scale.to(torch.bfloat16)[:, None, None], bias.to(torch.bfloat16)[:, None, None]
    bound_ms, bound_by = bound(2 * x.numel() * 2 + wt.numel() * 2 + 2 * 64 * 4,
                               2.0 * x.numel() * 9 * 64, PEAK_BF16_FLOPS)
    out["fused_conv3x3_bn_relu"] = dict(
        shape=list(x.shape), max_abs_err=float(err.max()),
        ok=bool(torch.all(err <= 2.0 ** -7 * ref.abs() + 1e-3)),
        ms=cuda_ms(lambda: fused_conv3x3_bn_relu(x, wt, scale, bias), 20),
        plain_ms=cuda_ms(lambda: fused_conv3x3_bn_relu_plain(x, wt, scale, bias), 3, 1),
        library_ms=cuda_ms(lambda: torch.relu(F.conv2d(xl, wl, padding=1) * s16 + b16), 20),
        bound_ms=bound_ms, bound_by=bound_by)
    del x, xl, got, ref, err
    x = _tie_input((b, MD_SIZE, MD_SIZE, 64), torch.bfloat16, dev, gen)
    vals, codes = unpool.max_pool_with_indices(x)
    r_vals, r_codes = unpool.max_pool_with_indices_plain(x)
    up, r_up = unpool.max_unpool(vals, codes), unpool.max_unpool_plain(r_vals, r_codes)
    n_in, n_out = x.numel(), vals.numel()
    for name, ok, kern, plain, lib, nbytes, ops in (
            ("max_pool_with_indices", _bits_equal(vals, r_vals) and _bits_equal(codes, r_codes),
             lambda: unpool.max_pool_with_indices(x), lambda: unpool.max_pool_with_indices_plain(x),
             lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2, return_indices=True),
             2 * n_in + 2 * n_out + 4 * n_out, 3 * n_out),
            ("max_unpool", _bits_equal(up, r_up), lambda: unpool.max_unpool(vals, codes),
             lambda: unpool.max_unpool_plain(vals, codes), None, 2 * n_out + 4 * n_out + 2 * n_in,
             4 * n_out)):
        bound_ms, bound_by = bound(nbytes, ops, PEAK_F32_OPS)
        out[name] = dict(shape=list(x.shape), max_abs_err=0.0 if ok else float("nan"), ok=ok,
                         ms=cuda_ms(kern, 20), plain_ms=cuda_ms(plain, 5, 1),
                         library_ms=None if lib is None else cuda_ms(lib, 20),
                         bound_ms=bound_ms, bound_by=bound_by)
    del x, vals, codes, r_vals, r_codes, up, r_up
    ker = elliptical_kernel(20)
    m = (torch.rand((1, MD_SCENE, MD_SCENE), device=dev, generator=gen) < 0.02).to(torch.uint8)
    got, ref = dilate_disk(m, ker), dilate_disk_plain(m, ker)
    groups = se_row_groups(ker)
    ops_px = max(hi - lo for (lo, hi), _ in groups) + sum(len(s) for _, s in groups)
    bound_ms, bound_by = bound(2 * m.numel(), ops_px * m.numel(), PEAK_F32_OPS)
    out["dilate_disk"] = dict(shape=list(m.shape), size=20, ok=bool(torch.equal(got, ref)),
                              max_abs_err=float((got.float() - ref.float()).abs().max()),
                              ms=cuda_ms(lambda: dilate_disk(m, ker), 20),
                              plain_ms=cuda_ms(lambda: dilate_disk_plain(m, ker), 3, 1),
                              library_ms=cuda_ms(lambda: conv_threshold_dilate(m, ker), 3, 1),
                              bound_ms=bound_ms, bound_by=bound_by)
    qm = CoastlineExtractor(variables=random_unet_variables(seed=0), dtype=torch.bfloat16,
                            image_size=MD_SIZE, device=dev).quantize().quantized
    xq = normalize_images(torch.from_numpy(tiled_scene(MD_SIZE, 13)[0]).to(dev))[None]
    configs = int8_conv_configs({"unet": lambda: qm(xq.expand(MD_BATCH, -1, -1, -1)
                                                    .contiguous())})
    cases, int8_failures = check_int8_conv(dev, configs, iters=3)
    failures += int8_failures
    out["int8_conv"] = dict(configurations=len(cases), ok=not int8_failures,
                            max_abs_err=max(c["max_abs_err"] for c in cases), cases=cases)
    for name, row in out.items():
        log("multi_device_hold", name, json.dumps({k: v for k, v in row.items() if k != "cases"}))
        if not row["ok"]:
            failures.append(f"{name} disagrees with its plain version at a rank's shapes: {row}")
    return out, failures


def md_cli(dev):
    """`cli.train --data-parallel 1 --sharded-data` through the launcher (one
    NCCL rank on cuda:0), and the same under `torchrun --standalone`, as
    subprocesses started together; their outputs go to build/multi_device/."""
    os.makedirs(MULTI_DIR, exist_ok=True)
    args = ["-m", "coastline_torch.cli.train", "--synthetic", "10", "--epochs", "1",
            "--image-size", "256", "--batch-size", "4", "--data-parallel", "1",
            "--sharded-data", "--checkpoint-every", "1"]
    runs = {"launcher": [sys.executable] + args,
            "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc-per-node", "1"] + args}
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for name, cmd in runs.items():
        log_path = os.path.join(MULTI_DIR, f"cli_{name}.log")
        procs[name] = (subprocess.Popen(
            cmd + ["--save-dir", os.path.join(MULTI_DIR, f"cli_{name}")], cwd=REPO, env=env,
            stdout=open(log_path, "w"), stderr=subprocess.STDOUT), log_path, time.perf_counter())
    return procs


def md_cli_finish(procs):
    out, failures = {}, []
    for name, (proc, log_path, t0) in procs.items():
        rc = proc.wait(timeout=300)
        text = open(log_path).read()
        ok = (rc == 0 and "datasets sample-sharded over 1 chips" in text
              and "done: best IoU" in text)
        out[name] = dict(rc=rc, s=time.perf_counter() - t0, ok=ok, tail=text[-400:])
        if not ok:
            failures.append(f"cli.train --data-parallel 1 --sharded-data ({name}) failed: {text[-2000:]}")
    return out, failures


def multi_device_path(dev):
    """The multi-device phase: (1) two gloo ranks sharing cuda:0 train the
    full-width UNet with DDP (two bf16 steps at global batch 8, 512^2, and a
    validation pass) against the single-process card run; (2) SegNet's
    sample-sharded `evaluate_model` on the two ranks; (3) `predict_scene(mesh=)`
    on the two ranks, bf16 and int8 with the band, bit-identical to one
    process; (4) `cli.train --data-parallel 1 --sharded-data` through the NCCL
    launcher and torchrun. Every kernel the ranks launch is held against its
    plain version at a rank's shapes and counted on each rank. Two ranks on
    one card share its SMs: their times are not a scaling measurement."""
    from coastline_torch.parallel.launch import run

    t0 = time.perf_counter()
    single = dict(train=md_train(dev), segnet=md_segnet(dev), scene=md_scene(dev))
    single_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run(multi_device_rank, MD_RANKS, device="cuda:0", backend="gloo")
    ranks_s = time.perf_counter() - t0
    holds, failures = hold_md_kernels(dev)
    cli_out, cli_failures = md_cli_finish(md_cli(dev))
    failures += cli_failures

    ref = single["train"]
    lr, steps = 1e-4, len(ref["losses"])
    train = dict(single_losses=ref["losses"], single_val_loss=ref["val_loss"],
                 single_step_ms=ref["step_ms"], ranks=[])
    for r in ranks:
        t, s = r["train"], r["segnet"]
        row = dict(rank=r["rank"], device=r["device"], losses=t["losses"],
                   loss_rel=[abs(a - b) / abs(b) for a, b in zip(t["losses"], ref["losses"])],
                   val_loss=t["val_loss"], val_rel=abs(t["val_loss"] - ref["val_loss"])
                   / abs(ref["val_loss"]), step_ms=t["step_ms"],
                   train_launches=t["train_launches"], val_launches=t["val_launches"])
        row["checksum"] = t["checksum"]
        if "params" in t:
            d = torch.cat([(t["params"][k] - ref["params"][k]).abs().reshape(-1)
                           for k in ref["params"]])
            row.update(param_max_abs=float(d.max()), param_share_within_lr_10=float(
                (d <= lr / 10).float().mean()), n_params=int(d.numel()),
                grad_rel_l2=float((t["grad"] - ref["grad"]).norm() / ref["grad"].norm()))
        train["ranks"].append(row)
        if max(row["loss_rel"]) > MD_LOSS_REL or row["val_rel"] > MD_LOSS_REL:
            failures.append(f"rank {r['rank']}'s UNet losses are off the single-process run: {row}")
        if "param_max_abs" in row and (row["param_max_abs"] > 2 * lr * steps * 1.1
                                       or row["grad_rel_l2"] > MD_GRAD_REL):
            failures.append(f"rank 0's UNet gradient or parameters are off the single-process "
                            f"run: {row}")
        if t["checksum"] != ranks[0]["train"]["checksum"]:
            failures.append(f"rank {r['rank']}'s parameters differ from rank 0's: {row}")
        if t["train_launches"]["fused_conv3x3_bn_relu"] != 0 or \
                t["val_launches"]["fused_conv3x3_bn_relu"] != 2:
            failures.append(f"rank {r['rank']} launched the fused conv {t['train_launches']} in "
                            f"train steps and {t['val_launches']} in its validation forward, "
                            f"want 0 and 2")
        want = {"max_pool_with_indices": 4 * s["forwards"], "max_unpool": 4 * s["forwards"],
                "fused_conv3x3_bn_relu": 2 * s["forwards"]}
        got = {k: s["launches"][k] for k in want}
        if got != want or s["stored_rows"] != MD_BATCH:
            failures.append(f"rank {r['rank']}'s SegNet evaluation launched {got}, want {want} "
                            f"({s['forwards']} forwards, {s['stored_rows']} stored rows)")
        for k in ("mean_iou", "mean_accuracy", "mean_f1_score"):
            if abs(s["results"][k] - single["segnet"]["results"][k]) > 5e-3:
                failures.append(f"rank {r['rank']}'s SegNet {k} {s['results'][k]} is off the "
                                f"single process's {single['segnet']['results'][k]}")
        for kind in ("bf16", "int8"):
            a, b = r["scene"][kind], single["scene"][kind]
            if not (np.array_equal(a["mask"], b["mask"]) and np.array_equal(a["band"], b["band"])):
                failures.append(f"rank {r['rank']}'s {kind} scene differs from one process's")
    segnet = dict(single=single["segnet"]["results"], single_launches=single["segnet"]["launches"],
                  ranks=[dict(rank=r["rank"], results=r["segnet"]["results"],
                              launches=r["segnet"]["launches"], forwards=r["segnet"]["forwards"],
                              rows=r["segnet"]["rows"]) for r in ranks])
    n_side = -(-(MD_SCENE - MD_SIZE // 8) // (MD_SIZE - MD_SIZE // 8))
    n_tiles = n_side * n_side
    scene = dict(size=MD_SCENE, tiles=n_tiles, batch=MD_BATCH,
                 single={k: dict(s=v["s"], launches=v["launches"],
                                 water_fraction=float(v["mask"].mean()))
                         for k, v in single["scene"].items()},
                 ranks=[{k: dict(s=v["s"], launches=v["launches"],
                                 bit_identical=bool(np.array_equal(v["mask"], single["scene"][k]["mask"])
                                                    and np.array_equal(v["band"],
                                                                       single["scene"][k]["band"])))
                         for k, v in r["scene"].items()} for r in ranks])
    # rank r forwards chunks r, r + MD_RANKS, ... of 8 tiles each
    forwards = -(-(-(-n_tiles // MD_BATCH)) // MD_RANKS)
    for r in scene["ranks"]:
        if r["bf16"]["launches"]["fused_conv3x3_bn_relu"] != 2 * forwards or \
                r["bf16"]["launches"]["dilate_disk"] != 1 or \
                r["int8"]["launches"]["int8_conv"] != INT8_CONVS["unet"] * forwards or \
                r["int8"]["launches"]["dilate_disk"] != 1:
            failures.append(f"a rank's scene launches are off: {r}")
    result = dict(ranks=MD_RANKS, backend="gloo", device="cuda:0", single_s=single_s,
                  ranks_s=ranks_s, train=train, segnet=segnet, scene=scene, holds=holds,
                  cli=cli_out, loss_rel_limit=MD_LOSS_REL, grad_rel_limit=MD_GRAD_REL)
    log("multi_device", json.dumps({k: v for k, v in result.items() if k != "holds"}))
    with open(os.path.join(MULTI_DIR, "result.json"), "w") as f:
        json.dump(dict(result, failures=failures), f, indent=1)
    if failures:
        raise AssertionError("multi-device phase failed:\n" + "\n".join(failures))
    return result


def md_launches(result) -> dict:
    """{kernel: {path: launches}} of the phase, summed over the ranks."""
    out = {}
    for t, s, sc in zip(result["train"]["ranks"], result["segnet"]["ranks"],
                        result["scene"]["ranks"]):
        for k, n in t["val_launches"].items():
            out.setdefault(k, {}).setdefault("multi_device_unet_validate", 0)
            out[k]["multi_device_unet_validate"] += n
        for k, n in s["launches"].items():
            out.setdefault(k, {}).setdefault("multi_device_segnet_eval", 0)
            out[k]["multi_device_segnet_eval"] += n
        for kind in ("bf16", "int8"):
            for k, n in sc[kind]["launches"].items():
                out.setdefault(k, {}).setdefault(f"multi_device_scene_{kind}", 0)
                out[k][f"multi_device_scene_{kind}"] += n
    return {k: {p: n for p, n in v.items() if n} for k, v in out.items()}


SPACE_DIR = os.path.join(REPO, "build", "space")  # listed in .gitignore
SP_RANKS, SP_SIZE, SP_BATCH, SP_SCENE, SP_STEPS, SP_LR = 2, 512, 8, 2048, 3, 1e-4
# f32 forwards against one process: the bridge's forward tolerance
# (`tests/test_torch_import.py:114`); cuDNN picks algorithms by shape, so a
# rank's half-height convs sum in another order than one process's
SP_F32_TOL = (2e-4, 1e-3)
# masks agreeing with one process: the scene 99.9%; SegNet's bf16 95% (pool
# windows flip on near-ties, ROADMAP queue 3), its pool and unpool calls bit
# for bit on their own inputs. The Robust U-Net's bf16 masks are held to the
# float32 forward instead: a rank's maps equal one process's bit for bit
# until the bottleneck at 32^2 (16 rows a rank), whose convs cuDNN rounds
# otherwise on a rank's slab (the dilated block's output 1.4e-5 of its
# elements one bf16 ulp apart, the 1024-channel conv after it 0.38%;
# `SP_TAPS`), and the decoder spreads that to 0.33% of the seeded model's
# masks (PERF.md); so the row-split bf16 masks must agree with float32
# within SP_BF16_MARGIN of one process's bf16 agreement with float32
SP_MASK_AGREE = {"segnet": 0.95, "scene": 0.999}
SP_BF16_MARGIN = 1e-3
# a rank's peak memory in the Robust U-Net's bf16 train steps, against one
# process's on the same card: the axis exists to cut it
SP_MEMORY_SHARE = 0.7
SP_COUNTERS = ("fused_conv3x3_bn_relu", "avg_max_pool", "gated_spatial_stats", "cbam_tail",
               "max_pool_with_indices", "max_unpool", "dilate_disk")


def sp_counts() -> dict:
    return {k: n for k, n in launch_counts().items() if k in SP_COUNTERS}


def sp_tiles(dev):
    """The phase's batch: SP_BATCH coast tiles of SP_SIZE^2 (uint8 NHWC,
    masks) and the normalized NCHW float32 input on `dev`."""
    images, masks, _ = coast_tiles(SP_BATCH, SP_SIZE, 31)
    x = normalize_images(torch.from_numpy(images).to(dev)).permute(0, 3, 1, 2)
    return images, masks, x.contiguous(memory_format=torch.channels_last)


def sp_models():
    """(name, dtype, state_dict) of the phase's eval forwards."""
    rsd = robust_unet_state_dict(random_robust_unet_variables(seed=0))
    ssd = segnet_state_dict(random_segnet_variables(seed=0))
    return [("Robust UNet", torch.bfloat16, rsd), ("Robust UNet", torch.float32, rsd),
            ("SegNet", torch.bfloat16, ssd)]


@contextlib.contextmanager
def held_space_kernels(record):
    """`held_kernels` for a row-split forward: each kernel is held where it
    launches, on the inputs it gets there: the fused conv on its halo'd
    slab (`fused_conv._fused`), the CBAM pool in its partials mode (the
    combine over the ranks runs after it), the stats, the tail with its
    halo'd stats, and SegNet's pool and unpool bit for bit."""
    def hold(name, x, got, ref, ok):
        r = record.setdefault(name, dict(calls=0, failed=0, max_abs_err=0.0, shapes=[]))
        r["calls"] += 1
        r["failed"] += not ok
        r["max_abs_err"] = max(r["max_abs_err"], float((got.float() - ref.float()).abs().max()))
        if list(x.shape) not in r["shapes"]:
            r["shapes"].append(list(x.shape))

    real_fused, real_pool = fused_conv_module._fused, cbam.run_avg_max_pool
    real_stats, real_tail = cbam.gated_spatial_stats, cbam.cbam_tail_apply
    real_mp, real_up = unpool.max_pool_with_indices, unpool.max_unpool

    def fused(x, w, scale, bias, relu):
        got, ref = real_fused(x, w, scale, bias, relu), fused_conv3x3_bn_relu_plain(
            x, w, scale, bias, relu)
        hold("fused_conv3x3_bn_relu", x, got, ref, _conv_ok(got, ref))
        return got

    def pool(x, wrapper, partials=False):
        if collectives.row_split() is not None and not partials:
            return real_pool(x, wrapper)  # the combine; its partials call comes back here
        got, ref = real_pool(x, wrapper, partials), cbam.avg_max_pool_plain(x, partials)
        area = 1 if not partials else x.shape[1] * x.shape[2]
        absmean = x.float().abs().mean((1, 2))
        ok = torch.equal(got[1], ref[1]) and _mean_ok(got[0] / area, ref[0] / area, absmean,
                                                      torch.float32 if partials else x.dtype)
        hold("avg_max_pool", x, torch.stack(got), torch.stack(ref), ok)
        return got

    def stats(x, gate):
        got, ref = real_stats(x, gate), cbam.gated_spatial_stats_plain(x, gate)
        z_abs = (x * gate[:, None, None, :]).float().abs().mean(-1)
        ok = torch.equal(got[:, 1], ref[:, 1]) and _mean_ok(got[:, 0], ref[:, 0], z_abs, x.dtype)
        hold("gated_spatial_stats", x, got, ref, ok)
        return got

    def tail(y, shortcut, gate, st, w, halo=0):
        got = real_tail(y, shortcut, gate, st, w, halo=halo)
        ref = cbam.cbam_tail_apply_plain(y, shortcut, gate, st, w, halo)
        hold("cbam_tail", y, got, ref, _tail_ok(got, ref, y, y.dtype))
        return got

    def mp(x):
        got, ref = real_mp(x), unpool.max_pool_with_indices_plain(x)
        hold("max_pool_with_indices", x, got[0], ref[0],
             _bits_equal(got[0], ref[0]) and _bits_equal(got[1], ref[1]))
        return got

    def up(vals, codes):
        got, ref = real_up(vals, codes), unpool.max_unpool_plain(vals, codes)
        hold("max_unpool", vals, got, ref, _bits_equal(got, ref))
        return got

    # the stats, tail, pool and unpool wrappers count on the name their module
    # looks up, here the held function: these comparison runs' launches land there
    stats.launches = tail.launches = mp.launches = up.launches = 0
    with patched(fused_conv_module, _fused=fused), \
            patched(cbam, run_avg_max_pool=pool, gated_spatial_stats=stats, cbam_tail_apply=tail), \
            patched(unpool, max_pool_with_indices=mp, max_unpool=up):
        yield


def sp_forward(model, x, mesh):
    """`model`'s logits on this rank's rows of `x` (or on all of it with
    mesh=None), under `no_grad`; with a mesh the rows are gathered back
    whole. Returns the forward as a thunk and the logits."""
    if mesh is None:
        def fwd():
            return model(x, return_logits=True)
        with torch.no_grad():
            return fwd, fwd()
    from coastline_torch.parallel.mesh import batch_sharding, space_group

    h, w = x.shape[2:]
    xl = x[:, :, batch_sharding(mesh).rows_of(h)].contiguous(memory_format=torch.channels_last)
    group = space_group(mesh)

    def fwd():
        with collectives.split_rows(group, h, w) as split:
            y = model(xl, return_logits=True)
            return collectives.gather_rows(y, split)
    with torch.no_grad():
        return fwd, fwd()


def sp_eval(dev, mesh=None):
    """The phase's eval forwards on one device or on this rank's rows:
    each warmed once, then counted (every counter zeroed just before),
    timed, and run again with every kernel call held against its plain
    version (`held_space_kernels`)."""
    _, _, x = sp_tiles(dev)
    out = {}
    for name, dt, sd in sp_models():
        model = create_model(name, dtype=dt)
        model.load_state_dict(sd, strict=True)
        model = model.to(dev).eval()
        fwd, _ = sp_forward(model, x, mesh)
        sync(dev)
        taps = sp_taps(model) if name == "Robust UNet" else {}
        md_zero()
        with torch.no_grad():
            logits = fwd().float()
        sync(dev)
        launches = sp_counts()
        maps = sp_untap(taps, mesh)
        record = {}
        with torch.no_grad(), held_space_kernels(record):
            fwd()
        with torch.no_grad():
            ms = cuda_ms(fwd, 3, warmup=0)
        tag = f"{label(name)}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
        out[tag] = dict(logits=logits.cpu(), launches=launches, held=record, forward_ms=ms,
                        maps=maps)
        del model
        torch.cuda.empty_cache()
    return out


SP_TAPS = ("bottleneck.1", "bottleneck.2.conv1")  # the dilated block; the first 1024-channel conv


def sp_taps(model):
    """Forward hooks keeping the outputs of the Robust U-Net's `SP_TAPS`
    (where a rank's bf16 forward first parts from one process's)."""
    kept, hooks = {}, []
    for name, mod in model.named_modules():
        if name in SP_TAPS:
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: kept.__setitem__(name, o)))
    return dict(kept=kept, hooks=hooks)


def sp_untap(taps, mesh):
    """The tapped maps, whole (a rank's rows gathered), on the host; the
    hooks removed."""
    if not taps:
        return {}
    for h in taps["hooks"]:
        h.remove()
    out = {}
    for name, t in taps["kept"].items():
        if mesh is not None:  # both maps are the 1/16 level: SP_SIZE / 16 rows
            from coastline_torch.parallel.mesh import space_group

            split = collectives.RowSplit(space_group(mesh), SP_SIZE // 16, SP_SIZE // 16)
            t = collectives.gather_rows(t.contiguous(memory_format=torch.channels_last), split)
        out[name] = t.cpu()
    return out


def sp_train(dev, mesh=None):
    """SP_STEPS bf16 Adam steps (lr 1e-4, dropout on, no augmentation) of the
    full-width Robust U-Net at batch SP_BATCH, SP_SIZE^2, one batch a step:
    on one device or on this rank's rows of every image. Each process's
    peak memory is read over the steps, its counter reset once the model,
    its Adam state and the tiles are on the card; `step_ms` includes the
    first step's cuDNN plan choice."""
    sd = robust_unet_state_dict(random_robust_unet_variables(seed=0))
    images, masks, _ = coast_tiles(SP_STEPS * SP_BATCH, SP_SIZE, 32)
    model = create_model("Robust UNet", dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    cfg = TrainConfig(batch_size=SP_BATCH, lr=SP_LR, weight_decay=0.0, seed=0)
    epoch = make_train_epoch(model, cfg, device=dev, mesh=mesh)
    state = create_train_state(model, cfg, device=dev)
    idx, valid = batch_indices(len(images), SP_BATCH, shuffle=False,
                               rng=np.random.default_rng(0))
    images, masks = torch.from_numpy(images).to(dev), torch.from_numpy(masks).to(dev)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, losses = epoch(state, images, masks, idx, valid, per_step=True)
    sync(dev)
    step_ms = (time.perf_counter() - t0) / SP_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    params = {k: v.detach().float().cpu() for k, v in model.named_parameters()}
    return dict(losses=losses.tolist(), peak_gib=peak, step_ms=step_ms, params=params)


def sp_scene(dev, mesh=None):
    """`predict_scene(batch=8, with_band=20)` of a 2048^2 scene with the
    full-width bf16 UNet extractor, warmed once, then counted."""
    ex = CoastlineExtractor(variables=random_unet_variables(seed=0), dtype=torch.bfloat16,
                            image_size=SP_SIZE, device=dev)
    scene, _ = tiled_scene(SP_SCENE, 13)
    ex.predict_scene(scene, batch=SP_BATCH, with_band=20, mesh=mesh)
    sync(dev)
    md_zero()
    t0 = time.perf_counter()
    mask, band = ex.predict_scene(scene, batch=SP_BATCH, with_band=20, mesh=mesh)
    sync(dev)
    s = time.perf_counter() - t0
    launches = sp_counts()
    redo = coastline_band(torch.from_numpy(mask).to(dev), 20, device=dev).cpu().numpy()
    return dict(mask=mask, band=band, s=s, launches=launches,
                band_is_dilation=bool(np.array_equal(band, redo)))


def space_rank():
    """One rank of the space phase (two gloo ranks on `cuda:0`,
    `make_mesh(2, space=2)`: each holds every image's half of the rows)."""
    from coastline_torch.parallel.launch import local_device
    from coastline_torch.parallel.mesh import make_mesh

    md_flags()
    dev = local_device()
    mesh = make_mesh(SP_RANKS, space=SP_RANKS)
    out = dict(rank=torch.distributed.get_rank(), device=str(dev), eval=sp_eval(dev, mesh))
    out["train"] = sp_train(dev, mesh)
    out["scene"] = sp_scene(dev, mesh)
    return out


def check_space_kernels(dev):
    """The two kernel modes the row split adds, against their plain
    versions at a rank's shapes (half of 8 x 512 x 512 rows), and timed:
    the CBAM tail reading stats with a 3-row halo and with none (bf16 and
    f32), and the CBAM pool's float32 partials (bf16 and f32)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (SP_BATCH, SP_SIZE // SP_RANKS, SP_SIZE, 64)
    out, failures = {}, []
    for dt in (torch.bfloat16, torch.float32):
        y, s, gate, w = _cbam_inputs(shape, dt, dev, gen)
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for halo in (3, 0):
            st = torch.randn((shape[0], 2, shape[1] + 2 * halo, shape[2]), device=dev,
                             generator=gen).to(dt)
            got = cbam.cbam_tail_apply(y, s, gate, st, w, halo=halo)
            ref = cbam.cbam_tail_apply_plain(y, s, gate, st, w, halo)
            n = y.numel()
            bound_ms, bound_by = bound(3 * n * y.element_size() + st.numel() * y.element_size(),
                                       98 * n // shape[3] + 4 * n, PEAK_F32_OPS)
            out[f"cbam_tail_halo{halo}_{tag}"] = dict(
                shape=list(shape), halo=halo, ok=_tail_ok(got, ref, y, dt),
                max_abs_err=float((got.float() - ref.float()).abs().max()),
                ms=cuda_ms(lambda: cbam.cbam_tail_apply(y, s, gate, st, w, halo=halo), 10),
                plain_ms=cuda_ms(lambda: cbam.cbam_tail_apply_plain(y, s, gate, st, w, halo),
                                 3, 1),
                bound_ms=bound_ms, bound_by=bound_by)
        got = cbam.avg_max_pool(y, partials=True)
        ref = cbam.avg_max_pool_plain(y, partials=True)
        area = shape[1] * shape[2]
        ok = torch.equal(got[1], ref[1]) and _mean_ok(got[0] / area, ref[0] / area,
                                                      y.float().abs().mean((1, 2)), torch.float32)
        bound_ms, bound_by = bound(y.numel() * y.element_size() + 2 * shape[0] * 64 * 4,
                                   2 * y.numel(), PEAK_F32_OPS)
        out[f"avg_max_pool_partials_{tag}"] = dict(
            shape=list(shape), ok=ok, max_abs_err=float((torch.stack(got) - torch.stack(ref))
                                                        .abs().max()),
            ms=cuda_ms(lambda: cbam.avg_max_pool(y, partials=True), 10),
            plain_ms=cuda_ms(lambda: cbam.avg_max_pool_plain(y, partials=True), 3, 1),
            library_ms=cuda_ms(lambda: (y.float().sum((1, 2)), y.amax((1, 2))), 10),
            bound_ms=bound_ms, bound_by=bound_by)
        del y, s, gate, st
    for name, row in out.items():
        log("space_kernel", name, json.dumps(row))
        if not row["ok"]:
            failures.append(f"{name} disagrees with its plain version: {row}")
    return out, failures


def space_path(dev):
    """The space phase: one process on the card, then two gloo ranks on
    cuda:0 under `make_mesh(2, space=2)`, each holding half the rows of
    every image, against it: (a) the full-width Robust U-Net's bf16 and f32
    eval forwards at batch 8, 512^2, (b) SegNet's bf16 forward, both with
    every kernel counted on each rank and every kernel call held against
    its plain version; (c) 3 bf16 Robust U-Net train steps with each rank's
    peak memory beside one process's; (d) `predict_scene(mesh=)` of a
    2048^2 scene with the UNet, mask and band. Then the tail's halo and
    the pool's partials against their plain versions. Two ranks on one
    card share its SMs and exchange halos through the host (gloo): their
    times are not a scaling measurement."""
    from coastline_torch.parallel.launch import run

    t0 = time.perf_counter()
    single = dict(eval=sp_eval(dev), train=sp_train(dev), scene=sp_scene(dev))
    single_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run(space_rank, SP_RANKS, device="cuda:0", backend="gloo")
    ranks_s = time.perf_counter() - t0
    kernels, failures = check_space_kernels(dev)
    result = dict(ranks=SP_RANKS, backend="gloo", device="cuda:0", single_s=single_s,
                  ranks_s=ranks_s, kernels=kernels, eval={}, train={}, scene={})
    want = {"robust_unet_bf16": {"fused_conv3x3_bn_relu": 2, "avg_max_pool": 9,
                                 "gated_spatial_stats": 9, "cbam_tail": 9},
            "robust_unet_f32": {"fused_conv3x3_bn_relu": 0, "avg_max_pool": 9,
                                "gated_spatial_stats": 9, "cbam_tail": 9},
            "segnet_bf16": {"fused_conv3x3_bn_relu": 2, "max_pool_with_indices": 4,
                            "max_unpool": 4}}
    for tag, ref in single["eval"].items():
        rows = []
        for r in ranks:
            e = r["eval"][tag]
            got = {k: e["launches"][k] for k in want[tag]}
            cmp = compare_logits(e["logits"], ref["logits"], torch.float32)
            row = dict(rank=r["rank"], launches=got, held=e["held"], forward_ms=e["forward_ms"],
                       mask_agree=cmp["mask_agree"], max_abs_err=cmp["max_abs_err"])
            if e["maps"]:  # where the rank's forward first parts from one process's
                row["maps_differing_share"] = {k: float((t != ref["maps"][k]).float().mean())
                                               for k, t in e["maps"].items()}
            if tag == "robust_unet_f32":
                row["within_f32_tol"] = bool(torch.allclose(e["logits"], ref["logits"],
                                                            atol=SP_F32_TOL[0],
                                                            rtol=SP_F32_TOL[1]))
                if not row["within_f32_tol"]:
                    failures.append(f"rank {r['rank']}'s {tag} logits are off one process's: {row}")
            elif tag == "robust_unet_bf16":
                f32 = single["eval"]["robust_unet_f32"]["logits"]
                row["vs_f32_mask_agree"] = compare_logits(e["logits"], f32, torch.float32)[
                    "mask_agree"]
                row["single_vs_f32_mask_agree"] = compare_logits(ref["logits"], f32,
                                                                 torch.float32)["mask_agree"]
                if row["vs_f32_mask_agree"] < row["single_vs_f32_mask_agree"] - SP_BF16_MARGIN:
                    failures.append(f"rank {r['rank']}'s {tag} masks are further from float32 "
                                    f"than one process's: {row}")
            elif cmp["mask_agree"] < SP_MASK_AGREE[tag.rsplit("_", 1)[0]]:
                failures.append(f"rank {r['rank']}'s {tag} masks agree on {cmp['mask_agree']}")
            if got != want[tag]:
                failures.append(f"rank {r['rank']}'s {tag} forward launched {got}, want "
                                f"{want[tag]}")
            for k, h in e["held"].items():
                if h["failed"] or h["calls"] != want[tag].get(k, h["calls"]):
                    failures.append(f"rank {r['rank']}'s {tag} {k} calls held: {h}")
            if set(k for k, n in want[tag].items() if n) - set(e["held"]):
                failures.append(f"rank {r['rank']}'s {tag} held no call of {want[tag]}")
            rows.append(row)
        result["eval"][tag] = dict(single_forward_ms=ref["forward_ms"],
                                   single_launches=ref["launches"], ranks=rows)
    ref = single["train"]
    limit = 2 * SP_LR * SP_STEPS * 1.1
    result["train"] = dict(single_losses=ref["losses"], single_peak_gib=ref["peak_gib"],
                           single_step_ms=ref["step_ms"], ranks=[], param_limit=limit,
                           memory_share_limit=SP_MEMORY_SHARE)
    for r in ranks:
        t = r["train"]
        d = torch.cat([(t["params"][k] - ref["params"][k]).abs().reshape(-1) for k in ref["params"]])
        row = dict(rank=r["rank"], losses=t["losses"], peak_gib=t["peak_gib"],
                   peak_share=t["peak_gib"] / ref["peak_gib"], step_ms=t["step_ms"],
                   param_max_abs=float(d.max()),
                   loss_rel=[abs(a - b) / abs(b) for a, b in zip(t["losses"], ref["losses"])])
        result["train"]["ranks"].append(row)
        if row["param_max_abs"] > limit or max(row["loss_rel"]) > MD_LOSS_REL:
            failures.append(f"rank {r['rank']}'s Robust U-Net steps are off one process's: {row}")
        if row["peak_share"] >= SP_MEMORY_SHARE:
            failures.append(f"rank {r['rank']}'s train-step peak {row['peak_gib']:.2f} GiB is "
                            f"{row['peak_share']:.3f} of one process's {ref['peak_gib']:.2f}")
    ref = single["scene"]
    result["scene"] = dict(size=SP_SCENE, single_s=ref["s"], single_launches=ref["launches"],
                           ranks=[])
    for r in ranks:
        sc = r["scene"]
        agree = float((sc["mask"] == ref["mask"]).mean())
        row = dict(rank=r["rank"], s=sc["s"], launches=sc["launches"], mask_agree=agree,
                   band_is_dilation=sc["band_is_dilation"],
                   water_fraction=float(sc["mask"].mean()))
        result["scene"]["ranks"].append(row)
        if agree < SP_MASK_AGREE["scene"] or not sc["band_is_dilation"]:
            failures.append(f"rank {r['rank']}'s scene is off one process's: {row}")
        forwards = ref["launches"]["fused_conv3x3_bn_relu"] // 2
        if sc["launches"]["fused_conv3x3_bn_relu"] != 2 * forwards or \
                sc["launches"]["dilate_disk"] != 1:
            failures.append(f"rank {r['rank']}'s scene launches {sc['launches']}, want "
                            f"{2 * forwards} fused convs and one dilation")
    log("space", json.dumps(result))
    os.makedirs(SPACE_DIR, exist_ok=True)
    with open(os.path.join(SPACE_DIR, "result.json"), "w") as f:
        json.dump(dict(result, failures=failures), f, indent=1)
    if failures:
        raise AssertionError("space phase failed:\n" + "\n".join(failures))
    return result


def space_launches(result) -> dict:
    """{kernel: {path: launches}} of the space phase, summed over its ranks."""
    out = {}
    for tag, e in result["eval"].items():
        for r in e["ranks"]:
            for k, n in r["launches"].items():
                out.setdefault(k, {}).setdefault(f"space_{tag}", 0)
                out[k][f"space_{tag}"] += n
    for r in result["scene"]["ranks"]:
        for k, n in r["launches"].items():
            out.setdefault(k, {}).setdefault("space_scene", 0)
            out[k]["space_scene"] += n
    return {k: {p: n for p, n in v.items() if n} for k, v in out.items()}


TOOLS_DIR = os.path.join(REPO, "build", "tools_path")  # listed in .gitignore
# the root bench's keys (`bench.py:213-230`), which the port's bench line carries
ROOT_BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "best_batch", "bf16_images_per_sec",
                   "int8_images_per_sec", "int8_accuracy_gated", "int8_zoo_accuracy_gated",
                   "p50_tile_latency_ms", "int8_p50_tile_latency_ms",
                   "train_images_per_sec_per_chip", "platform")
BENCH_KW = dict(n_loop=5, trials=1)  # short loops: the bench's numbers here are a smoke reading
BENCH_BF16_WANT = {"avg_max_pool": 9, "gated_spatial_stats": 9, "cbam_tail": 9,
                   "fused_conv3x3_bn_relu": 2}
# kernel-name substrings (`_KERNEL_CLASSES`) a bf16 Robust U-Net forward's trace must show
TRACE_WANT = {"cbam_avg_max": 9, "cbam_gated_stats": 9, "cbam_tail_kernel": 9,
              "fused_conv_kernel": 2}


def keep_first(store, batch, fixed, make) -> bool:
    """Put `make()` under `batch` in `store` at the first call of each batch
    in `fixed`, and at the first call of a batch larger than any other kept,
    dropping that one: `store` ends with `fixed` and the largest batch.
    Returns whether it put it."""
    if batch in store:
        return False
    if batch not in fixed:
        others = [b for b in store if b not in fixed]
        if others and max(others) > batch:
            return False
        for b in others:
            del store[b]
    store[batch] = make()
    return True


def one_off(kernel):
    """A control for `held_kernels`: `kernel` with the last element of its
    output one more, which every held call of it must see."""
    def off(*args, **kw):
        out = kernel(*args, **kw)
        out.view(-1)[-1] += 1
        return out
    return off


def bench_vs_plain(dev, bf16_kept, int8_kept, failures):
    """The bench's kept outputs (`tools_bench`) against the plain-version
    forward (`plain_kernels`) on the card, on the same input and weights,
    free-running: bf16 masks within the eval paths' limit at 512^2
    (`ROBUST_UNET_LIMITS["bf16"]`'s), with the logits' share within 0.1 std
    reported (`compare_logits`), and int8 masks within the int8 evals' limit
    (`INT8_EVAL`). The plain forwards must launch no kernel. Then, held, on
    the same inputs: a forward under `held_kernels`, every kernel call
    within its check's criterion and each kernel called as often as a bench
    forward launches it. The controls (`one_off` in the CBAM tail and in
    the int8 conv, at batch 1) must fail every held call of that kernel."""
    from coastline_torch import bench

    agree = ROBUST_UNET_LIMITS["bf16"][1]
    int8_limit = INT8_EVAL["robust_unet"][1]
    out = dict(bf16={}, int8={})

    def held(forward, want, label, off=None):
        record = {}
        with held_kernels(record), torch.inference_mode():
            forward()
        sync(dev)
        calls = {k: r["calls"] for k, r in record.items()}
        failed = {k: r["failed"] for k, r in record.items() if r["failed"]}
        if calls != want or failed != ({off: want[off]} if off else {}):
            failures.append(f"{label}, each kernel call held to its plain version: {record} "
                            f"(want calls {want}, failed calls only {off})")
        return record

    model = bench.bf16_model(dev)
    for b, (x, logits) in sorted(bf16_kept.items()):
        for fn in ALL_COUNTERS.values():
            fn.launches = 0
        with plain_kernels(), torch.inference_mode():
            ref = model(x, return_logits=True)
        sync(dev)
        launched = {k: n for k, n in launch_counts().items() if n}
        r = out["bf16"][b] = dict(compare_logits(logits, ref, torch.bfloat16),
                                  finite=bool(torch.isfinite(logits).all()),
                                  plain_launches=launched)
        del ref
        if launched or not r["finite"] or r["mask_agree"] < agree:
            failures.append(f"the bench's bf16 batch-{b} logits against the plain-version "
                            f"forward: {r} (mask limit {agree})")
        r["held"] = held(lambda: model(x, return_logits=True), BENCH_BF16_WANT,
                         f"the bench's bf16 forward at batch {b}")
    with patched(cbam, cbam_tail_apply=one_off(cbam.cbam_tail_apply)):
        out["control_cbam_tail"] = held(lambda: model(bf16_kept[1][0], return_logits=True),
                                        BENCH_BF16_WANT, "control: the tail one off", "cbam_tail")
    del model
    for b, (args, kwargs, probs) in sorted(int8_kept.items()):
        for fn in ALL_COUNTERS.values():
            fn.launches = 0
        with plain_kernels(), torch.inference_mode():
            ref = quant.int8_forward(*args, **kwargs)
        sync(dev)
        launched = {k: n for k, n in launch_counts().items() if n}
        r = out["int8"][b] = dict(
            mask_agree=mask_agreement("robust_unet", probs, ref), limit=int8_limit,
            max_abs_err=float((probs - ref).abs().max()), bit_equal=_bits_equal(probs, ref),
            finite=bool(torch.isfinite(probs).all()), plain_launches=launched)
        del ref
        if launched or not r["finite"] or r["mask_agree"] < int8_limit:
            failures.append(f"the bench's int8 batch-{b} output against the plain-version "
                            f"forward: {r}")
        r["held"] = held(lambda: quant.int8_forward(*args, **kwargs),
                         {"int8_conv": INT8_CONVS["robust_unet"]},
                         f"the bench's int8 forward at batch {b}")
    args, kwargs, _ = int8_kept[1]
    with patched(quant, int8_conv=one_off(quant.int8_conv)):
        out["control_int8_conv"] = held(lambda: quant.int8_forward(*args, **kwargs),
                                        {"int8_conv": INT8_CONVS["robust_unet"]},
                                        "control: the int8 conv one off", "int8_conv")
    torch.cuda.empty_cache()
    log("bench_vs_plain", json.dumps(out))
    return out


def tools_bench(dev, failures, **kw):
    """(a) `coastline_torch.bench.run` in-process, every launch counter at
    0 just before it: each Robust U-Net forward and each int8 forward it
    makes is counted (a wrapper around `RobustUNet.forward` and
    `quant.int8_forward`). The outputs of the first call at a batch, the
    warm call of its timing loop (carry 0, so the input is unscaled), are
    kept with their inputs at batch 1, 8 (bf16) and the largest batch:
    bf16 logits from the forward's `outc`, int8 outputs. After the run,
    the batch-8 logits must equal, bit for bit, a direct call of the same
    seeded model on the same seeded input, and every kept output must agree
    with the plain-version forward (`bench_vs_plain`)."""
    from coastline_torch import bench
    from coastline_torch.models.robust_unet import RobustUNet

    forward, int8_forward = RobustUNet.forward, quant.int8_forward
    bf16, int8, bf16_kept, int8_kept = [], [], {}, {}

    def counted_forward(self, x, return_logits=False):
        before = launch_counts()
        logits = []
        keep = not self.training and keep_first(bf16_kept, int(x.shape[0]), (1, 8),
                                                lambda: (x.clone(), logits))
        hook = (self.outc.register_forward_hook(lambda m, a, o: logits.append(o.float()))
                if keep else None)
        try:
            out = forward(self, x, return_logits)
        finally:
            if hook is not None:
                hook.remove()
        bf16.append(dict(training=self.training, batch=int(x.shape[0]),
                         launches=launches_since(before)))
        return out

    def counted_int8(*args, **kwargs):
        before = launch_counts()
        out = int8_forward(*args, **kwargs)
        int8.append(launches_since(before))
        keep_first(int8_kept, int(args[2].shape[0]), (1,), lambda: (args, kwargs, out.clone()))
        return out

    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with patched(RobustUNet, forward=counted_forward), patched(quant, int8_forward=counted_int8):
        line = bench.run(device=dev, **kw)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    log("bench_line", json.dumps(line))

    missing = [k for k in ROOT_BENCH_KEYS if k not in line]
    if missing or not line["value"] > 0 or line["platform"] != "gpu" or \
            line["device_kind"] != torch.cuda.get_device_name(0):
        failures.append(f"the bench's line lacks {missing} or is off: {line}")
    evals = [f for f in bf16 if not f["training"]]
    trains = [f for f in bf16 if f["training"]]
    bad = [f for f in evals if {k: f["launches"][k] for k in BENCH_BF16_WANT} != BENCH_BF16_WANT]
    if not evals or bad:
        failures.append(f"{len(bad)} of {len(evals)} bf16 bench forwards launched other than "
                        f"{BENCH_BF16_WANT} a forward: {bad[:2]}")
    if not trains or any(any(f["launches"].values()) for f in trains):
        failures.append(f"the bench's train forwards ({len(trains)}) launched a kernel")
    bad8 = [f for f in int8 if f["int8_conv"] != INT8_CONVS["robust_unet"]]
    if not int8 or bad8:
        failures.append(f"{len(bad8)} of {len(int8)} int8 bench forwards launched int8_conv "
                        f"other than {INT8_CONVS['robust_unet']} times: {bad8[:2]}")
    bf16_kept = {b: (x, logits[0]) for b, (x, logits) in bf16_kept.items()}
    model = bench.bf16_model(dev)
    with torch.inference_mode():
        direct = model(bench.images(8, kw.get("size", 512), dev).permute(0, 3, 1, 2),
                       return_logits=True)
    equal = 8 in bf16_kept and torch.equal(direct, bf16_kept[8][1])
    if not equal:
        failures.append("the bench's bf16 batch-8 logits differ from a direct call")
    del model, direct
    vs_plain = bench_vs_plain(dev, bf16_kept, int8_kept, failures)
    del bf16_kept, int8_kept
    torch.cuda.empty_cache()
    return dict(line=line, s=seconds, launches={k: n for k, n in launches.items() if n},
                bf16_eval_forwards=len(evals), train_forwards=len(trains),
                int8_forwards=len(int8), batch8_bit_equal=equal, vs_plain=vs_plain,
                bf16_eval_launches_per_forward=evals[0]["launches"] if evals else None)


def tools_trace(dev, failures, size=512):
    """(b) `trace()` around one bf16 batch-8 Robust U-Net forward: the
    Chrome trace must name each kernel of the forward as often as it
    launches (`TRACE_WANT`)."""
    from coastline_torch import bench
    from coastline_torch.utils.profiling import trace

    model = bench.bf16_model(dev)
    x = bench.images(8, size, dev).permute(0, 3, 1, 2)
    with torch.inference_mode():
        model(x)
    # a first profiler session in a process can miss kernels: warm it up
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(8, device=dev).sum()
        torch.cuda.synchronize()
    logdir = fresh_dir(os.path.join(TOOLS_DIR, "trace"))
    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    with trace(logdir, device=dev) as d, torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
    launches = launch_counts()
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        failures.append(f"trace() wrote {files}, want one Chrome trace")
        return dict(files=files, launches=launches)
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat", "").lower() == "kernel"]
    seen = {k: sum(k in name for name in kernels) for k in TRACE_WANT}
    if seen != TRACE_WANT:
        failures.append(f"the trace names the kernels {seen} times, want {TRACE_WANT} "
                        f"({len(kernels)} kernel events; categories "
                        f"{sorted({e.get('cat', '') for e in events})[:12]})")
    del model, x
    torch.cuda.empty_cache()
    return dict(file=files[0], mb=os.path.getsize(os.path.join(d, files[0])) / 2**20,
                kernel_events=len(kernels), named=seen,
                launches={k: n for k, n in launches.items() if n})


def tools_gui(dev, failures, save_dir, size=512, dilation=20):
    """(d) The GUI's compute: `process_images` with the extractor the GUI
    loads (the trainer's best checkpoint in `save_dir`, float32) on two
    synthetic 512^2 PNG tiles, `drain_queue` into a `ResultStore`, and
    `save_extraction_result` for each. Each result's band must come from
    one `dilate_disk` launch and equal the plain version's."""
    import queue

    from PIL import Image

    from coastline_torch.cli.gui import ResultStore, drain_queue, process_images

    root = fresh_dir(os.path.join(TOOLS_DIR, "gui"))
    images, _, route = coast_tiles(2, size, seed=11)
    paths = []
    for i, img in enumerate(images):
        paths.append(os.path.join(root, f"tile{i}.png"))
        Image.fromarray(img).save(paths[-1])
    ex = (CoastlineExtractor(checkpoint_dir=save_dir, device=dev) if save_dir
          else CoastlineExtractor(device=dev))
    q = queue.Queue()
    for fn in ALL_COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    process_images(ex, paths, q, dilation)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    store, done = ResultStore(), []
    drain_queue(q, store, on_done=lambda: done.append(True))
    results = store.saveable()
    out_dir = os.path.join(root, "results")
    bands = []
    for r in results:
        band = coastline_band(r["water_mask"], dilation, device="cpu").numpy()  # plain version
        bands.append(dict(image=os.path.basename(r["image_path"]),
                          band_pixels=int(r["coastline_mask"].sum()),
                          band_equals_plain=bool(np.array_equal(band, r["coastline_mask"])),
                          coastlines=r["coastline_count"]))
        ex.save_extraction_result(r, out_dir)
    saved = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    if (len(results) != 2 or done != [True] or launches["dilate_disk"] != 2
            or not all(b["band_equals_plain"] and b["band_pixels"] > 0 for b in bands)
            or sum(f.endswith("_coastline_mask.png") for f in saved) != 2):
        failures.append(f"the GUI's compute: {len(results)} results, done {done}, launches "
                        f"{launches}, bands {bands}, saved {saved}")
    return dict(images=route, s=seconds, launches={k: n for k, n in launches.items() if n},
                results=bands, saved=saved)


def tools_path(dev, save_dir=TRAIN_DIR, size=512, bench_kw=BENCH_KW):
    """The tools phase: (a) the port's bench in-process (`tools_bench`),
    (b) a Chrome trace of a bf16 forward (`tools_trace`), (c) the dispatch
    round trip, (d) the GUI's compute (`tools_gui`). Failures are gathered
    and raised together."""
    from coastline_torch.utils.profiling import measure_dispatch_rtt

    failures = []
    result = dict(bench=tools_bench(dev, failures, size=size, **bench_kw))
    result["trace"] = tools_trace(dev, failures, size=size)
    result["dispatch_rtt_ms"] = measure_dispatch_rtt(device=dev) * 1e3
    if not 0 < result["dispatch_rtt_ms"] < 1e3:
        failures.append(f"dispatch round trip {result['dispatch_rtt_ms']} ms")
    result["gui"] = tools_gui(dev, failures, save_dir, size=size)
    log("tools_path", json.dumps(result))
    if failures:
        raise AssertionError("tools phase failed:\n" + "\n".join(failures))
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
    # bf16 GEMMs reduce split-K partials in float32, as the CPU does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, torch.cuda.get_device_name(0))

    t_start = t0 = time.perf_counter()
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
    zoo = zoo_path(dev)
    train = train_path(dev)
    protocol = protocol_path(dev)
    extraction = extraction_path(dev, train["save_dir"])
    granule = extraction["granule"]
    int8 = int8_path(dev, train["save_dir"])
    multi = multi_device_path(dev)
    space = space_path(dev)
    tools = tools_path(dev, train["save_dir"])

    def path_launches(path, name):
        return sum(e["launches"][name] for e in path["epochs"].values())

    def zoo_launches(name):
        return sum(path_launches(path, name) for path in zoo.values())

    main_dil = dil[0]
    on_protocol = protocol["launches"]
    conv_paths = {"serving": serving["launches"]["fused_conv3x3_bn_relu"],
                  "robust_unet_eval": path_launches(robust, "fused_conv3x3_bn_relu"),
                  "segnet_eval": path_launches(segnet, "fused_conv3x3_bn_relu"),
                  "zoo_eval": zoo_launches("fused_conv3x3_bn_relu"),
                  "unet_train_validate": train["fused_conv_launches"]["validate"],
                  "protocol": on_protocol["fused_conv3x3_bn_relu"],
                  "extraction_granule": granule["launches"]["fused_conv3x3_bn_relu"]}
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
             launches=(serving["launches"]["dilate_disk"] + on_protocol["dilate_disk"]
                       + granule["launches"]["dilate_disk"]),
             launches_by_path={"serving": serving["launches"]["dilate_disk"],
                               "protocol": on_protocol["dilate_disk"],
                               "extraction_granule": granule["launches"]["dilate_disk"]},
             max_abs_err=max(c["max_abs_err"] for c in dil), ms=main_dil["ms"],
             plain_ms=main_dil["plain_ms"], bound_ms=main_dil["bound_ms"],
             bound_by=main_dil["bound_by"], library_ms=main_dil["library_ms"],
             device_ms=main_dil["device_ms"], share_of_bound=main_dil["share_of_bound"],
             shape=main_dil["shape"], size=main_dil["size"],
             library="conv-threshold: F.conv2d f32 with the SE, then > 0", cases=dil,
             granule=granule["dilate_granule"]),
    ]
    for name, source, replaces in (
            ("avg_max_pool", "avg_max_pool.cu",
             "coastline/pallas/cbam.py:141 (and coastline/pallas/pools.py:56)"),
            ("gated_spatial_stats", "gated_spatial_stats.cu", "coastline/pallas/cbam.py:213"),
            ("cbam_tail", "cbam_tail.cu", "coastline/pallas/cbam.py:328")):
        t = cbam_times[name]
        by_path = {"robust_unet_eval": path_launches(robust, name), "protocol": on_protocol[name]}
        if name == "avg_max_pool":  # fused_avg_max_pool launches the same kernel
            by_path["zoo_eval_fused_avg_max_pool"] = zoo_launches("fused_avg_max_pool")
            by_path["protocol_fused_avg_max_pool"] = on_protocol["fused_avg_max_pool"]
        entry = dict(name=name, route="cuda", source=f"coastline_torch/csrc/{source}",
                     replaces=replaces, launches=sum(by_path.values()), launches_by_path=by_path,
                     max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
                     bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                     library_ms=t["library_ms"], shape=t["shape"], library=t["library"])
        if name == "avg_max_pool":
            entry.update(device_ms=t["device_ms"], share_of_bound=t["share_of_bound"],
                         levels=t["levels"],
                         launches_per_robust_unet_forward_profiled=robust["pool_launches_profiled"])
            entry["fused_avg_max_pool_launches_residual_block"] = block["fused_avg_max_pool_launches"]
            entry["fused_avg_max_pool_waternet"] = cbam_times["fused_avg_max_pool"]
        kernels.append(entry)
    for name, replaces in (("max_pool_with_indices", "coastline/pallas/unpool.py:67"),
                           ("max_unpool", "coastline/pallas/unpool.py:94")):
        t = unpool_times[name]
        by_path = {"segnet_eval": path_launches(segnet, name), "protocol": on_protocol[name],
                   "segnet_int8_eval": int8["segnet"]["launches"].get(name, 0),
                   "segnet_int8_export": int8["export"]["segnet"]["launches"].get(name, 0)}
        kernels.append(dict(name=name, route="cuda", source="coastline_torch/csrc/unpool.cu",
                            replaces=replaces, launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                            library_ms=t["library_ms"], shape=t["shape"], library=t["library"],
                            int8=t["int8"]))
    int8_by_path = {"int8_serving": int8["serving"]["launches"].get("int8_conv", 0),
                    "int8_scene": int8["scene"]["launches"].get("int8_conv", 0)}
    int8_by_path.update({f"{arch}_int8_eval": int8[arch]["launches"].get("int8_conv", 0)
                         for arch in INT8_EVAL})
    int8_by_path["int8_export"] = sum(r["launches"].get("int8_conv", 0)
                                      for arch, r in int8["export"].items() if arch in INT8_CONVS)
    cases = int8["conv_cases"]
    main_case = next((c for c in cases if c["x"] == [8, 512, 512, 64] and c["w"] == [3, 3, 64, 64]
                      and c["codes"] and c["act"] == "relu"), cases[0])  # the UNet's dc0.c2 (and dc8)
    kernels.append(dict(
        name="int8_conv", route="cuda", source="coastline_torch/csrc/int8_conv.cu",
        replaces="coastline/infer/quant.py:573",  # XLA's s8 conv: no Pallas kernel
        launches=sum(int8_by_path.values()), launches_by_path=int8_by_path,
        max_abs_err=max(c["max_abs_err"] for c in cases), ms=main_case["ms"],
        plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
        bound_by=main_case["bound_by"], library_ms=main_case["library_ms"],
        device_ms=main_case["device_ms"], share_of_bound=main_case["share_of_bound"],
        shape=main_case["x"], weights=main_case["w"], mode="codes, relu",
        configurations=len(cases),
        # the configurations beyond stride 1 and the 2x2 transposed conv: stride
        # 2 and 4, the 3x3 and 4x4 transposed convs, C_in = 144 and 1024, leaky
        extended=[{k: c[k] for k in ("x", "w", "stride", "lhs_dilation", "act", "codes", "out",
                                     "ms", "device_ms", "bound_ms", "bound_by", "library_ms",
                                     "plain_ms", "share_of_bound", "per_forward")}
                  for c in cases if c["stride"] > 1 or c["w"][2] in (144, 1024)
                  or (c["lhs_dilation"] and c["w"][0] > 2) or c["act"] == "leaky"],
        library="cuDNN bf16 conv (channels_last) + float32 epilogue + ReLU + the site's "
                "eager quantization"))
    for entry in kernels:  # the multi-device and space phases' launches, summed over ranks
        for path, n in md_launches(multi).get(entry["name"], {}).items():
            entry["launches_by_path"][path] = n
            entry["launches"] += n
        for path, n in space_launches(space).get(entry["name"], {}).items():
            entry["launches_by_path"][path] = n
            entry["launches"] += n
        held = {k: v for k, v in space["kernels"].items() if k.startswith(entry["name"])}
        if held:
            entry["space_modes"] = held
        for path, part in (("bench", "bench"), ("tools_trace", "trace"), ("tools_gui", "gui")):
            n = tools[part]["launches"].get(entry["name"], 0)
            if n:
                entry["launches_by_path"][path] = n
                entry["launches"] += n
        if entry["name"] in BENCH_BF16_WANT or entry["name"] == "int8_conv":
            # the bench's outputs at batch 1 and its largest batches against the plain
            # forward, and this kernel's calls held to its plain version in that forward
            vs = tools["bench"]["vs_plain"]
            entry["bench_vs_plain_forward"] = {
                b: dict({k: v for k, v in r.items() if k != "held"}, held=r["held"][entry["name"]])
                for b, r in vs["int8" if entry["name"] == "int8_conv" else "bf16"].items()}
            control = vs.get(f"control_{entry['name']}")
            if control:
                entry["bench_held_control"] = control[entry["name"]]
        if entry["name"] in multi["holds"]:
            entry["multi_device_hold"] = {k: v for k, v in multi["holds"][entry["name"]].items()
                                          if k != "cases"}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, build_s=build_s, kernels=kernels, logits=logits,
                           serving=serving, cbam_cases=cbam_cases, residual_block=block,
                           robust_unet=robust, unpool_cases=unpool_cases, segnet=segnet,
                           zoo=zoo, total_s=time.perf_counter() - t_start,
                           unet_train=train, protocol=protocol, extraction=extraction,
                           int8=int8, multi_device=multi, space=space, tools=tools),
                      f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
