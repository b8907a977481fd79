#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`coastline_torch`).

    python3 chip_smoke.py [--out results.json]

Needs one NVIDIA H100 and the CUDA toolkit; builds the kernels from
`coastline_torch/csrc/` into `build/coastline_torch/` on first use. Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel (one nvcc per source, in parallel);
  3. hold each kernel against its plain PyTorch version at the serving
     path's shapes and time kernel, plain version and a library yardstick
     with CUDA events;
  4. the serving path at full width: the 31,043,586-parameter 2-class UNet
     (random weights from a numpy seed, through the weight bridge) in bf16
     behind `serve(batch_size=8)` answers 16 concurrent 512^2 requests, the
     coastline band of every mask is taken and one synthetic shoreline is
     traced to contours; the launch counters must show both kernels ran,
     and the masks are compared with a float32 run of the same extractor;
     a second server then times 64 requests once its thread is warm, and
     torch.profiler breaks the bf16 batch-8 forward down by kernel;
  5. the last line: {"ok": true, "device": {...}}.

Float32 convolutions run with cuDNN's TF32 off, so every float32 number
here is a true float32 result. Any failure raises and exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from coastline_torch.infer.contours import extract_contours
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.infer.morphology import coastline_band, elliptical_kernel
from coastline_torch.kernels import _build
from coastline_torch.kernels.fused_conv import (fused_conv3x3_bn_relu,
                                                fused_conv3x3_bn_relu_plain)
from coastline_torch.kernels.morphology import dilate_disk, dilate_disk_plain, se_row_groups
from coastline_torch.utils.torch_import import random_unet_variables

# Published H100 SXM peaks (NVIDIA data sheet, dense): the roofs for bound_ms.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_OPS = 67e12  # non-tensor float32 rate; integer/float max runs on the same units
UNET_PARAMS = 31_043_586
CONV_SHAPE = (8, 512, 512, 64)
DILATE_CASES = [((8, 512, 512), 20), ((8, 512, 512), 5), ((8, 512, 512), 41),
                ((1, 2048, 2048), 20), ((1, 64, 10980), 20)]  # first = serving shape


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
    got = fused_conv3x3_bn_relu(x, wt, scale, bias).float()
    torch.cuda.synchronize()
    ref = fused_conv3x3_bn_relu_plain(x, wt, scale, bias).float()
    err = (got - ref).abs()
    # same float32 sums in another order, one bf16 rounding: 1 bf16 ulp (2^-7 rel) + 1e-3
    ok = bool(torch.all(err <= 2.0 ** -7 * ref.abs() + 1e-3))
    del got, ref
    xl = x.permute(0, 3, 1, 2)  # channels_last view
    wl = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    s16, b16 = scale.to(torch.bfloat16)[:, None, None], bias.to(torch.bfloat16)[:, None, None]
    ms = cuda_ms(lambda: fused_conv3x3_bn_relu(x, wt, scale, bias), 20)
    plain_ms = cuda_ms(lambda: fused_conv3x3_bn_relu_plain(x, wt, scale, bias), 3, 1)
    library_ms = cuda_ms(lambda: torch.relu(F.conv2d(xl, wl, padding=1) * s16 + b16), 20)
    flops = 2.0 * b * h * w * c * 9 * c
    nbytes = 2 * x.numel() * 2 + wt.numel() * 2 + 2 * c * 4
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    result = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                  library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                  shape=list(CONV_SHAPE), tflops=flops / ms / 1e9,
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
        plain_ms = cuda_ms(lambda: dilate_disk_plain(m, ker), 5, 1)
        library_ms = cuda_ms(lambda: conv_threshold_dilate(m, ker), 3, 1)
        groups = se_row_groups(ker)
        # per pixel: the widest row group's window grown once, one max per SE row
        ops_px = max(hi - lo for (lo, hi), _ in groups) + sum(len(s) for _, s in groups)
        bound_ms, bound_by = bound(2 * m.numel(), ops_px * m.numel(), PEAK_F32_OPS)
        case = dict(shape=list(shape), size=size, max_abs_err=max(errs),
                    max_abs_err_binary_u8_gray_u8_gray_f32=errs,
                    conv_threshold_equal=lib_equal, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log("dilate_disk", json.dumps(case))
        if max(errs) != 0.0 or not lib_equal:
            raise AssertionError(f"dilate_disk is not exact: {case}")
        cases.append(case)
    return cases


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
    result["profile"] = profile_forward(ex, x8)
    if agree < 0.95:
        raise AssertionError(f"bf16 masks agree with f32 on only {agree:.4f} of pixels")
    return result


_KERNEL_CLASSES = (  # (class, substrings of the CUDA kernel name), first match wins
    ("fused_conv3x3_bn_relu (ours)", ("fused_conv_kernel",)),
    ("dilate_disk (ours)", ("dilate_kernel",)),
    ("elementwise: bias, BN affine, ReLU, casts", ("elementwise",)),
    ("concat", ("CatArray",)),
    ("max pool", ("max_pool",)),
    ("argmax / softmax", ("reduce", "softmax", "argmax")),
    ("cuDNN conv and transposed conv", ("conv", "xmma", "gemm", "cudnn", "sm90", "cutlass",
                                        "nhwc", "nchw", "dgrad", "fprop", "implicit")),
)


def profile_forward(ex, x8, steps: int = 3):
    """Device time by kernel class over `steps` batch-8 forwards
    (torch.profiler), and the device's idle share of that window."""
    from torch.profiler import ProfilerActivity, profile

    ex.predict_masks_batch_async(x8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ex.predict_masks_batch_async(x8)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    by_class = {}
    for e in kernels:
        cls = next((c for c, keys in _KERNEL_CLASSES if any(k in e.key for k in keys)), "other")
        ms, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + e.self_device_time_total / 1e3 / steps, n + e.count / steps)
    busy_ms = sum(ms for ms, _ in by_class.values())
    result = dict(steps=steps, wall_ms_per_forward=wall_ms / steps,
                  device_ms_per_forward=busy_ms, idle_share=1 - busy_ms * steps / wall_ms,
                  classes={c: dict(ms_per_forward=ms, launches_per_forward=n)
                           for c, (ms, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0])},
                  top=[dict(kernel=e.key[:100], ms_per_forward=e.self_device_time_total / 1e3 / steps,
                            launches_per_forward=e.count / steps)
                       for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]])
    log("profile_forward_b8_bf16", json.dumps(result))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args(argv)
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
    variables = random_unet_variables(seed=0)
    logits = logits_check(variables, dev)
    serving = serving_path(variables, dev, rng)

    main_dil = dil[0]
    kernels = [
        dict(name="fused_conv3x3_bn_relu", route="cuda",
             source="coastline_torch/csrc/fused_conv3x3_bn_relu.cu",
             replaces="coastline/pallas/fused_conv.py:107",
             launches=serving["launches"]["fused_conv3x3_bn_relu"],
             max_abs_err=conv["max_abs_err"], ms=conv["ms"], plain_ms=conv["plain_ms"],
             bound_ms=conv["bound_ms"], bound_by=conv["bound_by"],
             library_ms=conv["library_ms"], shape=conv["shape"]),
        dict(name="dilate_disk", route="cuda", source="coastline_torch/csrc/dilate_disk.cu",
             replaces="coastline/pallas/morphology.py:262",
             launches=serving["launches"]["dilate_disk"],
             max_abs_err=max(c["max_abs_err"] for c in dil), ms=main_dil["ms"],
             plain_ms=main_dil["plain_ms"], bound_ms=main_dil["bound_ms"],
             bound_by=main_dil["bound_by"], library_ms=main_dil["library_ms"],
             shape=main_dil["shape"], size=main_dil["size"],
             library="conv-threshold: F.conv2d f32 with the SE, then > 0", cases=dil),
    ]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, build_s=build_s, kernels=kernels, logits=logits,
                           serving=serving), f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
