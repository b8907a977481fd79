"""Timing and tracing of device work (the port's counterpart of
`coastline/utils/profiling.py`).

  * `loop_seconds`: seconds a call of `fn()` takes, back to back on the
    device (the Evaluator's timer).
  * `trace(logdir)`: torch.profiler around a block, written as a Chrome
    trace (Perfetto, TensorBoard's profile plugin).
  * `measure_dispatch_rtt` and `device_loop_seconds`: the JAX package's
    dependency-chained timing loop (`step_fn(c, *args) -> c`) under its
    signatures. JAX chains a jitted scan on the device and subtracts its
    transport's round trip. Here the calls go back to back on the card's
    stream between two CUDA events, which exclude the host's round trip, so
    nothing is subtracted; on the CPU a host clock times the loop and the
    round trip is subtracted, as JAX does.
  * `device_time_by_class` and `conv_flops`: device time by kernel class
    over a few steps (torch.profiler) and the convolutions' FLOPs of one
    forward, counted from the layer shapes (hooks see the ctypes kernels'
    layers, which `FlopCounterMode` would miss).
"""

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from coastline_torch.utils.device import resolve_device


def loop_seconds(fn, device, n_loop: int = 20) -> float:
    """Seconds a call of `fn()` takes, from 2 runs of `n_loop` back-to-back
    calls on `device` after 2 warm-up calls, the faster run's mean."""
    dev = torch.device(device)
    for _ in range(2):
        fn()
    times = []
    for _ in range(2):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_loop):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(n_loop):
                fn()
            times.append(time.perf_counter() - t0)
    return max(1e-9, min(times) / n_loop)


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(), "coastline-trace"),
          device="cuda"):
    """Profile the block (CPU activity, and the card's kernels on CUDA) and
    write it to `logdir` (by default under the temporary directory, which
    follows `TMPDIR`) as a Chrome trace, `<host>_<pid>.<time>.pt.trace.json`.
    Yields `logdir`. The profiler stops, and the trace is written, when the
    block raises too."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_dispatch_rtt(trials: int = 3, device="cuda") -> float:
    """Host seconds of one tiny op and a synchronize (on the CPU, of the
    tiny op), the mean of `trials` after one warm call."""
    dev = resolve_device(device)
    z = torch.ones(8, device=dev)

    def once():
        z.sum()
        _sync(dev)

    once()
    t0 = time.perf_counter()
    for _ in range(trials):
        once()
    return (time.perf_counter() - t0) / trials


def device_loop_seconds(step_fn, args, n_loop: int = 20, trials: int = 3,
                        rtt: float = None, target_ratio: float = 20.0,
                        max_loop: int = 20_000, device=None) -> float:
    """step_fn(carry, *args) -> carry, with a float32 scalar carry on the
    device, chained `n_loop` times back to back. Returns s/iteration, the
    best of `trials` loops after one warm call of `step_fn`.

    The loop count grows until the loop takes at least `target_ratio` x the
    dispatch round trip `rtt` (measured when None), up to `max_loop`, as
    `coastline/utils/profiling.py:97-108` scales it. `device` defaults to
    the device of the first tensor among `args`, else "cuda"; a CUDA device
    without a card raises. On CUDA the loop is timed by CUDA events and
    nothing is subtracted; on the CPU by the host clock, minus `rtt`."""
    if device is None:
        device = next((a.device for a in args if isinstance(a, torch.Tensor)), "cuda")
    dev = resolve_device(device)
    if rtt is None:
        rtt = measure_dispatch_rtt(device=dev)
    overhead = 0.0 if dev.type == "cuda" else rtt
    c0 = torch.zeros((), dtype=torch.float32, device=dev)

    def loop(n) -> float:
        c = c0
        _sync(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                c = step_fn(c, *args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            c = step_fn(c, *args)
        float(c)
        return time.perf_counter() - t0

    step_fn(c0, *args)  # warm: cuDNN plans, kernel builds
    _sync(dev)
    t = loop(n_loop)
    needed = target_ratio * rtt
    if t - overhead < needed:
        # The floor of t / (10 n) guards against a noisy-high rtt making
        # (t - rtt) collapse, as JAX's does.
        per_iter = max((t - overhead) / n_loop, t / (10.0 * n_loop), 1e-7)
        n_loop = max(n_loop, min(max_loop, int(np.ceil(needed / per_iter))))
    times = [loop(n_loop) for _ in range(trials)]
    return max(1e-9, (min(times) - overhead) / n_loop)


# (class, substrings of the CUDA kernel name), first match wins
_KERNEL_CLASSES = (
    ("fused_conv3x3_bn_relu (ours)", ("fused_conv_kernel",)),
    ("int8_conv (ours)", ("int8_conv_kernel",)),
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
    ("bilinear resize", ("upsample_bilinear",)),
    ("depthwise conv (cuDNN)", ("conv2d_c1_k1", "depthwise")),
    ("cuDNN conv and transposed conv", ("conv", "xmma", "gemm", "cudnn", "sm90", "cutlass",
                                        "nhwc", "nchw", "dgrad", "fprop", "implicit")),
    ("cuBLAS GEMM (nvjet)", ("nvjet",)),
)


def device_time_by_class(fn, steps: int = 3, classes=_KERNEL_CLASSES) -> dict:
    """Device time by kernel class (`classes`) over `steps` calls of `fn`
    (a forward or a train step) on the card, under torch.profiler after one
    warm call, and the device's idle share of that window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
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

    return dict(steps=steps, wall_ms_per_forward=wall_ms / steps,
                device_ms_per_forward=busy_ms, idle_share=1 - busy_ms * steps / wall_ms,
                classes={c: dict(ms_per_forward=ms, launches_per_forward=n)
                         for c, (ms, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0])},
                top=rows(kernels, 10), top_other=rows(other, 6))


def conv_flops(model, x) -> float:
    """Multiply-adds x 2 of every convolution and transposed convolution in
    one forward of `model` on `x`, counted from the layer shapes."""
    from coastline_torch.ops.primitives import Conv, ConvTranspose

    total = []

    def hook(mod, args, out):
        k = mod.weight.shape[-1] * mod.weight.shape[-2]
        cin = args[0].shape[1]
        total.append(2.0 * out.numel() * cin * k / (4 if isinstance(mod, ConvTranspose) else 1))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, ConvTranspose))]
    try:
        with torch.inference_mode():
            model(x, return_logits=True)
    finally:
        for h in hooks:
            h.remove()
    return sum(total)
