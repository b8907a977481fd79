"""Benchmark of the port: the Robust U-Net at 512² on one card
(counterpart of the root `bench.py`, which measures the JAX package).

    python -m coastline_torch.bench [--device cuda] [--size 512]
        [--batches 8,16,32,64] [--int8-batches 8,16,32,48,64,80]
        [--n-loop 20] [--trials 3] [--train-batches 10]

Prints ONE JSON line on stdout, with the root bench's keys (`bench.py:
213-230`) and the card's name and power limit; everything else goes to
stderr. Without a card and without `--device cpu` it exits non-zero.

Headline: inference images/s of the Robust U-Net (40,872,223 parameters,
seeded init) in bfloat16, channels_last, at the best of the batch list.
`vs_baseline` divides it by the reference's PyTorch on a CPU
(`baselines/torch_cpu_baseline.json`).

Timing: every forward is timed by `utils/profiling.device_loop_seconds`,
the root bench's dependency chain (`bench.py:103-106`): the input is
scaled by (1 + c * 1e-20), where c is the running carry, and y.mean() is
added to it, so each forward depends on the one before and the number
means what the JAX package's meant. On the card CUDA events time the loop.
The int8 path is the port's `QuantizedModel` of the same weights,
calibrated on two seeded images at batch 2; train throughput is
`make_train_epoch` at batch 8, lr 1e-4, over 16 seeded tiles, the best of
`trials` epochs of `train_batches` steps after a warm one.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from coastline_torch.infer.quant import QuantizedModel
from coastline_torch.models.registry import create_model
from coastline_torch.train.loop import TrainConfig, create_train_state, make_train_epoch
from coastline_torch.utils.device import resolve_device
from coastline_torch.utils.profiling import (conv_flops, device_loop_seconds,
                                             measure_dispatch_rtt)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (8, 16, 32, 64)
INT8_BATCHES = (8, 16, 32, 48, 64, 80)
MEMORY_SHARE = 0.9  # an int8 batch runs only if its extrapolated peak fits in this share


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bf16_model(device) -> torch.nn.Module:
    """The benchmarked model: the Robust U-Net's seeded init in bf16, eval
    mode, channels_last, on `device`."""
    model = create_model("Robust UNet", dtype=torch.bfloat16)
    return model.to(device=device, memory_format=torch.channels_last).eval()


def images(batch: int, size: int, device, seed: int = 0) -> torch.Tensor:
    """(batch, size, size, 3) float32 standard normals from `seed`, drawn on
    `device` (the root bench's `jax.random.normal` inputs)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, size, size, 3), generator=g, device=device)


def card(dev: torch.device):
    """(name, power limit in W) of the card, or ("cpu", None)."""
    if dev.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(dev)
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(dev.index or 0),
                              "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        return name, float(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        log(f"power limit unavailable: {e}")
        return name, None


def _infer_seconds(step, x, n_loop, trials, rtt) -> float:
    with torch.inference_mode():
        return device_loop_seconds(step, (x,), n_loop=n_loop, trials=trials, rtt=rtt)


def run(device="cuda", size: int = 512, batches=BATCHES, int8_batches=INT8_BATCHES,
        n_loop: int = 20, trials: int = 3, train_batches: int = 10) -> dict:
    """Measure and return the JSON line's dict. Raises without a card
    unless `device="cpu"`."""
    dev = resolve_device(device)
    kind, power = card(dev)
    log(f"device: {dev} ({kind}, power limit {power} W)")
    rtt = measure_dispatch_rtt(device=dev)
    log(f"dispatch RTT: {rtt * 1000:.4f} ms")

    model = bf16_model(dev)

    def infer_step(c, x):
        xi = x.permute(0, 3, 1, 2) * (1.0 + c * 1e-20)  # chains the forwards
        return c + model(xi).mean().float()

    p50_ms = _infer_seconds(infer_step, images(1, size, dev), n_loop, trials, rtt) * 1e3
    log(f"single-tile latency: {p50_ms:.3f} ms")
    best_ips, best_b = 0.0, None
    for b in batches:
        ips = b / _infer_seconds(infer_step, images(b, size, dev), n_loop, trials, rtt)
        log(f"batch-{b} inference: {ips:.2f} images/sec")
        if ips > best_ips:
            best_ips, best_b = ips, b
    flops = conv_flops(model, images(1, size, dev).permute(0, 3, 1, 2))
    log(f"conv GFLOP/image: {flops / 1e9:.2f}; achieved: {flops * best_ips / 1e12:.2f} TFLOP/s")

    qm = QuantizedModel.from_state_dict(model.state_dict(), images(2, size, dev, seed=1),
                                        batch_size=2, arch="robust_unet", device=dev)

    def int8_step(c, x):
        return c + qm(x * (1.0 + c * 1e-20)).mean().float()

    int8_p50_ms = _infer_seconds(int8_step, images(1, size, dev), n_loop, trials, rtt) * 1e3
    log(f"int8 single-tile latency: {int8_p50_ms:.3f} ms")
    int8_ips, int8_b, first = 0.0, None, None
    total = torch.cuda.mem_get_info(dev)[1] if dev.type == "cuda" else None
    for b in int8_batches:
        if total is not None and first is not None:
            b0, base, peak0 = first
            need = base + (peak0 - base) * b / b0
            if need > MEMORY_SHARE * total:
                log(f"batch-{b} int8 skipped: {need / 2**30:.1f} GiB extrapolated from "
                    f"batch {b0}, over {MEMORY_SHARE:.0%} of {total / 2**30:.1f} GiB")
                continue
        if total is not None and first is None:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        x = images(b, size, dev)
        ips = b / _infer_seconds(int8_step, x, n_loop, trials, rtt)
        if total is not None and first is None:
            first = (b, base, torch.cuda.max_memory_allocated(dev))
            log(f"batch-{b} int8 peak: {first[2] / 2**30:.2f} GiB")
        del x
        log(f"batch-{b} int8 inference: {ips:.2f} images/sec")
        if ips > int8_ips:
            int8_ips, int8_b = ips, b
    del model, qm
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # Train-step throughput (batch 8, BCE, the full Adam update), as bench.py:180-201.
    batch = 8
    cfg = TrainConfig(batch_size=batch, lr=1e-4)
    tmodel = create_model("Robust UNet", dtype=torch.bfloat16)
    state = create_train_state(tmodel, cfg, device=dev)
    epoch = make_train_epoch(tmodel, cfg, device=dev)
    host = np.random.default_rng(0)
    tiles = torch.from_numpy(host.integers(0, 255, (2 * batch, size, size, 3), dtype=np.uint8))
    masks = torch.from_numpy(host.integers(0, 2, (2 * batch, size, size), dtype=np.uint8))
    idx = host.integers(0, 2 * batch, (train_batches, batch), dtype=np.int32)
    valid = np.ones((train_batches, batch), np.float32)
    tiles, masks = tiles.to(dev), masks.to(dev)
    state, loss = epoch(state, tiles, masks, idx, valid)  # warm; the loss is a host float
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        state, loss = epoch(state, tiles, masks, idx, valid)
        times.append(time.perf_counter() - t0)
    train_ips = batch * train_batches / max(1e-9, min(times) - rtt)
    log(f"train: {train_ips:.3f} images/sec (loss {loss:.4f})")

    # The int8 accuracy gates of bench.py:164-179 read artifacts/quant_accuracy*.json,
    # which measured the JAX package's int8, not this one's: int8 takes no headline here.
    int8_ok = int8_zoo_ok = False
    vs = None
    baseline = os.path.join(REPO, "baselines", "torch_cpu_baseline.json")
    if os.path.exists(baseline):
        with open(baseline) as f:
            vs = best_ips / json.load(f)["robust_unet_infer_images_per_sec"]
    return {
        "metric": f"robust_unet_{size}_bf16_infer_images_per_sec_per_chip",
        "value": best_ips,
        "unit": "images/sec/chip",
        "vs_baseline": vs,
        "best_batch": best_b,
        "bf16_images_per_sec": best_ips,
        "int8_images_per_sec": int8_ips if int8_b else None,
        "int8_accuracy_gated": int8_ok,
        "int8_zoo_accuracy_gated": int8_zoo_ok,
        "p50_tile_latency_ms": p50_ms,
        "int8_p50_tile_latency_ms": int8_p50_ms,
        "train_images_per_sec_per_chip": train_ips,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device_kind": kind,
        "power_limit_w": power,
    }


def _ints(text: str):
    return tuple(int(v) for v in text.split(",") if v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a card only 'cpu' runs")
    ap.add_argument("--size", type=int, default=512, help="tile side in pixels")
    ap.add_argument("--batches", type=_ints, default=BATCHES,
                    help="bf16 batch sizes, comma-separated")
    ap.add_argument("--int8-batches", type=_ints, default=INT8_BATCHES,
                    help="int8 batch sizes, comma-separated")
    ap.add_argument("--n-loop", type=int, default=20, help="chained forwards a timed loop")
    ap.add_argument("--trials", type=int, default=3, help="timed loops (and train epochs)")
    ap.add_argument("--train-batches", type=int, default=10, help="train steps an epoch")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"coastline_torch.bench: {e}", file=sys.stderr)
        return 2
    out = run(device=args.device, size=args.size, batches=args.batches,
              int8_batches=args.int8_batches, n_loop=args.n_loop, trials=args.trials,
              train_batches=args.train_batches)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
