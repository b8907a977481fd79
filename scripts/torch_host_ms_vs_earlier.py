"""Time the int8 path's kernel wrappers and host-bound int8 forwards of two
trees on one card: the host's cost a call, beside the device's.

Each tree runs in its own process, in turns (earlier, this, this, earlier),
and imports its own `coastline_torch` and `chip_smoke.py`. In each:

  * the wrappers `int8_conv`, `max_pool_with_indices` and `max_unpool` at
    configurations whose kernel is shorter than the call's host path (and
    the UNet's first-level conv, which is not): events ms over back-to-back
    calls (`chip_smoke.cuda_ms`), and, with the calls enqueued behind a
    kernel that keeps the card busy, host ms a call (`time.perf_counter`)
    and device ms a call (CUDA events);
  * the int8 forwards of SegNet and the host-bound models (`QuantizedModel`
    of `chip_smoke.zoo_state_dict`, calibrated on `default_calibration`,
    batch 8, 512^2): events ms over back-to-back forwards, and device ms and
    the idle share from torch.profiler (`chip_smoke.profile_forward`).

The kernel sources may be the same in both trees: the comparison is of the
Python path around them. Needs a card; run from the repository's root:

    mkdir -p build/earlier
    git archive <commit> | tar -x -C build/earlier
    python scripts/torch_host_ms_vs_earlier.py build/earlier . \\
        --out build/host_ms_vs_earlier.json

It prints one line a timing: each metric's mean over the tree's two runs
and the ratio this / earlier.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

#: (name, x shape, HWIO weight shape, padding, lhs dilation, output dtype, act, codes, stride)
CONV_CONFIGS = [
    ("enet_t3x3_values_bf16", (8, 64, 64, 128), (3, 3, 128, 64), ((1, 2), (1, 2)), (2, 2),
     "bfloat16", "relu", False, 1),
    ("leaky_values_f32", (8, 128, 128, 64), (3, 3, 64, 128), 1, None, "float32", "leaky",
     False, 1),
    ("stride4_values_bf16", (8, 64, 64, 64), (4, 4, 64, 64), 0, None, "bfloat16", "none",
     False, 4),
    ("pyramid_1x1_values_bf16", (8, 6, 6, 512), (1, 1, 512, 128), 0, None, "bfloat16", "relu",
     False, 1),
    ("unet_dc0_c2_codes_bf16", (8, 512, 512, 64), (3, 3, 64, 64), 1, None, "bfloat16", "relu",
     True, 1),
]
#: (name, pool input shape), int8 codes: SegNet's deepest level at 512^2, and a small map
POOL_CONFIGS = [("segnet_l4_codes", (8, 64, 64, 512)), ("small_codes", (8, 8, 8, 64))]
#: arch -> registry name of the int8 forwards timed
FORWARDS = {"segnet": "SegNet", "pspnet": "PSPNet", "deeplabv3p": "DeepLabV3+",
            "fastscnn": "Fast-SCNN", "enet": "ENet", "segformer_lite": "SegFormer-Lite"}


def host_and_device_ms(torch, fn, iters: int):
    """(host ms, device ms) a call of `fn`: `iters` calls enqueued behind
    `torch.cuda._sleep`, timed on the host's clock and by CUDA events; the
    sleep doubles until the card was still busy when the last call was
    enqueued."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24
    for _ in range(10):
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        end.record()
        busy = not start.query()
        torch.cuda.synchronize()
        if busy:
            return host * 1e3 / iters, start.elapsed_time(end) / iters
        cycles *= 2
    raise AssertionError("could not enqueue the calls ahead of the card")


def measure(root: str, iters: int, forward_iters: int) -> dict:
    """The timings of the tree at `root`, in this process."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    import coastline_torch
    from coastline_torch.infer import quant
    from coastline_torch.kernels import _build, unpool
    from coastline_torch.kernels.int8_conv import int8_conv, packed

    for module in (cs, coastline_torch):
        if root not in Path(module.__file__).resolve().parents:
            raise RuntimeError(f"{module.__name__} imported from {module.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    _build.build_all()
    rng = np.random.default_rng(9)
    out = {"root": str(root), "wrappers": {}, "forwards": {}}

    def row(fn, n):
        host, device = host_and_device_ms(torch, fn, n)
        return dict(events_ms=cs.cuda_ms(fn, n), host_ms=host, device_ms=device)

    with torch.inference_mode():
        for name, xs, ws, pad, lhs, dt, act, codes, stride in CONV_CONFIGS:
            x = torch.from_numpy(rng.integers(-127, 128, xs, dtype=np.int8)).to(dev)
            wq = torch.from_numpy(rng.integers(-127, 128, ws, dtype=np.int8)).to(dev)
            wstep = torch.from_numpy((rng.random(ws[3]) * 2e-3 + 1e-4).astype(np.float32)).to(dev)
            bias = torch.from_numpy(rng.normal(size=ws[3]).astype(np.float32)).to(dev)
            wp, dtype = packed(wq, lhs is not None), getattr(torch, dt)
            out_step = 0.0417 if codes else None

            def conv():
                return int8_conv(x, wp, 0.0371, wstep, bias, pad, 1, lhs, dtype, act=act,
                                 out_step=out_step, stride=stride)

            out["wrappers"][f"int8_conv/{name}"] = row(conv, iters)
        for name, shape in POOL_CONFIGS:
            x = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)
            vals, codes = unpool.max_pool_with_indices(x)
            out["wrappers"][f"max_pool_with_indices/{name}"] = row(
                lambda: unpool.max_pool_with_indices(x), iters)
            out["wrappers"][f"max_unpool/{name}"] = row(
                lambda: unpool.max_unpool(vals, codes), iters)
        calib = quant.default_calibration(512, device=dev)
        images, _, _ = cs.coast_tiles(8, 512, 30)
        x = cs.normalize_images(torch.from_numpy(images).to(dev))
        for arch, name in FORWARDS.items():
            qm = quant.QuantizedModel.from_state_dict(cs.zoo_state_dict(name), calib, arch=arch,
                                                      device=dev)
            prof = cs.profile_forward(lambda: qm(x), f"{arch}_int8_forward")
            out["forwards"][arch] = dict(events_ms=cs.cuda_ms(lambda: qm(x), forward_iters),
                                         device_ms=prof["device_ms_per_forward"],
                                         idle_share=prof["idle_share"])
            del qm
            torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="root of the earlier tree")
    ap.add_argument("this", help="root of this tree")
    ap.add_argument("--out", required=True, help="JSON file of every run and the summary")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--forward-iters", type=int, default=5)
    ap.add_argument("--one", metavar="ROOT", help=argparse.SUPPRESS)  # a child's one tree
    args = ap.parse_args()
    if args.one:
        Path(args.out).write_text(json.dumps(measure(args.one, args.iters, args.forward_iters)))
        return
    runs = []
    for i, (label, root) in enumerate((("earlier", args.earlier), ("this", args.this),
                                       ("this", args.this), ("earlier", args.earlier))):
        part = Path(args.out).with_suffix(f".run{i}.json")
        subprocess.run([sys.executable, __file__, args.earlier, args.this, "--one", root,
                        "--out", str(part), "--iters", str(args.iters),
                        "--forward-iters", str(args.forward_iters)], check=True)
        runs.append(dict(json.loads(part.read_text()), label=label))
    summary = {}
    for group in ("wrappers", "forwards"):
        for key in runs[0][group]:
            cell = {}
            for metric in runs[0][group][key]:
                for label in ("earlier", "this"):
                    vals = [r[group][key][metric] for r in runs if r["label"] == label]
                    cell[f"{label}_{metric}"] = sum(vals) / len(vals)
                cell[f"ratio_{metric}"] = cell[f"this_{metric}"] / cell[f"earlier_{metric}"]
            summary[f"{group}/{key}"] = cell
    Path(args.out).write_text(json.dumps({"runs": runs, "summary": summary}, indent=1))
    for key, cell in summary.items():
        print(key, " ".join(f"{k}={v:.4f}" for k, v in cell.items()))


if __name__ == "__main__":
    main()
