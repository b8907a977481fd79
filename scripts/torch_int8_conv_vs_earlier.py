"""Time this tree's int8 conv against an earlier tree's on one card.

At every conv configuration of the three int8 forwards (batch 8, 512^2, the
default policy; the same configurations `chip_smoke.int8_path` checks), in
turns (earlier, this, this, earlier), device ms of:
  * this tree's `int8_conv` in the mode the forward uses (values, or a site's
    codes, with or without the ReLU);
  * the earlier tree's kernel, an older `csrc/int8_conv.cu` with the
    values-only C interface (`coastline_int8_conv(x, w, w_step, bias, out, N,
    H, W, Cin, Cout, KH, KW, pad_t, pad_l, dil, Mh, Mw, transposed, x_step,
    out_bf16, stream)`), on the same inputs in values mode; the earlier
    forward quantized the site after it with eager passes, not counted here.
Both trees' values outputs are held bit for bit against each other. Needs a
card; run from the repository's root:

    mkdir -p build/earlier
    git archive <commit> coastline_torch/csrc/int8_conv.cu | tar -x -C build/earlier
    python scripts/torch_int8_conv_vs_earlier.py \\
        build/earlier/coastline_torch/csrc/int8_conv.cu --out chiprun_out/int8_vs_earlier.json
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from coastline_torch.infer import quant  # noqa: E402
from coastline_torch.kernels import _build  # noqa: E402
from coastline_torch.kernels.int8_conv import (_out_hw, int8_conv, int8_conv_plain,  # noqa: E402
                                               normalize_padding, packed)
from coastline_torch.utils.torch_import import (random_unet_variables,  # noqa: E402
                                                unet_state_dict)


def build_earlier(src: str):
    """The earlier source's C entry point, built with this tree's flags."""
    out = _build.BUILD_DIR / "earlier_int8_conv.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).coastline_int8_conv
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_float]
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def forward_configs(dev, batch: int, size: int) -> dict:
    """`chip_smoke.int8_conv_configs` of one forward of each int8 model:
    the UNet from seeded random variables, the Robust U-Net and SegNet from
    `chip_smoke.zoo_state_dict`, calibrated on `default_calibration`."""
    calib = quant.default_calibration(size, device=dev)
    models = {"unet": quant.QuantizedModel.from_state_dict(
        unet_state_dict(random_unet_variables(seed=0)), calib, arch="unet", device=dev)}
    for arch, name in (("robust_unet", "Robust UNet"), ("segnet", "SegNet")):
        models[arch] = quant.QuantizedModel.from_state_dict(cs.zoo_state_dict(name), calib,
                                                            arch=arch, device=dev)
    x = cs.normalize_images(torch.from_numpy(cs.coast_tiles(batch, size, 32)[0]).to(dev))
    return cs.int8_conv_configs({a: (lambda m=m: m(x)) for a, m in models.items()})


def compare(dev, earlier, configs, iters: int = 10) -> list:
    rng = np.random.default_rng(9)
    rows = []
    stream = torch.cuda.current_stream(dev).cuda_stream
    # stride 1 throughout: the three forwards of `forward_configs` have no other
    for (xs, ws, pad_json, dil, lhs, dt_name, act, codes, _), per in configs.items():
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
        values = int8_conv_plain(x, wq, step, wstep, bias, pad, dil, lhs, dt)
        out_step = 2.0 ** math.floor(math.log2(float(values.abs().max()) / 100)) if codes else None
        pads = normalize_padding(pad)
        (pt, _), (pl, _) = pads
        n, h, w, _ = xs
        ho, wo = _out_hw(h, w, kh, kw, pads, dil, lhs)
        geom = (1, 1, 0, 0, 1, h, w) if lhs is not None else (kh, kw, pt, pl, dil, ho, wo)
        out = torch.empty((n, ho, wo, cout), dtype=dt, device=dev)

        def old():
            status = earlier(x.data_ptr(), wp.mat.data_ptr(), wstep.data_ptr(), bias.data_ptr(),
                             out.data_ptr(), n, h, w, cin, cout, *geom, int(lhs is not None),
                             step, int(dt == torch.bfloat16), stream)
            _build.check(status, "earlier int8_conv")
            return out

        def new():
            return int8_conv(x, wp, step, wstep, bias, pad, dil, lhs, dt, act=act,
                             out_step=out_step)

        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        mine = int8_conv(x, wp, step, wstep, bias, pad, dil, lhs, dt)
        equal = bool(torch.equal(old().view(bits), mine.view(bits)))
        turns = [cs.device_ms(f, iters) for f in (old, new, new, old)]
        row = dict(x=list(xs), w=list(ws), padding=pad, dilation=dil,
                   lhs_dilation=None if lhs is None else list(lhs), out=dt_name, act=act,
                   codes=codes, per_forward=per, values_bit_equal=equal,
                   earlier_device_ms=(turns[0] + turns[3]) / 2,
                   device_ms=(turns[1] + turns[2]) / 2, turns=turns)
        row["speedup"] = row["earlier_device_ms"] / row["device_ms"]
        rows.append(row)
        cs.log("int8_vs_earlier", json.dumps(row))
        del x, wq, out, values, mine
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("earlier_source", help="an earlier tree's csrc/int8_conv.cu")
    ap.add_argument("--out", help="write the rows and sums to this JSON file")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    _build.build_all()
    earlier = build_earlier(args.earlier_source)
    rows = compare(dev, earlier, forward_configs(dev, args.batch, args.size))
    sums = {a: {k: sum(r[k] * r["per_forward"].get(a, 0) for r in rows)
                for k in ("earlier_device_ms", "device_ms")}
            for a in ("unet", "robust_unet", "segnet")}
    slower = [r for r in rows if r["device_ms"] >= r["earlier_device_ms"]]
    summary = dict(card=card, configurations=len(rows), slower=len(slower),
                   all_values_bit_equal=all(r["values_bit_equal"] for r in rows),
                   per_forward_sums=sums)
    cs.log("int8_vs_earlier_summary", json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(summary, rows=rows), indent=1))
    return 0 if summary["all_values_bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
