"""Time this tree's avg_max_pool against an earlier tree's, and scan its geometry, on one card.

At the Robust U-Net's five level shapes (batch 8, 512^2; the fourth,
(8, 64, 64, 512), is also WaterNet's bottleneck) in bfloat16 and float32, in
turns (earlier, this, this, earlier):
  * this tree's wrapper, `cbam.avg_max_pool` (one cluster kernel): CUDA
    events ms over back-to-back calls (`chip_smoke.cuda_ms`) and device ms
    (`chip_smoke.device_ms`, the calls queued behind a sleeping kernel);
  * the earlier tree's two-pass kernel, an older `csrc/avg_max_pool.cu`
    with the C interface `coastline_avg_max_pool(x, psum, pmax, avg, mx, B,
    HW, C, dtype, vec, groups_per_block, slices, px_per_slice, stream)`,
    called as its wrapper called it (its geometry, four `torch.empty`s, the
    device context; the entry point bound once), the same two measures.
The maxes are held bit for bit against each other and against the plain
version, the means within `chip_smoke._mean_ok`.

With --scan, the device ms of this tree's kernel at every candidate
geometry (channel groups a chunk, cluster size, threads a CTA) at each
shape and at batch 1, each launch checked against the plain version and
against a second call bit for bit; `pool_geometry`'s choice is marked.
With --host, the host microseconds a call (`time.perf_counter` over
back-to-back calls) of the wrapper and of each step of its host path at
(8, 32, 32, 1024) bf16, where the kernel is shorter than the launch path.
Needs a card; run from the repository's root:

    mkdir -p build/earlier
    git archive <commit> coastline_torch/csrc/avg_max_pool.cu \\
        coastline_torch/csrc/cbam_common.cuh | tar -x -C build/earlier
    python scripts/torch_avg_max_pool_vs_earlier.py \\
        build/earlier/coastline_torch/csrc/avg_max_pool.cu --scan --host --out chiprun_out/pool.json
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from coastline_torch.kernels import _build, cbam  # noqa: E402

SCAN_EXTRA = [(1, 512, 512, 64)]  # batch 1 at full resolution: few clusters


def build_earlier(src: str):
    """The earlier source's C entry point, built with this tree's flags."""
    out = _build.BUILD_DIR / "earlier_avg_max_pool.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).coastline_avg_max_pool
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def earlier_geometry(b, hw, c, vec, sms, threads=256):
    """The earlier wrapper's (groups a block, slices, pixels a slice)."""
    groups = c // vec
    gb = min(groups, threads)
    chunks = -(-groups // gb)
    lanes = threads // gb
    slices = max(1, min(-(-8 * sms // (b * chunks)), -(-hw // (4 * lanes)), 65535))
    px = -(-hw // slices)
    return gb, -(-hw // px), px


def earlier_pool(fn, x, sms):
    b, h, w, c = x.shape
    vec = cbam._vec(c, x)
    gb, slices, px = earlier_geometry(b, h * w, c, vec, sms)
    psum = torch.empty((b, slices, c), dtype=torch.float32, device=x.device)
    pmax = torch.empty_like(psum)
    avg = torch.empty((b, c), dtype=x.dtype, device=x.device)
    mx = torch.empty_like(avg)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), psum.data_ptr(), pmax.data_ptr(), avg.data_ptr(), mx.data_ptr(),
                    b, h * w, c, cbam._DTYPES[x.dtype], vec, gb, slices, px, cbam._stream(x))
    _build.check(status, "earlier avg_max_pool")
    return avg, mx


def _input(shape, dt, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, device=dev, generator=gen).to(dt)


def _agrees(x, avg, mx, ref) -> bool:
    r_avg, r_mx = ref
    return bool(torch.equal(mx, r_mx)) and cs._mean_ok(avg, r_avg, x.float().abs().mean((1, 2)),
                                                        x.dtype)


def compare(dev, earlier, sms, iters=20) -> list:
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for shape in cs.LEVEL_SHAPES:
            x = _input(shape, dt, dev, 0)
            ref = cbam.avg_max_pool_plain(x)
            mine, theirs = cbam.avg_max_pool(x), earlier_pool(earlier, x, sms)
            ok = _agrees(x, *mine, ref) and _agrees(x, *theirs, ref)

            def old():
                return earlier_pool(earlier, x, sms)

            def new():
                return cbam.avg_max_pool(x)

            dev_turns = [cs.device_ms(f, iters) for f in (old, new, new, old)]
            ev_turns = [cs.cuda_ms(f, iters) for f in (old, new, new, old)]
            n = x.numel()
            bound_ms, _ = cs.bound(n * x.element_size() + 2 * shape[0] * shape[3]
                                   * x.element_size(), 2 * n, cs.PEAK_F32_OPS)
            row = dict(shape=list(shape), dtype=str(dt).split(".")[-1], agree=ok,
                       geometry=cbam.pool_geometry(shape[0], shape[1] * shape[2], shape[3],
                                                   cbam._vec(shape[3], x), sms)._asdict(),
                       earlier_device_ms=(dev_turns[0] + dev_turns[3]) / 2,
                       device_ms=(dev_turns[1] + dev_turns[2]) / 2,
                       earlier_ms=(ev_turns[0] + ev_turns[3]) / 2,
                       ms=(ev_turns[1] + ev_turns[2]) / 2, bound_ms=bound_ms,
                       device_turns=dev_turns, event_turns=ev_turns)
            row["share_of_bound"] = bound_ms / row["device_ms"]
            row["earlier_share_of_bound"] = bound_ms / row["earlier_device_ms"]
            rows.append(row)
            cs.log("pool_vs_earlier", json.dumps(row))
            del x, ref
    return rows


def candidates(b, hw, c, vec):
    groups = c // vec
    top = min(1 << (groups - 1).bit_length(), 8 if vec > 1 else 32)
    width = 1
    while width <= top:
        chunks = -(-groups // width)
        for cluster in (1, 2, 3, 4, 5, 6, 8, 12, 16):
            px = -(-hw // cluster)
            if (cluster - 1) * px >= hw:
                continue
            for threads in (256, 512):
                yield cbam.PoolGeometry(width, cluster, px, threads, b * chunks * cluster)
        width *= 2


def scan(dev, sms, iters=20) -> list:
    rows = []
    fn = cbam._fn("avg_max_pool")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for dt in (torch.bfloat16, torch.float32):
        for shape in cs.LEVEL_SHAPES + (SCAN_EXTRA if dt == torch.bfloat16 else []):
            b, h, w, c = shape
            x = _input(shape, dt, dev, 1)
            vec = cbam._vec(c, x)
            ref = cbam.avg_max_pool_plain(x)
            chosen = cbam.pool_geometry(b, h * w, c, vec, sms)
            out = torch.empty((2, b, c), dtype=dt, device=dev)

            for geo in candidates(b, h * w, c, vec):
                def run(geo=geo):
                    status = fn(x.data_ptr(), out.data_ptr(), b, h * w, c, cbam._DTYPES[dt], vec,
                                geo.groups, geo.cluster, geo.px, geo.threads, stream)
                    _build.check(status, f"avg_max_pool at {geo}")

                row = dict(shape=list(shape), dtype=str(dt).split(".")[-1], **geo._asdict(),
                           chosen=geo == chosen)
                try:
                    run()
                    first = out.clone()
                    run()
                    torch.cuda.synchronize()
                    row["agree"] = _agrees(x, out[0], out[1], ref)
                    row["repeat_exact"] = bool(torch.equal(first, out))
                    row["device_ms"] = cs.device_ms(run, iters)
                except RuntimeError as err:
                    row["error"] = str(err)
                rows.append(row)
                cs.log("pool_scan", json.dumps(row))
            del x, ref, out
    return rows


def host_path(dev, shape=(8, 32, 32, 1024), n=2000) -> dict:
    """Host microseconds a call of the wrapper and of the steps of its path."""
    x = _input(shape, torch.bfloat16, dev, 2)
    b, h, w, c = shape
    fn = cbam._fn("avg_max_pool")
    out = x.new_empty((2, b, c))
    geo = cbam.pool_geometry(b, h * w, c, 8, cbam._sm_count(x.device.index))
    stream = cbam._stream(x)
    xl = x.permute(0, 3, 1, 2)
    steps = {
        "wrapper (avg_max_pool)": lambda: cbam.avg_max_pool(x),
        "_check": lambda: cbam._check("x", x, 4),
        "_on_card": lambda: cbam._on_card("avg_max_pool", x),
        "_vec": lambda: cbam._vec(c, x),
        "pool_geometry (cached)": lambda: cbam.pool_geometry(
            b, h * w, c, 8, cbam._sm_count(x.device.index)),
        "x.new_empty((2, B, C))": lambda: x.new_empty((2, b, c)),
        "torch.empty((2, B, C), dtype=, device=)": lambda: torch.empty((2, b, c), dtype=x.dtype,
                                                                        device=x.device),
        "_on_device (current device)": lambda: cbam._on_device(x.device),
        "_stream (raw handle)": lambda: cbam._stream(x),
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "ctypes call (the launch)": lambda: fn(x.data_ptr(), out.data_ptr(), b, h * w, c, 1, 8,
                                               geo.groups, geo.cluster, geo.px, geo.threads,
                                               stream),
        "out.unbind(0)": lambda: out.unbind(0),
        "library: x.mean((2,3)) + x.amax((2,3))": lambda: (xl.mean((2, 3)), xl.amax((2, 3))),
    }
    result = {}
    for name, f in steps.items():
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        result[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    cs.log("pool_host_us", json.dumps(dict(shape=list(shape), **result)))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("earlier_source", help="an earlier tree's csrc/avg_max_pool.cu")
    ap.add_argument("--scan", action="store_true", help="also scan this kernel's geometry")
    ap.add_argument("--host", action="store_true", help="also time the wrapper's host path")
    ap.add_argument("--out", help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    for name, log in _build.build_all().items():
        cs.log(name, log)
    earlier = build_earlier(args.earlier_source)
    sms = cbam._sm_count(dev.index or 0)
    rows = compare(dev, earlier, sms)
    result = dict(card=card, compare=rows)
    if args.host:
        result["host_us"] = host_path(dev)
    ok = all(r["agree"] for r in rows)
    if args.scan:
        result["scan"] = scan(dev, sms)
        ok = ok and all(r.get("agree", True) and r.get("repeat_exact", True)
                        for r in result["scan"])
        best = {}
        for r in result["scan"]:
            key = (tuple(r["shape"]), r["dtype"])
            if "device_ms" in r and (key not in best or r["device_ms"] < best[key]["device_ms"]):
                best[key] = r
        for (shape, dtype), r in best.items():
            mine = next(s for s in result["scan"] if tuple(s["shape"]) == shape
                        and s["dtype"] == dtype and s["chosen"])
            cs.log("pool_scan_best", json.dumps(dict(shape=list(shape), dtype=dtype, best=r,
                                                     chosen_ms=mine.get("device_ms"))))
    cs.log("pool_vs_earlier_summary", json.dumps(dict(
        card=card, all_agree=ok,
        earlier_device_ms={f"{r['dtype']} {r['shape']}": r["earlier_device_ms"] for r in rows},
        device_ms={f"{r['dtype']} {r['shape']}": r["device_ms"] for r in rows})))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
