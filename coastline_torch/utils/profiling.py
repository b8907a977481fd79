"""Timing of repeated device work (the port's counterpart of
`coastline/utils/profiling.py:60-115` `device_loop_seconds`).

The JAX package chains a jitted loop on the device and subtracts its
transport's round trip. Here the calls go back to back on the card's stream
between two CUDA events, after a warm-up (cuDNN picks its plans on the
first calls); there is no round trip to subtract. On the CPU a host clock
times the loop.
"""

import time

import torch


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
