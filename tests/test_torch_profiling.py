"""The port's timing and tracing helpers (`coastline_torch/utils/profiling.py`)
on the CPU: the JAX package's adaptive device-loop cases
(`tests/test_profiling.py`) against the port's functions, the Chrome trace
that `trace` writes, `conv_flops` against a count by hand, and the card's
paths refusing to run without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from coastline_torch.ops.primitives import Conv, ConvTranspose
from coastline_torch.utils.profiling import (conv_flops, device_loop_seconds,
                                             measure_dispatch_rtt, trace)

torch.set_num_threads(1)


def _step(c, x):
    return c + (x * (1.0 + c * 1e-20)).sum()


def test_returns_positive_per_iteration_time():
    x = torch.ones((64, 64))
    sec = device_loop_seconds(_step, (x,), n_loop=5, trials=2, rtt=0.0)
    assert sec > 1e-9  # not the clamp floor


def test_scales_loop_until_device_time_dominates_rtt():
    """With an artificially huge rtt, a cheap step is looped until the loop
    reaches ~target_ratio x rtt (bounded by max_loop): at n_loop=4, (t - rtt)
    would be dominated by the fake rtt and clamp or read ~12.5 ms a step."""
    x = torch.ones((8, 8))
    sec = device_loop_seconds(_step, (x,), n_loop=4, trials=2, rtt=0.05,
                              target_ratio=5.0, max_loop=50_000)
    assert 0 < sec < 1e-3


def test_measure_dispatch_rtt_smoke():
    rtt = measure_dispatch_rtt(trials=2, device="cpu")
    assert 0 <= rtt < 5.0


def _events(logdir):
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, files
    with open(os.path.join(logdir, files[0])) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir, device="cpu") as d:
        assert d == logdir
        with torch.profiler.record_function("coastline_span"):
            torch.ones(16).sum()
    assert any(e.get("name") == "coastline_span" for e in _events(logdir))


def test_trace_stops_and_writes_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with trace(str(tmp_path / "a"), device="cpu"):
            with torch.profiler.record_function("before_error"):
                torch.ones(4).sum()
            raise ValueError("inside")
    assert any(e.get("name") == "before_error" for e in _events(str(tmp_path / "a")))
    with trace(str(tmp_path / "b"), device="cpu"):  # the profiler was stopped
        torch.ones(4).sum()
    assert _events(str(tmp_path / "b"))


def test_trace_default_logdir_follows_tmpdir(tmp_path):
    code = ("import torch\n"
            "from coastline_torch.utils.profiling import trace\n"
            "with trace(device='cpu') as d:\n"
            "    torch.ones(4).sum()\n"
            "print(d)\n")
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300, check=True,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    logdir = str(tmp_path / "coastline-trace")
    assert proc.stdout.strip() == logdir
    assert _events(logdir)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv(3, 8, 3, padding=1)
        self.up = ConvTranspose(8, 4)

    def forward(self, x, return_logits=False):
        return self.up(self.conv(x))


def test_conv_flops_counts_from_the_layer_shapes():
    """2 x MACs: the 3x3 conv 3 -> 8 at 6x10, the k2/s2 transposed conv
    8 -> 4 to 12x20 (one tap an output pixel); batch 2."""
    x = torch.zeros(2, 3, 6, 10)
    want = 2 * (2 * 8 * 6 * 10 * 3 * 9) + 2 * (2 * 4 * 12 * 20 * 8)
    assert conv_flops(_Tiny(), x) == want


@pytest.mark.parametrize("call", ["trace", "rtt", "loop"])
def test_card_paths_raise_without_a_card(call, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "trace":
            with trace(str(tmp_path)):
                pass
        elif call == "rtt":
            measure_dispatch_rtt()
        else:
            device_loop_seconds(_step, (1.0,), rtt=0.0)
