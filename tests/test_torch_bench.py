"""The port's benchmark (`python -m coastline_torch.bench`) on the CPU at
32², full width: the root `bench.py`'s keys, one JSON line on stdout, and a
non-zero exit without a card unless `--device cpu`."""

import ast
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from coastline_torch import bench

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(size=32, batches=(2,), int8_batches=(2,), n_loop=2, trials=1, train_batches=1)
FLAGS = ["--device", "cpu", "--size", "32", "--batches", "2", "--int8-batches", "2",
         "--n-loop", "2", "--trials", "1", "--train-batches", "1"]


def root_bench_keys():
    """The keys of the dict the root bench prints (`bench.py:213-230`)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py prints no `out` dict")


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1")


def test_run_returns_the_root_bench_keys():
    out = bench.run(device="cpu", **SMALL)
    keys = root_bench_keys()
    assert len(keys) == 13 and keys <= set(out)
    assert out["metric"] == "robust_unet_32_bf16_infer_images_per_sec_per_chip"
    assert out["platform"] == "cpu" and out["device_kind"] == "cpu"
    assert out["power_limit_w"] is None
    assert out["int8_accuracy_gated"] is False and out["int8_zoo_accuracy_gated"] is False
    assert out["best_batch"] == 2 and out["value"] == out["bf16_images_per_sec"]
    for k in ("value", "bf16_images_per_sec", "int8_images_per_sec", "p50_tile_latency_ms",
              "int8_p50_tile_latency_ms", "train_images_per_sec_per_chip"):
        assert math.isfinite(out[k]) and out[k] > 0, k
    with open(os.path.join(REPO, "baselines", "torch_cpu_baseline.json")) as f:
        baseline = json.load(f)["robust_unet_infer_images_per_sec"]
    assert out["vs_baseline"] == pytest.approx(out["value"] / baseline)


def test_cli_prints_one_json_line():
    proc = subprocess.run([sys.executable, "-m", "coastline_torch.bench", *FLAGS], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    assert root_bench_keys() <= set(json.loads(lines[0]))
    assert "single-tile latency" in proc.stderr


def test_cli_without_a_card_exits_non_zero():
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")  # no card, on any machine
    proc = subprocess.run([sys.executable, "-m", "coastline_torch.bench", "--size", "32"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
