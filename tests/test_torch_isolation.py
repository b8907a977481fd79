"""The port stands alone: it imports no jax and nothing of `coastline`, and
its entry points refuse to run quietly on the CPU when no card is there."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import coastline_torch
mods = sorted(m.name for m in pkgutil.walk_packages(coastline_torch.__path__, "coastline_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "coastline"))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_coastline():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for m in ("coastline_torch.infer.extract", "coastline_torch.infer.server",
              "coastline_torch.kernels.fused_conv", "coastline_torch.kernels.morphology",
              "coastline_torch.models.unet", "coastline_torch.utils.torch_import",
              "coastline_torch.kernels.cbam", "coastline_torch.kernels.pools",
              "coastline_torch.models.robust_unet", "coastline_torch.models.registry",
              "coastline_torch.ops.initializers", "coastline_torch.train.losses",
              "coastline_torch.train.metrics", "coastline_torch.train.loop",
              "coastline_torch.kernels.unpool", "coastline_torch.models.segnet",
              "coastline_torch.train.lr", "coastline_torch.train.checkpoint",
              "coastline_torch.train.trainer", "coastline_torch.data.augment",
              "coastline_torch.data.rasterize", "coastline_torch.data.pipeline",
              "coastline_torch.data.synthetic", "coastline_torch.report.trainer_viz",
              "coastline_torch.cli.train", "coastline_torch.cli.bench_all",
              "coastline_torch.train.hsv", "coastline_torch.utils.metrics_log",
              "coastline_torch.utils.tables", "coastline_torch.utils.profiling",
              "coastline_torch.report.curves", "coastline_torch.report.comparison",
              "coastline_torch.report.error_maps", "coastline_torch.models.deeplabv3p",
              "coastline_torch.models.yoloseg", "coastline_torch.models.pspnet",
              "coastline_torch.models.fastscnn", "coastline_torch.models.enet",
              "coastline_torch.models.waternet", "coastline_torch.models.mswnet",
              "coastline_torch.models.hrnet_water", "coastline_torch.models.segformer_lite",
              "coastline_torch.data.tiling", "coastline_torch.infer.scene",
              "coastline_torch.data.geotiff", "coastline_torch.infer.geojson",
              "coastline_torch.infer.change", "coastline_torch.report.coastsat_fig",
              "coastline_torch.report.change_fig", "coastline_torch.cli.predict",
              "coastline_torch.cli.convert", "coastline_torch.cli.change",
              "coastline_torch.cli.export", "coastline_torch.native",
              "coastline_torch.infer.quant", "coastline_torch.infer.deploy",
              "coastline_torch.kernels.int8_conv", "coastline_torch.bench",
              "coastline_torch.cli.gui"):
        assert m in report["modules"]


def _entry_points():
    from coastline_torch.infer.extract import CoastlineExtractor
    from coastline_torch.infer.morphology import coastline_band, dilate
    from coastline_torch.models.robust_unet import RobustUNet
    from coastline_torch.models.segnet import SegNet
    from coastline_torch.cli.train import main as train_cli
    from coastline_torch.data.pipeline import make_dataset
    from coastline_torch.models.unet import UNet
    from coastline_torch.train.loop import (TrainConfig, create_train_state, make_eval_epoch,
                                            make_train_epoch)
    from coastline_torch.train.trainer import WaterSegmentationTrainer
    from coastline_torch.cli.bench_all import main as bench_all_cli
    from coastline_torch.train.loop import Evaluator
    from coastline_torch.models.registry import create_model
    from coastline_torch.cli.predict import main as predict_cli
    from coastline_torch.cli.export import main as export_cli
    from coastline_torch.infer.deploy import load_quantized
    from coastline_torch.infer.quant import QuantizedModel, default_calibration
    from coastline_torch.bench import run as bench_run

    mask = np.zeros((8, 8), np.uint8)
    return {
        "extractor": lambda: CoastlineExtractor(),
        "coastline_band": lambda: coastline_band(mask),
        "dilate": lambda: dilate(mask),
        "make_eval_epoch": lambda: make_eval_epoch(RobustUNet(base=16), TrainConfig()),
        "segnet_eval_epoch": lambda: make_eval_epoch(SegNet(), TrainConfig()),
        "make_train_epoch": lambda: make_train_epoch(UNet(), TrainConfig(loss="ce")),
        "create_train_state": lambda: create_train_state(UNet(), TrainConfig()),
        "trainer": lambda: WaterSegmentationTrainer(),
        "train_cli": lambda: train_cli(["--synthetic", "2", "--epochs", "1"]),
        "make_dataset": lambda: make_dataset(np.zeros((1, 8, 8, 3), np.uint8),
                                             np.zeros((1, 8, 8), np.uint8)),
        "evaluator": lambda: Evaluator(SegNet(), TrainConfig()),
        "bench_all_cli": lambda: bench_all_cli(["--synthetic", "2", "--models", "SegNet"]),
        "zoo_eval_epoch": lambda: make_eval_epoch(create_model("WaterNet"), TrainConfig()),
        "zoo_train_epoch": lambda: make_train_epoch(create_model("PSPNet"), TrainConfig()),
        "zoo_evaluator": lambda: Evaluator(create_model("SegFormer-Lite"), TrainConfig()),
        "bench_all_default_list": lambda: bench_all_cli(["--synthetic", "2"]),
        "predict_cli": lambda: predict_cli(["x.png", "--random-weights"]),
        "scene": lambda: CoastlineExtractor().predict_scene(np.zeros((40, 40, 3), np.uint8)),
        "export_cli": lambda: export_cli(["--checkpoint-dir", "x", "--out", "x.pth"]),
        "quantized_model": lambda: QuantizedModel({}, {}, arch="unet"),
        "load_quantized": lambda: load_quantized("x.npz"),
        "from_quantized": lambda: CoastlineExtractor.from_quantized("x.npz"),
        "default_calibration": lambda: default_calibration(64),
        "predict_cli_int8": lambda: predict_cli(["x.png", "--random-weights", "--int8"]),
        "export_cli_int8": lambda: export_cli(["--checkpoint-dir", "x", "--quantized-out",
                                               "x.npz"]),
        "bench": lambda: bench_run(size=32),
    }


@pytest.mark.parametrize("name", ["extractor", "coastline_band", "dilate", "make_eval_epoch",
                                  "segnet_eval_epoch", "make_train_epoch", "create_train_state",
                                  "trainer", "train_cli", "make_dataset", "evaluator",
                                  "bench_all_cli", "zoo_eval_epoch", "zoo_train_epoch",
                                  "zoo_evaluator", "bench_all_default_list", "predict_cli",
                                  "scene", "export_cli", "quantized_model", "load_quantized",
                                  "from_quantized", "default_calibration", "predict_cli_int8",
                                  "export_cli_int8", "bench"])
def test_entry_points_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_cpu_runs_only_when_asked():
    from coastline_torch.infer.morphology import coastline_band
    from coastline_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    band = coastline_band(np.ones((8, 8), np.uint8), 3, device="cpu")
    assert band.device.type == "cpu" and int(band.sum()) == 0
