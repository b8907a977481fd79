"""The multi-device flags of `cli.train` and `cli.bench_all` on the CPU
(gloo ranks, `--device cpu`), with the JAX CLIs' semantics and messages
(`coastline/cli/train.py:30-107`, `coastline/cli/bench_all.py:118-160`).

`cli.train --data-parallel 2` writes the single-process checkpoint files
(rank 0), which `--data-parallel 4 --model-parallel 2 --resume` reloads
and re-shards, and whose FSDP-gathered final state one process restores;
`--sharded-data` sample-shards both datasets. `cli.bench_all` runs SegNet
sample-sharded over two ranks and on a 2 x 2 mesh. Ranks print nothing
but rank 0; their output is read at the file descriptor (`capfd`).
"""

import json
import os

import numpy as np
import pytest
import torch

from coastline_torch.cli import bench_all
from coastline_torch.cli import train as train_cli
from coastline_torch.models.unet import UNet
from coastline_torch.train.checkpoint import CheckpointManager
from coastline_torch.train.loop import TrainConfig, create_train_state

torch.set_num_threads(1)
TRAIN = ["--synthetic", "5", "--image-size", "32", "--batch-size", "4", "--device", "cpu",
         "--checkpoint-every", "1"]


def test_train_data_parallel_then_model_parallel_resume(tmp_path, capfd):
    save = str(tmp_path / "run")
    assert train_cli.main(TRAIN + ["--epochs", "1", "--data-parallel", "2",
                                   "--save-dir", save]) == 0
    said = capfd.readouterr().out
    assert said.count("training on 4 samples, validating on 1") == 1
    assert "Epoch 1/1" in said and "done: best IoU" in said
    assert sorted(os.listdir(save)) == ["best", "resume_meta.pkl", "step_1.pth",
                                        "training_history.pkl", "training_report.png"]

    assert train_cli.main(TRAIN + ["--epochs", "2", "--data-parallel", "4", "--model-parallel",
                                   "2", "--resume", "--save-dir", save]) == 0
    said = capfd.readouterr().out
    assert "resumed at epoch 2/2" in said and "Epoch 2/2" in said and "Epoch 1/2" not in said
    # the 2 x 2 mesh's final state, gathered from FSDP, restores in one process
    model = UNet(n_classes=2)
    state = CheckpointManager(save).restore(
        create_train_state(model, TrainConfig(weight_decay=0.0), device="cpu"))
    assert state.step == 2 and len(state.optimizer.state) == len(list(model.parameters()))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    model.load_state_dict(CheckpointManager(save).restore_best(), strict=True)


def test_train_sharded_data(tmp_path, capfd):
    assert train_cli.main(TRAIN + ["--epochs", "1", "--data-parallel", "2", "--sharded-data",
                                   "--checkpoint-every", "0", "--save-dir",
                                   str(tmp_path)]) == 0
    said = capfd.readouterr().out
    assert "datasets sample-sharded over 2 chips" in said
    assert said.count("training on 4 samples, validating on 1") == 1
    assert "done: best IoU" in said


@pytest.mark.parametrize("argv,message", [
    (["--sharded-data"], "--sharded-data requires --data-parallel; ignoring"),
    (["--sharded-data", "--data-parallel", "2", "--batch-size", "3"],
     "--sharded-data needs batch 3 divisible by the data axis (2); ignoring")])
def test_train_sharded_data_ignored_as_jax(monkeypatch, capfd, argv, message):
    ran = []
    monkeypatch.setattr(train_cli, "_train", lambda args, sharded: ran.append(sharded))
    monkeypatch.setattr("coastline_torch.parallel.launch.run",
                        lambda fn, n, device, args, quiet: [fn(*args)])
    assert train_cli.main(["--device", "cpu"] + argv) == 0
    assert message in capfd.readouterr().out and ran == [False]


@pytest.mark.parametrize("argv,error", [
    (["--data-parallel", "4", "--model-parallel", "3"],
     "4 devices not divisible by space=1 x dcn=1 x model=3"),
    (["--data-parallel", "2", "--device", "cuda"], "no CUDA device")])
def test_train_refuses_before_any_rank(argv, error):
    """Sizes are checked before a rank starts; a CUDA request without a card
    raises (no quiet fallback to the CPU)."""
    with pytest.raises((ValueError, RuntimeError), match=error):
        train_cli.main(["--synthetic", "2", "--epochs", "1"] + argv)


@pytest.mark.parametrize("mesh_args,line", [
    (["--data-parallel", "2", "--sharded-data"],
     "datasets sample-sharded over 2 chips (1/2 per-chip HBM share)"),
    (["--data-parallel", "4", "--model-parallel", "2"],
     "mesh over 4 devices (model-parallel x2)")])
def test_bench_all_multi_device(tmp_path, capfd, mesh_args, line):
    argv = ["--models", "SegNet", "--synthetic", "5", "--image-size", "32", "--epochs", "1",
            "--batch-size", "4", "--throughput-batch", "4", "--device", "cpu",
            "--out-dir", str(tmp_path)] + mesh_args
    assert bench_all.main(argv) == 0
    said = capfd.readouterr().out
    assert line in said and said.count("Training SegNet") == 1
    with open(tmp_path / "benchmark_results.json") as f:
        out = json.load(f)
    res = out["results"]["SegNet"]
    assert res["total_samples"] == 1 and res["throughput_batch_size"] == 4
    assert np.isfinite(out["histories"]["SegNet"]["train_loss"]).all()
