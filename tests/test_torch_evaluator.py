"""The comparison protocol vs the JAX package (CPU): `Evaluator.train_model`
and `evaluate_model`, the HostDataset validation, `nan_policy`, the JSONL
log, and the `bench_all` CLI.

The protocol case trains SegNet (the comne protocol: plateau on the val
loss, patience 3) for 2 epochs over 4 synthetic 32^2 tiles at batch 2 and
validates on 2, through the JAX `Evaluator` and the port's from the same
`init_variables`: the port's init with every BN bias at 2 (weight seed 0
of its constructor, `chip_smoke.shift_bn`; `tests/test_torch_segnet_train.py`
says why), handed to JAX as variables and to the port as the bridge's
state_dict. Every history entry, best IoU and evaluated metric within 1e-5.
"""

import contextlib
import io
import json
import math
import re

import numpy as np
import pytest
import torch

from chip_smoke import shift_bn
from coastline.cli import bench_all as jax_bench_all
from coastline.data.pipeline import make_dataset as jax_make_dataset
from coastline.models import registry as jax_registry
from coastline.models.segnet import SegNet as JaxSegNet
from coastline.train import loop as jax_loop
from coastline.utils.tables import format_results_table as jax_format_results_table
from coastline.utils.torch_import import import_reference_segnet
from coastline_torch.cli import bench_all
from coastline_torch.data.pipeline import make_dataset
from coastline_torch.data.synthetic import synthetic_dataset_arrays
from coastline_torch.models.segnet import SegNet
from coastline_torch.train.loop import Evaluator, TrainConfig
from coastline_torch.utils.tables import format_results_table

torch.set_num_threads(1)
HISTORY_KEYS = ("train_loss", "val_loss", "val_iou", "val_f1", "val_accuracy")


def _tiles(n, seed, size=32):
    return synthetic_dataset_arrays(n, size, seed)


@pytest.fixture(scope="module")
def protocol_run():
    """The 2-epoch protocol through both packages: (jax train, jax eval,
    port train, port eval, port evaluator)."""
    train, val = _tiles(4, 0), _tiles(2, 1)
    sd = shift_bn(SegNet().state_dict(), 2.0)
    variables = import_reference_segnet({k: v.numpy() for k, v in sd.items()})
    jax_cfg = jax_bench_all.model_train_config("SegNet", epochs=2)
    ev = jax_loop.Evaluator(JaxSegNet(), jax_cfg)
    jax_train = ev.train_model(jax_make_dataset(*train), jax_make_dataset(*val), verbose=False,
                               init_variables=variables)
    jax_eval = ev.evaluate_model(jax_make_dataset(*val))
    cfg = bench_all.model_train_config("SegNet", epochs=2)
    assert cfg == TrainConfig(**{k: getattr(jax_cfg, k) for k in jax_cfg.__dataclass_fields__})
    port = Evaluator(SegNet(), cfg, device="cpu")
    port_train = port.train_model(make_dataset(*train, device="cpu"),
                                  make_dataset(*val, device="cpu"), verbose=False,
                                  init_variables=sd)
    port_eval = port.evaluate_model(make_dataset(*val, device="cpu"))
    return jax_train, jax_eval, port_train, port_eval, port


def test_train_model_matches_jax(protocol_run):
    jax_train, _, port_train, _, port = protocol_run
    assert set(port_train) == {"best_iou", "history"}
    assert tuple(port_train["history"]) == HISTORY_KEYS
    for k in HISTORY_KEYS:
        got, ref = port_train["history"][k], jax_train["history"][k]
        assert len(got) == len(ref) == 2
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=k)
    assert port_train["best_iou"] == pytest.approx(jax_train["best_iou"], abs=1e-5)
    assert port.state.step == 4 and 0 < port_train["best_iou"] < 1


def test_evaluate_model_matches_jax(protocol_run):
    _, jax_eval, _, port_eval, _ = protocol_run
    assert set(port_eval) == set(jax_eval)
    for k, v in jax_eval.items():
        if k == "avg_inference_time":
            assert port_eval[k] > 0
        elif k.startswith(("mean_", "std_")):
            assert port_eval[k] == pytest.approx(v, abs=1e-5), k
        else:
            assert port_eval[k] == v, k
    assert port_eval["inference_batch_size"] == 2 and port_eval["total_samples"] == 2


def test_host_dataset_validation_equals_resident(protocol_run):
    """A HostDataset uploaded one batch a chunk: the per-chunk sufficient
    statistics give the resident pass's loss and every mean and std."""
    port = protocol_run[4]
    images, masks = _tiles(5, 2)
    idx, valid = jax_loop.batch_indices(5, 2, shuffle=False, rng=np.random.default_rng(0))
    resident = port._run_eval_epoch(make_dataset(images, masks, device="cpu"), idx, valid)
    host = port._run_eval_epoch(make_dataset(images, masks, placement="host", superbatch=1),
                                idx, valid)
    assert host[0] == pytest.approx(resident[0], rel=1e-6)
    assert set(host[1]) == set(resident[1])
    for k, v in resident[1].items():
        assert host[1][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


@pytest.mark.parametrize("policy,epochs_kept", [("halt", 1), ("warn", 3)])
def test_nan_policy_and_jsonl_log(tmp_path, capsys, policy, epochs_kept):
    """A non-finite train loss in epoch 1 of 3: `halt` stops before
    recording it, `warn` records it and goes on; both log a `nan` event
    beside the `epoch` events."""
    log_path = tmp_path / "metrics.jsonl"
    cfg = TrainConfig(epochs=3, nan_policy=policy, log_path=str(log_path), log_every=1)
    ev = Evaluator(SegNet(), cfg, device="cpu")
    run_epoch, calls = ev._run_train_epoch, []

    def poisoned(*args):
        state, loss = run_epoch(*args)
        calls.append(loss)
        return state, (float("nan") if len(calls) == 2 else loss)

    ev._run_train_epoch = poisoned
    ds = make_dataset(*_tiles(2, 3), device="cpu")
    out = ev.train_model(ds, ds)
    hist = out["history"]
    assert all(len(hist[k]) == epochs_kept for k in HISTORY_KEYS)
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    assert [e["event"] for e in events] == (["epoch", "nan"] if policy == "halt"
                                            else ["epoch", "nan", "epoch", "epoch"])
    said = capsys.readouterr().out
    assert ("HALT: non-finite loss at epoch 1" in said) == (policy == "halt")
    assert ("WARNING: non-finite loss at epoch 1" in said) == (policy == "warn")
    if policy == "warn":
        assert math.isnan(hist["train_loss"][1]) and "Epoch  2:" in said


def _jax_cli_flags():
    """The JAX `bench_all` flags, from its --help."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        jax_bench_all.main(["--help"])
    return set(re.findall(r"^\s+(?:-\w, )?(--[a-z][\w-]*)", out.getvalue(), re.M))


def test_bench_all_cli_on_the_cpu(tmp_path, capsys):
    argv = ["--synthetic", "6", "--image-size", "32", "--epochs", "1", "--device", "cpu",
            "--models", "SegNet", "--out-dir", str(tmp_path)]
    assert bench_all.main(argv) == 0
    said = capsys.readouterr().out
    with open(tmp_path / "benchmark_results.json") as f:
        out = json.load(f)
    assert set(out) == {"config", "results", "param_counts", "histories"}
    flags = {k.replace("_", "-") for k in out["config"]} - {"per-model",
                                                             "inference-time-batch-size"}
    assert {f"--{k}" for k in flags} == (_jax_cli_flags() - {"--help"}) | {"--device"}
    assert out["config"]["per_model"] == {"SegNet": {"epochs": 1, "plateau_on": "val",
                                                     "plateau_patience": 3}}
    assert out["config"]["inference_time_batch_size"] == 2
    assert out["param_counts"] == {"SegNet": 15_278_593}
    res = out["results"]["SegNet"]
    metrics = {f"{s}_{m}" for s in ("mean", "std")
               for m in ("accuracy", "iou", "precision", "recall", "f1_score")}
    assert set(res) == metrics | {"avg_inference_time", "inference_batch_size",
                                  "throughput_images_per_sec", "throughput_batch_size",
                                  "total_samples"}
    assert res["throughput_batch_size"] == 64 and res["total_samples"] == 2
    assert tuple(out["histories"]["SegNet"]) == HISTORY_KEYS
    table = format_results_table(out["results"], out["param_counts"])
    assert table == jax_format_results_table(out["results"], out["param_counts"])
    assert table in said and "Training SegNet... (15,278,593 params, 1 epochs)" in said


@pytest.mark.parametrize("argv,code,message", [
    (["--models", "SegNet,DeepLabV3++"], None, "unknown model 'DeepLabV3\\+\\+'"),
    (["--models", "robust_unet,segformer"], None, "unknown model 'segformer'"),  # not an alias
    (["--models", "SegNet", "--data-parallel", "2"], 2, "not ported yet"),
    (["--models", "SegNet", "--model-parallel", "2"], 2, "not ported yet"),
    (["--models", "SegNet", "--sharded-data"], 2, "not ported yet"),
])
def test_bench_all_refuses_what_is_not_ported(capsys, argv, code, message):
    argv = argv + ["--synthetic", "2", "--image-size", "32", "--device", "cpu"]
    if code is None:
        with pytest.raises(KeyError, match=message) as err:
            bench_all.main(argv)
        assert str(jax_registry.available_models()) in str(err.value)
        assert "Training" not in capsys.readouterr().out  # refused before any training
    else:
        assert bench_all.main(argv) == code
        assert message in capsys.readouterr().err


def test_results_table_is_the_jax_table():
    results = {"Robust UNet": {"mean_iou": 0.81234, "mean_f1_score": 0.9, "mean_accuracy": 0.95,
                               "avg_inference_time": 0.0123},
               "SegNet": {"mean_iou": 0.7, "mean_f1_score": 0.91, "mean_accuracy": 0.93,
                          "avg_inference_time": 0.004, "throughput_images_per_sec": 512.5,
                          "throughput_batch_size": 64}}
    counts = {"Robust UNet": 40_872_223, "SegNet": 15_278_593}
    assert format_results_table(results, counts) == jax_format_results_table(results, counts)
    assert format_results_table({}, {}) == jax_format_results_table({}, {})
