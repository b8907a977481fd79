"""The port's production trainer (CPU): validation against the JAX
trainer's, a short run with its artifacts, bit-exact resume, the CLI.

Validation tolerance 1e-5 (loss, pixel accuracy, batch IoU): the float32
logits of the two packages agree to ~2.5e-5, and no logit pair lies within
1e-4 of a tie (checked), so the argmax counts are exact.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.models.unet import UNet as JaxUNet
from coastline.train.loop import normalize_images as jax_normalize
from coastline.train.trainer import TrainerConfig as JaxTrainerConfig
from coastline.train.trainer import WaterSegmentationTrainer as JaxTrainer
from coastline_torch.cli import train as cli_train
from coastline_torch.data.pipeline import DeviceDataset, HostDataset
from coastline_torch.data.synthetic import synthetic_dataset_arrays, synthetic_device_dataset
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.models.unet import UNet
from coastline_torch.train.loop import batch_indices
from coastline_torch.train.trainer import TrainerConfig, WaterSegmentationTrainer
from coastline_torch.utils.torch_import import random_unet_variables, unet_state_dict

torch.set_num_threads(1)


def test_validate_matches_jax_trainer():
    """n = 3 at batch 2: the padded slot is masked out of every reduction."""
    variables = random_unet_variables(seed=4)
    images, masks = synthetic_dataset_arrays(3, 32, seed=7)
    idx, valid = batch_indices(3, 2, shuffle=False, rng=np.random.default_rng(0))
    logits = np.asarray(JaxUNet(n_classes=2).apply(variables, jax_normalize(jnp.asarray(images))))
    assert np.abs(logits[..., 1] - logits[..., 0]).min() > 1e-4
    ref = JaxTrainer(JaxTrainerConfig(image_size=32, batch_size=2))._make_validate()(
        variables["params"], variables["batch_stats"], jnp.asarray(images), jnp.asarray(masks),
        jnp.asarray(idx), jnp.asarray(valid))

    trainer = WaterSegmentationTrainer(TrainerConfig(image_size=32, batch_size=2), device="cpu")
    trainer.model.load_state_dict(unet_state_dict(variables), strict=True)
    got = trainer._make_validate()(images, masks, idx, valid)
    assert all(t.ndim == 0 for t in got)
    for g, r in zip(got, ref):
        assert float(g) == pytest.approx(float(r), abs=1e-5)
    assert float(got[3]) == 2.0 and 0.0 < float(got[1]) < 1.0


def _cfg(save_dir, epochs, size=32, **kw):
    return TrainerConfig(epochs=epochs, batch_size=2, lr=1e-3, image_size=size,
                         save_dir=str(save_dir), augment=True, **kw)


@pytest.fixture(scope="module")
def datasets():
    return (synthetic_device_dataset(4, size=32, seed=0, device="cpu"),
            synthetic_device_dataset(2, size=32, seed=1, device="cpu"))


def test_trainer_short_run_artifacts_and_best_export(tmp_path, datasets):
    train_ds, val_ds = datasets
    cfg = _cfg(tmp_path / "models", 3, viz_every=2)
    trainer = WaterSegmentationTrainer(cfg, device="cpu")
    hist = trainer.train(train_ds, val_ds, verbose=False)
    for key in ("train_losses", "val_losses", "learning_rates", "accuracies", "iou_scores"):
        assert len(hist[key]) == 3 and all(np.isfinite(hist[key])), key
    assert hist["learning_rates"] == [float(np.float32(1e-3))] * 3
    assert hist["training_time"] > 0 and trainer.state.step == 6
    with open(os.path.join(cfg.save_dir, "training_history.pkl"), "rb") as f:
        assert pickle.load(f)["iou_scores"] == hist["iou_scores"]
    assert os.path.exists(os.path.join(cfg.save_dir, "training_report.png"))
    progress = os.listdir(os.path.join(cfg.save_dir, "progress"))
    assert any(p.startswith("progress_epoch_0002") for p in progress)
    assert any(p.startswith("confusion_epoch_0002") for p in progress)

    best = trainer.load_best()
    model = UNet()
    model.load_state_dict(best, strict=True)
    assert best["final.weight"].device.type == "cpu"
    ex = CoastlineExtractor(torch_checkpoint=os.path.join(cfg.save_dir, "best", "model.pth"),
                            image_size=32, device="cpu")
    masks = ex.predict_masks_batch(val_ds.images.numpy())
    assert masks.shape == (2, 32, 32) and set(np.unique(masks)) <= {0, 1}


def test_trainer_resume_is_bit_exact(tmp_path):
    """2 epochs, then 2 more resumed by a new trainer == 4 straight: the
    parameters, Adam state, histories, best epoch and the shuffles continue
    from the resume point. Resuming a finished run is a no-op; resuming
    without a resume point starts fresh. At 16^2 to keep it short."""
    train_ds = synthetic_device_dataset(4, size=16, seed=0, device="cpu")
    val_ds = synthetic_device_dataset(2, size=16, seed=1, device="cpu")
    straight = WaterSegmentationTrainer(_cfg(tmp_path / "a", 4, 16, viz_every=0, checkpoint_every=2),
                                        device="cpu")
    hist_a = straight.train(train_ds, val_ds, verbose=False)
    first = WaterSegmentationTrainer(_cfg(tmp_path / "b", 2, 16, viz_every=0, checkpoint_every=2),
                                     device="cpu")
    first.train(train_ds, val_ds, verbose=False)
    resumed = WaterSegmentationTrainer(_cfg(tmp_path / "b", 4, 16, viz_every=0, checkpoint_every=2),
                                       device="cpu")
    hist_b = resumed.train(train_ds, val_ds, verbose=False, resume=True)

    for key in ("train_losses", "val_losses", "iou_scores", "accuracies", "learning_rates"):
        assert hist_a[key] == hist_b[key], key
    assert len(hist_b["train_losses"]) == 4
    assert hist_a["best_model_epoch"] == hist_b["best_model_epoch"]
    for (k, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = straight.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i in sa["state"]:
        assert all(torch.equal(sa["state"][i][m], sb["state"][i][m])
                   for m in ("step", "exp_avg", "exp_avg_sq"))
    assert straight.state.step == resumed.state.step == 8
    assert torch.equal(straight.state.generator.get_state(), resumed.state.generator.get_state())

    again = WaterSegmentationTrainer(_cfg(tmp_path / "b", 4, 16, viz_every=0, checkpoint_every=2),
                                     device="cpu")
    hist_c = again.train(train_ds, val_ds, verbose=False, resume=True)
    assert hist_c["train_losses"] == hist_b["train_losses"]
    fresh = WaterSegmentationTrainer(_cfg(tmp_path / "fresh", 1, 16, viz_every=0), device="cpu")
    assert len(fresh.train(train_ds, val_ds, verbose=False, resume=True)["train_losses"]) == 1


def test_cli_trains_on_synthetic_data(tmp_path, capsys):
    save_dir = tmp_path / "cli"
    assert cli_train.main(["--synthetic", "6", "--epochs", "1", "--image-size", "32",
                           "--batch-size", "2", "--device", "cpu",
                           "--save-dir", str(save_dir)]) == 0
    out = capsys.readouterr().out
    assert "training on 4 samples, validating on 2" in out and "done: best IoU" in out
    assert sorted(os.listdir(save_dir)) == ["best", "resume_meta.pkl", "step_1.pth",
                                            "training_history.pkl", "training_report.png"]


def test_prepare_dataset_reads_the_labelme_tree(tmp_path):
    from coastline_torch.data.synthetic import write_synthetic_tree

    images_dir, labels_dir = write_synthetic_tree(str(tmp_path), 5, size=60, seed=3)
    trainer = WaterSegmentationTrainer(TrainerConfig(image_size=32), device="cpu")
    train_ds, val_ds = trainer.prepare_dataset(images_dir, labels_dir)
    assert isinstance(train_ds, DeviceDataset) and (len(train_ds), len(val_ds)) == (4, 1)
    assert tuple(train_ds.images.shape) == (4, 32, 32, 3)


def test_host_resident_datasets_train_like_resident_ones(tmp_path):
    """An epoch whose train and validation sets live on the host (chunked
    uploads, one batch a chunk) gives the resident run's history and
    weights bit for bit."""
    from coastline_torch.data.pipeline import make_dataset

    arrays = [synthetic_dataset_arrays(n, 16, seed=s) for n, s in ((4, 0), (3, 1))]
    runs = []
    for placement in ("device", "host"):
        sets = [make_dataset(*a, placement=placement, superbatch=1, device="cpu") for a in arrays]
        trainer = WaterSegmentationTrainer(_cfg(tmp_path / placement, 1, 16, viz_every=0),
                                           device="cpu")
        runs.append((trainer.train(*sets, verbose=False), trainer.model.state_dict()))
    (ha, sa), (hb, sb) = runs
    assert isinstance(sets[1], HostDataset)
    for key in ("train_losses", "val_losses", "accuracies", "iou_scores"):
        assert ha[key] == hb[key], key
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
