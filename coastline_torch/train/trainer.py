"""The production training loop (counterpart of `coastline/train/trainer.py`;
the reference's `WaterSegmentationTrainer`,
`train_water_segmentation.py:290-830`).

The 2-class UNet with cross-entropy, Adam without weight decay at 1e-4, the
plateau schedule on the val loss (patience 10, x0.5), the quality-gated
dataset with the seeded 80/20 split, per-epoch validation (pixel accuracy
and batch-level IoU with the union == 0 -> 1.0 rule), best-IoU export,
early stop after 20 stale epochs, the history pickle and the figures.
Augmentation runs on the device and moves image and mask together
(`image_only_geometric=True` keeps the reference's image-only geometry).
Resume points hold the full train state (`train/checkpoint.py`) plus the
host loop's state in `resume_meta.pkl`, so `train(resume=True)` continues
bit for bit.

The train steps run the model in train mode, which takes no fused kernel;
every validation forward runs in eval mode, where a bf16 UNet launches
`fused_conv3x3_bn_relu` twice (`enc1`/`dec1` conv 2).

With a mesh (`parallel/mesh.py`, one process a device, `device` the
rank's) each rank trains and validates on its rows of every batch
(`train/loop.py`; with a 'space' axis its rows of every image too), the
validation sums are all-reduced, and rank 0 alone
writes the checkpoints (full state, `train/checkpoint.py`), the resume
sidecar, the history, the figures and the progress lines.
"""

import contextlib
import json
import os
import pickle
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from coastline_torch.data.augment import make_augment_fn
from coastline_torch.data.pipeline import HostDataset, build_dataset, pair_files, seeded_split
from coastline_torch.data.rasterize import WATER_LABELS
from coastline_torch.models.unet import UNet
from coastline_torch.parallel import collectives
from coastline_torch.train.checkpoint import CheckpointManager
from coastline_torch.train.loop import (TrainConfig, _as_device, _chunk_stream, _split,
                                        create_train_state, epoch_indices, make_train_epoch,
                                        normalize_images, run_train_epoch_any)
from coastline_torch.train.losses import per_image_cross_entropy
from coastline_torch.train.lr import plateau_update
from coastline_torch.utils.device import resolve_device


@dataclass
class TrainerConfig:
    epochs: int = 200
    batch_size: int = 8
    lr: float = 1e-4
    plateau_patience: int = 10
    early_stop_patience: int = 20
    image_size: int = 512
    save_dir: str = "./models"
    viz_every: int = 5
    augment: bool = True
    image_only_geometric: bool = False  # True = the reference's image-only geometry
    min_image_px: int = 50
    seed: int = 0
    dtype: str = "float32"
    # Every N epochs the full train state and the host loop's state (epoch,
    # best IoU, stale count, history, shuffle-rng state) are saved, so
    # `train(resume=True)` continues bit for bit from the last one. 0 saves
    # only at the end of the run.
    checkpoint_every: int = 5


def quality_gate_pairs(image_paths, label_paths, min_px: int = 50, verbose=True):
    """The reference's dataset gates (`train_water_segmentation.py:774-807`):
    drop images smaller than `min_px`, pairs without a water polygon, and
    unreadable files."""
    from PIL import Image

    kept_i, kept_l = [], []
    for ip, lp in zip(image_paths, label_paths):
        try:
            with Image.open(ip) as im:
                if min(im.size) < min_px:
                    continue
            with open(lp, "r", encoding="utf-8") as f:
                shapes = json.load(f).get("shapes", [])
            if not any(str(s.get("label", "")).lower() in WATER_LABELS for s in shapes):
                continue
        except Exception:  # any unreadable image or label (PIL's DecompressionBombError too)
            continue
        kept_i.append(ip)
        kept_l.append(lp)
    if verbose:
        print(f"quality gate: kept {len(kept_i)}/{len(image_paths)} pairs")
    return kept_i, kept_l


class WaterSegmentationTrainer:
    """The production trainer. `self.model` is the UNet that `train` trains
    (its init drawn from `config.seed`; load other weights into it before
    training to start from them). Raises without a card unless
    `device='cpu'`. `mesh` runs it on every rank of a mesh;
    `sharded_data=True` (requires `mesh`) takes sample-sharded datasets
    (`parallel.mesh.shard_device_dataset`), each rank holding and reading
    only its 1/k."""

    def __init__(self, config: TrainerConfig = TrainerConfig(), mesh=None,
                 sharded_data: bool = False, device="cuda"):
        if sharded_data and mesh is None:
            raise ValueError("sharded_data=True requires a mesh")
        self.config = config
        self.mesh, self.sharded_data = mesh, sharded_data
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
        self.model = UNet(n_classes=2, dtype=dtype, seed=config.seed).to(self.device)
        self.history = {"train_losses": [], "val_losses": [], "learning_rates": [],
                        "accuracies": [], "iou_scores": [], "best_model_epoch": 0,
                        "training_time": 0.0}

    # ---------------------------------------------------------------- data
    def prepare_dataset(self, images_dir, labels_dir):
        imgs, lbls = pair_files(images_dir, labels_dir,
                                extensions=(".png", ".jpg", ".jpeg", ".tif", ".tiff"))
        imgs, lbls = quality_gate_pairs(imgs, lbls, self.config.min_image_px)
        train_pairs, val_pairs = seeded_split(list(zip(imgs, lbls)), test_size=0.2, seed=42)
        size = (self.config.image_size, self.config.image_size)
        return tuple(build_dataset([p[0] for p in pairs], [p[1] for p in pairs], size,
                                   device=self.device)
                     for pairs in (train_pairs, val_pairs))

    # ------------------------------------------------------------ validate
    def _make_validate(self):
        """`validate(images_u8, masks, idx, valid) -> (loss, accuracy, iou,
        batches)`, device scalars: the eval forward over the plan's batches,
        each batch's loss and pixel accuracy masked by its valid samples and
        its IoU over them (union == 0 -> 1.0), averaged over the batches
        that hold a valid sample (`batches`, for combining chunks). On a
        mesh each rank runs its samples (with a space axis its rows of them,
        each image's loss and accuracy its pixels' sums over the image's
        count) and the batch sums are all-reduced."""
        model = self.model
        split = _split(self.mesh, model, self.device, self.sharded_data, train=False)

        def validate(images, masks, idx, valid):
            with torch.inference_mode() if split is None else torch.no_grad():
                return _validate(images, masks, idx, valid)

        def _validate(images, masks, idx, valid):
            images, masks, idx, valid = _as_device(images, masks, idx, valid, self.device)
            model.eval()
            rows = None if split is None else split.rows(idx.shape[1])
            height, width = images.shape[1], images.shape[2]
            count = None if split is None or split.space_group is None else height * width
            sums = []
            for bidx, w in zip(idx, valid):
                if rows is not None:
                    bidx, w = bidx[rows], w[rows]
                x_u8, y = images.index_select(0, bidx), masks.index_select(0, bidx).long()
                if count is not None:
                    x_u8, y = split.cut(x_u8, 1), split.cut(y, 1)
                x = normalize_images(x_u8).permute(0, 3, 1, 2)
                with contextlib.nullcontext() if split is None else split.rows_ctx(height, width):
                    logits = model(x, return_logits=True)
                pred = logits.argmax(1)
                hits = (pred == y).float()
                sums.append(torch.stack([
                    (per_image_cross_entropy(logits, y, count) * w).sum(),
                    ((hits.mean((1, 2)) if count is None else hits.sum((1, 2)) / count)
                     * w).sum(),
                    (((pred == 1) & (y == 1)).sum((1, 2)) * w).sum(),
                    (((pred == 1) | (y == 1)).sum((1, 2)) * w).sum()]))
            sums = torch.stack(sums)
            if split is not None:
                sums = collectives.all_reduce_sum(sums, split.group)
            n_valid = valid.sum(1).clamp_min(1.0)
            loss, acc = sums[:, 0] / n_valid, sums[:, 1] / n_valid
            inter, union = sums[:, 2], sums[:, 3]
            iou = torch.where(union == 0, 1.0, inter / union.clamp_min(1.0))
            has_valid = valid.amax(1)
            n = has_valid.sum().clamp_min(1.0)
            per_batch = torch.stack([loss, acc, iou], 1)
            return (*((per_batch * has_valid[:, None]).sum(0) / n), has_valid.sum())

        return validate

    # ----------------------------------------------------------- resume IO
    @staticmethod
    def _resume_meta_path(save_dir: str) -> str:
        return os.path.join(save_dir, "resume_meta.pkl")

    def _save_resume_point(self, ckpt, epoch, state, val_iou, best_iou, stale, host_rng,
                           elapsed_s):
        """The full state under step epoch + 1, then the host loop's state in
        the sidecar, written after the state is in place: a crash between
        the two leaves the previous resume point. On a mesh, rank 0 writes."""
        step = epoch + 1
        ckpt.save(step, state, metrics={"val_iou": float(val_iou)}, force=True)
        ckpt.wait()
        if not collectives.is_main():
            return
        meta = {"epoch": epoch, "ckpt_step": step, "best_iou": float(best_iou),
                "stale": int(stale),
                "history": {k: (list(v) if isinstance(v, list) else v)
                            for k, v in self.history.items()},
                "host_rng_state": host_rng.bit_generator.state, "elapsed_s": float(elapsed_s)}
        path = self._resume_meta_path(self.config.save_dir)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(meta, f)
        os.replace(path + ".tmp", path)

    def _load_resume_point(self, ckpt, state_template):
        """(state, meta) from the last resume point, or None."""
        path = self._resume_meta_path(self.config.save_dir)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                meta = pickle.load(f)
            state = ckpt.restore(state_template, step=meta["ckpt_step"])
        except (OSError, pickle.UnpicklingError, EOFError, KeyError, RuntimeError) as e:
            print(f"resume point unreadable ({e}); starting fresh")
            return None
        return None if state is None else (state, meta)

    # --------------------------------------------------------------- train
    def train(self, train_ds, val_ds, verbose=True, resume: bool = False):
        cfg = self.config
        loop_cfg = TrainConfig(epochs=cfg.epochs, lr=cfg.lr,
                               weight_decay=0.0,  # the reference's production Adam has none
                               batch_size=cfg.batch_size, eval_batch_size=cfg.batch_size,
                               loss="ce", plateau_on="val",
                               plateau_patience=cfg.plateau_patience, seed=cfg.seed)
        augment_fn = (make_augment_fn(image_only_geometric=cfg.image_only_geometric)
                      if cfg.augment else None)
        verbose = verbose and collectives.is_main()
        main = collectives.is_main()
        mesh, sharded = self.mesh, self.sharded_data
        train_epoch = make_train_epoch(self.model, loop_cfg, augment_fn, device=self.device,
                                       mesh=mesh, sharded_dataset=sharded)
        validate = self._make_validate()
        state = create_train_state(self.model, loop_cfg, device=self.device)
        ckpt = CheckpointManager(cfg.save_dir)
        host_rng = np.random.default_rng(cfg.seed)
        vidx, vvalid = epoch_indices(val_ds, cfg.batch_size, shuffle=False, rng=host_rng,
                                     mesh=mesh, sharded=sharded)

        def run_validate():
            if isinstance(val_ds, HostDataset):
                tot, n_tot = torch.zeros(3, device=self.device), 0.0
                for imgs, msks, lidx, v in _chunk_stream(val_ds, vidx, vvalid, self.device):
                    l, a, i, n = validate(imgs, msks, lidx, v)
                    tot += torch.stack([l, a, i]) * n
                    n_tot += float(n)
                return tuple((tot / max(n_tot, 1.0)).tolist())
            return tuple(torch.stack(validate(val_ds.images, val_ds.masks, vidx,
                                              vvalid)[:3]).tolist())

        best_iou, stale, t_start = -1.0, 0, time.time()
        start_epoch, elapsed_prior = 0, 0.0
        if resume:
            restored = self._load_resume_point(ckpt, state)
            if restored is None:
                if verbose:
                    print("no resume point found — starting fresh")
            else:
                state, meta = restored
                start_epoch = meta["epoch"] + 1
                best_iou, stale = meta["best_iou"], meta["stale"]
                elapsed_prior = meta.get("elapsed_s", 0.0)
                self.history = meta["history"]
                host_rng.bit_generator.state = meta["host_rng_state"]
                ckpt.best_iou = best_iou  # keep the best export monotone
                if verbose:
                    print(f"resumed at epoch {start_epoch + 1}/{cfg.epochs} "
                          f"(best IoU {best_iou:.4f})")
        last_epoch, last_saved, val_iou = None, start_epoch, float("nan")
        for epoch in range(start_epoch, cfg.epochs):
            idx, valid = epoch_indices(train_ds, cfg.batch_size, shuffle=True, rng=host_rng,
                                       mesh=mesh, sharded=sharded)
            state, train_loss = run_train_epoch_any(train_epoch, state, train_ds, idx, valid)
            val_loss, val_acc, val_iou = run_validate()

            self.history["train_losses"].append(train_loss)
            self.history["val_losses"].append(val_loss)
            self.history["learning_rates"].append(state.plateau.lr)
            self.history["accuracies"].append(val_acc)
            self.history["iou_scores"].append(val_iou)
            state.plateau = plateau_update(state.plateau, val_loss, cfg.plateau_patience, 0.5)

            if val_iou > best_iou:
                best_iou, stale = val_iou, 0
                self.history["best_model_epoch"] = epoch
                ckpt.maybe_save_best(epoch, state, val_iou)
            else:
                stale += 1
            if verbose:
                print(f"Epoch {epoch + 1}/{cfg.epochs}: train {train_loss:.4f} val {val_loss:.4f} "
                      f"acc {val_acc:.4f} IoU {val_iou:.4f} lr {state.plateau.lr:.2e}")
            if cfg.viz_every and (epoch + 1) % cfg.viz_every == 0:
                self._save_progress_figures(epoch, val_ds)
            last_epoch = epoch
            if cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0:
                self._save_resume_point(ckpt, epoch, state, val_iou, best_iou, stale, host_rng,
                                        elapsed_prior + (time.time() - t_start))
                last_saved = epoch + 1
            if stale >= cfg.early_stop_patience:
                if verbose:
                    print(f"early stop at epoch {epoch + 1} (patience {cfg.early_stop_patience})")
                break

        self.history["training_time"] = elapsed_prior + (time.time() - t_start)
        if main:
            os.makedirs(cfg.save_dir, exist_ok=True)
            with open(os.path.join(cfg.save_dir, "training_history.pkl"), "wb") as f:
                pickle.dump(self.history, f)
            try:
                from coastline_torch.report.trainer_viz import save_final_report

                save_final_report(self.history, cfg.save_dir)
            except Exception as e:  # a figure never fails the run
                print("final report figure failed:", e)
        self.state = state
        # the final resume point, keyed by epoch: resuming a finished run (or
        # extending it with a larger cfg.epochs) starts where this one stopped
        if last_epoch is not None and last_epoch + 1 != last_saved:
            self._save_resume_point(ckpt, last_epoch, state, val_iou, best_iou, stale, host_rng,
                                    self.history["training_time"])
        ckpt.close()
        return self.history

    def _save_progress_figures(self, epoch, val_ds):
        """Rank 0 draws; on a mesh every rank runs the forward (an
        FSDP-sharded model's forward is a collective)."""
        images = torch.as_tensor(val_ds.images[:4], device=self.device)
        with torch.inference_mode() if self.mesh is None else torch.no_grad():
            logits = self.model.eval()(normalize_images(images).permute(0, 3, 1, 2))
        if not collectives.is_main():
            return
        try:
            from coastline_torch.report.trainer_viz import (save_confusion_matrix,
                                                            save_progress_figure)

            out_dir = os.path.join(self.config.save_dir, "progress")
            save_progress_figure(self.history, epoch, out_dir)
            pred = logits.argmax(1).cpu().numpy()
            save_confusion_matrix(np.asarray(torch.as_tensor(val_ds.masks[:4]).cpu()), pred,
                                  epoch, out_dir)
        except Exception as e:  # a figure never fails the run
            print("progress figure failed:", e)

    # ----------------------------------------------------------- restoring
    def load_best(self, save_dir: Optional[str] = None):
        """The best epoch's state_dict (reference layout, CPU tensors), or None."""
        return CheckpointManager(save_dir or self.config.save_dir).restore_best()
