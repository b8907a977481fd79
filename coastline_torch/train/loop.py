"""The train and evaluation epochs (counterpart of `coastline/train/loop.py:
44-135,167-372`).

The JAX package runs an epoch as one jitted `lax.scan` over gather-indexed,
fixed-shape batches of a dataset held on the device as uint8. Here the
model carries its weights, the batches run eagerly on the device, and each
epoch makes one device-to-host copy at its end:

- `make_train_epoch`: gather -> /255 -> augment -> normalize -> forward in
  train mode (batch-statistics BN, no fused kernel) -> the validity-masked
  loss -> backward -> Adam with coupled L2 (`torch.optim.Adam(weight_decay=)`,
  which equals `optax.add_decayed_weights` -> `scale_by_adam`) at the
  plateau's learning rate;
- `make_eval_epoch`: the comparison protocol's validation pass, the eval
  forward, the masked loss and per-image metrics aggregated as a
  validity-masked mean and population std;
- `run_train_epoch_any` runs a train epoch over a `HostDataset` chunk by
  chunk (`_chunk_stream`) with the same batches in the same order as the
  resident path;
- `Evaluator` (`loop.py:375-602`): the comparison protocol's
  `train_model` (epochs, validation, plateau, `nan_policy`, JSONL log) and
  `evaluate_model` (protocol metrics and forward timing).

Randomness: the train state's device generator draws the augmentation and
then, in forward order, the Robust U-Net's Dropout2d masks. The streams
differ from JAX's by design.
"""

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from coastline_torch.data.pipeline import HostDataset, normalize01
from coastline_torch.data.pipeline import normalize_u8 as normalize_images  # the JAX loop's name
from coastline_torch.ops.blocks import set_dropout_generator
from coastline_torch.train.hsv import hsv_consistency
from coastline_torch.train.losses import per_image_bce, per_image_cross_entropy
from coastline_torch.train.lr import PlateauState, plateau_init, plateau_update
from coastline_torch.train.metrics import per_image_metrics
from coastline_torch.utils.device import resolve_device
from coastline_torch.utils.metrics_log import JsonlLogger
from coastline_torch.utils.profiling import loop_seconds


@dataclass(frozen=True)
class TrainConfig:
    """The JAX package's `TrainConfig` with its defaults (the comparison
    protocol, `Main_Final.py:549-553,834`). The eval epoch's batch is the
    width of the `idx` plan handed to it (`batch_indices`)."""

    epochs: int = 20
    lr: float = 1e-4
    weight_decay: float = 1e-4
    batch_size: int = 2
    eval_batch_size: int = 2
    loss: str = "bce"  # bce (sigmoid models) | ce (2-class UNet) | hsv_bce
    hsv_weight: float = 0.1  # weight of the HSV-consistency term (hsv_bce)
    plateau_on: str = "train"  # train (Main_Final/Extended) | val (comne/production)
    plateau_patience: int = 5
    plateau_factor: float = 0.5
    threshold: float = 0.5
    augment: bool = False
    log_every: int = 5
    seed: int = 0
    nan_policy: str = "halt"  # halt | warn on a non-finite epoch loss
    log_path: str = ""  # optional JSONL metrics stream


@dataclass
class TrainState:
    """What a train epoch carries from step to step: the model (parameters
    and BN statistics), the Adam state, the plateau schedule, the step count
    and the device generator that draws the augmentation."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    plateau: PlateauState
    step: int
    generator: torch.Generator


def make_optimizer(params, weight_decay: float, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam(0.9, 0.999, eps 1e-8) with coupled L2: the decay is added to the
    gradient before the moments, as `optax.add_decayed_weights` ->
    `scale_by_adam` does. The trainer writes the plateau's lr into
    `param_groups` before each epoch."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def create_train_state(model, config: TrainConfig, device="cuda") -> TrainState:
    """The model moved to `device` with fresh Adam moments, the plateau at
    `config.lr`, step 0 and a device generator seeded with `config.seed`.
    Raises without a card unless `device='cpu'`."""
    dev = resolve_device(device)
    model = model.to(dev)
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), config.weight_decay, config.lr),
                      plateau=plateau_init(config.lr), step=0,
                      generator=torch.Generator(device=dev).manual_seed(config.seed))


def batch_indices(n: int, batch_size: int, *, shuffle: bool, rng: np.random.Generator):
    """Fixed-shape (num_batches, B) index and validity arrays covering all n
    samples; the last batch is padded wrap-around with the first samples of
    the order, marked invalid (the JAX package's rule, `loop.py:278-299`):
    the padding that enters train-mode BN statistics is then real images."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    num_batches = (n + batch_size - 1) // batch_size
    total = num_batches * batch_size
    padded = order[np.arange(total) % n].astype(np.int32)
    valid = np.zeros(total, dtype=np.float32)
    valid[:n] = 1.0
    return padded.reshape(num_batches, batch_size), valid.reshape(num_batches, batch_size)


def epoch_indices(ds, batch_size: int, *, shuffle: bool, rng: np.random.Generator):
    """An epoch's index plan over a dataset of either residency (one device:
    the global wrap-padded batches of `batch_indices`)."""
    return batch_indices(len(ds), batch_size, shuffle=shuffle, rng=rng)


def _check_loss(config: TrainConfig):
    if config.loss not in ("bce", "ce", "hsv_bce"):
        raise ValueError(f"unknown loss {config.loss!r}")


def _compute_loss(config: TrainConfig, logits, masks, valid, rgb01=None):
    """Masked mean over the valid samples of per-image mean losses; logits
    NCHW (one channel for bce, two classes for ce), masks (N, H, W). With
    `hsv_bce` and `rgb01` (N, H, W, 3) in [0, 1], each image's BCE gains
    `hsv_weight` times its HSV consistency (`loop.py:112-135`)."""
    w = valid.float()
    if config.loss == "ce":
        per_img = per_image_cross_entropy(logits, masks)
    else:
        per_img = per_image_bce(logits, masks)
        if config.loss == "hsv_bce" and rgb01 is not None:
            probs = torch.sigmoid(logits.float()[:, 0] if logits.ndim == 4 else logits.float())
            per_img = per_img + config.hsv_weight * hsv_consistency(probs, rgb01, axes=(1, 2))
    return (per_img * w).sum() / w.sum().clamp_min(1.0)


def _probs(config: TrainConfig, logits):
    if config.loss == "ce":
        return torch.softmax(logits, dim=1)[:, 1]
    return torch.sigmoid(logits[:, 0] if logits.ndim == 4 else logits)


def _as_device(images_u8, masks, idx, valid, dev):
    return (torch.as_tensor(images_u8, device=dev), torch.as_tensor(masks, device=dev),
            torch.as_tensor(np.asarray(idx), dtype=torch.long, device=dev),
            torch.as_tensor(np.asarray(valid), dtype=torch.float32, device=dev))


def make_train_epoch(model, config: TrainConfig, augment_fn: Optional[Callable] = None,
                     device="cuda"):
    """`train_epoch(state, images_u8, masks, idx, valid) -> (state, mean loss)`
    for `model` on `device`.

    images_u8 (N, H, W, 3) uint8 and masks (N, H, W), numpy or tensors, go
    to the device once; idx and valid are `batch_indices`' arrays. Each batch
    is one Adam step of the masked loss; `augment_fn(generator, x01, masks)`
    (`data/augment.py`) draws from `state.generator`, and so, after it, do
    the model's Dropout2d masks. `hsv_bce` sees the augmented `x01`, before
    normalization (`loop.py:186-204`). The losses stay on the
    device; the epoch's mean is one host copy at its end, or, with
    `per_step=True`, the (num_batches,) tensor of step losses is returned
    as it is. Raises without a card unless `device='cpu'`."""
    _check_loss(config)
    dev = resolve_device(device)
    model.to(dev)  # in place: an optimizer built over its parameters keeps them

    def train_epoch(state: TrainState, images_u8, masks, idx, valid, *, per_step: bool = False):
        images, masks, idx, valid = _as_device(images_u8, masks, idx, valid, dev)
        model.train()
        set_dropout_generator(model, state.generator)
        opt = state.optimizer
        for group in opt.param_groups:
            group["lr"] = state.plateau.lr
        losses = []
        for bidx, bvalid in zip(idx, valid):
            x01 = images.index_select(0, bidx).float() / 255.0
            y = masks.index_select(0, bidx)
            if augment_fn is not None:
                x01, y = augment_fn(state.generator, x01, y)
            x = normalize01(x01).permute(0, 3, 1, 2)
            opt.zero_grad(set_to_none=True)
            loss = _compute_loss(config, model(x, return_logits=True), y, bvalid, x01)
            loss.backward()
            opt.step()
            state.step += 1
            losses.append(loss.detach())
        losses = torch.stack(losses)
        return state, (losses if per_step else float(losses.mean()))

    return train_epoch


def _chunk_stream(ds: HostDataset, idx: np.ndarray, valid: np.ndarray, device):
    """Device chunks of a host-resident dataset: each covers `ds.superbatch`
    consecutive batches of the epoch's plan, gathered on the host into pinned
    memory (on a card), uploaded without blocking, with the batch indices
    remapped to positions inside the chunk, so the train epoch runs unchanged
    on it and every batch equals the resident path's. A generator: the next
    chunk is gathered while the card works on the current one.

    Yields (images, masks, local idx, valid)."""
    dev = torch.device(device)
    pin = dev.type == "cuda"

    def put(a):
        t = torch.from_numpy(a)
        return (t.pin_memory() if pin else t).to(dev, non_blocking=pin)

    for j0 in range(0, idx.shape[0], ds.superbatch):
        j1 = min(j0 + ds.superbatch, idx.shape[0])
        flat = np.asarray(idx[j0:j1]).reshape(-1)
        lidx = np.arange(flat.size, dtype=np.int32).reshape(j1 - j0, -1)
        yield put(ds.images[flat]), put(ds.masks[flat]), lidx, valid[j0:j1]


def run_train_epoch_any(train_epoch_fn, state: TrainState, ds, idx, valid):
    """One train epoch over a DeviceDataset or a HostDataset: the host one
    runs `train_epoch_fn` per uploaded chunk, the state threading through, so
    every update equals the resident path's; the loss is the mean over all
    steps either way."""
    if not isinstance(ds, HostDataset):
        return train_epoch_fn(state, ds.images, ds.masks, idx, valid)
    dev = state.generator.device
    losses = []
    for imgs, msks, lidx, v in _chunk_stream(ds, idx, valid, dev):
        state, step_losses = train_epoch_fn(state, imgs, msks, lidx, v, per_step=True)
        losses.append(step_losses)
    return state, float(torch.cat(losses).mean())


def make_eval_epoch(model, config: TrainConfig, device="cuda"):
    """The model on `device` behind
    `eval_epoch(images_u8, masks, idx, valid) -> (loss, {'mean_*', 'std_*'})`,
    which runs it in eval mode.

    images_u8 (N, H, W, 3) uint8 and masks (N, H, W), numpy or tensors, are
    moved to the device once; idx and valid are `batch_indices`' arrays. The
    loss is the mean over batches of each batch's masked mean (`hsv_bce`
    sees `x_u8 / 255`, `loop.py:248-249`); every metric is aggregated over
    the valid samples only, with the population std. Raises without a card
    unless `device='cpu'`."""
    _check_loss(config)
    dev = resolve_device(device)
    model = model.to(dev)

    @torch.inference_mode()
    def eval_epoch(images_u8, masks, idx, valid) -> Tuple[float, Dict[str, float]]:
        images, masks, idx, valid = _as_device(images_u8, masks, idx, valid, dev)
        model.eval()
        losses, metrics = [], []
        for bidx, bvalid in zip(idx, valid):
            x_u8 = images.index_select(0, bidx)
            x = normalize_images(x_u8).permute(0, 3, 1, 2)
            y = masks.index_select(0, bidx)
            logits = model(x, return_logits=True)
            losses.append(_compute_loss(config, logits, y, bvalid, x_u8.float() / 255.0))
            metrics.append(per_image_metrics(_probs(config, logits), y.float(), config.threshold))
        v = valid.reshape(-1)
        n = v.sum().clamp_min(1.0)
        agg = {}
        for key in metrics[0]:
            vals = torch.cat([m[key] for m in metrics])
            mean = (vals * v).sum() / n
            agg[f"mean_{key}"] = mean
            agg[f"std_{key}"] = torch.sqrt((((vals - mean) ** 2) * v).sum() / n)
        out = torch.stack([torch.stack(losses).mean(), *agg.values()]).cpu().tolist()
        return out[0], dict(zip(agg, out[1:]))

    return eval_epoch


class Evaluator:
    """The comparison protocol's train and evaluate harness on one device
    (the reference's `ModelEvaluator`, `Main_Final.py:513-668`; the JAX
    package's `Evaluator`, `coastline/train/loop.py:375-602`).

    `train_model(...) -> {'best_iou', 'history'}` with the history keys
    train_loss, val_loss, val_iou, val_f1 and val_accuracy;
    `evaluate_model(...) -> {'mean_*', 'std_*', 'avg_inference_time',
    'inference_batch_size', 'total_samples'}`, plus
    `throughput_images_per_sec` and `throughput_batch_size` when asked.
    Datasets are `DeviceDataset`s or `HostDataset`s. Raises without a card
    unless `device='cpu'`."""

    def __init__(self, model, config: TrainConfig, augment_fn=None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self._train_epoch = make_train_epoch(self.model, config, augment_fn, self.device)
        self._eval_epoch = make_eval_epoch(self.model, config, self.device)
        self._log = JsonlLogger(config.log_path or None)
        self.state: Optional[TrainState] = None

    def _run_train_epoch(self, state, ds, idx, valid):
        return run_train_epoch_any(self._train_epoch, state, ds, idx, valid)

    def _run_eval_epoch(self, ds, idx, valid):
        """Validation on either residency. A HostDataset's chunks combine
        exactly through their sufficient statistics (n, mean, E[x^2]),
        `loop.py:409-439`."""
        if not isinstance(ds, HostDataset):
            return self._eval_epoch(ds.images, ds.masks, idx, valid)
        s1, s2 = {}, {}
        n_tot, loss_num, nb = 0.0, 0.0, 0
        for imgs, msks, lidx, v in _chunk_stream(ds, idx, valid, self.device):
            loss, agg = self._eval_epoch(imgs, msks, lidx, v)
            cnt, nv = lidx.shape[0], float(np.asarray(v).sum())
            loss_num += loss * cnt
            nb += cnt
            for k, m in agg.items():
                if k.startswith("mean_"):
                    base = k[5:]
                    sd = agg[f"std_{base}"]
                    s1[base] = s1.get(base, 0.0) + m * nv
                    s2[base] = s2.get(base, 0.0) + (sd * sd + m * m) * nv
            n_tot += nv
        n = max(n_tot, 1.0)
        agg = {}
        for base in s1:
            m = s1[base] / n
            agg[f"mean_{base}"] = m
            agg[f"std_{base}"] = math.sqrt(max(s2[base] / n - m * m, 0.0))
        return loss_num / nb, agg

    def train_model(self, train_ds, val_ds, verbose=True, init_variables=None):
        """`config.epochs` epochs of Adam over shuffled batches, each followed
        by a validation pass and a plateau step on the train or val loss.
        `init_variables`, a state_dict of the model (from JAX variables, the
        port's bridge `utils/torch_import.py`), replaces the random init:
        Adam's moments start at zero either way. A non-finite epoch loss is
        logged and, under `nan_policy='halt'`, ends the run before that
        epoch is recorded."""
        cfg = self.config
        if init_variables is not None:
            self.model.load_state_dict(init_variables, strict=True)
        state = create_train_state(self.model, cfg, device=self.device)
        host_rng = np.random.default_rng(cfg.seed)
        history = {k: [] for k in ("train_loss", "val_loss", "val_iou", "val_f1", "val_accuracy")}
        best_iou = 0.0
        vidx, vvalid = epoch_indices(val_ds, cfg.eval_batch_size, shuffle=False, rng=host_rng)
        for epoch in range(cfg.epochs):
            idx, valid = epoch_indices(train_ds, cfg.batch_size, shuffle=True, rng=host_rng)
            state, train_loss = self._run_train_epoch(state, train_ds, idx, valid)
            val_loss, agg = self._run_eval_epoch(val_ds, vidx, vvalid)
            val_iou = float(agg["mean_iou"])
            if not (math.isfinite(train_loss) and math.isfinite(val_loss)):
                msg = f"non-finite loss at epoch {epoch} (train={train_loss}, val={val_loss})"
                self._log.log(event="nan", epoch=epoch, train_loss=train_loss)
                if cfg.nan_policy == "halt":
                    print(f"HALT: {msg} — stopping (nan_policy=halt); "
                          f"history up to here is returned")
                    break
                print(f"WARNING: {msg}")
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["val_iou"].append(val_iou)
            history["val_f1"].append(float(agg["mean_f1_score"]))
            history["val_accuracy"].append(float(agg["mean_accuracy"]))
            metric = train_loss if cfg.plateau_on == "train" else val_loss
            state.plateau = plateau_update(state.plateau, metric, cfg.plateau_patience,
                                           cfg.plateau_factor)
            best_iou = max(best_iou, val_iou)
            self._log.log(event="epoch", epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                          val_iou=val_iou, lr=float(state.plateau.lr))
            if verbose and epoch % cfg.log_every == 0:
                print(f"Epoch {epoch:2d}: Train Loss: {train_loss:.4f}, "
                      f"Val Loss: {val_loss:.4f}, IoU: {val_iou:.4f}, "
                      f"F1: {history['val_f1'][-1]:.4f}")
        self.state = state
        return {"best_iou": best_iou, "history": history}

    def evaluate_model(self, test_ds, state: Optional[TrainState] = None,
                       throughput_batch: int = 0):
        """Protocol metrics over `test_ds` and forward timing.
        `avg_inference_time` is seconds an image at the protocol batch
        (`eval_batch_size`, `Main_Final.py:644`); `throughput_batch > 0`
        also times that batch and reports `throughput_images_per_sec`. Each
        timing is `utils.profiling.loop_seconds` over back-to-back eval
        forwards under `torch.inference_mode()`: 20 a trial at the protocol
        batch, 10 at the throughput batch, the faster of 2 trials."""
        cfg = self.config
        state = state or self.state
        model = state.model.eval()
        idx, valid = epoch_indices(test_ds, cfg.eval_batch_size, shuffle=False,
                                   rng=np.random.default_rng(0))

        def batch_of(n):  # the first n images, wrapping around the dataset
            rows = np.arange(n) % len(test_ds)
            images = test_ds.images
            x_u8 = (torch.from_numpy(images[rows]) if isinstance(images, np.ndarray)
                    else images.index_select(0, torch.as_tensor(rows, device=images.device)))
            return normalize_images(x_u8.to(self.device)).permute(0, 3, 1, 2)

        def seconds(x, n_loop):
            with torch.inference_mode():
                return loop_seconds(lambda: model(x), self.device, n_loop=n_loop)

        x0 = batch_of(min(cfg.eval_batch_size, len(test_ds)))
        per_image_time = seconds(x0, 20) / x0.shape[0]
        throughput_ips = None
        if throughput_batch and throughput_batch > 0:
            xb = batch_of(throughput_batch)
            throughput_ips = throughput_batch / seconds(xb, 10)
            del xb
        _, agg = self._run_eval_epoch(test_ds, idx, valid)
        results = {k: float(v) for k, v in agg.items()}
        results["avg_inference_time"] = per_image_time
        results["inference_batch_size"] = int(x0.shape[0])
        if throughput_ips is not None:
            results["throughput_images_per_sec"] = float(throughput_ips)
            results["throughput_batch_size"] = int(throughput_batch)
        results["total_samples"] = int(len(test_ds))
        return results
