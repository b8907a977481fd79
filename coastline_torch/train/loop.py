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
  resident path.

Not ported yet (the comparison protocol's training slice): `Evaluator`, the
`hsv_bce` loss, train-mode Dropout2d, `log_every`, `nan_policy`, `log_path`.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from coastline_torch.data.pipeline import HostDataset, normalize01
from coastline_torch.data.pipeline import normalize_u8 as normalize_images  # the JAX loop's name
from coastline_torch.train.losses import per_image_bce, per_image_cross_entropy
from coastline_torch.train.lr import PlateauState, plateau_init
from coastline_torch.train.metrics import per_image_metrics
from coastline_torch.utils.device import resolve_device


@dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX package's `TrainConfig` that the ported epochs
    and the production trainer read, with its defaults (the comparison
    protocol, `Main_Final.py:549-553,834`). The eval epoch's batch is the
    width of the `idx` plan handed to it (`batch_indices`)."""

    epochs: int = 20
    lr: float = 1e-4
    weight_decay: float = 1e-4
    batch_size: int = 2
    eval_batch_size: int = 2
    loss: str = "bce"  # bce (sigmoid models) | ce (2-class UNet) | hsv_bce
    plateau_on: str = "train"  # train (Main_Final/Extended) | val (comne/production)
    plateau_patience: int = 5
    plateau_factor: float = 0.5
    threshold: float = 0.5
    augment: bool = False
    seed: int = 0


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
    if config.loss == "hsv_bce":
        raise NotImplementedError("the hsv_bce loss is ported with the comparison protocol's "
                                  "training slice (the next one)")
    if config.loss not in ("bce", "ce"):
        raise ValueError(f"unknown loss {config.loss!r}")


def _compute_loss(config: TrainConfig, logits, masks, valid):
    """Masked mean over the valid samples of per-image mean losses; logits
    NCHW (one channel for bce, two classes for ce), masks (N, H, W)."""
    w = valid.float()
    per_img = (per_image_cross_entropy(logits, masks) if config.loss == "ce"
               else per_image_bce(logits, masks))
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
    (`data/augment.py`) draws from `state.generator`. The losses stay on the
    device; the epoch's mean is one host copy at its end, or, with
    `per_step=True`, the (num_batches,) tensor of step losses is returned
    as it is. Raises without a card unless `device='cpu'`."""
    _check_loss(config)
    dev = resolve_device(device)
    model.to(dev)  # in place: an optimizer built over its parameters keeps them

    def train_epoch(state: TrainState, images_u8, masks, idx, valid, *, per_step: bool = False):
        images, masks, idx, valid = _as_device(images_u8, masks, idx, valid, dev)
        model.train()
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
            loss = _compute_loss(config, model(x, return_logits=True), y, bvalid)
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
    """The model on `device`, in eval mode, behind
    `eval_epoch(images_u8, masks, idx, valid) -> (loss, {'mean_*', 'std_*'})`.

    images_u8 (N, H, W, 3) uint8 and masks (N, H, W), numpy or tensors, are
    moved to the device once; idx and valid are `batch_indices`' arrays. The
    loss is the mean over batches of each batch's masked mean; every metric
    is aggregated over the valid samples only, with the population std.
    Raises without a card unless `device='cpu'`."""
    _check_loss(config)
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def eval_epoch(images_u8, masks, idx, valid) -> Tuple[float, Dict[str, float]]:
        images, masks, idx, valid = _as_device(images_u8, masks, idx, valid, dev)
        losses, metrics = [], []
        for bidx, bvalid in zip(idx, valid):
            x = normalize_images(images.index_select(0, bidx)).permute(0, 3, 1, 2)
            y = masks.index_select(0, bidx)
            logits = model(x, return_logits=True)
            losses.append(_compute_loss(config, logits, y, bvalid))
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
