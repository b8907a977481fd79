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

On a mesh (`parallel/mesh.py`; `mesh=`, one process a device) every rank
runs the same epoch plan and takes its rows of each batch
(`batch_sharding`): from the whole dataset, or with `sharded_dataset=True`
from its own shard through shard-local indices. A train step runs the model
under `DistributedDataParallel` (or FSDP with a 'model' axis) inside
`collectives.split_batch`, so BN's statistics are the whole batch's; the
augmentation and dropout draw for the whole batch and keep the rank's rows;
each rank's loss is its masked sum over the whole batch's valid count times
the rank count, so the averaged gradient is the global masked mean's. Eval
forwards run the bare model under `no_grad`, so the kernels launch; their
loss sums and per-image metrics are gathered in global order.

With a 'space' axis the ranks of a space group take the same samples, each
its rows of every image (`batch_sharding(mesh).rows_of`): the augmentation
runs on the whole images before the row cut, the forward runs inside
`collectives.split_rows`, each rank's per-image loss is its pixels' sum
over the image's pixel count (the ranks' terms add up to the image's mean
under the same `denom`), and the eval metrics' per-image pixel counts are
summed over the space group before any ratio.
"""

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from coastline_torch.data.pipeline import HostDataset, normalize01
from coastline_torch.data.pipeline import normalize_u8 as normalize_images  # the JAX loop's name
from coastline_torch.ops.blocks import set_dropout_generator
from coastline_torch.parallel import collectives
from coastline_torch.train.hsv import hsv_consistency
from coastline_torch.train.losses import per_image_bce, per_image_cross_entropy
from coastline_torch.train.lr import PlateauState, plateau_init, plateau_update
from coastline_torch.train.metrics import metrics_from_counts, per_image_counts
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


def epoch_indices(ds, batch_size: int, *, shuffle: bool, rng: np.random.Generator,
                  mesh=None, sharded: bool = False):
    """An epoch's index plan: the global wrap-padded batches of
    `batch_indices` (a replicated dataset of either residency), or with
    `sharded=True` the shard-local aligned batches of a sample-sharded
    DeviceDataset (`parallel.mesh.sharded_epoch_indices`)."""
    if not sharded:
        return batch_indices(len(ds), batch_size, shuffle=shuffle, rng=rng)
    if isinstance(ds, HostDataset):
        raise ValueError(
            "sharded data requires device-resident sharded datasets "
            "(parallel.mesh.shard_device_dataset); HostDataset chunked "
            "uploads already bound per-chip HBM — use one or the other")
    from coastline_torch.parallel.mesh import sharded_epoch_indices

    return sharded_epoch_indices(mesh, ds, batch_size, shuffle=shuffle, rng=rng)


def _check_loss(config: TrainConfig):
    if config.loss not in ("bce", "ce", "hsv_bce"):
        raise ValueError(f"unknown loss {config.loss!r}")


def _per_image_loss(config: TrainConfig, logits, masks, rgb01=None, count=None):
    """(N,) per-image mean losses; logits NCHW (one channel for bce, two
    classes for ce), masks (N, H, W). With `hsv_bce` and `rgb01` (N, H, W,
    3) in [0, 1], each image's BCE gains `hsv_weight` times its HSV
    consistency (`loop.py:112-135`). With `count` (a rank's rows of images
    of `count` pixels) each term is the sum over the rank's pixels / count."""
    if config.loss == "ce":
        return per_image_cross_entropy(logits, masks, count)
    per_img = per_image_bce(logits, masks, count)
    if config.loss == "hsv_bce" and rgb01 is not None:
        probs = torch.sigmoid(logits.float()[:, 0] if logits.ndim == 4 else logits.float())
        per_img = per_img + config.hsv_weight * hsv_consistency(probs, rgb01, axes=(1, 2),
                                                                count=count)
    return per_img


def _compute_loss(config: TrainConfig, logits, masks, valid, rgb01=None, denom=None,
                  count=None):
    """Masked mean over the valid samples of `_per_image_loss`: the masked
    sum over `denom`, by default the valid count (at least 1)."""
    w = valid.float()
    if denom is None:
        denom = w.sum().clamp_min(1.0)
    return (_per_image_loss(config, logits, masks, rgb01, count) * w).sum() / denom


def _probs(config: TrainConfig, logits):
    if config.loss == "ce":
        return torch.softmax(logits, dim=1)[:, 1]
    return torch.sigmoid(logits[:, 0] if logits.ndim == 4 else logits)


def _as_device(images_u8, masks, idx, valid, dev):
    return (torch.as_tensor(images_u8, device=dev), torch.as_tensor(masks, device=dev),
            torch.as_tensor(np.asarray(idx), dtype=torch.long, device=dev),
            torch.as_tensor(np.asarray(valid), dtype=torch.float32, device=dev))


class _Split:
    """This rank's share of the batches of a mesh run: its samples of a
    batch of `b` (`rows(b)`) and, with a space axis, its rows of each image
    (`cut`, run the forward inside `rows_ctx`), the rank count and the group
    the batch splits over, and `net`, the model as the train step calls it:
    DDP over the group, or with a 'model' axis the model itself,
    FSDP-sharded in place. No model of the registry leaves a parameter
    unused in a train step, so DDP runs without `find_unused_parameters`."""

    def __init__(self, mesh, model, dev, train: bool):
        from coastline_torch.parallel import mesh as pmesh

        self.share = pmesh.batch_sharding(mesh)
        self.world = mesh.size()
        self.group = torch.distributed.group.WORLD  # a mesh spans every rank of it
        self.space_group = pmesh.space_group(mesh)
        self.whole_group = pmesh.whole_group(mesh)
        # the ranks holding the samples in order, one of each space group
        m, s, flat = pmesh.model_axis_size(mesh), pmesh.space_axis_size(mesh), \
            mesh.mesh.flatten().tolist()
        self.sample_ranks = [flat[p] for p in sorted(
            (p for p in range(len(flat)) if (p // m) % s == 0),
            key=lambda p: (p // (s * m)) * m + p % m)]
        self.net = model
        if train and pmesh.model_axis_size(mesh) > 1:
            self.net = pmesh.state_sharding(mesh, model)
        elif train:
            from torch.nn.parallel import DistributedDataParallel

            self.net = DistributedDataParallel(
                model, device_ids=[dev.index] if dev.type == "cuda" else None,
                process_group=self.group)

    def rows(self, b: int) -> slice:
        return self.share.of(b)

    def cut(self, t, dim: int):
        """This rank's rows of the images in `t` (their rows along `dim`)."""
        if self.space_group is None:
            return t
        rows = self.share.rows_of(t.shape[dim])
        return t.narrow(dim, rows.start, rows.stop - rows.start)

    def rows_ctx(self, height: int, width: int):
        """`collectives.split_rows` over the space group for images of
        `height` x `width`; nothing without a space axis."""
        if self.space_group is None:
            return contextlib.nullcontext()
        return collectives.split_rows(self.space_group, height, width, self.whole_group)

    def counts_over_space(self, counts):
        """Per-image pixel counts summed over the space group."""
        if self.space_group is None:
            return counts
        return collectives.all_reduce_sum(counts, self.space_group)


def _split(mesh, model, dev, sharded_dataset: bool, train: bool):
    if sharded_dataset and mesh is None:
        raise ValueError("sharded_dataset=True requires a mesh")
    return None if mesh is None else _Split(mesh, model, dev, train)


def make_train_epoch(model, config: TrainConfig, augment_fn: Optional[Callable] = None,
                     device="cuda", *, mesh=None, sharded_dataset: bool = False):
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
    as it is. Raises without a card unless `device='cpu'`.

    With `mesh` the step runs this rank's rows of every batch (the module
    docstring); `sharded_dataset=True` (requires `mesh`) takes a
    `shard_device_dataset` shard and its shard-local plan. The reported
    losses are the global batch's. With a 'model' axis the model is sharded
    in place here, so make the train state's optimizer after this call."""
    _check_loss(config)
    dev = resolve_device(device)
    model.to(dev)  # in place: an optimizer built over its parameters keeps them
    split = _split(mesh, model, dev, sharded_dataset, train=True)
    net = model if split is None else split.net

    def train_epoch(state: TrainState, images_u8, masks, idx, valid, *, per_step: bool = False):
        images, masks, idx, valid = _as_device(images_u8, masks, idx, valid, dev)
        model.train()
        b = idx.shape[1]
        rows = None if split is None else split.rows(b)
        set_dropout_generator(model, state.generator, None if rows is None else (rows.start, b))
        opt = state.optimizer
        for group in opt.param_groups:
            group["lr"] = state.plateau.lr
        losses = []
        for bidx, bvalid in zip(idx, valid):
            denom = None
            if rows is not None:  # the global masked mean's share: sum_r (num_r / denom) = W * loss
                denom = bvalid.sum().clamp_min(1.0) / split.world
                bidx, bvalid = bidx[rows], bvalid[rows]
            x01 = images.index_select(0, bidx).float() / 255.0
            y = masks.index_select(0, bidx)
            if augment_fn is not None:
                x01, y = (augment_fn(state.generator, x01, y) if rows is None else
                          augment_fn(state.generator, x01, y, rows=(rows.start, b)))
            height, width, count = x01.shape[1], x01.shape[2], None
            if split is not None and split.space_group is not None:  # whole images, then rows
                x01, y, count = split.cut(x01, 1), split.cut(y, 1), height * width
            x = normalize01(x01).permute(0, 3, 1, 2)
            opt.zero_grad(set_to_none=True)
            with contextlib.ExitStack() as scope:
                if split is not None:
                    scope.enter_context(collectives.split_batch(split.group))
                    scope.enter_context(split.rows_ctx(height, width))
                loss = _compute_loss(config, net(x, return_logits=True), y, bvalid, x01, denom,
                                     count)
                loss.backward()
            opt.step()
            state.step += 1
            losses.append(loss.detach() if denom is None else loss.detach() * denom)
        losses = torch.stack(losses)
        if split is not None:  # the masked sums of all ranks over each batch's valid count
            losses = (collectives.all_reduce_sum(losses, split.group)
                      / valid.sum(1).clamp_min(1.0))
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


def make_eval_epoch(model, config: TrainConfig, device="cuda", *, mesh=None,
                    sharded_dataset: bool = False):
    """The model on `device` behind
    `eval_epoch(images_u8, masks, idx, valid) -> (loss, {'mean_*', 'std_*'})`,
    which runs it in eval mode.

    images_u8 (N, H, W, 3) uint8 and masks (N, H, W), numpy or tensors, are
    moved to the device once; idx and valid are `batch_indices`' arrays. The
    loss is the mean over batches of each batch's masked mean (`hsv_bce`
    sees `x_u8 / 255`, `loop.py:248-249`); every metric is aggregated over
    the valid samples only, with the population std. Raises without a card
    unless `device='cpu'`. With `mesh` each rank runs its rows of every
    batch under `no_grad`; the loss sums are all-reduced and the per-image
    metrics gathered in global order before the aggregation, which every
    rank then takes alike."""
    _check_loss(config)
    dev = resolve_device(device)
    model = model.to(dev)
    split = _split(mesh, model, dev, sharded_dataset, train=False)

    def eval_epoch(images_u8, masks, idx, valid) -> Tuple[float, Dict[str, float]]:
        with torch.inference_mode() if split is None else torch.no_grad():
            return _eval(images_u8, masks, idx, valid)

    def _eval(images_u8, masks, idx, valid):
        images, masks, idx, valid = _as_device(images_u8, masks, idx, valid, dev)
        model.eval()
        rows = None if split is None else split.rows(idx.shape[1])
        losses, metrics = [], []
        height, width = images.shape[1], images.shape[2]
        count = None if split is None or split.space_group is None else height * width
        for bidx, bvalid in zip(idx, valid):
            if rows is not None:
                bidx, bvalid = bidx[rows], bvalid[rows]
            x_u8 = images.index_select(0, bidx)
            y = masks.index_select(0, bidx)
            if count is not None:
                x_u8, y = split.cut(x_u8, 1), split.cut(y, 1)
            x = normalize_images(x_u8).permute(0, 3, 1, 2)
            with contextlib.nullcontext() if split is None else split.rows_ctx(height, width):
                logits = model(x, return_logits=True)
            rgb01 = x_u8.float() / 255.0
            losses.append(_compute_loss(config, logits, y, bvalid, rgb01) if rows is None else
                          (_per_image_loss(config, logits, y, rgb01, count) * bvalid).sum())
            counts = per_image_counts(_probs(config, logits), y.float(), config.threshold)
            metrics.append(counts if split is None else split.counts_over_space(counts))
        losses = torch.stack(losses)
        if rows is not None:
            losses = (collectives.all_reduce_sum(losses, split.group)
                      / valid.sum(1).clamp_min(1.0))
            local = torch.stack(metrics)  # (batches, rows, 4)
            every = collectives.gather(local, split.group)[split.sample_ranks]
            metrics = [every.transpose(0, 1).reshape(-1, local.shape[-1])]
        metrics = [metrics_from_counts(c) for c in metrics]
        v = valid.reshape(-1)
        n = v.sum().clamp_min(1.0)
        agg = {}
        for key in metrics[0]:
            vals = torch.cat([m[key] for m in metrics])
            mean = (vals * v).sum() / n
            agg[f"mean_{key}"] = mean
            agg[f"std_{key}"] = torch.sqrt((((vals - mean) ** 2) * v).sum() / n)
        out = torch.stack([losses.mean(), *agg.values()]).cpu().tolist()
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
    unless `device='cpu'`.

    With `mesh` (on every rank of it, `device` the rank's) the epochs split
    each batch over the ranks; `sharded_data=True` (requires `mesh`) takes
    sample-sharded DeviceDatasets (`parallel.mesh.shard_device_dataset`),
    each rank reading only its own shard. Rank 0 alone logs and prints."""

    def __init__(self, model, config: TrainConfig, augment_fn=None, device="cuda", mesh=None,
                 sharded_data: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.mesh, self.sharded_data = mesh, sharded_data
        self._train_epoch = make_train_epoch(self.model, config, augment_fn, self.device,
                                             mesh=mesh, sharded_dataset=sharded_data)
        self._eval_epoch = make_eval_epoch(self.model, config, self.device, mesh=mesh,
                                           sharded_dataset=sharded_data)
        self._log = JsonlLogger((config.log_path or None) if collectives.is_main() else None)
        self.state: Optional[TrainState] = None

    def _epoch_indices(self, ds, batch_size: int, *, shuffle: bool, rng):
        return epoch_indices(ds, batch_size, shuffle=shuffle, rng=rng, mesh=self.mesh,
                             sharded=self.sharded_data)

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
        verbose = verbose and collectives.is_main()
        if init_variables is not None:
            load_full_state_dict(self.model, init_variables)
        state = create_train_state(self.model, cfg, device=self.device)
        host_rng = np.random.default_rng(cfg.seed)
        history = {k: [] for k in ("train_loss", "val_loss", "val_iou", "val_f1", "val_accuracy")}
        best_iou = 0.0
        vidx, vvalid = self._epoch_indices(val_ds, cfg.eval_batch_size, shuffle=False,
                                           rng=host_rng)
        for epoch in range(cfg.epochs):
            idx, valid = self._epoch_indices(train_ds, cfg.batch_size, shuffle=True,
                                             rng=host_rng)
            state, train_loss = self._run_train_epoch(state, train_ds, idx, valid)
            val_loss, agg = self._run_eval_epoch(val_ds, vidx, vvalid)
            val_iou = float(agg["mean_iou"])
            if not (math.isfinite(train_loss) and math.isfinite(val_loss)):
                msg = f"non-finite loss at epoch {epoch} (train={train_loss}, val={val_loss})"
                self._log.log(event="nan", epoch=epoch, train_loss=train_loss)
                if cfg.nan_policy == "halt":
                    if verbose:
                        print(f"HALT: {msg} — stopping (nan_policy=halt); "
                              f"history up to here is returned")
                    break
                if verbose:
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
        batch, 10 at the throughput batch, the faster of 2 trials.

        On a mesh every rank times its own forwards at once and the slowest
        rank's time counts: the protocol batch (the first images of the
        rank's data) whole on each rank, the throughput batch split, its
        ceil(throughput_batch / ranks) rows a rank (so the batch rounds up
        to a multiple of the rank count), gathered from the rank's own
        shard under `sharded_data`, never from another rank's."""
        cfg = self.config
        state = state or self.state
        model = state.model.eval()
        idx, valid = self._epoch_indices(test_ds, cfg.eval_batch_size, shuffle=False,
                                         rng=np.random.default_rng(0))
        images = test_ds.images
        n_local = len(test_ds)
        if self.mesh is not None and self.sharded_data:  # rows of this rank's shard
            n_local = max(1, min(int(images.shape[0]), len(test_ds)))

        def batch_of(rows):  # images at `rows`, wrapping around the (local) data
            rows = np.asarray(rows) % n_local
            x_u8 = (torch.from_numpy(images[rows]) if isinstance(images, np.ndarray)
                    else images.index_select(0, torch.as_tensor(rows, device=images.device)))
            return normalize_images(x_u8.to(self.device)).permute(0, 3, 1, 2)

        inference = torch.inference_mode if self.mesh is None else torch.no_grad
        split = _split(self.mesh, model, self.device, self.sharded_data, train=False)

        def forward(x, size):
            with contextlib.nullcontext() if split is None else split.rows_ctx(*size):
                return model(x)

        def seconds(x, n_loop):
            size = x.shape[2:]
            if split is not None:
                x = split.cut(x, 2)
            with inference():
                sec = loop_seconds(lambda: forward(x, size), self.device, n_loop=n_loop)
            if self.mesh is not None:
                sec = float(collectives.all_reduce_max(torch.tensor([sec], device=self.device)))
            return sec

        x0 = batch_of(np.arange(min(cfg.eval_batch_size, len(test_ds))))
        per_image_time = seconds(x0, 20) / x0.shape[0]
        throughput_ips = None
        if throughput_batch and throughput_batch > 0:
            if self.mesh is None:
                xb = batch_of(np.arange(throughput_batch))
            else:
                from coastline_torch.parallel.mesh import batch_sharding

                share = batch_sharding(self.mesh)  # the space ranks of a sample share it
                per = -(-throughput_batch // share.count)  # ceil: keep >= requested
                throughput_batch = per * share.count
                first = 0 if self.sharded_data else share.index * per
                xb = batch_of(first + np.arange(per))
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


def load_full_state_dict(model: torch.nn.Module, state_dict):
    """Load a full (unsharded) state_dict into `model`, strictly: directly,
    or into an FSDP-sharded model through
    `torch.distributed.checkpoint.state_dict.set_model_state_dict`, which
    keeps each rank's shard."""
    from coastline_torch.parallel.mesh import is_sharded

    if not is_sharded(model):
        model.load_state_dict(state_dict, strict=True)
        return
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_model_state_dict

    set_model_state_dict(model, dict(state_dict),
                         options=StateDictOptions(full_state_dict=True, strict=True))
