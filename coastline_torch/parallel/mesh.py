"""The device mesh on `torch.distributed` (counterpart of
`coastline/parallel/mesh.py`).

Each rank is one process on one device (`parallel/launch.py`). The mesh is
a `torch.distributed.device_mesh.DeviceMesh` over every rank of the process
group, with the JAX package's axis names:

  * `data`: the batch axis. Train steps wrap the model in
    `DistributedDataParallel`, which all-reduces the gradients;
  * `dcn`: an outer batch axis (`make_mesh(dcn=N)`); the batch splits over
    ('dcn', 'data') jointly, as in JAX;
  * `model`: the innermost axis. Every parameter and its Adam moments are
    sharded over their output channels (dim 0 of a torch weight) inside a
    model group and replicated over the data groups: FSDP2's
    `fully_shard` on the 2-D (data, model) mesh, i.e. HSDP. FSDP is data
    parallel inside its shard group, so with a model axis the global batch
    splits over all the mesh's ranks.

A batch of B rows splits over the mesh's N ranks in rank order: rank r
(its flat position in the mesh, (dcn, data, model) row-major) holds rows
[r B / N, (r + 1) B / N) (`batch_sharding`). So batch position j belongs to
data group j // (B / d) and, inside it, to the group's model index. A
sample-sharded dataset (`shard_device_dataset`) splits over the d data
groups only: each rank keeps its group's contiguous slab on its own device.

The `space` axis (image rows split over ranks with a halo exchange for
every conv, pool and resize) is not ported: `space > 1` raises.

The numpy helpers (`pad_for_sharding`, `sharded_batch_indices`,
`localize_aligned_indices`, `process_local_slab`) are the JAX package's,
line for line, and return the same arrays.
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from coastline_torch.parallel import collectives, launch


def mesh_shape(n: int, space: int = 1, dcn: int = 1, model: int = 1):
    """(dims, names) of a mesh of `n` devices; raises as `make_mesh` does,
    so a launcher can check the sizes before it starts the ranks."""
    if n % (space * dcn * model) != 0:
        raise ValueError(
            f"{n} devices not divisible by space={space} x dcn={dcn} "
            f"x model={model}")
    if space > 1:
        raise NotImplementedError(
            "space > 1 (image rows sharded over devices) is not ported: it needs a "
            "hand-written halo exchange for every conv, pool and resize (ROADMAP.md, "
            "queue 1: spatial sharding)")
    dims, names = [], []
    if dcn > 1:
        dims.append(dcn)
        names.append("dcn")
    dims.append(n // (dcn * model))
    names.append("data")
    if model > 1:
        dims.append(model)
        names.append("model")
    return tuple(dims), tuple(names)


_NO_GROUP = ("make_mesh runs on the ranks of a process group: start them with "
             "coastline_torch.parallel.launch.run(fn, n) or torchrun")


def _device_type() -> str:
    dev = launch.local_device()
    if dev is not None:
        return dev.type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, space: int = 1,
              devices: Optional[Sequence[int]] = None, dcn: int = 1, model: int = 1):
    """A ('data',) mesh over the ranks of the process group, with an outer
    'dcn' axis when dcn > 1 and an innermost 'model' axis when model > 1.
    `devices` are ranks (default: all, in order), the first `n_devices`
    of them taken. The mesh spans every rank of the group. On CUDA, a mesh
    with a model axis, or over NCCL, needs a card a rank."""
    if not dist.is_initialized() and n_devices is None:
        raise RuntimeError(_NO_GROUP)
    ranks = list(devices) if devices is not None else (
        list(range(dist.get_world_size())) if dist.is_initialized() else [])
    n = n_devices if n_devices is not None else len(ranks)
    dims, names = mesh_shape(n, space, dcn, model)
    if not dist.is_initialized():
        raise RuntimeError(_NO_GROUP)
    ranks = ranks[:n]
    world = dist.get_world_size()
    if len(ranks) != world:
        raise ValueError(f"the mesh spans every rank of the process group: {len(ranks)} "
                         f"devices asked, {world} ranks running")
    kind = _device_type()
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if n > cards and (model > 1 or dist.get_backend() == "nccl"):
            raise ValueError(
                f"a CUDA mesh of data x model = {n} ranks needs {n} cards; this machine has "
                f"{cards}" + (f" (--model-parallel {model} shards weights over cards)"
                              if model > 1 else ""))
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(kind, torch.tensor(ranks).reshape(dims), mesh_dim_names=names)


def _data_axes(mesh):
    return tuple(a for a in ("dcn", "data") if a in mesh.mesh_dim_names)


def data_axis_size(mesh) -> int:
    """Number of shards a sample-sharded dataset splits into on this mesh."""
    return int(np.prod([mesh.size(mesh.mesh_dim_names.index(a)) for a in _data_axes(mesh)]))


def model_axis_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index("model")) if "model" in names else 1


def mesh_rank(mesh) -> int:
    """This rank's flat position in the mesh (row-major over its axes)."""
    return mesh.mesh.flatten().tolist().index(dist.get_rank())


@dataclass(frozen=True)
class Rows:
    """Rank `index` of `count`'s contiguous share of a leading axis."""

    index: int
    count: int

    def of(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a batch of {n} does not split over {self.count} ranks")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh) -> Rows:
    """This rank's rows of a global batch: rank r of N holds [r B/N, (r+1) B/N)."""
    return Rows(mesh_rank(mesh), mesh.size())


def replicated(mesh) -> Rows:
    """The whole batch on every rank."""
    return Rows(0, 1)


def dataset_sharding(mesh) -> Rows:
    """This rank's data group's slab of a sample-sharded dataset."""
    return Rows(mesh_rank(mesh) // model_axis_size(mesh), data_axis_size(mesh))


def param_sharding(mesh):
    """The 2-D (replicate, shard) mesh `fully_shard` takes for the 'model'
    axis: ('data', 'model'), or ('dcn' x 'data', 'model') flattened; None
    without a model axis (every parameter replicated)."""
    if "model" not in mesh.mesh_dim_names:
        return None
    if "dcn" not in mesh.mesh_dim_names:
        return mesh
    from torch.distributed.device_mesh import DeviceMesh

    m = model_axis_size(mesh)
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(-1, m),
                      mesh_dim_names=("data", "model"))


def state_sharding(mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Place `model` for training on `mesh`, in place, before its optimizer
    is made: with a 'model' axis every parameter becomes a DTensor sharded
    over dim 0 (output channels) inside a model group, so the Adam moments
    made over it are too; BN buffers stay replicated. `fully_shard` wraps
    the root only: parents such as `ops/blocks.py::ConvStack` read their
    children's conv and BN weights in their own forward (to call the fused
    conv), which a per-module wrap would hand them sharded. Without a model
    axis the model is returned as it is (the train step wraps it in DDP)."""
    fsdp_mesh = param_sharding(mesh)
    if fsdp_mesh is None or is_sharded(model):
        return model
    from torch.distributed.fsdp import fully_shard

    fully_shard(model, mesh=fsdp_mesh)
    return model


def is_sharded(model: torch.nn.Module) -> bool:
    """Whether `model` is FSDP-sharded (`state_sharding`). Its parameters
    are DTensor shards, except between a forward without backward (an eval
    pass) and the next step, when FSDP keeps the root's unsharded."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def local_device(mesh) -> torch.device:
    """This rank's device: its current CUDA device on a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_dataset(mesh, images: np.ndarray, masks: np.ndarray):
    """This rank's data-group slab of (images, masks), global arrays whose
    leading dim divides by the data axes' size, as tensors on its device.
    (JAX assembles one global sharded array; here every rank keeps its
    contiguous block on its own device.)"""
    k = data_axis_size(mesh)
    if images.shape[0] % k:
        raise ValueError(f"dataset size {images.shape[0]} not divisible by the data-axis "
                         f"size {k}; use pad_for_sharding")
    rows = dataset_sharding(mesh).of(images.shape[0])
    return tuple(torch.from_numpy(np.ascontiguousarray(a[rows])).to(local_device(mesh))
                 for a in (images, masks))


def local_batch_gather(mesh, idx, *arrays):
    """Rows `idx` (shard-local indices, this rank's positions of an aligned
    batch) of this rank's dataset shards: a local `index_select`, no
    collective."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=arrays[0].device)
    out = tuple(a.index_select(0, idx) for a in arrays)
    return out if len(arrays) > 1 else out[0]


def pad_for_sharding(images: np.ndarray, masks: np.ndarray, n_shards: int):
    """Pad a dataset's leading dim up to a multiple of `n_shards`.

    Padding wraps the FIRST samples (real images, never zeros, so any batch
    statistics they leak into are real-image statistics). Returns
    (images, masks, n_real); `sharded_batch_indices` marks every padded
    sample invalid."""
    n = images.shape[0]
    if n == 0:
        raise ValueError("cannot shard an empty dataset")
    m = -(-n // n_shards)  # ceil
    pad = n_shards * m - n
    if pad:
        wrap = np.arange(pad) % n  # pad may exceed n (tiny datasets)
        images = np.concatenate([images, images[wrap]], axis=0)
        masks = np.concatenate([masks, masks[wrap]], axis=0)
    return images, masks, n


def process_local_slab(images: np.ndarray, masks: np.ndarray, n_shards: int):
    """This process's contiguous slab of the globally padded sample order:
    pads the GLOBAL arrays with `pad_for_sharding` and keeps rank p's
    samples [p M / P, (p + 1) M / P) of the padded order M (P the process
    group's size). Returns (local_images, local_masks, n_real_global) for
    `shard_device_dataset(..., n_valid=n_real_global)`."""
    images, masks, n_real = pad_for_sharding(
        np.asarray(images), np.asarray(masks), n_shards)
    nproc = collectives.group_size()
    m = images.shape[0]
    if m % nproc:
        raise ValueError(f"padded dataset size {m} not divisible by "
                         f"process count {nproc}")
    p = collectives.group_rank()
    lo, hi = p * m // nproc, (p + 1) * m // nproc
    return images[lo:hi], masks[lo:hi], n_real


def _pad_paths(paths, n_stored: int, n_real: int):
    """The wrap rule of `pad_for_sharding` on a list of source paths, so
    stored index i always names sample i's source."""
    paths = list(paths)[:n_real]
    return paths + [paths[i % n_real] for i in range(n_stored - len(paths))]


def shard_device_dataset(mesh, images: np.ndarray, masks: np.ndarray, paths=None, *,
                         n_valid: Optional[int] = None):
    """A sample-sharded DeviceDataset: this rank holds its data group's 1/k
    of the dataset (a contiguous block of the padded sample order) on its
    device. `len(ds)` is the real sample count (`n_valid`); the stored size
    is `ds.images.shape[0] * data_axis_size(mesh)`. Pair with
    `sharded_epoch_indices` and `make_train_epoch(..., sharded_dataset=True)`.

    Without `n_valid`, `images`/`masks` are the GLOBAL arrays (every rank
    passes the same): they are padded to divide by k. With `n_valid` (the
    GLOBAL real count), they are this process's slab of the padded global
    order (`process_local_slab`), which is its shard when the mesh has no
    model axis. `paths`, the global list of sources, is padded with the
    same wrap rule on both branches, so `ds.paths[i]` names stored sample i."""
    from coastline_torch.data.pipeline import DeviceDataset

    k = data_axis_size(mesh)
    if n_valid is None:
        images, masks, n_real = pad_for_sharding(np.asarray(images), np.asarray(masks), k)
        n_valid, n_stored = n_real, images.shape[0]
        di, dm = shard_dataset(mesh, images, masks)
    else:
        nproc = collectives.group_size()
        n_stored = images.shape[0] * nproc
        if n_stored % k:
            raise ValueError(f"global stored size {n_stored} not divisible by the "
                             f"data-axis size {k}")
        if model_axis_size(mesh) > 1:
            raise ValueError("with a model axis a rank's shard spans several processes' "
                             "slabs: pass the global arrays (n_valid=None)")
        di, dm = (torch.from_numpy(np.ascontiguousarray(a)).to(local_device(mesh))
                  for a in (images, masks))
    if paths is not None:
        paths = _pad_paths(paths, n_stored, n_valid)
    return DeviceDataset(di, dm, paths, n_valid=n_valid)


def sharded_batch_indices(n_real: int, n_stored: int, batch_size: int,
                          n_shards: int, *, shuffle: bool,
                          rng: np.random.Generator):
    """Shard-aligned epoch indices: (num_batches, B) GLOBAL indices and a
    validity mask, such that batch position j always reads from shard
    j // (B / n_shards), the alignment `local_batch_gather` requires. Each
    shard's real samples are permuted independently and dealt B/n_shards a
    batch (torch DistributedSampler semantics); every real sample appears
    exactly once valid an epoch; shard-tail padding wraps the shard's own
    order and is masked invalid, as are `pad_for_sharding`'s duplicates."""
    if batch_size % n_shards:
        raise ValueError(
            f"batch_size={batch_size} must divide by the data-axis size "
            f"{n_shards} for sample-sharded training")
    if n_stored % n_shards:
        raise ValueError(f"stored dataset size {n_stored} not divisible by "
                         f"{n_shards}; use pad_for_sharding")
    m = n_stored // n_shards  # shard size
    per = batch_size // n_shards
    real = [int(np.clip(n_real - s * m, 0, m)) for s in range(n_shards)]
    if max(real) == 0:
        raise ValueError("dataset has no real samples")
    num_batches = -(-max(real) // per)
    total = num_batches * per
    cols_idx, cols_valid = [], []
    for s in range(n_shards):
        r = real[s]
        if r == 0:  # shard holds only padding: emit index 0, all invalid
            order = np.zeros(total, dtype=np.int64)
        else:
            order = rng.permutation(r) if shuffle else np.arange(r)
            order = order[np.arange(total) % r]
        cols_idx.append((order + s * m).reshape(num_batches, per))
        v = (np.arange(total) < r).astype(np.float32)
        cols_valid.append(v.reshape(num_batches, per))
    return (
        np.concatenate(cols_idx, axis=1).astype(np.int32),
        np.concatenate(cols_valid, axis=1),
    )


def sharded_epoch_indices(mesh, ds, batch_size: int, *, shuffle: bool,
                          rng: np.random.Generator):
    """Shard-LOCAL epoch indices and validity for a `shard_device_dataset`
    dataset, (num_batches, B) each, the same on every rank: a rank reads
    its own columns (`batch_sharding`), all from its data group's shard."""
    k = data_axis_size(mesh)
    n_stored = int(ds.images.shape[0]) * k
    gidx, valid = sharded_batch_indices(
        len(ds), n_stored, batch_size, k, shuffle=shuffle, rng=rng)
    return localize_aligned_indices(gidx, n_stored, k), valid


def localize_aligned_indices(global_idx: np.ndarray, n: int, n_shards: int):
    """Global -> local indices of an aligned batch (position j's index
    lives on the shard that produces position j). Raises if not aligned."""
    global_idx = np.asarray(global_idx)
    b = global_idx.shape[-1]
    shard = n // n_shards
    owner = global_idx // shard
    expect = np.arange(b) * n_shards // b
    if not np.all(owner == expect):
        raise ValueError(
            "batch indices are not shard-aligned; use a replicated dataset "
            "or the plain gather (which all-gathers)"
        )
    return global_idx % shard
