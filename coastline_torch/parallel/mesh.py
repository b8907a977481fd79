"""The device mesh on `torch.distributed` (counterpart of
`coastline/parallel/mesh.py`).

Each rank is one process on one device (`parallel/launch.py`). The mesh is
a `torch.distributed.device_mesh.DeviceMesh` over every rank of the process
group, with the JAX package's axis names:

  * `data`: the batch axis. Train steps wrap the model in
    `DistributedDataParallel`, which all-reduces the gradients;
  * `dcn`: an outer batch axis (`make_mesh(dcn=N)`); the batch splits over
    ('dcn', 'data') jointly, as in JAX;
  * `space`: image rows (`make_mesh(space=S)`, between `data` and
    `model`, JAX's order): the S ranks of a space group hold the same
    samples and split every image's rows (below);
  * `model`: the innermost axis. Every parameter and its Adam moments are
    sharded over their output channels (dim 0 of a torch weight) inside a
    model group and replicated over the other ranks: FSDP2's
    `fully_shard` on the 2-D (rest, model) mesh, i.e. HSDP. FSDP is data
    parallel inside its shard group, so with a model axis the global batch
    splits over the model ranks too.

A batch of B samples splits over the mesh's N / S sample groups in order:
the rank at flat position r ((dcn, data, space, model) row-major) belongs
to sample group g = (r // (S m)) m + r % m (m the model axis) and holds
samples [g B S / N, (g + 1) B S / N) (`batch_sharding`). So batch position
j belongs to data group j // (B / d) and, inside it, to the group's model
index. A sample-sharded dataset (`shard_device_dataset`) splits over the d
data groups only: each rank keeps its group's contiguous slab on its own
device, the ranks of one space group the same slab.

The space axis, in full:

  * Row rule. Space rank s of S holds rows [ceil(s H / S), ceil((s + 1) H /
    S)) of every H-row map (`collectives.row_share`): 33 rows over 2 are 17
    + 16, a 6-row map 3 + 3. Every layer derives its output's global
    height from its input's, and every rank's share from this rule, so all
    ranks know who needs which rows without asking (`ops/primitives.py`).
  * Halo. A layer whose windows span rows fetches, for this rank's output
    rows, the input rows they read that other ranks own
    (`collectives.fetch_rows`): only those rows, taken from every rank that
    owns one (a halo wider than a neighbour's share reaches past it: the
    Robust U-Net's dilation-4 bottleneck at 64^2 sits on 2 rows a rank),
    and rows outside the image take the layer's padding, as in one
    process. Strided windows start at global multiples of the stride, so a
    2x2 pool window on a seam reads its far row from the other rank. The
    exchange is one `all_reduce` of a zeroed byte buffer, each row written
    by its owner (exact), because gloo offers only `all_reduce` and
    `broadcast` for CUDA tensors; its backward sends each fetched row's
    gradient to the owner the same way.
  * Whole-image reductions. Global pools, the channel attention's mean and
    max, BN's batch sums and the losses' and metrics' per-image sums add
    (or max) the ranks' partials over the space group (BN over every rank
    of the step); PSPNet's pooled pyramid levels are whole on every rank;
    attention's reduced keys and values are gathered whole.
  * Kernels. The fused conv fetches one halo row each side and crops; the
    CBAM pool returns float32 partials for the all-reduce; the CBAM tail's
    7x7 conv reads a stats map carrying a 3-row halo; SegNet's pool and
    unpool fetch a straddling window's row.
  * Cost. Per conv, pool or resize: one all-reduce of (ranks' halo rows) x
    W x C elements, a copy of the local map into a slab with its halo, and
    on the card, with gloo, the host round trip of that buffer. Per
    attention block an all-reduce of the reduced keys and values. Memory: a
    rank's activations are 1 / S of a sample's plus one slab at a time.
    int8 forwards refuse a space mesh (ROADMAP queue 1).

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
    dims, names = [], []
    if dcn > 1:
        dims.append(dcn)
        names.append("dcn")
    dims.append(n // (dcn * space * model))
    names.append("data")
    if space > 1:
        dims.append(space)
        names.append("space")
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
    'dcn' axis when dcn > 1, a 'space' axis after 'data' when space > 1 and
    an innermost 'model' axis when model > 1. `devices` are ranks
    (default: all, in order), the first `n_devices` of them taken. The mesh
    spans every rank of the group. On CUDA, a mesh with a model axis, or
    over NCCL, needs a card a rank. With a space axis it also makes, on
    every rank, each space group's complement (the ranks of the other
    samples at the same rows, `whole_group`)."""
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

    mesh = DeviceMesh(kind, torch.tensor(ranks).reshape(dims), mesh_dim_names=names)
    if space > 1:  # every rank makes every group, in one order
        at = names.index("space")
        grid = mesh.mesh.movedim(at, -1).reshape(-1, space)
        whole = [dist.new_group(grid[:, j].tolist()) for j in range(space)]
        mesh.coastline_whole_group = whole[space_index(mesh)]
    return mesh


def _data_axes(mesh):
    return tuple(a for a in ("dcn", "data") if a in mesh.mesh_dim_names)


def data_axis_size(mesh) -> int:
    """Number of shards a sample-sharded dataset splits into on this mesh."""
    return int(np.prod([mesh.size(mesh.mesh_dim_names.index(a)) for a in _data_axes(mesh)]))


def model_axis_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index("model")) if "model" in names else 1


def space_axis_size(mesh) -> int:
    """Ranks an image's rows split over (1 without a 'space' axis)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index("space")) if "space" in names else 1


def space_index(mesh) -> int:
    """This rank's place in its space group (0 without a 'space' axis)."""
    return (mesh_rank(mesh) // model_axis_size(mesh)) % space_axis_size(mesh)


def space_group(mesh):
    """The process group of this rank's space group (the ranks holding the
    other rows of its samples); None without a 'space' axis."""
    return mesh.get_group("space") if "space" in mesh.mesh_dim_names else None


def whole_group(mesh):
    """The ranks at this rank's space index: those that hold the other
    samples of a split batch at the same rows (a train-mode BN over a map
    every space rank holds whole sums over them); None without a 'space'
    axis."""
    return getattr(mesh, "coastline_whole_group", None)


def mesh_rank(mesh) -> int:
    """This rank's flat position in the mesh (row-major over its axes)."""
    return mesh.mesh.flatten().tolist().index(dist.get_rank())


@dataclass(frozen=True)
class Rows:
    """Rank `index` of `count`'s contiguous share of a leading axis and,
    with a space axis, space rank `space_index` of `space_count`'s share of
    an image's rows."""

    index: int
    count: int
    space_index: int = 0
    space_count: int = 1

    def of(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a batch of {n} does not split over {self.count} ranks")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def rows_of(self, height: int) -> slice:
        """This rank's rows of a `height`-row image (`collectives.row_share`)."""
        return slice(*collectives.row_share(height, self.space_index, self.space_count))


def batch_sharding(mesh) -> Rows:
    """This rank's share of a global batch: sample group g of G (the module
    docstring) holds samples [g B/G, (g+1) B/G), and with a space axis its
    space rank's rows of each."""
    m, s = model_axis_size(mesh), space_axis_size(mesh)
    r = mesh_rank(mesh)
    return Rows((r // (s * m)) * m + r % m, mesh.size() // s, space_index(mesh), s)


def replicated(mesh) -> Rows:
    """The whole batch on every rank."""
    return Rows(0, 1)


def dataset_sharding(mesh) -> Rows:
    """This rank's data group's slab of a sample-sharded dataset."""
    return Rows(mesh_rank(mesh) // (model_axis_size(mesh) * space_axis_size(mesh)),
                data_axis_size(mesh))


def param_sharding(mesh):
    """The 2-D (replicate, shard) mesh `fully_shard` takes for the 'model'
    axis: ('data', 'model'), or ('dcn' x 'data' x 'space', 'model')
    flattened; None without a model axis (every parameter replicated)."""
    if "model" not in mesh.mesh_dim_names:
        return None
    if mesh.mesh_dim_names == ("data", "model"):
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
        if model_axis_size(mesh) * space_axis_size(mesh) > 1:
            raise ValueError("with a model or space axis a rank's shard spans several "
                             "processes' slabs: pass the global arrays (n_valid=None)")
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
