"""Rank functions of the port's multi-process tests (`tests/test_torch_parallel*.py`).

`coastline_torch.parallel.launch.run` starts its ranks with the `spawn`
method, and each rank imports the module its function lives in: a test
file imports JAX, so the rank functions live here, in a module that
imports only the port. Each function runs several checks in one process
group and returns plain numpy / Python results for the test to compare.
"""

import numpy as np
import torch

from coastline_torch.data.synthetic import synthetic_dataset_arrays
from coastline_torch.models.fastscnn import FastSCNN
from coastline_torch.ops.primitives import Norm
from coastline_torch.parallel import collectives
from coastline_torch.parallel import mesh as pmesh
from coastline_torch.parallel.launch import local_device
from coastline_torch.train.loop import (Evaluator, TrainConfig, batch_indices, create_train_state,
                                        make_eval_epoch, make_train_epoch)

torch.set_num_threads(1)


def bn_stats(model):
    return {name: np.concatenate([m.running_mean.numpy(), m.running_var.numpy()])
            for name, m in model.named_modules() if isinstance(m, Norm)}


def params(model):
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def fastscnn_epoch(sd, images, masks, idx, valid, cfg, mesh=None, sharded=False, ds=None,
                   augment_fn=None, eval_too=False):
    """One train epoch (and optionally an eval epoch) of FastSCNN from `sd`:
    (loss, model, state, eval result)."""
    dev = local_device() or torch.device("cpu")
    model = FastSCNN()
    model.load_state_dict(sd)
    epoch = make_train_epoch(model, cfg, augment_fn, dev, mesh=mesh, sharded_dataset=sharded)
    state = create_train_state(model, cfg, device=dev)
    if ds is not None:
        images, masks = ds.images, ds.masks
    state, loss = epoch(state, images, masks, idx, valid)
    ev = None
    if eval_too:
        ev = make_eval_epoch(model, cfg, dev, mesh=mesh, sharded_dataset=sharded)(
            images, masks, idx, valid)
    return loss, model, state, ev


def data_parallel_checks(sd, size, batch, n, sharded_case):
    """(b) a DDP epoch over the replicated dataset and (c) the sample-sharded
    epoch against the replicated one on the same aligned plan."""
    mesh = pmesh.make_mesh(2)
    cfg = TrainConfig(epochs=1, batch_size=batch, lr=1e-3)
    images, masks = synthetic_dataset_arrays(n, size, seed=0)
    idx, valid = batch_indices(n, batch, shuffle=False, rng=np.random.default_rng(0))
    loss, model, _, _ = fastscnn_epoch(sd, images, masks, idx, valid, cfg, mesh=mesh)
    out = {"loss": loss, "bn": bn_stats(model), "params": params(model),
           "rank": collectives.group_rank()}

    # (c): the same aligned plan, gathered from the whole dataset and from a shard
    s_images, s_masks, s_n, s_batch = sharded_case
    cfg_s = TrainConfig(epochs=1, batch_size=s_batch, eval_batch_size=s_batch, lr=1e-3)
    gidx, svalid = pmesh.sharded_batch_indices(s_n, s_n, s_batch, 2, shuffle=True,
                                               rng=np.random.default_rng(1))
    rep = fastscnn_epoch(sd, s_images, s_masks, gidx, svalid, cfg_s, mesh=mesh, eval_too=True)
    ds = pmesh.shard_device_dataset(mesh, s_images, s_masks)
    lidx = pmesh.localize_aligned_indices(gidx, s_n, 2)
    shd = fastscnn_epoch(sd, None, None, lidx, svalid, cfg_s, mesh=mesh, sharded=True, ds=ds,
                         eval_too=True)
    out["sharded"] = {"len": len(ds), "rows": int(ds.images.shape[0]),
                      "replicated": (rep[0], rep[3]), "sharded": (shd[0], shd[3]),
                      "params_equal": all(np.array_equal(a, b) for a, b in
                                          zip(params(rep[1]).values(), params(shd[1]).values()))}
    return out


def model_parallel_checks(sd, size, batch, n):
    """(d) `make_mesh(4, model=2)`: the epoch's loss, and each rank's local
    shapes of the large conv weights and of their Adam moments."""
    from torch.distributed.tensor import DTensor

    mesh = pmesh.make_mesh(4, model=2)
    cfg = TrainConfig(epochs=1, batch_size=batch, lr=1e-3)
    images, masks = synthetic_dataset_arrays(n, size, seed=0)
    idx, valid = batch_indices(n, batch, shuffle=False, rng=np.random.default_rng(0))
    loss, model, state, _ = fastscnn_epoch(sd, images, masks, idx, valid, cfg, mesh=mesh)
    shards = {}
    for name, p in model.named_parameters():
        if p.ndim == 4 and p.shape[0] >= 64:
            st = state.optimizer.state[p]
            shards[name] = (tuple(p.shape), isinstance(p, DTensor), tuple(p.to_local().shape),
                            tuple(st["exp_avg"].to_local().shape),
                            tuple(st["exp_avg_sq"].to_local().shape))
    bn = {name: (m.running_mean.numpy().copy(), m.running_var.numpy().copy())
          for name, m in model.named_modules() if isinstance(m, Norm)}
    return {"loss": loss, "shards": shards, "bn": bn}


def slab_checks(images, masks, n_shards, paths):
    """(g) each process's `process_local_slab`, a sample-sharded epoch from
    the slabs (`shard_device_dataset(..., n_valid=)`) against one from the
    global arrays, and (e) `paths` padded on the slab branch."""
    mesh = pmesh.make_mesh()
    li, lm, n_real = pmesh.process_local_slab(images, masks, n_shards)
    from_slab = pmesh.shard_device_dataset(mesh, li, lm, paths, n_valid=n_real)
    from_global = pmesh.shard_device_dataset(mesh, images, masks, paths)
    sd = FastSCNN().state_dict()
    cfg = TrainConfig(epochs=1, batch_size=4, lr=1e-3)
    losses = []
    for ds in (from_slab, from_global):
        idx, valid = pmesh.sharded_epoch_indices(mesh, ds, 4, shuffle=True,
                                                 rng=np.random.default_rng(0))
        losses.append(fastscnn_epoch(sd, None, None, idx, valid, cfg, mesh=mesh, sharded=True,
                                     ds=ds)[0])
    return {"slab": (li, lm, n_real), "len": len(from_slab), "paths": from_slab.paths,
            "global_paths": from_global.paths, "equal_images": bool(torch.equal(
                from_slab.images, from_global.images)), "losses": losses}


def evaluator_checks(images, masks, paths, log_dir):
    """(e) the Evaluator on two ranks: sample-sharded end to end (JSONL log
    from rank 0 only; the trained weights for a one-process evaluation), and
    on a replicated dataset."""
    from coastline_torch.data.pipeline import DeviceDataset

    dev = local_device()
    mesh = pmesh.make_mesh(2)
    ds = pmesh.shard_device_dataset(mesh, images, masks, paths)
    cfg = TrainConfig(epochs=2, batch_size=4, eval_batch_size=4, lr=1e-3,
                      log_path=f"{log_dir}/sharded.jsonl")
    ev = Evaluator(FastSCNN(), cfg, device=dev, mesh=mesh, sharded_data=True)
    trained = ev.train_model(ds, ds, verbose=False)
    res = ev.evaluate_model(ds, throughput_batch=8)
    out = {"sharded": {"len": len(ds), "rows": int(ds.images.shape[0]), "paths": ds.paths,
                       "history": trained["history"], "results": res,
                       "weights": params(ev.state.model)}}
    full = DeviceDataset.from_numpy(images, masks, device=dev)
    ev = Evaluator(FastSCNN(), TrainConfig(epochs=1, batch_size=4, eval_batch_size=4, lr=1e-3),
                   device=dev, mesh=mesh)
    trained = ev.train_model(full, full, verbose=False)
    out["replicated"] = {"history": trained["history"],
                         "results": ev.evaluate_model(full, throughput_batch=3)}
    return out


def scene_checks(scene, tile, batch, overlap, band):
    """(f) `predict_scene(mesh=)` of the full-width UNet (seeded weights)
    in float32 and in int8, each with the band, and at an odd chunk batch."""
    from coastline_torch.infer.extract import CoastlineExtractor
    from coastline_torch.utils.torch_import import random_unet_variables

    mesh = pmesh.make_mesh(2)
    ex = CoastlineExtractor(variables=random_unet_variables(seed=0), image_size=tile,
                            device=local_device())
    out = {"f32": ex.predict_scene(scene, batch=batch, overlap=overlap, with_band=band,
                                   mesh=mesh),
           "f32_mask": ex.predict_scene(scene, batch=batch, overlap=overlap, mesh=mesh)}
    out["odd_batch"] = ex.predict_scene(scene, batch=batch + 1, overlap=overlap, mesh=mesh)
    out["cached"] = len(ex._scene_cache)
    ex.quantize()
    out["int8"] = ex.predict_scene(scene, batch=batch, overlap=overlap, with_band=band,
                                   mesh=mesh)
    return out
