"""Rank functions of the port's row-split tests (`tests/test_torch_space_*.py`).

The ranks start with the `spawn` method and import this module, which
imports only the port (a test file imports JAX). Each function runs every
check of its test file in one process group and returns plain numpy /
Python results; where a check needs the one-process result, the ranks
compute it themselves, split between them.
"""

import numpy as np
import torch
import torch.nn.functional as F

from coastline_torch.data.synthetic import synthetic_dataset_arrays
from coastline_torch.kernels import cbam, fused_conv, pools
from coastline_torch.models.fastscnn import FastSCNN
from coastline_torch.models.registry import available_models, create_model
from coastline_torch.models.robust_unet import RobustUNet
from coastline_torch.ops import primitives as prim
from coastline_torch.parallel import collectives
from coastline_torch.parallel import mesh as pmesh
from coastline_torch.parallel.launch import local_device
from coastline_torch.train.loop import (TrainConfig, batch_indices, create_train_state,
                                        make_eval_epoch, make_train_epoch)

torch.set_num_threads(1)
CL = torch.channels_last


def _randn(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)).to(dtype)


def space_forward(fn, x, group, whole=None):
    """`fn` on this rank's rows of NCHW `x` inside a row split over `group`,
    the output's rows gathered back in image order (whole on every rank)."""
    h, w = x.shape[2:]
    lo, hi = collectives.row_share(h, collectives.group_rank(group), collectives.group_size(group))
    with collectives.split_rows(group, h, w, whole) as split:
        y = fn(x[:, :, lo:hi].contiguous(memory_format=CL))
        if isinstance(y, tuple):
            return tuple(collectives.gather_rows(t, split) for t in y)
        return collectives.gather_rows(y, split)


def fetch_case(group, height, needs_of, seed):
    """Each rank's `fetch_rows` of a (2, 3, height, 5) map and the gradient
    it sends back, against one process: the padded map's rows, and the
    gradient of sum_r <fetch_r, R_r> on the whole map, cut to the rank's rows."""
    size, rank = collectives.group_size(group), collectives.group_rank(group)
    x = _randn((2, 3, height, 5), seed)
    shares = [collectives.row_share(height, r, size) for r in range(size)]
    needs = [needs_of(lo, hi) for lo, hi in shares]
    weights = [_randn((2, 3, b - a, 5), seed + 1 + r) for r, (a, b) in enumerate(needs)]
    pad = max(0, -min(a for a, _ in needs)), max(0, max(b for _, b in needs) - height)
    xf = x.clone().requires_grad_(True)
    padded = F.pad(xf, (0, 0, *pad), value=-7.0)
    refs = [padded[:, :, a + pad[0]:b + pad[0]] for a, b in needs]
    sum(((t * wt).sum() for t, wt in zip(refs, weights))).backward()
    lo, hi = shares[rank]
    xl = x[:, :, lo:hi].clone().requires_grad_(True)
    with collectives.split_rows(group, height, 5) as split:
        got = collectives.fetch_rows(xl, split, height, needs, fill=-7.0)
    (got * weights[rank]).sum().backward()
    return {"fetched": bool(torch.equal(got, refs[rank].detach())),
            "grad_err": float((xl.grad - xf.grad[:, :, lo:hi]).abs().max()),
            "needs": needs[rank], "share": (lo, hi)}


class ConvStack(torch.nn.Module):
    """`tests/test_parallel.py:104-137`'s stack: 3x3 to 8, ReLU, 3x3
    dilation 2 to 8, ReLU, 3x3 stride 2 to 4."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(2)
        self.c1 = prim.Conv(3, 8, 3, 1, generator=g)
        self.c2 = prim.Conv(8, 8, 3, 2, dilation=2, generator=g)
        self.c3 = prim.Conv(8, 4, 3, 1, generator=g, stride=2)

    def forward(self, x):
        return self.c3(torch.relu(self.c2(torch.relu(self.c1(x)))))


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def conv_stack_case(group, x):
    """The stack's forward and its gradients (input and weights) under the
    row split against one process."""
    model = ConvStack()
    r = _randn((2, 4, 17, 20), 9)
    xf = x.clone().requires_grad_(True)
    ref = model(xf)
    (ref * r).sum().backward()
    ref_grads = _grads(model)
    model.zero_grad()
    size, rank = collectives.group_size(group), collectives.group_rank(group)
    lo, hi = collectives.row_share(x.shape[2], rank, size)
    olo, ohi = collectives.row_share(ref.shape[2], rank, size)
    xl = x[:, :, lo:hi].clone().requires_grad_(True)
    with collectives.split_rows(group, x.shape[2], x.shape[3]):
        y = model(xl)
        (y * r[:, :, olo:ohi]).sum().backward()
    wgrad = {k: collectives.all_reduce_sum(g, group) for k, g in _grads(model).items()}
    full = collectives.gather_rows(y.detach(), collectives.RowSplit(group, ref.shape[2],
                                                                    ref.shape[3]))
    return {"out": full.numpy(), "ref": ref.detach().numpy(),
            "x_grad_err": float((xl.grad - xf.grad[:, :, lo:hi]).abs().max()),
            "w_grad_err": max(float((wgrad[k] - ref_grads[k]).abs().max()) for k in ref_grads),
            "weights": {k: v.detach().numpy() for k, v in model.state_dict().items()}}


MODEL_CASES = [(name, 64, 64) for name in available_models()] + [
    ("Fast-SCNN", 66, 64), ("HRNet-Water", 72, 64)]  # odd shares at their deeper levels


def model_cases(group):
    """Every registry model's f32 eval forward (logits) at batch 1 under the
    row split; rank r also runs the one-process forwards of cases r, r + S, ..."""
    size, rank = collectives.group_size(group), collectives.group_rank(group)
    out = {}
    for i, (name, h, w) in enumerate(MODEL_CASES):
        model = create_model(name).eval()
        x = _randn((1, 3, h, w), i)
        with torch.no_grad():
            got = space_forward(lambda t: model(t, return_logits=True), x, group)
            ref = model(x.contiguous(memory_format=CL), return_logits=True) \
                if i % size == rank else None
        out[(name, h, w)] = (got.numpy(), None if ref is None else ref.numpy())
    return out


def kernel_cases(group):
    """The kernel wrappers' plain versions inside a row split against one
    process: the fused conv with its 1-row halo, the CBAM pool's partials,
    the CBAM tail with its 3-row stats halo (the plain tail on a halo'd
    stats map bit for bit too), and SegNet's pool and unpool at 48 rows
    (the fourth pool on 3 + 3 rows)."""
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = _randn((2, 64, 20, 12), 1, dt).contiguous(memory_format=CL)
        w, scale, bias = _randn((3, 3, 64, 64), 2) * 0.05, _randn((64,), 3), _randn((64,), 4)
        if dt == torch.bfloat16:
            ref = fused_conv.fused_conv3x3_bn_relu(x.permute(0, 2, 3, 1), w, scale, bias)
            got = space_forward(lambda t: fused_conv.fused_conv3x3_bn_relu(
                t.permute(0, 2, 3, 1), w, scale, bias).permute(0, 3, 1, 2), x, group)
            out["fused_conv"] = bool(torch.equal(got.permute(0, 2, 3, 1), ref))
        for name, fn in (("avg_max_pool", cbam.avg_max_pool),
                         ("fused_avg_max_pool", pools.fused_avg_max_pool)):
            ref = fn(x.permute(0, 2, 3, 1))
            h, wd = x.shape[2:]
            lo, hi = collectives.row_share(h, collectives.group_rank(group),
                                           collectives.group_size(group))
            with collectives.split_rows(group, h, wd):
                got = fn(x[:, :, lo:hi].permute(0, 2, 3, 1))
            out[f"{name}_{dt}"] = [float((g.float() - r.float()).abs().max())
                                   for g, r in zip(got, ref)]
        sc = _randn((2, 64, 20, 12), 5, dt).contiguous(memory_format=CL)
        fc1, fc2, sconv = _randn((64, 4), 6) * 0.2, _randn((4, 64), 7) * 0.2, _randn((7, 7, 2, 1), 8)
        ref = cbam.fused_cbam_tail(x.permute(0, 2, 3, 1), sc.permute(0, 2, 3, 1), fc1, fc2, sconv)
        both = torch.cat([x, sc], 1)
        got = space_forward(lambda t: cbam.fused_cbam_tail(
            t[:, :64].permute(0, 2, 3, 1), t[:, 64:].permute(0, 2, 3, 1), fc1, fc2,
            sconv).permute(0, 3, 1, 2), both, group)
        out[f"cbam_tail_{dt}"] = float((got.permute(0, 2, 3, 1).float() - ref.float()).abs().max())
        gate = torch.sigmoid(_randn((2, 64), 10)).to(dt)
        stats = cbam.gated_spatial_stats(x.permute(0, 2, 3, 1), gate)
        full = cbam.cbam_tail_apply(x.permute(0, 2, 3, 1), sc.permute(0, 2, 3, 1), gate, stats,
                                    sconv)
        padded = F.pad(stats, (0, 0, 3, 3))
        out[f"cbam_tail_halo_{dt}"] = max(float((cbam.cbam_tail_apply(
            x.permute(0, 2, 3, 1)[:, a:b], sc.permute(0, 2, 3, 1)[:, a:b], gate,
            padded[:, :, a:b + 6].contiguous(), sconv, halo=3).float()
            - full[:, a:b].float()).abs().max()) for a, b in ((0, 7), (7, 20), (3, 4)))
    x = _randn((2, 8, 48, 16), 11).contiguous(memory_format=CL)

    def segnet_chain(t):
        codes = []
        for _ in range(4):
            t, c = prim.max_pool_with_indices(t)
            codes.append(c)
        for _ in range(4):
            t = prim.max_unpool(t, codes.pop())
        return t

    out["pool_unpool"] = bool(torch.equal(space_forward(segnet_chain, x, group),
                                          segnet_chain(x)))
    return out


PRIMITIVE_CASES = {
    "avg_pool": lambda t: prim.avg_pool(t, 3, 2, 1),
    "max_pool": lambda t: prim.max_pool(t, 3, 2, 1),
    "upsample_nearest": lambda t: prim.upsample_nearest(t, 2),
    "nearest_resize": lambda t: prim.nearest_resize(t, (21, 9)),
    "bilinear_resize": lambda t: prim.bilinear_resize(t, (47, 20)),
    "conv_transpose": prim.ConvTranspose(4, 3, 3, 2, 1, output_padding=1,
                                         generator=torch.Generator().manual_seed(3)),
}
WHOLE_CASES = {  # maps every rank holds whole
    "max_pool_global": prim.max_pool_global, "avg_pool_global": prim.avg_pool_global,
    "adaptive_avg_pool": lambda t: prim.adaptive_avg_pool(t, 3),
    "adaptive_max_pool": lambda t: prim.adaptive_max_pool(t, (3, 2)),
}


def primitive_cases(group):
    """The row-split primitives no registry model takes at 64^2 (ragged
    windows, downsizing and odd upsizing resizes, a 3x3/2 transposed conv)
    and the pools whose output every rank holds whole, at H = 13, against
    one process: (max abs error, gradient's max abs error)."""
    x = _randn((2, 4, 13, 10), 14)
    size, rank = collectives.group_size(group), collectives.group_rank(group)
    lo, hi = collectives.row_share(13, rank, size)
    out = {}
    for name, fn in {**PRIMITIVE_CASES, **WHOLE_CASES}.items():
        xf = x.clone().requires_grad_(True)
        ref = fn(xf)
        r = _randn(tuple(ref.shape), 15)
        (ref * r).sum().backward()
        xl = x[:, :, lo:hi].clone().requires_grad_(True)
        with collectives.split_rows(group, 13, 10) as split:
            y = fn(xl)
            if name in WHOLE_CASES:
                got, rl = y, r
            else:
                got = collectives.gather_rows(y.detach(), split)
                olo, ohi = collectives.row_share(ref.shape[2], rank, size)
                rl = r[:, :, olo:ohi]
            (y * rl).sum().backward()
        # a whole map's loss counts once a rank: its gradient is `size` times one process's
        want = xf.grad[:, :, lo:hi] * (size if name in WHOLE_CASES else 1)
        out[name] = (float((got - ref.detach()).abs().max()),
                     float((xl.grad - want).abs().max()))
    return out


def int8_refusal(group):
    """An int8 forward inside a row split raises, before any conv."""
    from coastline_torch.infer import quant

    with collectives.split_rows(group, 64, 64):
        try:
            quant.int8_forward({}, {}, torch.zeros((1, 64 // 2, 64, 3)))
        except NotImplementedError as err:
            return str(err)
    return None


def scene_case(mesh, scene, tile, batch, overlap, band):
    """`predict_scene` of the full-width UNet (seeded weights, float32) on
    the space mesh against one process, and the int8 scene's refusal."""
    from coastline_torch.infer.extract import CoastlineExtractor
    from coastline_torch.utils.torch_import import random_unet_variables

    ex = CoastlineExtractor(variables=random_unet_variables(seed=0), image_size=tile,
                            device=local_device())
    got = ex.predict_scene(scene, batch=batch, overlap=overlap, with_band=band, mesh=mesh)
    ref = ex.predict_scene(scene, batch=batch, overlap=overlap, with_band=band)
    ex.quantize()
    try:
        ex.predict_scene(scene, batch=batch, overlap=overlap, mesh=mesh)
        refused = None
    except NotImplementedError as err:
        refused = str(err)
    return {"mask": got[0], "band": got[1], "ref_mask": ref[0], "ref_band": ref[1],
            "int8_refused": refused}


def model_checks(scene_args):
    """Every check of `test_torch_space_model.py` on `make_mesh(2, space=2)`."""
    mesh = pmesh.make_mesh(2, space=2)
    group = pmesh.space_group(mesh)
    out = {"fetch": {
        "h33_conv": fetch_case(group, 33, lambda lo, hi: (lo - 1, hi + 1), 0),
        "h33_dilated": fetch_case(group, 33, lambda lo, hi: (lo - 2, hi + 2), 1),
        "h33_stride2": fetch_case(group, 33, lambda lo, hi: (2 * (-(-lo // 2)) - 1,
                                                              2 * (-(-hi // 2)) + 1), 2),
        "h4_wide": fetch_case(group, 4, lambda lo, hi: (lo - 4, hi + 4), 3)}}
    wide = prim.Conv(3, 5, 3, padding=4, dilation=4, generator=torch.Generator().manual_seed(4))
    x = _randn((2, 3, 4, 6), 12)
    with torch.no_grad():
        out["wide_conv"] = float((space_forward(wide, x, group) - wide(x)).abs().max())
    out["stack"] = conv_stack_case(group, _randn((2, 3, 33, 40), 1))
    out["models"] = model_cases(group)
    yolo = create_model("YOLO-SEG").eval()
    images, _ = synthetic_dataset_arrays(4, 64, seed=3)
    x = torch.from_numpy(images).float().permute(0, 3, 1, 2) / 255.0
    with torch.no_grad():
        out["yolo"] = space_forward(lambda t: yolo(t), x, group).numpy()
    out["yolo_sd"] = {k: v.numpy() for k, v in yolo.state_dict().items()}
    with torch.no_grad():
        out["kernels"] = kernel_cases(group)
    out["primitives"] = primitive_cases(group)
    out["int8_refused"] = int8_refusal(group)
    out["scene"] = scene_case(mesh, *scene_args)
    out["rank"] = collectives.group_rank()
    return out


# ---------------------------------------------------------------------------
# test_torch_space_train.py
# ---------------------------------------------------------------------------


def mesh_facts(mesh):
    return {"shape": tuple(mesh.mesh.shape), "names": mesh.mesh_dim_names,
            "share": pmesh.batch_sharding(mesh), "data": pmesh.dataset_sharding(mesh),
            "space_ranks": sorted(torch.distributed.get_process_group_ranks(
                pmesh.space_group(mesh))),
            "whole_ranks": sorted(torch.distributed.get_process_group_ranks(
                pmesh.whole_group(mesh)))}


def fastscnn_step(sd, mesh, size, batch, n):
    """One batch of Fast-SCNN (lr 1e-3) on `mesh`, or in this process with
    mesh=None: (loss, BN running statistics)."""
    dev = local_device() or torch.device("cpu")
    model = FastSCNN()
    model.load_state_dict(sd)
    cfg = TrainConfig(epochs=1, batch_size=batch, lr=1e-3)
    images, masks = synthetic_dataset_arrays(n, size, seed=0)
    idx, valid = batch_indices(n, batch, shuffle=False, rng=np.random.default_rng(0))
    epoch = make_train_epoch(model, cfg, device=dev, mesh=mesh)
    state = create_train_state(model, cfg, device=dev)
    _, loss = epoch(state, images, masks, idx, valid)
    bn = {k: np.concatenate([m.running_mean.numpy(), m.running_var.numpy()])
          for k, m in model.named_modules() if isinstance(m, prim.Norm)}
    return loss, bn


def robust_unet_epoch(sd, images, masks, gidx, valid, mesh=None):
    """One train epoch and one eval epoch of RobustUNet(base=16) on the
    aligned plan `gidx`: from a sample-sharded dataset on `mesh`, or from the
    whole dataset in this process."""
    dev = local_device() or torch.device("cpu")
    model = RobustUNet(base=16)
    model.load_state_dict(sd)
    cfg = TrainConfig(epochs=1, batch_size=gidx.shape[1], eval_batch_size=gidx.shape[1], lr=1e-4)
    idx = gidx
    if mesh is not None:
        ds = pmesh.shard_device_dataset(mesh, images, masks)
        images, masks = ds.images, ds.masks
        idx = pmesh.localize_aligned_indices(gidx, len(ds), pmesh.data_axis_size(mesh))
    epoch = make_train_epoch(model, cfg, device=dev, mesh=mesh, sharded_dataset=mesh is not None)
    state = create_train_state(model, cfg, device=dev)
    _, loss = epoch(state, images, masks, idx, valid)
    ev = make_eval_epoch(model, cfg, dev, mesh=mesh, sharded_dataset=mesh is not None)(
        images, masks, idx, valid)
    return loss, ev


def trainer_validate(mesh, images, masks):
    """The production trainer's validation (UNet, float32) over one batch of
    4: on `mesh`, or in this process with mesh=None."""
    from coastline_torch.train.trainer import TrainerConfig, WaterSegmentationTrainer

    dev = local_device() or torch.device("cpu")
    trainer = WaterSegmentationTrainer(TrainerConfig(image_size=images.shape[1]), mesh=mesh,
                                       device=dev)
    idx, valid = batch_indices(len(images), 4, shuffle=False, rng=np.random.default_rng(0))
    return [float(v) for v in trainer._make_validate()(images, masks.astype(np.int64), idx,
                                                       valid)]


def evaluator_results(mesh, sd, images, masks):
    """`Evaluator.evaluate_model` of Fast-SCNN (its timed batches and the
    protocol metrics) on `mesh`."""
    from coastline_torch.data.pipeline import DeviceDataset
    from coastline_torch.train.loop import Evaluator

    dev = local_device() or torch.device("cpu")
    model = FastSCNN()
    model.load_state_dict(sd)
    cfg = TrainConfig(batch_size=4, eval_batch_size=4)
    ev = Evaluator(model, cfg, device=dev, mesh=mesh)
    ds = DeviceDataset.from_numpy(images, masks, device=dev)
    return ev.evaluate_model(ds, state=create_train_state(ev.model, cfg, device=dev),
                             throughput_batch=4)


def train_checks(fastscnn_sd, unet_sd, size, batch, n, unet_case):
    """Every check of `test_torch_space_train.py` on four ranks."""
    rank = collectives.group_rank()
    out = {"meshes": {}}
    for kw in (dict(space=2), dict(space=2, dcn=2), dict(space=2, model=2)):
        out["meshes"][tuple(sorted(kw.items()))] = mesh_facts(pmesh.make_mesh(4, **kw))
    errors = []
    for kw in (dict(space=3), dict(space=2, model=3)):
        try:
            pmesh.make_mesh(4, **kw)
        except ValueError as err:
            errors.append(str(err))
    out["errors"] = errors
    three = torch.distributed.new_group([0, 1, 2])
    if rank < 3:
        out["fetch3"] = {
            "h7_conv": fetch_case(three, 7, lambda lo, hi: (lo - 1, hi + 1), 20),
            "h7_wide": fetch_case(three, 7, lambda lo, hi: (lo - 3, hi + 3), 21)}
    out["dcn"] = fastscnn_step(fastscnn_sd, pmesh.make_mesh(4, space=2, dcn=2), size, batch, n)
    out["model"] = fastscnn_step(fastscnn_sd, pmesh.make_mesh(4, space=2, model=2), size, batch,
                                 n)
    if rank == 0:
        out["single"] = fastscnn_step(fastscnn_sd, None, size, batch, n)
    images, masks, gidx, valid = unet_case
    out["unet"] = robust_unet_epoch(unet_sd, images, masks, gidx, valid,
                                    pmesh.make_mesh(4, space=2))
    if rank == 1:
        out["unet_single"] = robust_unet_epoch(unet_sd, images, masks, gidx, valid)
    mesh = pmesh.make_mesh(4, space=2)
    out["validate"] = trainer_validate(mesh, images, masks)
    if rank == 2:
        out["validate_single"] = trainer_validate(None, images, masks)
    f_images, f_masks = synthetic_dataset_arrays(4, size, seed=5)
    out["evaluator"] = evaluator_results(mesh, fastscnn_sd, f_images, f_masks)
    if rank == 3:
        out["evaluator_single"] = evaluator_results(None, fastscnn_sd, f_images, f_masks)
    return out
