"""The port's training machinery vs the JAX package (CPU): the plateau
schedule, train-mode BatchNorm, two Adam steps of the full-width UNet, the
augmentation transforms, the data path and host-resident epochs.

Tolerances, the JAX package's own where it has one:
- plateau: exact (both keep float32 state and compare in float32);
- train-mode BN at (2, 8, 8, 16) f32: outputs and running statistics 1e-6,
  the input, scale and bias gradients 1e-5 (sums over 128 elements);
- two Adam steps: loss 1e-5, parameters atol 3e-5 / rtol 1e-4, BN statistics
  atol 2e-5 / rtol 2e-4 (`tests/test_train_parity.py:77-108`);
- augmentation 1e-6 (the same float32 formula, the grey mean summed in
  another order); the data path bit for bit.

Why the Adam cases use these seeds: Adam's first steps are about
lr * sign(g), so a weight whose decayed gradient lies within float32
rounding of 0 moves up to 2 * lr = 2e-4 the other way when the two packages
round it differently, and a pre-ReLU value within rounding of 0 that takes
the ReLU's other side in one package shifts its channel's gradients enough
to flip many such signs. Among the UNet's 31M parameters a few such weights
turn up at some weight seeds and batch plans, while every other value stays
well inside the tolerance; the torch-default init at weight seed 0 with the
plans below has none. He-uniform weights with random BN affines
(`random_unet_variables`) have many more.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.data import augment as jax_augment
from coastline.data import pipeline as jax_pipeline
from coastline.data import rasterize as jax_rasterize
from coastline.data import synthetic as jax_synthetic
from coastline.models.unet import UNet as JaxUNet
from coastline.ops.primitives import Norm as JaxNorm
from coastline.train import loop as jax_loop
from coastline.train import lr as jax_lr
from coastline.utils.torch_import import export_reference_unet, import_reference_unet
from coastline_torch.data import augment, pipeline, rasterize, synthetic
from coastline_torch.models.unet import UNet
from coastline_torch.ops.primitives import Norm
from coastline_torch.train.loop import (TrainConfig, batch_indices, create_train_state,
                                        make_train_epoch, run_train_epoch_any)
from coastline_torch.train.lr import plateau_init, plateau_update

torch.set_num_threads(1)


# ------------------------------------------------------------------ plateau
def test_plateau_update_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.89995, 0.89, 0.89, 0.89, 0.89, float("nan"), 0.5,
               float("inf"), 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]
    ref, got = jax_lr.plateau_init(1e-3), plateau_init(1e-3)
    for i, m in enumerate(metrics):
        ref = jax_lr.plateau_update(ref, m, patience=2, factor=0.5, min_lr=2e-4)
        got = plateau_update(got, m, patience=2, factor=0.5, min_lr=2e-4)
        assert got.lr == float(ref.lr), i
        assert got.best == float(ref.best), i
        assert got.num_bad == int(ref.num_bad), i
    assert got.lr == float(np.float32(2e-4))  # floored at min_lr after four cuts


# ------------------------------------------------------------ train-mode BN
def test_norm_train_mode_matches_jax():
    rng = np.random.default_rng(0)
    c = 16
    x = rng.normal(0.3, 1.2, (2, 8, 8, c)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    rmean = rng.normal(0, 0.1, c).astype(np.float32)
    rvar = rng.uniform(0.5, 1.5, c).astype(np.float32)

    def loss(x, s, b):
        y, upd = JaxNorm().apply({"params": {"BatchNorm_0": {"scale": s, "bias": b}},
                                  "batch_stats": {"BatchNorm_0": {"mean": rmean, "var": rvar}}},
                                 x, train=True, mutable=["batch_stats"])
        return (y * r).sum(), (y, upd["batch_stats"]["BatchNorm_0"])

    (_, (ref_y, ref_stats)), ref_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    norm = Norm(c)
    with torch.no_grad():
        for t, v in ((norm.weight, scale), (norm.bias, bias), (norm.running_mean, rmean),
                     (norm.running_var, rvar)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_()
    y = norm.train()(xt)
    (y * torch.from_numpy(r.transpose(0, 3, 1, 2))).sum().backward()

    def nhwc(t):
        return t.detach().numpy().transpose(0, 2, 3, 1)

    np.testing.assert_allclose(nhwc(y), np.asarray(ref_y), atol=1e-6, rtol=0)
    np.testing.assert_allclose(norm.running_mean.numpy(), np.asarray(ref_stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(norm.running_var.numpy(), np.asarray(ref_stats["var"]), atol=1e-6)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(ref_g[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(norm.weight.grad.numpy(), np.asarray(ref_g[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(norm.bias.grad.numpy(), np.asarray(ref_g[2]), atol=1e-5, rtol=0)
    assert int(norm.num_batches_tracked) == 1
    # eval mode normalizes with the running statistics just updated
    with torch.no_grad():
        inv, shift = norm.folded()
        got = norm.eval()(xt)
    np.testing.assert_array_equal(got.numpy(), (xt * inv[:, None, None]
                                                + shift[:, None, None]).detach().numpy())


# ------------------------------------------------------- two Adam steps
LR, WD = 1e-4, 0.1


@pytest.fixture(scope="module")
def adam_case():
    """Images, masks, the torch-default init (weight seed 0) as a state_dict
    and as JAX variables, and the jitted JAX epoch, compiled once."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    masks = (rng.random((4, 32, 32)) > 0.5).astype(np.uint8)
    sd = {k: v.clone() for k, v in UNet(seed=0).state_dict().items()}
    variables = import_reference_unet({k: v.numpy() for k, v in sd.items()})
    config = jax_loop.TrainConfig(lr=LR, weight_decay=WD, loss="ce", batch_size=2)
    return images, masks, sd, variables, jax_loop.make_train_epoch(JaxUNet(n_classes=2), config)


def _jax_state(variables):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jax_loop.TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                               batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                               opt_state=jax_loop.make_optimizer(WD).init(params),
                               plateau=jax_lr.plateau_init(LR), rng=jax.random.PRNGKey(0))


def _run_both(adam_case, idx, valid):
    images, masks, sd, variables, jax_epoch = adam_case
    state, ref_loss = jax_epoch(_jax_state(variables), jnp.asarray(images), jnp.asarray(masks),
                                jnp.asarray(idx), jnp.asarray(valid))
    ref = export_reference_unet(jax.device_get({"params": state.params,
                                                "batch_stats": state.batch_stats}))
    model = UNet()
    model.load_state_dict(sd, strict=True)
    config = TrainConfig(lr=LR, weight_decay=WD, loss="ce", batch_size=2)
    pstate = create_train_state(model, config, device="cpu")
    pstate, loss = make_train_epoch(model, config, device="cpu")(pstate, images, masks, idx, valid)
    assert pstate.step == 2
    assert loss == pytest.approx(float(ref_loss), abs=1e-5, rel=1e-5)
    got = model.state_dict()
    assert set(got) == set(ref)
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 2
            continue
        atol, rtol = (2e-5, 2e-4) if ".running_" in k else (3e-5, 1e-4)
        np.testing.assert_allclose(got[k].numpy(), r, atol=atol, rtol=rtol, err_msg=k)
    return got


def test_two_adam_steps_match_jax(adam_case):
    idx = np.array([[0, 1], [2, 3]], np.int32)
    got = _run_both(adam_case, idx, np.ones((2, 2), np.float32))
    moved = sum(float((got[k] - v).abs().max()) > 0 for k, v in adam_case[2].items()
                if not k.endswith("num_batches_tracked"))
    assert moved == len(adam_case[2]) - 18  # every parameter and statistic moved


def test_padded_epoch_matches_jax(adam_case):
    """n = 3 at batch 2: the wrap-around padding enters BN but not the loss."""
    idx, valid = batch_indices(3, 2, shuffle=True, rng=np.random.default_rng(3))
    assert idx.tolist() == [[2, 1], [0, 2]] and valid.tolist() == [[1, 1], [1, 0]]
    _run_both(adam_case, idx, valid)


# ----------------------------------------------------------- augmentation
@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("deg", [0.0, 10.0, -10.0, 7.3])
def test_rotate_matches_jax(nearest, deg):
    rng = np.random.default_rng(1)
    img = rng.random((13, 17, 3)).astype(np.float32)
    if nearest:
        img = (img > 0.5).astype(np.float32)
    angle = np.float32(deg * np.pi / 180.0)
    ref = np.asarray(jax_augment._rotate_bilinear(jnp.asarray(img), jnp.asarray(angle),
                                                  order_nearest=nearest))
    got = augment.rotate(torch.from_numpy(img)[None], torch.tensor([angle]), nearest=nearest)[0]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    if deg == 0.0:
        np.testing.assert_array_equal(got.numpy(), img)


def test_color_jitter_and_flip_match_jax():
    rng = np.random.default_rng(2)
    img = rng.random((2, 11, 9, 3)).astype(np.float32)
    got_imgs = []
    for i, seed in enumerate((3, 4)):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax_augment.color_jitter(key, jnp.asarray(img[i]), 0.1, 0.1, 0.1))
        kb, kc, ks = jax.random.split(key, 3)
        b, c, s = (float(jax.random.uniform(k, (), minval=0.9, maxval=1.1)) for k in (kb, kc, ks))
        got = augment.color_jitter(torch.from_numpy(img[i])[None], torch.tensor([b]),
                                   torch.tensor([c]), torch.tensor([s]))[0]
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
        got_imgs.append(got)
    flipped = augment.flip(torch.from_numpy(img), torch.tensor([True, False]))
    np.testing.assert_array_equal(flipped[0].numpy(), np.asarray(jnp.asarray(img[0])[:, ::-1, :]))
    np.testing.assert_array_equal(flipped[1].numpy(), img[1])


def test_augmentation_keeps_image_mask_alignment():
    """The default moves image and mask together; `image_only_geometric`
    leaves the mask where it was (the reference's behaviour)."""
    img, mask, _ = synthetic.make_scene(np.random.default_rng(3), size=64)
    images = torch.from_numpy(img).float()[None] / 255.0
    masks = torch.from_numpy(mask.copy())[None]
    aug = augment.make_augment_fn(max_rotate_deg=10.0, flip_prob=1.0, jitter=0.0)
    out_img, out_mask = aug(torch.Generator().manual_seed(7), images, masks)
    assert out_mask.dtype == masks.dtype and out_img.shape == images.shape
    darkness = out_img.mean(-1)[0] < 0.35
    water = out_mask[0] > 0
    assert (darkness & water).sum() / (darkness | water).sum() > 0.8
    assert not torch.equal(out_mask, masks)
    aug_ref = augment.make_augment_fn(flip_prob=1.0, jitter=0.0, image_only_geometric=True)
    _, mask_ref = aug_ref(torch.Generator().manual_seed(7), images, masks)
    assert torch.equal(mask_ref, masks)


def test_augment_batch_is_a_function_of_the_generator():
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.random((3, 16, 20, 3)).astype(np.float32))
    masks = torch.from_numpy((rng.random((3, 16, 20)) > 0.5).astype(np.uint8))
    aug = augment.make_augment_fn()
    a = aug(torch.Generator().manual_seed(11), images, masks)
    b = aug(torch.Generator().manual_seed(11), images, masks)
    c = aug(torch.Generator().manual_seed(12), images, masks)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert float(a[0].min()) >= 0.0 and float(a[0].max()) <= 1.0


# -------------------------------------------------------------- data path
def test_rasterize_and_labelme_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    polys = [rng.uniform(0, 40, (7, 2)).tolist(), [[1, 1], [30, 2], [15, 20]], [[0, 0], [5, 5]]]
    np.testing.assert_array_equal(rasterize.rasterize_polygons(polys, (41, 33)),
                                  jax_rasterize.rasterize_polygons(polys, (41, 33)))
    label = tmp_path / "a.json"
    label.write_text(json.dumps({"shapes": [
        {"label": "Water", "points": polys[0]}, {"label": "land", "points": polys[1]},
        {"label": "海水", "points": polys[1][::-1]}]}), encoding="utf-8")
    broken = tmp_path / "b.json"
    broken.write_text("{not json")
    for path in (label, broken, tmp_path / "missing.json"):
        got = rasterize.mask_from_labelme(str(path), (41, 33))
        np.testing.assert_array_equal(got, jax_rasterize.mask_from_labelme(str(path), (41, 33)))
    assert rasterize.mask_from_labelme(str(label), (41, 33)).sum() > 0
    assert rasterize.WATER_LABELS == jax_rasterize.WATER_LABELS


def test_file_pipeline_matches_jax(tmp_path):
    images_dir, labels_dir = synthetic.write_synthetic_tree(str(tmp_path), 3, size=40, seed=2)
    (tmp_path / "converted" / "no_label.png").write_bytes(
        (tmp_path / "converted" / "scene_0000.png").read_bytes())
    got = pipeline.pair_files(images_dir, labels_dir)
    assert got == jax_pipeline.pair_files(images_dir, labels_dir) and len(got[0]) == 3
    for ip, lp in zip(*got):
        for a, b in zip(pipeline.load_pair(ip, lp, (24, 20)),
                        jax_pipeline.load_pair(ip, lp, (24, 20))):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    items = [f"item{i}" for i in range(23)]
    assert pipeline.seeded_split(items) == jax_pipeline.seeded_split(items)
    assert pipeline.sequential_split(items) == jax_pipeline.sequential_split(items)
    ds = pipeline.build_dataset(*got, (24, 20), with_paths=True, device="cpu")
    assert isinstance(ds, pipeline.DeviceDataset) and ds.paths == got[0]
    assert tuple(ds.images.shape) == (3, 20, 24, 3) and ds.masks.dtype == torch.uint8
    tif = tmp_path / "scene.tif"
    tif.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="GeoTIFF"):
        pipeline.load_image_rgb(str(tif))


def test_synthetic_arrays_match_jax():
    for a, b in zip(synthetic.synthetic_dataset_arrays(3, 48, seed=5),
                    jax_synthetic.synthetic_dataset_arrays(3, 48, seed=5)):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_make_dataset_placement_and_budget(capsys):
    images = np.zeros((4, 8, 8, 3), np.uint8)
    masks = np.zeros((4, 8, 8), np.uint8)
    ds = pipeline.make_dataset(images, masks, device="cpu")
    assert isinstance(ds, pipeline.DeviceDataset) and ds.images.device.type == "cpu"
    assert len(ds) == 4
    host = pipeline.make_dataset(images, masks, max_device_bytes=100, superbatch=3, device="cpu")
    assert isinstance(host, pipeline.HostDataset) and host.superbatch == 3 and len(host) == 4
    assert "exceeds the device-resident budget" in capsys.readouterr().out
    assert isinstance(pipeline.make_dataset(images, masks, placement="host"), pipeline.HostDataset)
    with pytest.raises(ValueError, match="device-resident budget is"):
        pipeline.make_dataset(images, masks, placement="device", max_device_bytes=100,
                              device="cpu")
    with pytest.raises(ValueError, match="placement"):
        pipeline.make_dataset(images, masks, placement="hbm", device="cpu")


# ------------------------------------------------------ host-resident epoch
def test_host_dataset_epoch_equals_resident():
    """Five samples at batch 2 with augmentation, uploaded two batches a
    chunk: every parameter, statistic and the loss equal the resident run's
    bit for bit."""
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    masks = (rng.random((5, 16, 16)) > 0.5).astype(np.uint8)
    idx, valid = batch_indices(5, 2, shuffle=True, rng=np.random.default_rng(1))
    config = TrainConfig(lr=1e-3, weight_decay=0.0, loss="ce", batch_size=2)
    runs = []
    for ds in (pipeline.make_dataset(images, masks, device="cpu"),
               pipeline.make_dataset(images, masks, placement="host", superbatch=2)):
        model = UNet(seed=1)
        state = create_train_state(model, config, device="cpu")
        epoch = make_train_epoch(model, config, augment.make_augment_fn(), device="cpu")
        state, loss = run_train_epoch_any(epoch, state, ds, idx, valid)
        runs.append((loss, model.state_dict(), state.generator.get_state()))
    (l0, sd0, g0), (l1, sd1, g1) = runs
    assert l0 == l1 and np.isfinite(l0)
    assert torch.equal(g0, g1)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
