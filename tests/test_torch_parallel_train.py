"""The port's multi-device training against one process and against JAX's
mesh (CPU, gloo ranks).

One two-rank group (`torch_parallel_workers.data_parallel_checks`) runs:
  (b) a DDP epoch of Fast-SCNN at 64^2, batch 4 (one batch, so its loss is
      the forward's at the shared init, `tests/test_parallel.py:35-67`): its
      loss equals the port's single-process epoch at rtol 1e-4 and JAX's
      `make_mesh(4)` epoch at that test's rtol 1e-4; the BN running
      statistics, taken over the whole batch, are equal on both ranks and
      within the bridge's BN bounds (atol 2e-5 / rtol 2e-4) of one process;
  (c) on one shard-aligned plan (`sharded_batch_indices`), the
      sample-sharded epoch (each rank holding half the dataset) equals the
      replicated one: loss, eval loss and metrics, and every parameter, bit
      for bit.
One four-rank group (`model_parallel_checks`) runs:
  (d) `make_mesh(4, model=2)`: the loss within rtol 1e-4 of one process, and
      every large conv weight (C_out >= 64) and its Adam moments holding
      C_out / 2 output channels on each rank (`tests/test_parallel.py:
      219-260`), BN statistics equal on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from coastline.models.fastscnn import FastSCNN as JaxFastSCNN
from coastline.parallel.mesh import make_mesh as jax_make_mesh, replicated as jax_replicated
from coastline.train import loop as jax_loop
from coastline.utils import torch_import as jax_import
from coastline_torch.data.augment import make_augment_fn
from coastline_torch.data.synthetic import synthetic_dataset_arrays
from coastline_torch.models.fastscnn import FastSCNN
from coastline_torch.ops.blocks import Dropout2d, set_dropout_generator
from coastline_torch.parallel.launch import run
from coastline_torch.train.loop import TrainConfig, batch_indices

torch.set_num_threads(1)
SIZE, BATCH, N = 64, 4, 4


@pytest.fixture(scope="module")
def state_dict():
    return FastSCNN().state_dict()


@pytest.fixture(scope="module")
def single(state_dict):
    images, masks = synthetic_dataset_arrays(N, SIZE, seed=0)
    idx, valid = batch_indices(N, BATCH, shuffle=False, rng=np.random.default_rng(0))
    cfg = TrainConfig(epochs=1, batch_size=BATCH, lr=1e-3)
    loss, model, _, _ = workers.fastscnn_epoch(state_dict, images, masks, idx, valid, cfg)
    return loss, workers.bn_stats(model)


@pytest.fixture(scope="module")
def sharded_case():
    images, masks = synthetic_dataset_arrays(16, 32, seed=2)
    return images, masks, 16, 4


@pytest.fixture(scope="module")
def two_ranks(state_dict, sharded_case):
    return run(workers.data_parallel_checks, 2, device="cpu",
               args=(state_dict, SIZE, BATCH, N, sharded_case))


@pytest.fixture(scope="module")
def four_ranks(state_dict):
    return run(workers.model_parallel_checks, 4, device="cpu",
               args=(state_dict, SIZE, BATCH, N))


def test_ddp_epoch_matches_one_process(two_ranks, single):
    loss1, bn1 = single
    assert [r["rank"] for r in two_ranks] == [0, 1]
    for r in two_ranks:
        np.testing.assert_allclose(r["loss"], loss1, rtol=1e-4)
        for k in bn1:
            np.testing.assert_array_equal(r["bn"][k], two_ranks[0]["bn"][k])
            np.testing.assert_allclose(r["bn"][k], bn1[k], atol=2e-5, rtol=2e-4)
    for k, v in two_ranks[0]["params"].items():  # DDP keeps the replicas equal
        np.testing.assert_array_equal(two_ranks[1]["params"][k], v)


def test_ddp_epoch_matches_jax_mesh_epoch(two_ranks, state_dict):
    """JAX's `make_mesh(4)` epoch from the same weights (the JAX package's
    own importer), as `tests/test_parallel.py:35-67` runs it."""
    ds_images, ds_masks = synthetic_dataset_arrays(N, SIZE, seed=0)
    model = JaxFastSCNN()
    cfg = jax_loop.TrainConfig(epochs=1, batch_size=BATCH, lr=1e-3)
    state = jax_loop.create_train_state(model, cfg, (1, SIZE, SIZE, 3))
    variables = jax_import.import_reference_fastscnn({k: v.numpy() for k, v in state_dict.items()})
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    idx, valid = batch_indices(N, BATCH, shuffle=False, rng=np.random.default_rng(0))
    mesh = jax_make_mesh(4, space=1)
    state = jax.device_put(state, jax_replicated(mesh))
    images = jax.device_put(jnp.asarray(ds_images), jax_replicated(mesh))
    masks = jax.device_put(jnp.asarray(ds_masks), jax_replicated(mesh))
    _, loss = jax_loop.make_train_epoch(model, cfg, mesh=mesh)(
        state, images, masks, jnp.asarray(idx), jnp.asarray(valid))
    for r in two_ranks:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-4)


def test_sharded_epoch_equals_replicated(two_ranks, sharded_case):
    for r in two_ranks:
        s = r["sharded"]
        assert s["len"] == 16 and s["rows"] == 8  # each rank holds its half
        (loss_r, (vloss_r, agg_r)), (loss_s, (vloss_s, agg_s)) = s["replicated"], s["sharded"]
        assert loss_s == loss_r and vloss_s == vloss_r and agg_s == agg_r
        assert s["params_equal"]
        assert np.isfinite(loss_r) and set(agg_r) == {
            f"{a}_{m}" for a in ("mean", "std")
            for m in ("accuracy", "iou", "precision", "recall", "f1_score")}


def test_model_axis_shards_weights_and_moments(four_ranks, single):
    loss1, _ = single
    for r in four_ranks:
        np.testing.assert_allclose(r["loss"], loss1, rtol=1e-4)
        assert r["shards"], "expected large conv kernels in Fast-SCNN"
        for name, (full, is_dtensor, local, m1, m2) in r["shards"].items():
            half = (full[0] // 2,) + full[1:]
            assert is_dtensor and local == m1 == m2 == half, name
        for k, (mean, var) in r["bn"].items():  # BN buffers stay replicated and equal
            np.testing.assert_array_equal(mean, four_ranks[0]["bn"][k][0])
            np.testing.assert_array_equal(var, four_ranks[0]["bn"][k][1])


@pytest.mark.parametrize("start,total", [(0, 8), (4, 8), (2, 6)])
def test_split_batch_draws_the_whole_batch(start, total):
    """A rank's augmentation and Dropout2d masks are its rows of the
    single-process draws (every rank holds the same generator state)."""
    x = torch.rand((total, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    y = (x[..., 0] > 0.5).to(torch.uint8)
    aug = make_augment_fn()
    n = total // 2
    whole = aug(torch.Generator().manual_seed(3), x, y)
    part = aug(torch.Generator().manual_seed(3), x[start:start + n], y[start:start + n],
               rows=(start, total))
    torch.testing.assert_close(part[0], whole[0][start:start + n], rtol=0, atol=0)
    torch.testing.assert_close(part[1], whole[1][start:start + n], rtol=0, atol=0)

    drop = torch.nn.Sequential(Dropout2d(0.5)).train()
    h = torch.ones((total, 8, 4, 4))
    set_dropout_generator(drop, torch.Generator().manual_seed(5))
    full = drop(h)
    set_dropout_generator(drop, torch.Generator().manual_seed(5), rows=(start, total))
    torch.testing.assert_close(drop(h[start:start + n]), full[start:start + n], rtol=0, atol=0)
