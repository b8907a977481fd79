"""The port's row split (a mesh's `space` axis) in training, against one
process and JAX (CPU, four gloo ranks).

One four-rank group (`torch_space_workers.train_checks`) runs every check:
  * the meshes' shapes, axis names, batch and dataset shares, space groups
    and their complements at `make_mesh(4, space=2)`, `(4, space=2, dcn=2)`
    and `(4, space=2, model=2)` (`tests/test_parallel.py:9-19, 139-149,
    184-197`), and the sizes it refuses with JAX's message;
  * `fetch_rows` at H = 7 over three ranks (3 + 2 + 2 rows), for a conv
    and for a 3-row halo wider than a neighbour's share;
  * one Fast-SCNN batch (64^2, batch 4, lr 1e-3) under dcn x space and
    space x model: the loss within rtol 1e-4 of one process and of JAX
    (`test_parallel.py:151-181, 219-260`), BN running statistics within the
    bridge's atol 2e-5 / rtol 2e-4 of one process;
  * a sample-sharded RobustUNet(base=16) train and eval epoch at 32^2
    under `make_mesh(4, space=2)` (two data groups of two space ranks)
    against one process on the same aligned plan;
  * on that mesh, the production trainer's validation (UNet) and
    `Evaluator.evaluate_model` (Fast-SCNN at 64^2, its timed batches and
    the protocol metrics) against one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_space_workers as workers
from coastline.models.fastscnn import FastSCNN as JaxFastSCNN
from coastline.train import loop as jax_loop
from coastline.utils import torch_import as jax_import
from coastline_torch.data.synthetic import synthetic_dataset_arrays
from coastline_torch.models.fastscnn import FastSCNN
from coastline_torch.models.robust_unet import RobustUNet
from coastline_torch.parallel import mesh as pmesh
from coastline_torch.parallel.launch import run
from coastline_torch.train.loop import batch_indices

torch.set_num_threads(1)
SIZE, BATCH, N = 64, 4, 4


@pytest.fixture(scope="module")
def fastscnn_sd():
    return FastSCNN().state_dict()


@pytest.fixture(scope="module")
def ranks(fastscnn_sd):
    images, masks = synthetic_dataset_arrays(8, 32, seed=2)
    gidx, valid = pmesh.sharded_batch_indices(8, 8, 8, 2, shuffle=True,
                                              rng=np.random.default_rng(1))
    return run(workers.train_checks, 4, device="cpu",
               args=(fastscnn_sd, RobustUNet(base=16).state_dict(), SIZE, BATCH, N,
                     (images, masks, gidx, valid)))


@pytest.mark.parametrize("kw,shape,names", [
    ((("space", 2),), (2, 2), ("data", "space")),
    ((("dcn", 2), ("space", 2)), (2, 1, 2), ("dcn", "data", "space")),
    ((("model", 2), ("space", 2)), (1, 2, 2), ("data", "space", "model"))])
def test_space_mesh_shapes(ranks, kw, shape, names):
    model = dict(kw).get("model", 1)
    for rank, r in enumerate(ranks):
        m = r["meshes"][kw]
        assert m["shape"] == shape and m["names"] == names
        space_index = (rank // model) % 2
        share = m["share"]
        assert (share.space_index, share.space_count) == (space_index, 2)
        assert share.count == 2 and share.rows_of(33) == (slice(0, 17) if space_index == 0
                                                          else slice(17, 33))
        peers = [p for p in range(4) if p // (2 * model) == rank // (2 * model)
                 and p % model == rank % model]
        assert m["space_ranks"] == peers  # the same samples, the other rows
        assert m["whole_ranks"] == [p for p in range(4) if (p // model) % 2 == space_index]
        assert m["data"].count == 4 // (2 * model)


def test_space_mesh_refusals(ranks):
    assert ranks[0]["errors"] == ["4 devices not divisible by space=3 x dcn=1 x model=1",
                                  "4 devices not divisible by space=2 x dcn=1 x model=3"]
    with pytest.raises(ValueError, match="8 devices not divisible by space=3"):
        pmesh.mesh_shape(8, space=3)
    assert pmesh.mesh_shape(8, space=2, dcn=2) == ((2, 2, 2), ("dcn", "data", "space"))
    assert pmesh.mesh_shape(8, space=2, model=2) == ((2, 2, 2), ("data", "space", "model"))


@pytest.mark.parametrize("case", ["h7_conv", "h7_wide"])
def test_fetch_rows_over_three_ranks(ranks, case):
    shares = [r["fetch3"][case]["share"] for r in ranks[:3]]
    assert shares == [(0, 3), (3, 5), (5, 7)]
    for r in ranks[:3]:
        got = r["fetch3"][case]
        assert got["fetched"]
        assert got["grad_err"] < 1e-6
    assert ranks[3].get("fetch3") is None


@pytest.fixture(scope="module")
def jax_loss(fastscnn_sd):
    """JAX's single-batch Fast-SCNN epoch from the same weights (the JAX
    package's importer); `tests/test_parallel.py` holds its dcn x space and
    space x model meshes to it at rtol 1e-4."""
    images, masks = synthetic_dataset_arrays(N, SIZE, seed=0)
    model = JaxFastSCNN()
    cfg = jax_loop.TrainConfig(epochs=1, batch_size=BATCH, lr=1e-3)
    state = jax_loop.create_train_state(model, cfg, (1, SIZE, SIZE, 3))
    variables = jax_import.import_reference_fastscnn(
        {k: v.numpy() for k, v in fastscnn_sd.items()})
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    idx, valid = batch_indices(N, BATCH, shuffle=False, rng=np.random.default_rng(0))
    _, loss = jax_loop.make_train_epoch(model, cfg)(
        state, jnp.asarray(images), jnp.asarray(masks), jnp.asarray(idx), jnp.asarray(valid))
    return float(loss)


@pytest.mark.parametrize("layout", ["dcn", "model"])
def test_fastscnn_step_matches_one_process_and_jax(ranks, jax_loss, layout):
    loss1, bn1 = ranks[0]["single"]
    np.testing.assert_allclose(loss1, jax_loss, rtol=1e-4)
    for r in ranks:
        loss, bn = r[layout]
        np.testing.assert_allclose(loss, loss1, rtol=1e-4)
        np.testing.assert_allclose(loss, jax_loss, rtol=1e-4)
        for k in bn1:
            np.testing.assert_array_equal(bn[k], ranks[0][layout][1][k])
            np.testing.assert_allclose(bn[k], bn1[k], atol=2e-5, rtol=2e-4)


def test_sharded_robust_unet_epoch_matches_one_process(ranks):
    loss1, (vloss1, agg1) = ranks[1]["unet_single"]
    for r in ranks:
        loss, (vloss, agg) = r["unet"]
        np.testing.assert_allclose(loss, loss1, rtol=1e-5)
        np.testing.assert_allclose(vloss, vloss1, rtol=1e-5)
        assert agg.keys() == agg1.keys()
        for k in agg1:
            np.testing.assert_allclose(agg[k], agg1[k], rtol=1e-5, atol=1e-7)


def test_trainer_validation_matches_one_process(ranks):
    """Loss, pixel accuracy and batch IoU: per image, each rank's pixels'
    sums over the image's pixel count, summed over the ranks."""
    ref = ranks[2]["validate_single"]
    for r in ranks:
        np.testing.assert_allclose(r["validate"], ref, rtol=1e-5, atol=1e-7)


def test_evaluator_on_a_space_mesh_matches_one_process(ranks):
    ref = ranks[3]["evaluator_single"]
    for r in ranks:
        got = r["evaluator"]
        assert got.keys() == ref.keys()
        assert got["inference_batch_size"] == 4 and got["throughput_batch_size"] == 4
        for k in ref:
            if k.startswith(("mean_", "std_")):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert got["avg_inference_time"] > 0 and got["throughput_images_per_sec"] > 0
