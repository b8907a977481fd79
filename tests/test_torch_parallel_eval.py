"""The port's multi-device evaluation and scene serving (CPU, two gloo ranks).

  (e) `Evaluator(mesh=, sharded_data=True)` trains and evaluates from a
      sample-sharded dataset (`tests/test_parallel.py:449-492`): finite
      losses, the throughput batch shard-local and rounded up to the rank
      count, the JSONL log written once (rank 0), `paths` padded with the
      wrap rule; its eval metrics equal one process's `make_eval_epoch` on
      the trained weights (rtol 1e-5: the same valid images, gathered in
      order); on a replicated dataset the two-rank history matches one
      process's (rtol 1e-4, the loss bound of the data-parallel test).
  (f) `predict_scene(mesh=)` over two ranks equals one process's scene bit
      for bit, the mask and the band, for the float32 and the int8
      extractor (`tests/test_parallel.py:581-631`), and at an odd chunk
      batch: the ranks take whole chunks in turn (`infer/scene.py`), so no
      batch needs to divide by the rank count.
"""

import json

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from coastline_torch.data.pipeline import DeviceDataset
from coastline_torch.data.synthetic import synthetic_dataset_arrays
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.models.fastscnn import FastSCNN
from coastline_torch.parallel.launch import run
from coastline_torch.train.loop import (Evaluator, TrainConfig, batch_indices,
                                        make_eval_epoch)
from coastline_torch.utils.torch_import import random_unet_variables

torch.set_num_threads(1)
TILE, BATCH, OVERLAP, BAND = 32, 4, 8, 5


@pytest.fixture(scope="module")
def data():
    images, masks = synthetic_dataset_arrays(11, 32, seed=0)
    return images, masks, [f"img_{i}.png" for i in range(11)]


@pytest.fixture(scope="module")
def evaluated(data, tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("logs")
    return run(workers.evaluator_checks, 2, device="cpu", args=(*data, str(log_dir))), log_dir


def test_evaluator_sharded_data_end_to_end(evaluated, data):
    out, log_dir = evaluated
    images, masks, paths = data
    for r in out:
        s = r["sharded"]
        assert s["len"] == 11 and s["rows"] == 6  # 11 -> padded 12, half a rank
        assert s["paths"] == paths + ["img_0.png"]
        assert all(np.isfinite(s["history"]["train_loss"])) and len(s["history"]["val_iou"]) == 2
        res = s["results"]
        assert res["total_samples"] == 11 and 0.0 <= res["mean_iou"] <= 1.0
        assert res["throughput_batch_size"] == 8 and res["throughput_images_per_sec"] > 0
        assert res["inference_batch_size"] == 4
    assert out[0]["sharded"]["results"] == out[1]["sharded"]["results"]
    with open(log_dir / "sharded.jsonl") as f:
        events = [json.loads(line)["event"] for line in f]
    assert events == ["epoch", "epoch"]  # rank 0 alone writes

    # one process on the trained weights: the same valid images, the same metrics
    model = FastSCNN()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           out[0]["sharded"]["weights"].items()})
    idx, valid = batch_indices(11, 4, shuffle=False, rng=np.random.default_rng(0))
    _, agg = make_eval_epoch(model, TrainConfig(eval_batch_size=4), "cpu")(
        images, masks, idx, valid)
    for k, v in agg.items():
        np.testing.assert_allclose(out[0]["sharded"]["results"][k], v, rtol=1e-5, atol=1e-7)


def test_evaluator_replicated_matches_one_process(evaluated, data):
    out, _ = evaluated
    images, masks, _ = data
    ev = Evaluator(FastSCNN(), TrainConfig(epochs=1, batch_size=4, eval_batch_size=4, lr=1e-3),
                   device="cpu")
    full = DeviceDataset.from_numpy(images, masks, device="cpu")
    hist = ev.train_model(full, full, verbose=False)["history"]
    res = ev.evaluate_model(full, throughput_batch=3)
    for r in out:
        got = r["replicated"]
        for k in hist:
            np.testing.assert_allclose(got["history"][k], hist[k], rtol=1e-4)
        assert got["results"]["throughput_batch_size"] == 4  # 3 rounded up to 2 ranks
        for k in ("mean_iou", "mean_accuracy", "mean_f1_score"):
            np.testing.assert_allclose(got["results"][k], res[k], rtol=1e-4)


@pytest.fixture(scope="module")
def scene():
    return np.random.default_rng(7).integers(0, 255, (70, 90, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def sharded_scene(scene):
    return run(workers.scene_checks, 2, device="cpu", args=(scene, TILE, BATCH, OVERLAP, BAND))


@pytest.fixture(scope="module")
def one_process_scene(scene):
    ex = CoastlineExtractor(variables=random_unet_variables(seed=0), image_size=TILE,
                            device="cpu")
    f32 = ex.predict_scene(scene, batch=BATCH, overlap=OVERLAP, with_band=BAND)
    return {"f32": f32, "int8": ex.quantize().predict_scene(scene, batch=BATCH, overlap=OVERLAP,
                                                           with_band=BAND)}


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_sharded_scene_bit_identical(sharded_scene, one_process_scene, kind):
    ref_mask, ref_band = one_process_scene[kind]
    assert 0 < ref_mask.mean() < 1 and ref_band.any()
    for r in sharded_scene:
        mask, band = r[kind]
        np.testing.assert_array_equal(mask, ref_mask)
        np.testing.assert_array_equal(band, ref_band)


def test_sharded_scene_odd_batch_and_cache(sharded_scene, one_process_scene, scene):
    ex = CoastlineExtractor(variables=random_unet_variables(seed=0), image_size=TILE,
                            device="cpu")
    odd = ex.predict_scene(scene, batch=BATCH + 1, overlap=OVERLAP)  # 12 tiles: 3 chunks
    for r in sharded_scene:
        np.testing.assert_array_equal(r["f32_mask"], one_process_scene["f32"][0])
        np.testing.assert_array_equal(r["odd_batch"], odd)
        assert r["cached"] == 3  # one function a (geometry, batch, band) on this mesh
