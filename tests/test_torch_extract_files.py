"""File-path extraction (images, directories, scenes) vs the JAX package
(CPU, full-width UNet at 64^2).

Tolerances: masks >= 99.9% of pixels against JAX (float32 logits summed in
another order flip the argmax only at near ties); everything computed from
a given mask (band, contours, PNGs, JSON, GeoJSON) and everything compared
within the port: exact.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from coastline.infer.extract import CoastlineExtractor as JaxExtractor
from coastline_torch.data.synthetic import make_scene
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.utils.torch_import import random_unet_variables

torch.set_num_threads(1)

GT = [500000.0, 10.0, 0.0, 4000000.0, 0.0, -10.0]


@pytest.fixture(scope="module")
def variables():
    return random_unet_variables(seed=1)


@pytest.fixture(scope="module")
def port(variables):
    return CoastlineExtractor(variables=variables, image_size=64, device="cpu")


@pytest.fixture(scope="module")
def jax_ex(variables):
    return JaxExtractor(variables=variables, image_size=64)


def _write_inputs(d):
    """Two PNGs of other sizes than the model's, a 5-band uint8 TIFF and a
    3-channel one (written with PIL), and a 128x192 scene."""
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(80, 64), (50, 100)]):
        img, _, _ = make_scene(rng, size=max(h, w))
        paths.append(str(d / f"img{i}.png"))
        Image.fromarray(img[:h, :w]).save(paths[-1])
    img, _, _ = make_scene(rng, size=64)
    bands = [rng.integers(0, 255, (64, 64), dtype=np.uint8), img[..., 1],
             img[..., 2], img[..., 1], img[..., 0]]
    paths.append(str(d / "five.tif"))
    Image.fromarray(bands[0]).save(paths[-1], save_all=True,
                                   append_images=[Image.fromarray(b) for b in bands[1:]])
    paths.append(str(d / "rgb.tif"))
    Image.fromarray(img).save(paths[-1])
    scene = str(d / "scene_2021.png")
    Image.fromarray(np.tile(img, (2, 3, 1))).save(scene)
    return paths, scene


def _artifacts(out):
    names = sorted(os.listdir(out))
    keys = {n: sorted(json.load(open(os.path.join(out, n)))) for n in names
            if n.endswith((".json", ".geojson"))}
    return names, keys


def _mask_agreement(a_dir, b_dir, name):
    a = np.asarray(Image.open(os.path.join(a_dir, name)))
    b = np.asarray(Image.open(os.path.join(b_dir, name)))
    assert a.shape == b.shape
    return float(np.mean(a == b))


def test_artifact_sets_match_jax(port, jax_ex, tmp_path):
    """The four file entry points write the JAX package's artifact set
    under the same names with the same JSON keys, and their masks agree."""
    paths, scene = _write_inputs(tmp_path)
    runs = {
        "image": lambda ex, out: [ex.extract_coastline_from_image(p, out, 5) for p in paths],
        "batch": lambda ex, out: ex.extract_batch(paths, out, 5, batch_size=2),
        "scene": lambda ex, out: [ex.extract_scene(scene, out, 5, batch=4)],
        "scenes": lambda ex, out: ex.extract_scenes([scene, paths[0]], out, 5, batch=4),
    }
    for kind, run in runs.items():
        got_dir, ref_dir = str(tmp_path / f"port_{kind}"), str(tmp_path / f"jax_{kind}")
        got, ref = run(port, got_dir), run(jax_ex, ref_dir)
        assert [r is None for r in got] == [r is None for r in ref] == [False] * len(got)
        assert _artifacts(got_dir) == _artifacts(ref_dir), kind
        for r, s in zip(got, ref):
            assert r["image_size"] == s["image_size"] and r.keys() == s.keys()
        for name in os.listdir(got_dir):
            if name.endswith("_water_mask.png"):
                assert _mask_agreement(got_dir, ref_dir, name) >= 0.999, (kind, name)


def test_saved_artifacts_equal_jax_for_a_given_mask(port, jax_ex, tmp_path):
    """From one mask, the port's band, contours, PNGs, JSON and GeoJSON equal
    the JAX package's byte for byte (the figure is left out: matplotlib
    writes no two PNGs alike)."""
    yy, xx = np.mgrid[0:96, 0:128]
    mask = ((yy + 0.4 * xx + 10 * np.sin(xx / 9.0)) > 70).astype(np.uint8)
    image = Image.fromarray(np.zeros((96, 128, 3), np.uint8))
    meta = {"geo_transform": GT, "projection": "EPSG:32630"}
    result = port._result("scene.tif", image, meta, mask, 5)
    result["extraction_time"] = "t"
    from coastline.infer.contours import extract_contours as jax_extract_contours
    from coastline.infer.morphology import coastline_band as jax_coastline_band

    ref_band = np.asarray(jax_coastline_band(mask, 5))
    np.testing.assert_array_equal(result["coastline_mask"], ref_band)
    assert result["coastlines"] == jax_extract_contours(ref_band)
    assert result["geo_transform"] == GT and result["projection"] == "EPSG:32630"
    got_dir, ref_dir = tmp_path / "port", tmp_path / "jax"
    port.save_extraction_result(result, str(got_dir))
    jax_ex.save_extraction_result(dict(result), str(ref_dir))
    for name in ("scene_water_mask.png", "scene_coastline_mask.png",
                 "scene_coastlines.json", "scene_coastlines.geojson"):
        assert (got_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name
    assert (got_dir / "scene_analysis.png").exists()
    del result["geo_transform"]
    port.save_extraction_result(result, str(tmp_path / "nogeo"))
    assert not (tmp_path / "nogeo" / "scene_coastlines.geojson").exists()


def test_tif_intake_matches_jax(port, jax_ex, tmp_path):
    """A 5-band TIFF loads as JAX's NIR-R-G enhanced image; a broken one as
    JAX's black 512^2 fallback, and its extraction still succeeds."""
    paths, _ = _write_inputs(tmp_path)
    for p in paths[2:]:
        got, meta = port._load_image_meta(p)
        ref, ref_meta = jax_ex._load_image_meta(p)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        assert meta == ref_meta
    broken = tmp_path / "broken.tif"
    broken.write_bytes(b"not a tiff")
    got, meta = port._load_image_meta(str(broken))
    assert meta is None and got.size == (512, 512) and not np.asarray(got).any()
    result = port.extract_coastline_from_image(str(broken), None, 5)
    assert result is not None and result["image_size"] == [512, 512]
    assert port.predict_mask(got).shape == (512, 512)


def test_extract_batch_matches_per_image(port, tmp_path):
    """Batched directory extraction gives the per-image path's masks, bands
    and contours, with mixed native sizes and a corrupt file (None)."""
    rng = np.random.default_rng(3)
    paths = []
    for i, (w, h) in enumerate([(80, 64), (64, 64), (100, 40)]):
        paths.append(str(tmp_path / f"img{i}.png"))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(paths[-1])
    (tmp_path / "broken.png").write_bytes(b"not an image")
    paths.append(str(tmp_path / "broken.png"))
    single = [port.extract_coastline_from_image(p, None, 5) for p in paths]
    batched = port.extract_batch(paths, None, 5, batch_size=2)
    assert single[3] is None and batched[3] is None
    for s, b in zip(single[:3], batched[:3]):
        np.testing.assert_array_equal(s["water_mask"], b["water_mask"])
        np.testing.assert_array_equal(s["coastline_mask"], b["coastline_mask"])
        assert s["coastlines"] == b["coastlines"] and s["image_size"] == b["image_size"]


def test_extract_batch_degrades_chunk_on_forward_failure(variables, tmp_path):
    """A failed forward gives None for its chunk's images; the run goes on."""
    ex = CoastlineExtractor(variables=variables, image_size=32, device="cpu")
    rng = np.random.default_rng(5)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"img{i}.png"))
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(paths[-1])
    real = ex.predict_masks_batch_async
    calls = []

    def flaky(arr):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("simulated device failure")
        return real(arr)

    ex.predict_masks_batch_async = flaky
    results = ex.extract_batch(paths, None, 5, batch_size=2)
    assert results[0] is None and results[1] is None
    assert results[2] is not None and results[3] is not None


def test_extract_scenes_pipelined_matches_sequential(variables, tmp_path):
    """`extract_scenes` (scene N+1 queued before N is fetched) equals one
    `extract_scene` at a time, across a change of geometry, in input order;
    a missing file mid-list gives None and the rest are written."""
    ex = CoastlineExtractor(variables=variables, image_size=32, device="cpu")
    paths = []
    for i, reps in enumerate([(2, 3, 1), (2, 3, 1), (3, 2, 1)]):
        img, _, _ = make_scene(np.random.default_rng(i), size=32)
        paths.append(str(tmp_path / f"y{2017 + i}.png"))
        Image.fromarray(np.tile(img, reps)).save(paths[-1])
    piped = ex.extract_scenes(paths, dilation_size=5, batch=4, pipeline_depth=2)
    for path, got in zip(paths, piped):
        ref = ex.extract_scene(path, dilation_size=5, batch=4)
        assert got["image_path"] == path and got["image_size"] == ref["image_size"]
        np.testing.assert_array_equal(got["water_mask"], ref["water_mask"])
        np.testing.assert_array_equal(got["coastline_mask"], ref["coastline_mask"])
        assert got["coastlines"] == ref["coastlines"]
    out = str(tmp_path / "out")
    results = ex.extract_scenes([paths[0], str(tmp_path / "missing.png"), paths[2]], out, 5,
                                batch=4)
    assert results[1] is None and results[0] is not None and results[2] is not None
    assert os.path.exists(os.path.join(out, "y2017_water_mask.png"))
    assert os.path.exists(os.path.join(out, "y2019_water_mask.png"))
