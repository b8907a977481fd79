"""Scene tiling and the device scene pipeline vs the host path and the JAX
package (CPU).

Tolerances:
  * tiling, stitching, and the device path against the host path: exact
    (the same integer work on the same tiles; the forward runs on the same
    tiles in the same batches);
  * port against JAX at the model: masks agree on >= 99.9% of pixels (both
    compute float32 logits whose sums differ in order, which flips the
    argmax only where the two class logits nearly tie); the band of a given
    mask: exact.
"""

import numpy as np
import pytest
import torch

from coastline.data.tiling import stitch_tiles as jax_stitch_tiles
from coastline.data.tiling import tile_scene as jax_tile_scene
from coastline.infer.extract import CoastlineExtractor as JaxExtractor
from coastline.infer.morphology import coastline_band as jax_coastline_band
from coastline_torch.data.tiling import stitch_tiles, tile_scene
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.infer.morphology import coastline_band
from coastline_torch.infer.scene import build_scene_fn
from coastline_torch.utils.torch_import import random_unet_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def variables():
    return random_unet_variables(seed=1)


@pytest.mark.parametrize("shape", [(20, 17, 3), (150, 200, 3), (64, 64, 1), (33, 97, 3)])
@pytest.mark.parametrize("overlap", [0, 8])
def test_tile_and_stitch_match_jax(shape, overlap):
    rng = np.random.default_rng(sum(shape) + overlap)
    scene = rng.integers(0, 256, shape, dtype=np.uint8)
    tiles, grid = tile_scene(scene, 32, overlap)
    ref_tiles, ref_grid = jax_tile_scene(scene, 32, overlap)
    assert grid == ref_grid
    np.testing.assert_array_equal(tiles, ref_tiles)
    outs = rng.integers(0, 256, tiles.shape[:3], dtype=np.uint8)  # distinct per tile
    np.testing.assert_array_equal(stitch_tiles(outs, grid), jax_stitch_tiles(outs, ref_grid))
    np.testing.assert_array_equal(stitch_tiles(tiles, grid), scene)  # round trip, with C
    with pytest.raises(ValueError, match="overlap"):
        tile_scene(scene, tile=32, overlap=32)


def _random_tile_predict(x_u8):
    """A stand-in forward that depends on every tile's content and position
    inside the tile, so a tile or crop taken from the wrong place shows."""
    lane = torch.arange(x_u8.shape[1], dtype=torch.int32)
    return ((x_u8[..., 0].int() + x_u8[..., 1].int() * 3 + lane[:, None] + 2 * lane[None, :])
            % 251).to(torch.uint8)


@pytest.mark.parametrize("shape,batch,overlap", [
    ((150, 200, 3), 8, 16),  # final chunk padded
    ((130, 97, 3), 4, 8),  # odd width
    ((32, 32, 3), 8, 4),  # one tile, n < batch
    ((200, 150, 3), 5, 0),  # zero overlap
    ((20, 27, 3), 3, 6),  # smaller than the tile
])
def test_device_stitch_equals_host_stitch(shape, batch, overlap):
    """The device pipeline's tile cut and one-gather stitch equal
    `tile_scene` + `stitch_tiles` bit for bit, for any tile outputs."""
    scene = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    got = build_scene_fn(_random_tile_predict, *shape, 32, overlap, batch)(torch.from_numpy(scene))
    tiles, grid = tile_scene(scene, 32, overlap)
    ref = stitch_tiles(_random_tile_predict(torch.from_numpy(tiles)).numpy(), grid)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


def test_predict_scene_device_equals_host_with_band(variables):
    """The extractor's two scene paths on the full-width UNet: masks and
    bands bit for bit, the fused band equal to a separate `coastline_band`,
    and one batch shape for every forward of the host path."""
    ex = CoastlineExtractor(variables=variables, image_size=32, device="cpu")
    seen = []
    predict = ex.predict_masks_batch
    ex.predict_masks_batch = lambda a: (seen.append(a.shape), predict(a))[1]
    rng = np.random.default_rng(1)
    for shape, batch, overlap in [((70, 90, 3), 8, 8), ((20, 27, 3), 3, 4)]:
        scene = rng.integers(0, 256, shape, dtype=np.uint8)
        mask, band = ex.predict_scene(scene, batch=batch, overlap=overlap, with_band=5)
        host_mask, host_band = ex.predict_scene(scene, batch=batch, overlap=overlap,
                                                device_pipeline=False, with_band=5)
        np.testing.assert_array_equal(mask, host_mask)
        np.testing.assert_array_equal(band, host_band)
        np.testing.assert_array_equal(band, coastline_band(mask, 5, device="cpu").numpy())
        np.testing.assert_array_equal(
            ex.predict_scene(scene, batch=batch, overlap=overlap), mask)
        assert mask.shape == shape[:2] and 0 < mask.mean() < 1
    assert {s[0] for s in seen} == {8, 3}
    assert len(seen) == 2 + 1  # 12 tiles in chunks of 8, then one tile


class _ThresholdExtractor(CoastlineExtractor):
    """An extractor whose forward is a local function of the green channel
    (no model): a 5x5 box mean thresholded, or a plain threshold."""

    def __init__(self, tile, box=True):  # skips the model entirely
        self.image_size = tile
        self.device = torch.device("cpu")
        self._predict_fn = self.box_predict if box else (
            lambda x: (x[..., 1] > 127).to(torch.uint8))

    @staticmethod
    def box_predict(x_u8):
        x = torch.nn.functional.pad(x_u8[..., 1].float(), (2, 2, 2, 2))
        acc = sum(x[:, dy:dy + x_u8.shape[1], dx:dx + x_u8.shape[2]]
                  for dy in range(5) for dx in range(5))
        return (acc / 25.0 > 127.0).to(torch.uint8)


def test_predict_scene_seam_consistency():
    """A coastline crossing tile boundaries stitches without seams: with a
    5x5-neighbourhood predictor and the default overlap, every output
    pixel's neighbourhood lies inside the tile that contributes it, so both
    scene paths equal the predictor applied to the whole scene
    (`tests/test_infer.py::test_predict_scene_seam_consistency`)."""
    h, w, tile = 300, 420, 128
    yy, xx = np.mgrid[0:h, 0:w]
    water = (yy * 0.7 + xx * 0.45 + 30 * np.sin(xx / 17.0)) > 260
    scene = np.zeros((h, w, 3), np.uint8)
    scene[..., 1] = np.where(water, 200, 40)
    ex = _ThresholdExtractor(tile)
    whole = ex.box_predict(torch.from_numpy(scene)[None])[0].numpy()
    for device_pipeline in (True, False):
        stitched = ex.predict_scene(scene, batch=4, device_pipeline=device_pipeline)
        assert stitched.shape == (h, w)
        np.testing.assert_array_equal(stitched, whole)
    stride, half = tile - 16, 8  # default overlap 128 // 8
    assert any(water[:, s].any() and (~water[:, s]).any()
               for s in range(stride + half, w, stride))


def test_predict_scene_default_overlap_scales_with_tile(monkeypatch):
    """The default overlap is image_size // 8 on both paths."""
    from coastline_torch.infer import scene as scene_module

    seen = []
    build = scene_module.build_scene_fn
    monkeypatch.setattr(scene_module, "build_scene_fn",
                        lambda *a, **k: (seen.append(a[5]), build(*a, **k))[1])
    scene = np.random.default_rng(0).integers(0, 255, (100, 130, 3), dtype=np.uint8)
    for tile in (32, 64):
        ex = _ThresholdExtractor(tile, box=False)
        mask = ex.predict_scene(scene)
        np.testing.assert_array_equal(
            ex.predict_scene(scene, overlap=tile // 8, device_pipeline=False), mask)
        assert mask.shape == (100, 130)
    assert seen == [4, 8]


def test_predict_scene_matches_jax(variables):
    """Port against the JAX package's `predict_scene` (device pipeline) at
    image_size 64 with the same variables; the band of the JAX mask through
    the port equals JAX's `coastline_band` exactly."""
    scene = np.random.default_rng(4).integers(0, 256, (150, 200, 3), dtype=np.uint8)
    ref_mask, ref_band = JaxExtractor(variables=variables, image_size=64).predict_scene(
        scene, batch=4, with_band=5)
    mask, band = CoastlineExtractor(variables=variables, image_size=64,
                                    device="cpu").predict_scene(scene, batch=4, with_band=5)
    assert mask.shape == ref_mask.shape == (150, 200)
    assert np.mean(mask == np.asarray(ref_mask)) >= 0.999
    assert 0.02 < mask.mean() < 0.98
    np.testing.assert_array_equal(coastline_band(np.asarray(ref_mask), 5, device="cpu").numpy(),
                                  np.asarray(ref_band))
    np.testing.assert_array_equal(band, np.asarray(jax_coastline_band(mask, 5)))
