"""The GeoTIFF intake vs the JAX package (CPU): TIFFs this test writes with
PIL, and the GDAL and rasterio readers through stubs (neither is installed
here). Every comparison is exact: the same numpy arithmetic on the same
bands."""

import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from coastline.data import geotiff as jax_geotiff
from coastline.data import pipeline as jax_pipeline
from coastline_torch.data import geotiff, pipeline

torch.set_num_threads(1)


def _write_tifs(d):
    rng = np.random.default_rng(0)
    five_u8 = [rng.integers(0, 255, (40, 50), dtype=np.uint8) for _ in range(5)]
    five_u16 = [rng.integers(0, 4000, (40, 50)).astype(np.uint16) for _ in range(5)]
    paths = {}
    for name, frames in (("five_u8", five_u8), ("five_u16", five_u16)):
        paths[name] = str(d / f"{name}.tif")
        ims = [Image.fromarray(f) for f in frames]
        ims[0].save(paths[name], save_all=True, append_images=ims[1:])
    paths["rgb"] = str(d / "rgb.tif")
    Image.fromarray(rng.integers(0, 255, (30, 20, 3), dtype=np.uint8)).save(paths["rgb"])
    paths["grey"] = str(d / "grey.tif")
    Image.fromarray(rng.integers(0, 255, (16, 24), dtype=np.uint8)).save(paths["grey"])
    return paths


@pytest.mark.parametrize("name", ["five_u8", "five_u16", "rgb", "grey"])
def test_intake_matches_jax(tmp_path, name):
    path = _write_tifs(tmp_path)[name]
    bands, meta = geotiff.read_bands(path)
    ref_bands, ref_meta = jax_geotiff.read_bands(path)
    assert bands.dtype == ref_bands.dtype and meta == ref_meta and meta["backend"] == "pil"
    np.testing.assert_array_equal(bands, ref_bands)
    for water in (True, False):
        rgb, combo = geotiff.combine_bands(bands, water)
        ref_rgb, ref_combo = jax_geotiff.combine_bands(bands, water)
        assert combo == ref_combo
        np.testing.assert_array_equal(rgb, ref_rgb)
        np.testing.assert_array_equal(geotiff.enhance_image(rgb, water),
                                      jax_geotiff.enhance_image(rgb, water))
    np.testing.assert_array_equal(geotiff.normalize_for_display(rgb),
                                  jax_geotiff.normalize_for_display(rgb))
    np.testing.assert_array_equal(geotiff.percentile_stretch(bands[0].astype(np.float64), 5, 90),
                                  jax_geotiff.percentile_stretch(bands[0].astype(np.float64), 5, 90))
    got, ref = geotiff.compute_ndwi(path), jax_geotiff.compute_ndwi(path)
    assert (got is None) == (ref is None) == (bands.shape[0] < 4)
    if got is not None:
        np.testing.assert_array_equal(got, ref)
    rgb, meta = geotiff.load_tif_enhanced(path)
    ref_rgb, ref_meta = jax_geotiff.load_tif_enhanced(path)
    assert rgb.dtype == np.uint8 and meta == ref_meta
    np.testing.assert_array_equal(rgb, ref_rgb)


def test_constant_band_and_unreadable_file(tmp_path):
    band = np.full((8, 8), 7.0)
    np.testing.assert_array_equal(geotiff.percentile_stretch(band), band)
    assert geotiff.compute_ndwi(str(tmp_path / "missing.tif")) is None


class _RasterioDataset:
    """What `rasterio.open` gives: 5 bands, an affine, a CRS."""

    count, width, height = 5, 6, 4
    transform = (10.0, 0.5, 500000.0, 0.25, -10.0, 4000000.0, 0.0, 0.0, 1.0)

    def __init__(self, crs):
        self.crs = crs

    def read(self, indexes):
        return np.stack([np.full((4, 6), i, np.uint16) for i in indexes])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _GdalBand:
    def __init__(self, i):
        self.i = i

    def ReadAsArray(self):
        return np.full((4, 6), self.i, np.uint16)


class _GdalDataset:
    RasterCount, RasterXSize, RasterYSize = 7, 6, 4

    def GetRasterBand(self, i):
        return _GdalBand(i)

    def GetGeoTransform(self):
        return (500000.0, 10.0, 0.0, 4000000.0, 0.0, -10.0)

    def GetProjection(self):
        return "PROJCS[UTM]"


@pytest.mark.parametrize("crs", ["EPSG:32630", None])
def test_rasterio_affine_is_reordered_to_gdal_order(monkeypatch, crs):
    """rasterio's Affine (a, b, c, d, e, f) becomes GDAL's (c, a, b, f, d, e),
    and a missing CRS is None, not "None"; the JAX reader agrees."""
    stub = types.ModuleType("rasterio")
    stub.open = lambda path: _RasterioDataset(crs)
    monkeypatch.setitem(sys.modules, "rasterio", stub)
    for module in (geotiff, jax_geotiff):
        monkeypatch.setattr(module, "_BACKEND", "rasterio")
    bands, meta = geotiff.read_bands("x.tif", max_bands=3)
    ref_bands, ref_meta = jax_geotiff.read_bands("x.tif", max_bands=3)
    assert meta["geo_transform"] == [500000.0, 10.0, 0.5, 4000000.0, 0.25, -10.0]
    assert meta["projection"] == crs and meta["bands_count"] == 5 and meta["size"] == [6, 4]
    assert meta == ref_meta
    np.testing.assert_array_equal(bands, ref_bands)
    assert bands.shape == (3, 4, 6)


def test_gdal_reader_matches_jax(monkeypatch):
    gdal = types.SimpleNamespace(Open=lambda path: None if path == "bad" else _GdalDataset())
    for module in (geotiff, jax_geotiff):
        monkeypatch.setattr(module, "_BACKEND", "gdal")
        monkeypatch.setattr(module, "gdal", gdal, raising=False)
    bands, meta = geotiff.read_bands("x.tif")
    ref_bands, ref_meta = jax_geotiff.read_bands("x.tif")
    assert meta == ref_meta and meta["bands_count"] == 7 and bands.shape == (6, 4, 6)
    np.testing.assert_array_equal(bands, ref_bands)
    with pytest.raises(IOError):
        geotiff.read_bands("bad")


def test_pipeline_loaders_take_tifs_as_jax_does(tmp_path):
    """`load_image_rgb` and `load_pair` on a .tif give the JAX package's
    enhanced RGB, and its grey fallback for an empty file."""
    paths = _write_tifs(tmp_path)
    label = tmp_path / "a.json"
    label.write_text('{"shapes": [{"label": "water", "points": [[0, 0], [30, 0], [30, 20]]}]}')
    empty = tmp_path / "empty.tif"
    empty.write_bytes(b"")
    for path in [*paths.values(), str(empty)]:
        got, ref = pipeline.load_image_rgb(path), jax_pipeline.load_image_rgb(path)
        assert got.mode == ref.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        for a, b in zip(pipeline.load_pair(path, str(label), (24, 20)),
                        jax_pipeline.load_pair(path, str(label), (24, 20))):
            np.testing.assert_array_equal(a, b)
    grey = pipeline.load_image_rgb(str(empty))
    assert grey.size == (512, 512) and (np.asarray(grey) == 128).all()
