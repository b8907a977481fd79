"""GeoTIFF intake: band combination and water enhancement (the port's copy
of `coastline/data/geotiff.py`; the reference's `TIFToImageConverter`,
`tif_to_image.py:20-270`).

  * band selection: >= 5 bands -> NIR-Red-Green (bands[4], [3], [2]); else
    >= 3 -> bands[2], [1], [0]; else grey replicated (`tif_to_image.py:79-98`);
  * enhancement: per-band 2-98 percentile stretch to 0..255, then band-0
    pixels below 100 darkened by x0.7 to bring out water (`:139-171`);
  * display normalization: the stretch alone (`predict_coastline.py:514-550`).

Rasters are read through GDAL, else rasterio, else PIL (multi-frame TIFF),
whichever imports first. Only GDAL and rasterio give a geotransform, which
the GeoJSON artifact needs. The math is numpy on the host: the percentiles
depend on the data.
"""

from typing import Tuple

import numpy as np

_BACKEND = None
try:  # pragma: no cover - environment dependent
    from osgeo import gdal  # type: ignore

    _BACKEND = "gdal"
except ImportError:
    try:
        import rasterio  # type: ignore  # noqa: F401

        _BACKEND = "rasterio"
    except ImportError:
        _BACKEND = "pil"


def read_bands(path: str, max_bands: int = 6) -> Tuple[np.ndarray, dict]:
    """Read up to `max_bands` raster bands -> ((C, H, W) array, metadata)."""
    if _BACKEND == "gdal":
        ds = gdal.Open(path)
        if ds is None:
            raise IOError(f"cannot open {path}")
        bands = [ds.GetRasterBand(i).ReadAsArray()
                 for i in range(1, min(ds.RasterCount, max_bands) + 1)]
        meta = {"size": [ds.RasterXSize, ds.RasterYSize], "bands_count": ds.RasterCount,
                "geo_transform": ds.GetGeoTransform(), "projection": ds.GetProjection(),
                "backend": "gdal"}
        return np.asarray(bands), meta
    if _BACKEND == "rasterio":
        import rasterio

        with rasterio.open(path) as ds:
            count = min(ds.count, max_bands)
            bands = ds.read(list(range(1, count + 1)))
            # rasterio's Affine iterates (a, b, c, d, e, f) = (px_w, rot, x0,
            # rot, px_h, y0); "geo_transform" is GDAL's GetGeoTransform()
            # order (x0, px_w, rot, y0, rot, px_h) whatever the backend
            a, b, c, d, e, f = list(ds.transform)[:6]
            meta = {"size": [ds.width, ds.height], "bands_count": ds.count,
                    "geo_transform": [c, a, b, f, d, e],
                    "projection": str(ds.crs) if ds.crs else None,  # not "None"
                    "backend": "rasterio"}
        return np.asarray(bands), meta
    from PIL import Image  # multi-frame or multi-channel TIFF

    with Image.open(path) as im:
        frames = []
        try:
            i = 0
            while i < max_bands:
                im.seek(i)
                frames.append(np.asarray(im))
                i += 1
        except EOFError:
            pass
    if len(frames) == 1 and frames[0].ndim == 3:
        bands = np.transpose(frames[0], (2, 0, 1))[:max_bands]
    else:
        bands = np.asarray([f if f.ndim == 2 else f[..., 0] for f in frames])
    meta = {"size": [bands.shape[2], bands.shape[1]], "bands_count": bands.shape[0],
            "geo_transform": None, "projection": None, "backend": "pil"}
    return bands, meta


def combine_bands(bands: np.ndarray, enhance_water: bool = True) -> Tuple[np.ndarray, str]:
    """(C, H, W) -> (H, W, 3) band combination and its description
    (`tif_to_image.py:79-98`)."""
    c = bands.shape[0]
    if c >= 3:
        if enhance_water and c >= 4:
            try:
                return np.dstack([bands[4], bands[3], bands[2]]), "NIR-Red-Green (water enhanced)"
            except IndexError:
                return np.dstack([bands[2], bands[1], bands[0]]), "standard RGB"
        return np.dstack([bands[2], bands[1], bands[0]]), "standard RGB"
    g = bands[0]
    return np.dstack([g, g, g]), "grayscale"


def percentile_stretch(band: np.ndarray, lo: float = 2, hi: float = 98) -> np.ndarray:
    p_lo, p_hi = np.percentile(band, [lo, hi])
    if p_hi - p_lo <= 0:
        return np.clip(band, 0, 255)
    return np.clip((band - p_lo) / (p_hi - p_lo) * 255.0, 0, 255)


def enhance_image(rgb: np.ndarray, enhance_water: bool = True) -> np.ndarray:
    """Per-band stretch + water darkening (`tif_to_image.py:139-171`)."""
    enhanced = np.zeros_like(rgb, dtype=np.float64)
    for i in range(rgb.shape[2]):
        stretched = percentile_stretch(rgb[:, :, i].astype(np.float64))
        if enhance_water and i == 0:
            stretched = np.where(stretched < 100, stretched * 0.7, stretched)
        enhanced[:, :, i] = stretched
    return enhanced.astype(np.uint8)


def normalize_for_display(rgb: np.ndarray) -> np.ndarray:
    """Stretch-only normalization, no water darkening
    (`predict_coastline.py:514-550`)."""
    if rgb.shape[2] < 3:
        g = rgb[:, :, 0]
        rgb = np.dstack([g, g, g])
    out = np.zeros((rgb.shape[0], rgb.shape[1], 3), np.float64)
    for i in range(3):
        out[:, :, i] = percentile_stretch(rgb[:, :, i].astype(np.float64))
    return out.astype(np.uint8)


def compute_ndwi(path: str):
    """NDWI = (green - nir) / (green + nir + 1e-8) from raster bands 4 (NIR)
    and 2 (green), 1-indexed (`predict_coastline.py:789-800`): an (H, W)
    float array, or None when the raster has < 4 bands or cannot be read."""
    try:
        bands, meta = read_bands(path)
    except Exception:
        return None
    if meta.get("bands_count", bands.shape[0]) < 4 or bands.shape[0] < 4:
        return None
    nir = bands[3].astype(np.float64)
    green = bands[1].astype(np.float64)
    return (green - nir) / (green + nir + 1e-8)


def load_tif_enhanced(path: str) -> Tuple[np.ndarray, dict]:
    """Bands -> water combination -> enhancement: (H, W, 3) uint8 and the
    metadata (the model-input path, `predict_coastline.py:425-471`)."""
    bands, meta = read_bands(path)
    rgb, combo = combine_bands(bands, enhance_water=True)
    meta["enhancement_type"] = combo
    return enhance_image(rgb, enhance_water=True), meta
