"""Labelme polygon JSON -> binary water mask (the port's copy of
`coastline/data/rasterize.py`).

Shapes labelled water/sea/海水/水体 with at least three vertices fill to 1;
a malformed file gives a zero mask (`Main_Final.py:62-78`). Rasterizing is
host-side preprocessing, run once per image when a dataset is built. PIL's
polygon fill is the geometry engine, as in the JAX package, so the masks
agree bit for bit; Pillow is imported only here, so the rest of the port
imports on a machine without it.
"""

import json
from typing import Iterable, Sequence, Tuple

import numpy as np

WATER_LABELS = frozenset({"water", "sea", "海水", "水体"})


def rasterize_polygons(polygons: Iterable[Sequence[Tuple[float, float]]],
                       size: Tuple[int, int]) -> np.ndarray:
    """Fill polygons (lists of (x, y)) into a uint8 {0,1} mask of (W, H) `size`."""
    from PIL import Image, ImageDraw

    mask = Image.new("L", size, 0)
    draw = ImageDraw.Draw(mask)
    for points in polygons:
        pts = [(int(p[0]), int(p[1])) for p in points]
        if len(pts) >= 3:
            draw.polygon(pts, fill=1)
    return np.asarray(mask, dtype=np.uint8)


def mask_from_labelme(label_path, size: Tuple[int, int]) -> np.ndarray:
    """Parse a Labelme JSON and rasterize its water shapes at (W, H) `size`:
    an (H, W) uint8 {0,1} array; an unreadable or malformed file gives a zero
    mask (the reference's silent fallback, `Main_Final.py:77-78`)."""
    try:
        with open(label_path, "r", encoding="utf-8") as f:
            data = json.load(f)
        polys = [s.get("points", []) for s in data.get("shapes", [])
                 if str(s.get("label", "")).lower() in WATER_LABELS]
        return rasterize_polygons(polys, size)
    except ImportError:  # no Pillow: not a malformed file
        raise
    except Exception:
        return np.zeros((size[1], size[0]), dtype=np.uint8)
