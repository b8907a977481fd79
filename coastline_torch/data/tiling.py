"""Scene -> tile batch -> stitched mask on the host (the port's copy of
`coastline/data/tiling.py`).

A scene larger than the model's input is padded to a grid of overlapping
tiles, the tiles run through the model in batches, and the tile outputs
are stitched back at native resolution, each tile cropped by half the
overlap on its inner edges. This numpy path is the reference the device
pipeline (`infer/scene.py`) is held to bit for bit.
"""

from typing import Tuple

import numpy as np


def tile_scene(image: np.ndarray, tile: int = 512, overlap: int = 0
               ) -> Tuple[np.ndarray, dict]:
    """(H, W, C) -> (N, tile, tile, C) + grid info. Edge tiles are
    zero-padded; `overlap` keeps context at seams (stitch crops it back)."""
    h, w = image.shape[:2]
    stride = tile - overlap
    if stride <= 0:
        raise ValueError(
            f"overlap ({overlap}) must be smaller than tile ({tile}); "
            "the stride between tiles would be <= 0")
    ny = max(1, -(-max(h - overlap, 1) // stride))
    nx = max(1, -(-max(w - overlap, 1) // stride))
    tiles = np.zeros((ny * nx, tile, tile, image.shape[2]), image.dtype)
    for iy in range(ny):
        for ix in range(nx):
            y0, x0 = iy * stride, ix * stride
            patch = image[y0:y0 + tile, x0:x0 + tile]
            tiles[iy * nx + ix, :patch.shape[0], :patch.shape[1]] = patch
    return tiles, {"ny": ny, "nx": nx, "h": h, "w": w, "tile": tile, "overlap": overlap}


def stitch_tiles(tile_outputs: np.ndarray, grid: dict) -> np.ndarray:
    """(N, tile, tile[, C]) -> (H, W[, C]): tiles written in row-major
    order, each cropped by half the overlap on the sides it shares with an
    earlier tile."""
    ny, nx, h, w = grid["ny"], grid["nx"], grid["h"], grid["w"]
    tile, overlap = grid["tile"], grid["overlap"]
    stride = tile - overlap
    extra = tile_outputs.shape[3:] if tile_outputs.ndim > 3 else ()
    out = np.zeros((ny * stride + overlap, nx * stride + overlap, *extra),
                   tile_outputs.dtype)
    half = overlap // 2
    for iy in range(ny):
        for ix in range(nx):
            t = tile_outputs[iy * nx + ix]
            y0, x0 = iy * stride, ix * stride
            ys = half if iy > 0 else 0
            xs = half if ix > 0 else 0
            out[y0 + ys:y0 + tile, x0 + xs:x0 + tile] = t[ys:, xs:]
    return out[:h, :w]
