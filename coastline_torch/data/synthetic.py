"""Synthetic coastal scenes for tests and smoke runs (the port's copy of
`coastline/data/synthetic.py`).

Deterministic (image, mask) pairs that look like the task: a dark "water"
region under a smooth random coastline against a brighter textured "land".
The arrays are numpy plus the shared PIL rasterizer, so one seed gives the
JAX package's arrays bit for bit. `write_synthetic_tree` writes the same
scenes as PNG + Labelme JSON, the reference's on-disk layout.
"""

import json
import os
from typing import Tuple

import numpy as np

from coastline_torch.data.pipeline import DeviceDataset
from coastline_torch.data.rasterize import rasterize_polygons


def random_coast_polygon(rng: np.random.Generator, size: int, n_points: int = 12):
    """A polygon covering the lower part of the frame with a wavy top edge."""
    xs = np.linspace(0, size - 1, n_points)
    base = rng.uniform(0.35, 0.65) * size
    amp = rng.uniform(0.05, 0.18) * size
    phase = rng.uniform(0, 2 * np.pi)
    ys = base + amp * np.sin(2 * np.pi * xs / size * rng.uniform(1, 3) + phase)
    top = [(float(x), float(np.clip(y, 0, size - 1))) for x, y in zip(xs, ys)]
    return top + [(float(size - 1), float(size - 1)), (0.0, float(size - 1))]


def make_scene(rng: np.random.Generator, size: int = 512) -> Tuple[np.ndarray, np.ndarray, list]:
    """(uint8 (H, W, 3) image, uint8 (H, W) mask, polygon points)."""
    poly = random_coast_polygon(rng, size)
    mask = rasterize_polygons([poly], (size, size))
    yy, xx = np.mgrid[0:size, 0:size]
    land = np.stack([120 + 40 * np.sin(xx / 23.0) + 10 * rng.standard_normal((size, size)),
                     110 + 30 * np.cos(yy / 31.0) + 10 * rng.standard_normal((size, size)),
                     90 + 20 * np.sin((xx + yy) / 41.0) + 10 * rng.standard_normal((size, size))],
                    axis=-1)
    water = np.stack([35 + 8 * rng.standard_normal((size, size)),
                      55 + 8 * rng.standard_normal((size, size)),
                      95 + 8 * rng.standard_normal((size, size))], axis=-1)
    img = np.where(mask[..., None] > 0, water, land)
    return np.clip(img, 0, 255).astype(np.uint8), mask, poly


def synthetic_dataset_arrays(n: int, size: int = 512, seed: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Host numpy (images (n, size, size, 3), masks (n, size, size)), uint8."""
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, size) for _ in range(n)]
    return np.stack([s[0] for s in scenes]), np.stack([s[1] for s in scenes])


def synthetic_device_dataset(n: int, size: int = 512, seed: int = 0,
                             device="cuda") -> DeviceDataset:
    images, masks = synthetic_dataset_arrays(n, size, seed)
    return DeviceDataset.from_numpy(images, masks, device=device)


def write_synthetic_tree(root: str, n: int, size: int = 512, seed: int = 0):
    """Write `converted/scene_XXXX.png` and `annotations/scene_XXXX.json`
    under `root` (`Main_Final.py:826-827`); returns the two directories."""
    from PIL import Image

    images_dir = os.path.join(root, "converted")
    labels_dir = os.path.join(root, "annotations")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(labels_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, _, poly = make_scene(rng, size)
        name = f"scene_{i:04d}"
        Image.fromarray(img).save(os.path.join(images_dir, f"{name}.png"))
        label = {"version": "5.0.1",
                 "shapes": [{"label": "water", "points": [[x, y] for x, y in poly],
                             "shape_type": "polygon"}],
                 "imageHeight": size, "imageWidth": size}
        with open(os.path.join(labels_dir, f"{name}.json"), "w") as f:
            json.dump(label, f)
    return images_dir, labels_dir
