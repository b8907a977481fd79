"""Input pipeline (counterpart of `coastline/data/pipeline.py` and the u8 ->
f32 step of `coastline/infer/extract.py:50-53`).

Images are decoded, rasterized and resized once, when the dataset is built,
and held as uint8: on the device (`DeviceDataset`) while they fit its budget,
else on the host (`HostDataset`), whose epochs upload a chunk of batches at
a time (`train/loop.py::_chunk_stream`). Normalization and augmentation run
on the device inside the train step. Pillow is imported only inside the
functions that decode or resize, so the port imports without it.
"""

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from coastline_torch.data.rasterize import mask_from_labelme
from coastline_torch.utils.device import resolve_device

# torchvision Normalize constants, as in the reference training script
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# A uint8 dataset above this many bytes is kept on the host (HostDataset).
# The JAX package's figure, half of a TPU v5e's 16 GB; on an 80 GB card it
# leaves most of the memory to the model. Override through the environment
# or `make_dataset(max_device_bytes=)`.
DEFAULT_MAX_DEVICE_BYTES = int(os.environ.get("COASTLINE_MAX_DEVICE_DATASET_BYTES", 8 << 30))


def normalize_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 -> float32 `(x / 255 - mean) / std`, same op order as
    the JAX package so the f32 inputs agree bit for bit."""
    return normalize01(x_u8.to(torch.float32) / 255.0)


def normalize01(x01: torch.Tensor) -> torch.Tensor:
    """(..., 3) float32 in [0, 1] -> `(x - mean) / std` (the train step
    normalizes after augmenting)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x01.device)
    return (x01 - mean) / std


@dataclass
class DeviceDataset:
    """The whole dataset on one device: images uint8 (N, H, W, 3), masks
    uint8 (N, H, W), {0, 1} water masks or the 2-class UNet's class ids. A
    sample-sharded dataset (`parallel/mesh.py::shard_device_dataset`) holds
    this rank's slab of the padded sample order and `n_valid`, the global
    count of real samples, which `len()` reports."""

    images: torch.Tensor
    masks: torch.Tensor
    paths: Optional[List[str]] = None
    n_valid: Optional[int] = None

    def __len__(self):
        return int(self.n_valid if self.n_valid is not None else self.images.shape[0])

    @staticmethod
    def from_numpy(images: np.ndarray, masks: np.ndarray, paths=None,
                   device="cuda") -> "DeviceDataset":
        dev = resolve_device(device)
        return DeviceDataset(torch.from_numpy(np.ascontiguousarray(images)).to(dev),
                             torch.from_numpy(np.ascontiguousarray(masks)).to(dev), paths)


@dataclass
class HostDataset:
    """A uint8 dataset too large for the device budget, kept in host memory.

    Same surface as DeviceDataset; the train loop gathers `superbatch`
    batches at a time on the host and uploads them, so every batch's
    contents and order equal the resident path's."""

    images: np.ndarray
    masks: np.ndarray
    paths: Optional[List[str]] = None
    superbatch: int = 32  # batches uploaded per chunk

    def __len__(self):
        return int(self.images.shape[0])


def dataset_nbytes(images: np.ndarray, masks: np.ndarray) -> int:
    return int(images.nbytes + masks.nbytes)


def make_dataset(images: np.ndarray, masks: np.ndarray, paths=None, placement: str = "auto",
                 max_device_bytes: Optional[int] = None, superbatch: int = 32,
                 device="cuda"):
    """A DeviceDataset while the uint8 arrays fit the device budget, else a
    HostDataset (`placement='auto'`, with a log line); `placement='device'`
    raises a sized error instead of an allocation failure, `'host'` always
    keeps the arrays on the host."""
    if placement not in ("auto", "device", "host"):
        raise ValueError(f"placement must be auto, device or host, got {placement!r}")
    limit = DEFAULT_MAX_DEVICE_BYTES if max_device_bytes is None else max_device_bytes
    nbytes = dataset_nbytes(images, masks)
    if placement == "device" and nbytes > limit:
        raise ValueError(
            f"dataset is {nbytes / 2**30:.2f} GiB but the device-resident budget is "
            f"{limit / 2**30:.2f} GiB: a whole-dataset upload would run the card out of "
            f"memory once activations are added. Use placement='host' (chunked uploads) "
            f"or raise max_device_bytes / COASTLINE_MAX_DEVICE_DATASET_BYTES.")
    if placement == "host" or (placement == "auto" and nbytes > limit):
        if placement == "auto":
            print(f"dataset ({nbytes / 2**30:.2f} GiB) exceeds the device-resident budget "
                  f"({limit / 2**30:.2f} GiB); using host-resident cache with "
                  f"{superbatch}-batch chunked uploads")
        return HostDataset(np.ascontiguousarray(images), np.ascontiguousarray(masks), paths,
                           superbatch)
    return DeviceDataset.from_numpy(images, masks, paths, device=device)


def load_image_rgb(path: str, fallback_size=(512, 512)):
    """RGB PIL image with the reference's grey fallback for an unreadable
    file (`Main_Final.py:56-60`). Raw GeoTIFFs (`.tif`, `.tiff`) go through
    the NIR-R-G water-enhancement intake (`data/geotiff.py`), the
    production dataset's behaviour (`train_water_segmentation.py:89-174`)."""
    from PIL import Image

    try:
        if path.lower().endswith((".tif", ".tiff")):
            from coastline_torch.data.geotiff import load_tif_enhanced

            return Image.fromarray(load_tif_enhanced(path)[0])
        return Image.open(path).convert("RGB")
    except Exception:  # any unreadable file, PIL's DecompressionBombError too, as the reference
        return Image.new("RGB", fallback_size, (128, 128, 128))


def load_pair(image_path: str, label_path: str, image_size: Tuple[int, int] = (512, 512),
              resample=None) -> Tuple[np.ndarray, np.ndarray]:
    """One (image, mask) pair as `CoastalDataset.__getitem__` builds it
    (`Main_Final.py:40-54`): mask rasterized at native size, image resized
    with `resample` (LANCZOS by default), mask NEAREST. uint8 (H, W, 3) and
    (H, W)."""
    from PIL import Image

    image = load_image_rgb(image_path)
    mask = mask_from_labelme(label_path, image.size)
    image = image.resize(image_size, Image.LANCZOS if resample is None else resample)
    mask_img = Image.fromarray(mask).resize(image_size, Image.NEAREST)
    return np.asarray(image, np.uint8), np.asarray(mask_img, np.uint8)


def pair_files(images_dir: str, labels_dir: str,
               extensions: Tuple[str, ...] = (".png", ".jpg", ".jpeg")
               ) -> Tuple[List[str], List[str]]:
    """Sorted-filename pairing of images with same-stem Labelme JSONs
    (`Main_Final.py:671-686`)."""
    image_files, label_files = [], []
    for name in sorted(os.listdir(images_dir)):
        if name.lower().endswith(extensions):
            label = os.path.join(labels_dir, f"{os.path.splitext(name)[0]}.json")
            if os.path.exists(label):
                image_files.append(os.path.join(images_dir, name))
                label_files.append(label)
    return image_files, label_files


def sequential_split(items: Sequence, fraction: float = 0.8):
    """The comparison protocol's deterministic 80/20 split (`Main_Final.py:692-694`)."""
    split = int(fraction * len(items))
    return list(items[:split]), list(items[split:])


def seeded_split(items: Sequence, test_size: float = 0.2, seed: int = 42):
    """The production trainer's shuffled split (`train_water_segmentation.py:
    810-812`, sklearn `train_test_split` semantics: a permutation by seed,
    the test fraction from its front)."""
    items = list(items)
    order = np.random.RandomState(seed).permutation(len(items))
    n_test = int(np.ceil(test_size * len(items)))
    return [items[i] for i in order[n_test:]], [items[i] for i in order[:n_test]]


def build_dataset(image_paths: Sequence[str], label_paths: Sequence[str],
                  image_size: Tuple[int, int] = (512, 512), with_paths: bool = False,
                  device="cuda"):
    """Decode, rasterize and resize once, stack, and place the result with
    `make_dataset` (on the device while it fits the budget)."""
    pairs = [load_pair(i, l, image_size) for i, l in zip(image_paths, label_paths)]
    return make_dataset(np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
                        list(image_paths) if with_paths else None, device=device)


def prepare_datasets(images_dir: str, labels_dir: str, image_size: Tuple[int, int] = (512, 512),
                     split: str = "sequential", device="cuda"):
    """The comparison protocol's `prepare_dataset` (`Main_Final.py:671-711`;
    `coastline/data/pipeline.py:238-259`): pair the files, split them 80/20
    (`sequential_split`, or `seeded_split` for any other `split`), and build
    the train and val datasets. None when no pair is found."""
    image_files, label_files = pair_files(images_dir, labels_dir)
    if not image_files:
        return None
    pairs = list(zip(image_files, label_files))
    train_pairs, val_pairs = (sequential_split(pairs) if split == "sequential"
                              else seeded_split(pairs))
    return tuple(build_dataset([p[0] for p in part], [p[1] for p in part], image_size,
                               device=device)
                 for part in (train_pairs, val_pairs))
