"""Port serving path vs the JAX package (CPU, 64^2, full-width UNet).

Tolerances:
  * masks: >= 99.9% of pixels agree. Both sides compute float32 logits
    whose sums differ in order (~1e-6 relative), which can flip the argmax
    only where the two class logits nearly tie;
  * coastline band and contours: exact (integer work, same algorithm).
"""

import numpy as np
import pytest
import torch

from coastline.infer.contours import extract_contours as jax_extract_contours
from coastline.infer.extract import CoastlineExtractor as JaxExtractor
from coastline.infer.morphology import coastline_band as jax_coastline_band
from coastline_torch.infer.contours import extract_contours
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.infer.morphology import coastline_band, dilate
from coastline_torch.infer.server import BatchedPredictor
from coastline_torch.utils.torch_import import random_unet_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def variables():
    return random_unet_variables(seed=1)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("tta", [False, True])
def test_predict_masks_batch_matches_jax(variables, images, tta):
    ref = JaxExtractor(variables=variables, image_size=64, tta=tta).predict_masks_batch(images)
    ex = CoastlineExtractor(variables=variables, image_size=64, tta=tta, device="cpu")
    got = ex.predict_masks_batch(images)
    assert got.dtype == np.uint8 and got.shape == (2, 64, 64)
    assert set(np.unique(got)) <= {0, 1}
    assert np.mean(got == ref) >= 0.999
    assert 0.02 < got.mean() < 0.98  # the masks are not constant


def test_predict_rejects_bad_batches(variables):
    ex = CoastlineExtractor(variables=variables, image_size=64, device="cpu")
    with pytest.raises(ValueError):
        ex.predict_masks_batch(np.zeros((2, 64, 64, 4), np.uint8))
    with pytest.raises(ValueError):
        ex.predict_masks_batch(np.zeros((2, 64, 64, 3), np.float32))


def test_torch_checkpoint_loads_strict(variables, tmp_path):
    """A reference-layout `.pth` (written by the JAX package's exporter)
    serves the same masks as the same weights handed over as variables."""
    from coastline.utils.torch_import import save_reference_pth

    path = str(tmp_path / "unet.pth")
    save_reference_pth(variables, path, arch="unet")
    x = np.random.default_rng(3).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    a = CoastlineExtractor(torch_checkpoint=path, image_size=32, device="cpu")
    b = CoastlineExtractor(variables=variables, image_size=32, device="cpu")
    np.testing.assert_array_equal(a.predict_masks_batch(x), b.predict_masks_batch(x))


def _disk_masks():
    yy, xx = np.mgrid[0:96, 0:128]
    disk = (((yy - 48) ** 2 + (xx - 60) ** 2) < 30 ** 2).astype(np.uint8)
    rng = np.random.default_rng(4)
    speckle = (rng.random((96, 128)) < 0.01).astype(np.uint8)
    return disk, np.maximum(disk, speckle)


@pytest.mark.parametrize("scale", [1, 255])
@pytest.mark.parametrize("size", [5, 20])
def test_coastline_band_matches_jax(scale, size):
    for mask in _disk_masks():
        ref = np.asarray(jax_coastline_band(mask * scale, size))
        got = coastline_band(mask * scale, size, device="cpu")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)


def test_coastline_band_batch_and_tensor_input():
    masks = np.stack(_disk_masks())
    got = coastline_band(torch.from_numpy(masks), 20, device="cpu").numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], np.asarray(jax_coastline_band(masks[i], 20)))


def test_dilate_binarizes_grayscale():
    gray = np.random.default_rng(5).integers(0, 4, (40, 40), dtype=np.uint8)
    np.testing.assert_array_equal(dilate(gray, 7, device="cpu").numpy(),
                                  dilate((gray > 0).astype(np.uint8), 7, device="cpu").numpy())


@pytest.mark.parametrize("backend", ["python", "cv2"])
def test_extract_contours_matches_jax(backend):
    for mask in _disk_masks():
        band = coastline_band(mask, 5, device="cpu")
        ref = jax_extract_contours(np.asarray(jax_coastline_band(mask, 5)), backend=backend)
        assert extract_contours(band, backend=backend) == ref
    assert len(extract_contours(coastline_band(_disk_masks()[0], 5, device="cpu"))) == 1


def test_server_returns_predict_masks_batch_masks(variables):
    ex = CoastlineExtractor(variables=variables, image_size=32, device="cpu")
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    with ex.serve(batch_size=4, max_delay_ms=50) as srv:
        masks = srv.predict_many(list(images))
    padded = np.concatenate([images, np.zeros((2, 32, 32, 3), np.uint8)])
    ref = np.concatenate([ex.predict_masks_batch(padded[:4]), ex.predict_masks_batch(padded[4:])])
    for i in range(6):
        np.testing.assert_array_equal(masks[i], ref[i])


def test_server_batches_and_rejects_after_close():
    calls = []

    def predict(batch):
        calls.append(batch.shape[0])
        return (batch[..., 0] > 127).astype(np.uint8)

    rng = np.random.default_rng(7)
    images = [rng.integers(0, 255, (16, 16, 3), dtype=np.uint8) for _ in range(5)]
    srv = BatchedPredictor(predict, batch_size=4, image_size=16, max_delay_ms=20)
    try:
        masks = srv.predict_many(images)
        with pytest.raises(ValueError):
            srv.submit(np.zeros((8, 8, 3), np.uint8))
    finally:
        srv.close()
    for im, m in zip(images, masks):
        np.testing.assert_array_equal(m, (im[..., 0] > 127).astype(np.uint8))
    assert calls and all(c == 4 for c in calls)
    with pytest.raises(RuntimeError):
        srv.submit(images[0])
