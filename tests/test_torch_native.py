"""The port's native contour tracer (CPU): built with g++ into the build
directory, bit-identical to the port's Python tracer and to the JAX
package's native one, and selected by `extract_contours`. Every comparison
is exact: the same integer walk and the same RDP keep set."""

import os

import numpy as np
import pytest
import torch

from coastline import native as jax_native
from coastline.infer.contours import extract_contours as jax_extract_contours
from coastline_torch import native
from coastline_torch.infer.contours import _moore_trace, _rdp, extract_contours
from coastline_torch.infer.morphology import coastline_band
from coastline_torch.kernels._build import BUILD_DIR

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    path = native.build_library(verbose=True)
    assert path is not None, "g++ failed to build coastline_torch/native/contours.cpp"
    assert os.path.dirname(path) == str(BUILD_DIR)
    assert native.load_native() is not None
    assert jax_native.load_native() is not None
    return path


def _blob_mask(seed, h=96, w=128, n_blobs=4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((h, w), np.uint8)
    for _ in range(n_blobs):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(3, 18)
        m |= (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.uint8)
    return m


def _edge_masks():
    one = np.zeros((4, 4), np.uint8)
    one[2, 1] = 1
    line = np.zeros((8, 8), np.uint8)
    line[0, :] = 1
    line[:, 7] = 1  # an L along two borders, one 4-connected component
    speckle = (np.random.default_rng(9).random((40, 50)) < 0.3).astype(np.uint8)
    return [np.zeros((5, 7), np.uint8), one, np.ones((6, 9), np.uint8), line, speckle]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", range(8 + 5))
def test_trace_bit_parity(lib, case):
    m = _blob_mask(case) if case < 8 else _edge_masks()[case - 8]
    got = native.moore_trace(m)
    _equal(got, _moore_trace(m))
    _equal(got, jax_native.moore_trace(m))
    _equal(native.moore_trace(m * 255), got)  # 0/255 masks


def test_rdp_bit_parity(lib):
    rng = np.random.default_rng(0)
    cases = [rng.integers(0, 100, (n, 2)).astype(np.int32) for n in (3, 4, 17, 256)]
    cases += [np.full((9, 2), 5, np.int32),  # zero-length segments throughout
              np.array([[0, 0], [46341, 46341], [92682, 0]], np.int32)]  # int32 cross wraps
    for pts in cases:
        for eps in (0.0, 0.5, 2.0, 10.0):
            got = native.rdp(pts, eps)
            np.testing.assert_array_equal(got, _rdp(pts, eps))
            np.testing.assert_array_equal(got, jax_native.rdp(pts, eps))
    np.testing.assert_array_equal(native.rdp(cases[-1], 10.0), cases[-1])  # middle kept
    short = np.array([[0, 0], [3, 4]], np.int32)
    np.testing.assert_array_equal(native.rdp(short, 1.0), short)


@pytest.mark.parametrize("min_points,epsilon_frac", [(10, 0.002), (4, 0.02), (30, 0.0)])
def test_extract_contours_backends_agree_with_jax(lib, min_points, epsilon_frac):
    """Each backend, forced, gives the JAX package's polylines at default and
    non-default `min_points` / `epsilon_frac`; native equals python."""
    yy, xx = np.mgrid[0:128, 0:160]
    disk = (((yy - 64) ** 2 + (xx - 70) ** 2) < 40 ** 2).astype(np.uint8)
    for mask in (disk, _blob_mask(3, 128, 160, 6)):
        band = coastline_band(mask, 5, device="cpu")
        by_backend = {}
        for backend in ("native", "python", "cv2"):
            got = extract_contours(band, min_points=min_points, epsilon_frac=epsilon_frac,
                                   backend=backend)
            assert got == jax_extract_contours(band.numpy(), min_points, epsilon_frac,
                                               backend=backend), backend
            by_backend[backend] = got
        assert by_backend["native"] == by_backend["python"]
        assert extract_contours(band, min_points=min_points, epsilon_frac=epsilon_frac) \
            == by_backend["cv2"]  # auto takes cv2 where it imports
    assert len(extract_contours(coastline_band(disk, 5, device="cpu"), backend="native")) == 1


def test_forced_backends_that_are_missing_raise(monkeypatch):
    import coastline_torch.infer.contours as contours

    band = np.zeros((8, 8), np.uint8)
    monkeypatch.setattr(contours, "_HAS_CV2", False)
    with pytest.raises(RuntimeError, match="cv2"):
        extract_contours(band, backend="cv2")
    monkeypatch.setattr(native, "moore_trace", lambda mask: None)
    with pytest.raises(RuntimeError, match="native"):
        extract_contours(band, backend="native")
    assert extract_contours(band) == []  # auto falls back to python
    with pytest.raises(ValueError):
        extract_contours(band, backend="gpu")


def test_ownership_check_refuses_a_foreign_directory(tmp_path, monkeypatch):
    """A library is built or loaded only from a directory the current user
    owns: the same directory under another uid is refused."""
    mine = tmp_path / "build"
    assert native.owned_dir(mine) == str(mine) and mine.is_dir()
    uid = os.getuid()
    monkeypatch.setattr(os, "getuid", lambda: uid + 1)  # the directory is now someone else's
    assert native.owned_dir(mine) is None
    monkeypatch.setattr(native, "BUILD_DIR", mine)
    assert native.build_library() is None
