"""Host-side contour tracing and simplification (counterpart of
`coastline/infer/contours.py`).

External contours only, contours of <= `min_points` points dropped,
simplified with epsilon = `epsilon_frac` * arc length, as the reference
does (`predict_coastline.py:583-618`). Backends, in `auto`'s order: cv2
(the reference's exact semantics) when it imports, the native C++ tracer
(`coastline_torch/native`, built with g++ at first use; bit-identical to
the Python one), then the pure-Python Moore tracer and Ramer-Douglas-Peucker
(they need scipy). `backend=` forces one.
"""

from typing import List

import numpy as np
import torch

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False

MIN_POINTS = 10
EPSILON_FRAC = 0.002


def _moore_trace(mask: np.ndarray) -> List[np.ndarray]:
    """External boundary of each 4-connected component (Moore neighbourhood)."""
    from scipy import ndimage

    labeled, n = ndimage.label(mask > 0)
    contours = []
    offs = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]
    for comp in range(1, n + 1):
        ys, xs = np.nonzero(labeled == comp)
        if len(ys) == 0:
            continue
        start = (ys.min(), xs[ys == ys.min()].min())
        comp_mask = labeled == comp
        contour = [start]
        prev_dir = 6  # coming from the left
        cur = start
        for _ in range(4 * len(ys) + 8):
            found = False
            for k in range(8):
                d = (prev_dir + 1 + k) % 8
                ny, nx = cur[0] + offs[d][0], cur[1] + offs[d][1]
                if 0 <= ny < mask.shape[0] and 0 <= nx < mask.shape[1] and comp_mask[ny, nx]:
                    cur = (ny, nx)
                    prev_dir = (d + 4) % 8
                    found = True
                    break
            if not found or cur == start:
                break
            contour.append(cur)
        contours.append(np.array([[x, y] for y, x in contour], np.int32))
    return contours


def _rdp(points: np.ndarray, eps: float) -> np.ndarray:
    """Ramer-Douglas-Peucker simplification (approxPolyDP equivalent)."""
    if len(points) < 3:
        return points
    keep = np.zeros(len(points), bool)
    keep[0] = keep[-1] = True
    stack = [(0, len(points) - 1)]
    while stack:
        a, b = stack.pop()
        if b <= a + 1:
            continue
        # cross products in int64: int32 wraps past ~46341-px coordinate spans
        seg = (points[b] - points[a]).astype(np.int64)
        norm = np.hypot(*seg.astype(float))
        if norm == 0:
            d = np.hypot(*(points[a + 1:b] - points[a]).astype(float).T)
        else:
            d = np.abs(np.cross(seg, (points[a + 1:b] - points[a])
                                .astype(np.int64))) / norm
        i = int(np.argmax(d))
        if d[i] > eps:
            keep[a + 1 + i] = True
            stack += [(a, a + 1 + i), (a + 1 + i, b)]
    return points[keep]


def extract_contours(band_mask, min_points: int = MIN_POINTS,
                     epsilon_frac: float = EPSILON_FRAC,
                     backend: str = "auto") -> List[List[List[int]]]:
    """Coastline band (numpy array or tensor) -> polylines as [[x, y], ...].

    backend: 'auto' (cv2 > native > python), or 'cv2', 'native', 'python'.
    A forced backend that is unavailable raises."""
    if isinstance(band_mask, torch.Tensor):
        band_mask = band_mask.cpu().numpy()
    band = np.asarray(band_mask).astype(np.uint8)
    if backend not in ("auto", "cv2", "native", "python"):
        raise ValueError(f"unknown contour backend {backend!r}")
    if backend == "cv2" and not _HAS_CV2:
        raise RuntimeError("cv2 backend requested but cv2 is not installed")
    coastlines = []
    if backend == "cv2" or (backend == "auto" and _HAS_CV2):
        contours, _ = cv2.findContours(band, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        for c in contours:
            if len(c) > min_points:
                eps = epsilon_frac * cv2.arcLength(c, True)
                coastlines.append(cv2.approxPolyDP(c, eps, True).reshape(-1, 2).tolist())
        return coastlines
    traced, simplify = None, _rdp
    if backend in ("auto", "native"):
        from coastline_torch import native

        traced = native.moore_trace(band)
        if traced is not None:
            simplify = native.rdp
        elif backend == "native":
            raise RuntimeError("native contour library unavailable (g++ missing or build failed)")
    if traced is None:
        traced = _moore_trace(band)
    for c in traced:
        if len(c) > min_points:
            closed = np.vstack([c, c[:1]])
            arc = np.hypot(*np.diff(closed, axis=0).astype(float).T).sum()
            coastlines.append(simplify(c, epsilon_frac * arc).tolist())
    return coastlines
