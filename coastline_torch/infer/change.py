"""Transect-based shoreline-change analysis (the port's copy of
`coastline/infer/change.py`).

The per-year workflow (`tif_to_image.py:186-192`) extracts one shoreline a
date; this module measures how it moves, on the host:

1. ``generate_transects``: cross-shore transects at fixed arc-length
   spacing along a baseline polyline (the CoastSat convention).
2. ``shoreline_positions``: per-transect shoreline chainage (distance from
   the transect's origin to its crossing with the coastline polylines).
3. ``shoreline_change``: a dated series of extractions -> per-transect
   position time series and least-squares migration rates (units a year).

Everything runs in ONE coordinate space chosen by the caller: native
pixels (x=col, y=row, as `infer/contours.py` writes them) or world
coordinates after `infer/geojson.pixel_to_world`. Chainage and rates
inherit its units (pixels or metres a year).
"""

import json
import os
import re
from datetime import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "generate_transects",
    "transect_intersections",
    "shoreline_positions",
    "shoreline_change",
    "decimal_year",
    "load_coastlines_artifact",
    "year_from_name",
]


# ---------------------------------------------------------------- artifacts
def load_coastlines_artifact(path: str) -> Tuple[List, str]:
    """Read an extraction artifact into (coastlines, units).

    Accepts both artifact flavors `save_extraction_result` writes:
    `{base}_coastlines.json` (pixel-space polylines → units "px") and
    `{base}_coastlines.geojson` (world-space LineStrings → units from the
    recorded CRS: "m" for projected rasters, "deg" for geographic ones so
    degree-per-year rates are never mislabelled as metres).
    All inputs to one analysis must share a flavor — mixing coordinate
    spaces is a caller error the CLI rejects.
    """
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(
            f"{path}: not a coastlines artifact (expected a JSON object, "
            f"got {type(data).__name__})")
    if data.get("type") == "FeatureCollection":
        feats = data.get("features", [])
        if not isinstance(feats, list):
            raise ValueError(f"{path}: GeoJSON 'features' is not a list")
        lines = []
        for feat in feats:
            if not isinstance(feat, dict):
                continue
            geom = feat.get("geometry") or {}  # RFC 7946 allows null geometry
            if isinstance(geom, dict) and geom.get("type") == "LineString":
                lines.append(geom.get("coordinates", []))
        props = data.get("properties")
        crs = props.get("crs_wkt") if isinstance(props, dict) else None
        return lines, _units_from_crs(crs)
    return data.get("coastlines", []), "px"


def _units_from_crs(crs: Optional[str]) -> str:
    """Axis units implied by a CRS string (WKT or 'EPSG:nnnn').

    Projected CRSs (PROJCS/PROJCRS — e.g. Sentinel-2's UTM zones) use
    metres; geographic ones (GEOGCS/GEOGCRS/GEODCRS, incl. EPSG:4326) use
    degrees. Unknown/absent defaults to "m" (the common remote-sensing
    case and this module's historical behavior)."""
    if not crs:
        return "m"
    w = str(crs).upper()
    if "PROJCS" in w or "PROJCRS" in w:
        return "m"
    if ("GEOGCS" in w or "GEOGCRS" in w or "GEODCRS" in w
            or w.strip() == "EPSG:4326"):
        return "deg"
    return "m"


def year_from_name(path: str) -> Optional[float]:
    """First plausible year (1900-2099) in a file/directory name — matches
    the reference's per-year dataset layout (`tif_to_image.py:186-192`,
    `./data/{2017..2025}/*.tif`)."""
    m = re.search(r"(?:19|20)\d{2}", os.path.normpath(path))
    return float(m.group(0)) if m else None


# ----------------------------------------------------------------- geometry
def _seg_intersect(p0, p1, q0, q1) -> Optional[Tuple[float, float]]:
    """Parametric intersection of segments p0->p1 and q0->q1.

    Returns (t, u) with the hit at p0 + t*(p1-p0) = q0 + u*(q1-q0),
    both in [0, 1], or None when the segments miss / are parallel.
    """
    rx, ry = p1[0] - p0[0], p1[1] - p0[1]
    sx, sy = q1[0] - q0[0], q1[1] - q0[1]
    denom = rx * sy - ry * sx
    if denom == 0.0:  # parallel or degenerate (collinear overlap → no unique chainage)
        return None
    qpx, qpy = q0[0] - p0[0], q0[1] - p0[1]
    t = (qpx * sy - qpy * sx) / denom
    u = (qpx * ry - qpy * rx) / denom
    if -1e-12 <= t <= 1 + 1e-12 and -1e-12 <= u <= 1 + 1e-12:
        return min(max(t, 0.0), 1.0), min(max(u, 0.0), 1.0)
    return None


def generate_transects(
    baseline: Sequence[Sequence[float]],
    spacing: float,
    length: float,
    side: str = "both",
) -> List[List[List[float]]]:
    """Cross-shore transects along a baseline polyline.

    Stations are placed every `spacing` units of arc length (station 0 at
    the baseline start). At each station the transect runs perpendicular
    to the local baseline tangent: `side="both"` centers it (length/2 each
    way), `side="left"`/`"right"` runs the full `length` to that side of
    the walking direction (left = +90° CCW in an x-right/y-down raster
    frame is the seaward side for a west-to-east baseline with water
    below; callers pick by their geometry). Each transect is
    [[x0, y0], [x1, y1]] with chainage measured from [x0, y0].
    """
    pts = np.asarray(baseline, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[0] < 2 or spacing <= 0 or length <= 0:
        return []
    seg = np.diff(pts, axis=0)
    seg_len = np.hypot(seg[:, 0], seg[:, 1])
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(cum[-1])
    if total == 0.0:
        return []
    out: List[List[List[float]]] = []
    s = 0.0
    while s <= total + 1e-9:
        s_clip = min(s, total)
        i = int(np.searchsorted(cum, s_clip, side="right") - 1)
        i = min(max(i, 0), len(seg_len) - 1)
        if seg_len[i] == 0:  # repeated vertex: borrow the next live segment
            live = np.nonzero(seg_len)[0]
            i = int(live[np.argmin(np.abs(live - i))])
        frac = (s_clip - cum[i]) / seg_len[i]
        station = pts[i] + frac * seg[i]
        tx, ty = seg[i] / seg_len[i]
        nx, ny = -ty, tx  # +90° CCW normal
        if side == "both":
            a = station - np.array([nx, ny]) * (length / 2.0)
            b = station + np.array([nx, ny]) * (length / 2.0)
        elif side == "left":
            a, b = station, station + np.array([nx, ny]) * length
        elif side == "right":
            a, b = station, station - np.array([nx, ny]) * length
        else:
            raise ValueError(f"side must be both/left/right, got {side!r}")
        out.append([[float(a[0]), float(a[1])], [float(b[0]), float(b[1])]])
        s += spacing
    return out


def transect_intersections(
    transect: Sequence[Sequence[float]],
    coastlines: Sequence[Sequence[Sequence[float]]],
) -> List[float]:
    """All chainages (distance from transect[0]) where coastline polylines
    cross the transect, ascending. Vertex-coincident double hits on
    adjacent polyline segments are deduplicated."""
    t0, t1 = transect
    tlen = float(np.hypot(t1[0] - t0[0], t1[1] - t0[1]))
    hits: List[float] = []
    for line in coastlines:
        for a, b in zip(line[:-1], line[1:]):
            r = _seg_intersect(t0, t1, a, b)
            if r is not None:
                hits.append(r[0] * tlen)
    hits.sort()
    dedup: List[float] = []
    for h in hits:
        if not dedup or h - dedup[-1] > 1e-9:
            dedup.append(h)
    return dedup


def shoreline_positions(
    coastlines: Sequence[Sequence[Sequence[float]]],
    transects: Sequence[Sequence[Sequence[float]]],
    reduce: str = "median",
) -> np.ndarray:
    """Per-transect shoreline chainage; NaN where a transect finds no
    intersection. `reduce` picks among multiple crossings: "median"
    (CoastSat's robust default), "min" (most landward), "max" (most
    seaward)."""
    out = np.full(len(transects), np.nan, dtype=np.float64)
    for k, tr in enumerate(transects):
        hits = transect_intersections(tr, coastlines)
        if not hits:
            continue
        if reduce == "median":
            out[k] = float(np.median(hits))
        elif reduce == "min":
            out[k] = hits[0]
        elif reduce == "max":
            out[k] = hits[-1]
        else:
            raise ValueError(f"reduce must be median/min/max, got {reduce!r}")
    return out


def decimal_year(date) -> float:
    """A date as a decimal year (floats pass through; ISO strings and
    datetimes use day-of-year over the actual year length)."""
    if isinstance(date, (int, float)):
        return float(date)
    if isinstance(date, str):
        try:  # plain/decimal year strings ("2019", "2019.5") pass through
            return float(date)
        except ValueError:
            date = datetime.fromisoformat(date)
    start = datetime(date.year, 1, 1)
    end = datetime(date.year + 1, 1, 1)
    return date.year + (date - start).total_seconds() / (end - start).total_seconds()


def shoreline_change(
    series: Sequence[dict],
    transects: Sequence[Sequence[Sequence[float]]],
    reduce: str = "median",
) -> dict:
    """Shoreline position time series + migration rates along transects.

    `series` entries are {"date": float-year | ISO string | datetime,
    "coastlines": [[[x, y], ...], ...]} in one shared coordinate space;
    entries are processed in ascending date order. Rates are per-transect
    least-squares slopes of chainage vs decimal year (NaN positions are
    skipped; a transect needs >=2 dated positions for a rate). Positive
    rate = shoreline moving toward the transect END (away from its
    origin).
    """
    order = np.argsort([decimal_year(e["date"]) for e in series], kind="stable")
    years = np.array([decimal_year(series[i]["date"]) for i in order])
    pos = np.stack(
        [shoreline_positions(series[i]["coastlines"], transects, reduce) for i in order]
    )  # (n_dates, n_transects)
    n_tr = len(transects)
    rates = np.full(n_tr, np.nan)
    intercepts = np.full(n_tr, np.nan)
    for k in range(n_tr):
        valid = ~np.isnan(pos[:, k])
        if valid.sum() >= 2 and np.ptp(years[valid]) > 0:
            slope, icpt = np.polyfit(years[valid], pos[valid, k], 1)
            rates[k], intercepts[k] = slope, icpt
    finite = rates[~np.isnan(rates)]
    return {
        "transects": [list(map(list, t)) for t in transects],
        "dates": [float(y) for y in years],
        "positions": pos.tolist(),
        "rates": rates.tolist(),
        "intercepts": intercepts.tolist(),
        "mean_rate": float(finite.mean()) if finite.size else None,
        "reduce": reduce,
        "n_transects_with_rate": int(finite.size),
    }
