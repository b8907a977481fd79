"""World-coordinate shorelines as GeoJSON (the port's copy of
`coastline/infer/geojson.py`).

When a source raster carries a geotransform (`data/geotiff.py`), the
extractor also writes `{base}_coastlines.geojson`: a FeatureCollection of
LineStrings in the raster's CRS, one feature per coastline. Polylines are
(x=col, y=row) pixel vertices; world coordinates apply the GDAL
geotransform at pixel centres:

    X = GT0 + (col+0.5)*GT1 + (row+0.5)*GT2
    Y = GT3 + (col+0.5)*GT4 + (row+0.5)*GT5

RFC 7946 asks for WGS84, and raster CRSs are usually projected (UTM for
Sentinel-2), so the projection is recorded in the collection's
`properties.crs_wkt` instead of relabelling the coordinates.
"""

from typing import List, Optional, Sequence


def pixel_to_world(points, geo_transform) -> List[List[float]]:
    """Map [[col, row], ...] pixel vertices to world coordinates at pixel centres."""
    g0, g1, g2, g3, g4, g5 = geo_transform
    out = []
    for col, row in points:
        c, r = col + 0.5, row + 0.5
        out.append([g0 + c * g1 + r * g2, g3 + c * g4 + r * g5])
    return out


def coastlines_to_geojson(coastlines: Sequence[Sequence[Sequence[float]]],
                          geo_transform: Sequence[float], projection: Optional[str] = None,
                          properties: Optional[dict] = None) -> Optional[dict]:
    """A GeoJSON FeatureCollection of LineString coastlines, or None when
    the geotransform is absent, degenerate or the identity that GDAL and
    rasterio report for rasters without one (pixel coordinates would be
    labelled as world coordinates). Lines of fewer than 2 points are dropped."""
    if geo_transform is None or len(geo_transform) != 6:
        return None
    if (geo_transform[1] == 0 and geo_transform[2] == 0) or (
            geo_transform[4] == 0 and geo_transform[5] == 0):
        return None  # no pixel size on X or Y: every vertex would collapse
    if tuple(geo_transform) == (0, 1, 0, 0, 0, 1):
        return None
    features = []
    for i, line in enumerate(coastlines):
        if len(line) < 2:
            continue
        features.append({"type": "Feature",
                         "properties": {"coastline_id": i, "n_vertices": len(line)},
                         "geometry": {"type": "LineString",
                                      "coordinates": pixel_to_world(line, geo_transform)}})
    top_props = {"geo_transform": list(geo_transform)}
    if projection:
        top_props["crs_wkt"] = projection
    if properties:
        top_props.update(properties)
    return {"type": "FeatureCollection", "properties": top_props, "features": features}
