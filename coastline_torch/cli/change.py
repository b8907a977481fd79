"""Shoreline-change analysis CLI (counterpart of `coastline/cli/change.py`).

Reads the extraction artifacts `predict` writes (`{base}_coastlines.json`
in pixels, or `{base}_coastlines.geojson` in world coordinates) for the
same stretch of coast at different dates and reports per-transect
shoreline migration rates (`shoreline_change.json`) and a two-panel figure
(`shoreline_change.png`; a figure that fails, e.g. without matplotlib, is
printed and skipped). Host work only: it takes no --device.

Usage:
  python -m coastline_torch.cli.change results/2019_coastlines.json \\
      results/2021_coastlines.json results/2024_coastlines.json \\
      --spacing 50 --length 400 --output-dir ./change_results
  # dates come from --dates (ISO or decimal years, one per input) or are
  # parsed from the first 1900-2099 year in each path; the baseline
  # defaults to the earliest date's longest shoreline.
"""

import argparse
import json
import os
import sys
from typing import List, Optional


def _parse_baseline(spec: str) -> List[List[float]]:
    """'x0,y0 x1,y1 ...' → [[x0,y0], ...]."""
    pts = []
    for tok in spec.split():
        x, y = tok.split(",")
        pts.append([float(x), float(y)])
    if len(pts) < 2:
        raise ValueError("baseline needs at least 2 points")
    return pts


def _longest_line(coastlines) -> Optional[List[List[float]]]:
    import numpy as np

    best, best_len = None, -1.0
    for line in coastlines:
        arr = np.asarray(line, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[0] < 2:
            continue
        ln = float(np.hypot(*np.diff(arr, axis=0).T).sum())
        if ln > best_len:
            best, best_len = [list(map(float, p)) for p in arr], ln
    return best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("inputs", nargs="+",
                   help="*_coastlines.json / *_coastlines.geojson artifacts "
                        "(same coast, different dates, ONE coordinate space)")
    p.add_argument("--dates", nargs="*", default=None,
                   help="one per input: ISO date or decimal year "
                        "(default: first 1900-2099 year in each path)")
    p.add_argument("--baseline", default=None,
                   help="'x0,y0 x1,y1 ...' baseline polyline "
                        "(default: longest shoreline of the earliest date)")
    p.add_argument("--spacing", type=float, default=50.0,
                   help="transect spacing along the baseline (default 50)")
    p.add_argument("--length", type=float, default=400.0,
                   help="transect length (default 400)")
    p.add_argument("--side", choices=["both", "left", "right"], default="both")
    p.add_argument("--reduce", choices=["median", "min", "max"],
                   default="median", help="pick among multiple crossings")
    p.add_argument("--output-dir", default="./change_results")
    args = p.parse_args(argv)

    from coastline_torch.infer.change import (
        decimal_year,
        generate_transects,
        load_coastlines_artifact,
        shoreline_change,
        year_from_name,
    )

    if len(args.inputs) < 2:
        print("need at least 2 dated artifacts to measure change")
        return 2
    if args.dates and len(args.dates) != len(args.inputs):
        print(f"--dates got {len(args.dates)} values for {len(args.inputs)} inputs")
        return 2

    series, units_seen = [], set()
    for i, path in enumerate(args.inputs):
        try:
            lines, units = load_coastlines_artifact(path)
        except (OSError, ValueError) as e:
            print(f"cannot read coastlines artifact: {e}")
            return 2
        units_seen.add(units)
        if args.dates:
            try:
                date = decimal_year(args.dates[i])
            except ValueError as e:
                print(f"bad --dates value {args.dates[i]!r}: {e}")
                return 2
        else:
            date = year_from_name(path)
            if date is None:
                print(f"no year found in {path!r}; pass --dates")
                return 2
        series.append({"date": date, "coastlines": lines, "path": path})
    if len(units_seen) > 1:
        print("inputs mix pixel-space .json and world-space .geojson artifacts; "
              "use one flavor")
        return 2
    units = units_seen.pop()
    # keep the artifact's "inputs" aligned row-for-row with the
    # date-sorted "dates"/"positions" shoreline_change emits
    series.sort(key=lambda e: e["date"])

    if args.baseline:
        try:
            baseline = _parse_baseline(args.baseline)
        except ValueError as e:
            print(f"bad --baseline spec: {e}")
            return 2
    else:
        earliest = min(series, key=lambda e: e["date"])
        baseline = _longest_line(earliest["coastlines"])
        if baseline is None:
            print(f"no usable shoreline in {earliest['path']!r} to derive a "
                  "baseline; pass --baseline")
            return 2

    transects = generate_transects(baseline, args.spacing, args.length, args.side)
    if not transects:
        print("no transects generated (baseline too short or bad spacing)")
        return 2
    result = shoreline_change(series, transects, reduce=args.reduce)
    result["units"] = units
    result["inputs"] = [e["path"] for e in series]
    result["baseline"] = baseline

    os.makedirs(args.output_dir, exist_ok=True)
    out_json = os.path.join(args.output_dir, "shoreline_change.json")
    with open(out_json, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=2, ensure_ascii=False)

    out_png = os.path.join(args.output_dir, "shoreline_change.png")
    try:
        from coastline_torch.report.change_fig import plot_shoreline_change

        plot_shoreline_change(series, result, out_png, units=units)
    except Exception as e:  # the rates are written; a figure never fails the run
        print("shoreline change figure failed:", e)
        out_png = None

    n = result["n_transects_with_rate"]
    mean = result["mean_rate"]
    print(f"{len(series)} dates x {len(transects)} transects -> "
          f"{n} transects with a rate"
          + (f"; mean {mean:+.3f} {units}/yr" if mean is not None else ""))
    print(f"wrote {out_json}" + (f" and {out_png}" if out_png else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
