"""Shoreline-change figure (the port's copy of
`coastline/report/change_fig.py`): dated shorelines and transects in map
view, and the per-transect migration rates. matplotlib is imported when the
figure is drawn.
"""

import os
from typing import Optional, Sequence

import numpy as np

from coastline_torch.report.trainer_viz import _pyplot


def plot_shoreline_change(
    series: Sequence[dict],
    change: dict,
    output_path: str,
    title: str = "Shoreline change analysis",
    units: str = "px",
) -> Optional[str]:
    """Two-panel PNG: (left) shorelines colored by date with the transect
    fan; (right) per-transect migration rate with the mean annotated.
    `series` is the dated input of `shoreline_change`; `change` its
    return value. Returns the written path."""
    dates = change["dates"]
    rates = np.asarray(change["rates"], dtype=np.float64)
    transects = change["transects"]

    plt = _pyplot()
    from matplotlib import cm

    fig, (ax_map, ax_rate) = plt.subplots(
        1, 2, figsize=(13, 6), gridspec_kw={"width_ratios": [1.3, 1]}
    )
    colors = cm.viridis(np.linspace(0.05, 0.95, max(len(dates), 2)))

    for tr in transects:
        (x0, y0), (x1, y1) = tr
        ax_map.plot([x0, x1], [y0, y1], color="0.75", lw=0.8, zorder=1)
        ax_map.plot([x0], [y0], marker=".", color="0.55", ms=3, zorder=1)
    from coastline_torch.infer.change import decimal_year

    ordered = sorted(series, key=lambda e: decimal_year(e["date"]))
    for i, entry in enumerate(ordered):
        for j, line in enumerate(entry["coastlines"]):
            arr = np.asarray(line, dtype=np.float64)
            if arr.ndim != 2 or arr.shape[0] < 2:
                continue
            ax_map.plot(arr[:, 0], arr[:, 1], color=colors[i], lw=1.6,
                        label=f"{dates[i]:.2f}" if j == 0 else None, zorder=2)
    ax_map.set_title("Shorelines by date (transects in grey)")
    ax_map.set_xlabel(f"x [{units}]")
    ax_map.set_ylabel(f"y [{units}]")
    if units == "px":
        # raster convention: row grows downward. World coordinates
        # (geojson artifacts, units "m": northing grows upward) keep the
        # natural axis — inverting would mirror the map north-south.
        ax_map.invert_yaxis()
    ax_map.set_aspect("equal", adjustable="datalim")
    ax_map.legend(fontsize=8, title="date")

    idx = np.arange(len(rates))
    finite = ~np.isnan(rates)
    ax_rate.bar(idx[finite], rates[finite], color="#2c7fb8")
    if (~finite).any():
        ax_rate.plot(idx[~finite], np.zeros((~finite).sum()), "x", color="0.6",
                     label="no rate")
        ax_rate.legend(fontsize=8)
    ax_rate.axhline(0, color="0.3", lw=0.8)
    if change.get("mean_rate") is not None:
        ax_rate.axhline(change["mean_rate"], color="#d95f02", lw=1.2, ls="--")
        ax_rate.text(0.98, 0.95,
                     f"mean {change['mean_rate']:+.2f} {units}/yr",
                     transform=ax_rate.transAxes, ha="right", va="top",
                     color="#d95f02", fontsize=10)
    ax_rate.set_title("Migration rate per transect")
    ax_rate.set_xlabel("transect #")
    ax_rate.set_ylabel(f"rate [{units}/yr]  (+ = toward transect end)")

    fig.suptitle(title)
    fig.tight_layout(rect=(0, 0, 1, 0.96))
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path
