"""CoastSat-style extraction analysis figure (the port's copy of
`coastline/report/coastsat_fig.py`; parity: `predict_coastline.py:659-846`):
overlay, water mask, coastline band, blended composite, stats panel,
per-coastline length bars, and a spectral histogram (NDWI when the source
TIFF has NIR, RGB otherwise). matplotlib is imported when the figure is
drawn.
"""

import os

import numpy as np

from coastline_torch.report.trainer_viz import _pyplot


def _polyline_length(points) -> float:
    pts = np.asarray(points, float)
    if len(pts) < 2:
        return 0.0
    closed = np.vstack([pts, pts[:1]])
    return float(np.hypot(*np.diff(closed, axis=0).T).sum())


def create_analysis_figure(result: dict, output_dir: str, image=None):
    base = os.path.splitext(os.path.basename(result["image_path"]))[0]
    water = result["water_mask"]
    band = result["coastline_mask"]
    coastlines = result["coastlines"]

    plt = _pyplot()
    fig = plt.figure(figsize=(16, 12))
    gs = fig.add_gridspec(3, 4)

    ax = fig.add_subplot(gs[0:2, 0:2])
    if image is not None:
        ax.imshow(np.asarray(image))
    else:
        ax.imshow(water, cmap="gray")
    for line in coastlines:
        pts = np.asarray(line)
        ax.plot(pts[:, 0], pts[:, 1], "r-", linewidth=1.5)
    ax.set_title("Coastline overlay")
    ax.axis("off")

    ax = fig.add_subplot(gs[0, 2])
    ax.imshow(water, cmap="Blues")
    ax.set_title("Water mask")
    ax.axis("off")

    ax = fig.add_subplot(gs[0, 3])
    ax.imshow(band, cmap="Reds")
    ax.set_title("Coastline band")
    ax.axis("off")

    ax = fig.add_subplot(gs[1, 2])
    if image is not None:
        blend = np.asarray(image).astype(float) / 255.0
        overlay = blend.copy()
        overlay[water > 0] = overlay[water > 0] * 0.5 + np.array([0, 0, 0.5])
        ax.imshow(np.clip(overlay, 0, 1))
    else:
        ax.imshow(water, cmap="gray")
    ax.set_title("Composite")
    ax.axis("off")

    ax = fig.add_subplot(gs[1, 3])
    ax.axis("off")
    water_frac = float(np.mean(water > 0))
    stats = (
        f"image: {base}\n"
        f"size: {result['image_size'][0]}x{result['image_size'][1]}\n"
        f"water fraction: {water_frac:.1%}\n"
        f"coastlines: {result['coastline_count']}\n"
        f"dilation: {result.get('dilation_size', 5)} px\n"
        f"extracted: {result['extraction_time'][:19]}"
    )
    ax.text(0.02, 0.95, "Extraction stats", fontweight="bold", fontsize=12, va="top")
    ax.text(0.02, 0.8, stats, fontsize=10, va="top", family="monospace")

    ax = fig.add_subplot(gs[2, 0:2])
    lengths = [_polyline_length(c) for c in coastlines]
    if lengths:
        ax.bar(range(1, len(lengths) + 1), lengths, color="steelblue")
    ax.set_title("Per-coastline length (px)")
    ax.set_xlabel("coastline #")

    ax = fig.add_subplot(gs[2, 2:4])
    ndwi = None
    if str(result["image_path"]).lower().endswith((".tif", ".tiff")):
        from coastline_torch.data.geotiff import compute_ndwi

        ndwi = compute_ndwi(result["image_path"])
    if ndwi is not None:
        # water vs non-water NDWI densities (predict_coastline.py:789-815)
        wm = np.asarray(water)
        if wm.shape != ndwi.shape:
            from PIL import Image as _Image

            wm = np.asarray(
                _Image.fromarray((wm > 0).astype(np.uint8)).resize(
                    (ndwi.shape[1], ndwi.shape[0]), _Image.NEAREST
                )
            )
        ax.hist(ndwi[wm == 0].ravel(), bins=50, alpha=0.5, color="brown",
                label="non-water", density=True)
        ax.hist(ndwi[wm > 0].ravel(), bins=50, alpha=0.7, color="blue",
                label="water", density=True)
        ax.set_xlabel("NDWI")
        ax.set_ylabel("density")
        ax.set_title("Water index (NDWI) distribution")
        ax.legend()
    elif image is not None:
        arr = np.asarray(image)
        for ch, color in zip(range(3), ("red", "green", "blue")):
            ax.hist(arr[..., ch].ravel(), bins=64, histtype="step", color=color)
        ax.set_title("Band histograms")
    else:
        ax.axis("off")

    path = os.path.join(output_dir, f"{base}_analysis.png")
    plt.tight_layout()
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path
