"""GeoTIFF -> water-enhanced PNG batch converter (counterpart of
`coastline/cli/convert.py`; the reference's `tif_to_image.py:20-327`):
year-directory scan (2017-2025) with a flat-directory fallback, per-file
metadata JSON, conversion summary, optional preview figure. Host work only:
it takes no --device.

Usage:
  python -m coastline_torch.cli.convert --input ./data --output ./labelme_images
  python -m coastline_torch.cli.convert --input ./data --max-files 10 --preview f.tif
"""

import argparse
import json
import os
import sys
from datetime import datetime


def convert_one(tif_path: str, out_dir: str, enhance_water: bool = True):
    """One GeoTIFF -> `converted/{base}.png` (the band combination,
    enhanced) and `metadata/{base}.json` under `out_dir`; returns the PNG's
    path and the metadata."""
    from PIL import Image

    from coastline_torch.data.geotiff import combine_bands, enhance_image, read_bands

    bands, meta = read_bands(tif_path)
    rgb, combo = combine_bands(bands, enhance_water)
    enhanced = enhance_image(rgb, enhance_water)
    base = os.path.splitext(os.path.basename(tif_path))[0]
    png_dir = os.path.join(out_dir, "converted")
    meta_dir = os.path.join(out_dir, "metadata")
    os.makedirs(png_dir, exist_ok=True)
    os.makedirs(meta_dir, exist_ok=True)
    png_path = os.path.join(png_dir, f"{base}.png")
    Image.fromarray(enhanced).save(png_path, "PNG")
    metadata = {
        "original_file": tif_path,
        "png_file": png_path,
        "image_size": meta["size"],
        "bands_count": meta["bands_count"],
        "enhancement_type": combo,
        "conversion_time": str(datetime.now()),
        "geo_transform": meta.get("geo_transform"),
        "projection": meta.get("projection"),
    }
    with open(os.path.join(meta_dir, f"{base}.json"), "w", encoding="utf-8") as f:
        json.dump(metadata, f, indent=2, ensure_ascii=False)
    return png_path, metadata


def scan_year_dirs(input_dir: str, start=2017, end=2025):
    """Year-directory scan (`tif_to_image.py:186-192`)."""
    files = []
    for year in range(start, end + 1):
        ydir = os.path.join(input_dir, str(year))
        if os.path.isdir(ydir):
            for f in sorted(os.listdir(ydir)):
                if f.lower().endswith(".tif"):
                    files.append(os.path.join(ydir, f))
    if not files and os.path.isdir(input_dir):  # flat directory fallback
        files = [
            os.path.join(input_dir, f)
            for f in sorted(os.listdir(input_dir))
            if f.lower().endswith((".tif", ".tiff"))
        ]
    return files


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", default="./data")
    p.add_argument("--output", default="./labelme_images")
    p.add_argument("--max-files", type=int, default=None)
    p.add_argument("--no-enhance", action="store_true")
    p.add_argument("--preview", default=None, help="render a before/after figure")
    args = p.parse_args(argv)

    if args.preview:
        from coastline_torch.data.geotiff import (
            combine_bands, enhance_image, normalize_for_display, read_bands,
        )

        from coastline_torch.report.trainer_viz import _pyplot

        plt = _pyplot()
        bands, _ = read_bands(args.preview)
        rgb, combo = combine_bands(bands, True)
        fig, axes = plt.subplots(1, 2, figsize=(12, 6))
        axes[0].imshow(normalize_for_display(rgb))
        axes[0].set_title("display normalization")
        axes[1].imshow(enhance_image(rgb, True))
        axes[1].set_title(f"water enhanced ({combo})")
        for ax in axes:
            ax.axis("off")
        out = os.path.splitext(args.preview)[0] + "_preview.png"
        plt.savefig(out, dpi=150, bbox_inches="tight")
        print(f"preview -> {out}")
        return 0

    files = scan_year_dirs(args.input)
    print(f"found {len(files)} TIF files")
    if args.max_files:
        files = files[: args.max_files]
    converted = []
    for i, f in enumerate(files):
        print(f"[{i + 1}/{len(files)}] {os.path.basename(f)}")
        try:
            png, meta = convert_one(f, args.output, not args.no_enhance)
            converted.append({"tif_file": f, "png_file": png, "metadata": meta})
        except Exception as e:
            print(f"  failed: {e}")
    summary = {
        "total_files": len(files),
        "converted_files": len(converted),
        "conversion_time": str(datetime.now()),
        "files": converted,
    }
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "conversion_summary.json"), "w",
              encoding="utf-8") as f:
        json.dump(summary, f, indent=2, ensure_ascii=False)
    print(f"converted {len(converted)}/{len(files)} -> {args.output}/converted/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
