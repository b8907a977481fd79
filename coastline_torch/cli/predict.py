"""Coastline extraction CLI (counterpart of `coastline/cli/predict.py`):
single image, a directory with `--batch`, and native-resolution tiled
scenes with `--scene`, on one device.

Usage:
  python -m coastline_torch.cli.predict image.png --checkpoint ./models
  python -m coastline_torch.cli.predict dir/ --batch --output ./batch_results
  python -m coastline_torch.cli.predict scene.tif --scene --output ./coastline_results
  python -m coastline_torch.cli.predict image.png --random-weights --device cpu

The int8 flags (--int8, --save-quantized, --quantized) are not ported yet
and exit non-zero.
"""

import argparse
import glob
import os
import sys


def _extract_scene(ex, path, output_dir, dilation):
    """Native-resolution tiled extraction of one scene; raises on failure
    so the caller controls the error contract."""
    result = ex.extract_scene(path, output_dir, dilation_size=dilation)
    if result is None:
        raise RuntimeError(f"scene extraction failed for {path}")
    w, h = result["image_size"]
    print(f"scene {w}x{h}: {result['coastline_count']} coastlines -> {output_dir}")
    return result["coastlines"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input", help="image file or directory")
    p.add_argument("--checkpoint", default="./models",
                   help="trainer save dir with a best/ checkpoint")
    p.add_argument("--output", default="./coastline_results")
    p.add_argument("--dilation", type=int, default=20,
                   help="coastline band width (GUI default 20, predict_coastline.py:870)")
    p.add_argument("--batch", action="store_true", help="process a directory")
    p.add_argument("--scene", action="store_true",
                   help="tile full-resolution scene instead of downscaling")
    p.add_argument("--torch-checkpoint", default=None,
                   help="load a reference-layout PyTorch .pth directly")
    p.add_argument("--random-weights", action="store_true",
                   help="run without a checkpoint (smoke testing)")
    p.add_argument("--image-size", type=int, default=512,
                   help="model input resolution (must match training)")
    p.add_argument("--int8", action="store_true", help="not ported yet: exits non-zero")
    p.add_argument("--save-quantized", default=None, metavar="NPZ",
                   help="not ported yet: exits non-zero")
    p.add_argument("--quantized", default=None, metavar="NPZ",
                   help="not ported yet: exits non-zero")
    p.add_argument("--tta", action="store_true",
                   help="flip/transpose test-time-augmentation ensemble (8 forwards)")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card only 'cpu' runs")
    args = p.parse_args(argv)
    if args.int8 or args.save_quantized or args.quantized:
        print("--int8, --save-quantized and --quantized are not ported yet: the port "
              "serves the float UNet", file=sys.stderr)
        return 2

    from coastline_torch.infer.extract import CoastlineExtractor

    kwargs = {"image_size": args.image_size, "tta": args.tta, "device": args.device}
    if args.torch_checkpoint:
        kwargs["torch_checkpoint"] = args.torch_checkpoint
    elif not args.random_weights:
        kwargs["checkpoint_dir"] = args.checkpoint
    try:
        ex = CoastlineExtractor(**kwargs)
    except FileNotFoundError as e:
        print(f"{e}\n(hint: train first with coastline_torch.cli.train, or pass "
              f"--random-weights for a smoke run)")
        return 1

    if args.batch or os.path.isdir(args.input):
        exts = ("*.png", "*.jpg", "*.jpeg", "*.tif", "*.tiff")
        paths = sorted(f for pattern in exts for f in glob.glob(os.path.join(args.input, pattern)))
        if not paths:
            print(f"no images found in {args.input}")
            return 1
        print(f"processing {len(paths)} images -> {args.output}")
        if args.scene:  # per-file tiled scenes, pipelined (the per-year workflow)
            results = ex.extract_scenes(paths, args.output, args.dilation)
        else:
            results = ex.extract_batch(paths, args.output, args.dilation)
        ok = sum(r is not None for r in results)
        print(f"done: {ok}/{len(paths)} succeeded")
        return 0 if ok else 1

    if args.scene:
        _extract_scene(ex, args.input, args.output, args.dilation)
        return 0

    result = ex.extract_coastline_from_image(args.input, args.output, args.dilation)
    if result is None:
        return 1
    print(f"extracted {result['coastline_count']} coastlines from {args.input}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
