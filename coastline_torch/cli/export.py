"""Export a trainer checkpoint as a reference-compatible torch `.pth`
(counterpart of `coastline/cli/export.py`).

The reference consumes `best_water_segmentation_model.pth`, the 2-class
UNet's state_dict (`train_water_segmentation.py:597-606`). The port's
trainer writes its best epoch as `best/model.pth` under its save
directory; this CLI loads it strictly into `create_model(--arch)` on
`--device`, so a file that does not hold that model's weights is refused,
and writes the model's state_dict to `--out`.

    python -m coastline_torch.cli.export --checkpoint-dir ./models \\
        --out best_water_segmentation_model.pth

`--quantized-out model.npz` also (or instead of `--out`) writes the int8
PTQ serving artifact (`infer/deploy.py`): BN fold, calibration (on up to
eight images of `--calib-images`, resized BILINEAR to `--image-size`, or
on the synthetic coastal scenes) and quantization in one command, served
by the predict CLI's `--quantized` and `CoastlineExtractor.from_quantized`
of either package. Its int8 fold exists for all twelve architectures of
the registry (`--arch`: any registry name or alias); a name with no int8
fold exits 2, naming the ones that have one.
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint-dir", required=True,
                   help="save dir written by coastline_torch.cli.train")
    p.add_argument("--out", default=None, help="output .pth path")
    p.add_argument("--quantized-out", default=None, metavar="NPZ",
                   help="also write the int8 PTQ serving artifact (any architecture of the "
                        "registry)")
    p.add_argument("--calib-images", default=None,
                   help="directory of representative images for activation calibration "
                        "(default: synthetic coastal scenes)")
    p.add_argument("--arch", default="unet",
                   help="architecture in the checkpoint (registry name/alias)")
    p.add_argument("--image-size", type=int, default=512,
                   help="calibration image size of --quantized-out (the weights do not "
                        "depend on it)")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card only 'cpu' runs")
    args = p.parse_args(argv)
    if not (args.out or args.quantized_out):
        p.error("pass --out and/or --quantized-out")
    qarch = None
    if args.quantized_out:  # fail before any checkpoint IO if the arch has no int8 fold
        from coastline_torch.infer.quant import ARCHS, quant_arch_for

        qarch = quant_arch_for(args.arch)
        if qarch is None:
            print(f"--quantized-out: {args.arch!r} has no int8 fold "
                  f"(int8 folds: {sorted(ARCHS)})", file=sys.stderr)
            return 2

    import torch

    from coastline_torch.models.registry import canonical_name, create_model
    from coastline_torch.train.checkpoint import CheckpointManager
    from coastline_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    model = create_model(args.arch, **({"n_classes": 2} if canonical_name(args.arch) == "UNet"
                                       else {})).to(dev)
    payload = CheckpointManager(args.checkpoint_dir).restore_best()
    if payload is None:
        raise SystemExit(f"no best checkpoint under {args.checkpoint_dir}")
    model.load_state_dict(payload, strict=True)
    if args.out:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, args.out)
        print(f"exported {args.arch} weights -> {args.out}")
    if args.quantized_out:
        from coastline_torch.infer.deploy import save_quantized
        from coastline_torch.infer.quant import QuantizedModel, default_calibration

        s = args.image_size
        imgs = None  # None: default_calibration's synthetic scenes
        if args.calib_images:
            import glob
            import os

            import numpy as np
            from PIL import Image

            from coastline_torch.data.pipeline import load_image_rgb

            paths = sorted(sum((glob.glob(os.path.join(args.calib_images, e))
                                for e in ("*.png", "*.jpg", "*.tif", "*.tiff")), []))[:8]
            if not paths:
                raise SystemExit(f"no images in {args.calib_images}")
            imgs = np.stack([np.asarray(load_image_rgb(pp, (s, s)).resize((s, s),
                                                                          Image.BILINEAR),
                                        np.uint8) for pp in paths])
        calib = default_calibration(s, imgs, device=dev)
        qm = QuantizedModel.from_state_dict(model.state_dict(), calib, arch=qarch, device=dev)
        save_quantized(args.quantized_out, qm)
        print(f"quantized {qarch} serving artifact -> {args.quantized_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
