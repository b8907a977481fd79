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

`--quantized-out` and `--calib-images` (the int8 serving artifact) are not
ported yet and exit non-zero.
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint-dir", required=True,
                   help="save dir written by coastline_torch.cli.train")
    p.add_argument("--out", default=None, help="output .pth path")
    p.add_argument("--quantized-out", default=None, metavar="NPZ",
                   help="not ported yet: exits non-zero")
    p.add_argument("--calib-images", default=None, help="not ported yet: exits non-zero")
    p.add_argument("--arch", default="unet",
                   help="architecture in the checkpoint (registry name/alias)")
    p.add_argument("--image-size", type=int, default=512,
                   help="accepted for the JAX CLI's command lines; the weights do not "
                        "depend on it")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card only 'cpu' runs")
    args = p.parse_args(argv)
    if args.quantized_out or args.calib_images:
        print("--quantized-out and --calib-images are not ported yet: the port has no "
              "int8 serving artifact", file=sys.stderr)
        return 2
    if not args.out:
        p.error("pass --out")

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
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, args.out)
    print(f"exported {args.arch} weights -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
