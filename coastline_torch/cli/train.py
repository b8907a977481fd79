"""Production training CLI (counterpart of `coastline/cli/train.py`): the
reference's interactive prompts (`train_water_segmentation.py:832-875`) as
flags, on one device.

Usage:
  python -m coastline_torch.cli.train --images-dir D --labels-dir L --epochs 200
  python -m coastline_torch.cli.train --synthetic 16 --epochs 5 --image-size 64
  python -m coastline_torch.cli.train --synthetic 16 --epochs 2 --image-size 64 --device cpu

The JAX CLI's multi-device flags (--data-parallel, --model-parallel,
--sharded-data) are not ported yet.
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images-dir", default="./labelme_images/converted")
    p.add_argument("--labels-dir", default="./labelme_images/annotations/")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--save-dir", default="./models")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--strict-parity-aug", action="store_true",
                   help="reference behavior: rotate/flip image only, not mask")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue bit-exactly from the last resume point in --save-dir "
                        "(written every --checkpoint-every epochs and at run end)")
    p.add_argument("--checkpoint-every", type=int, default=5,
                   help="epochs between crash-safe full-state resume points (0 = end-of-run only)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card only 'cpu' runs")
    args = p.parse_args(argv)

    from coastline_torch.train.trainer import TrainerConfig, WaterSegmentationTrainer

    cfg = TrainerConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                        image_size=args.image_size, save_dir=args.save_dir,
                        augment=not args.no_augment, image_only_geometric=args.strict_parity_aug,
                        dtype=args.dtype, checkpoint_every=args.checkpoint_every)
    trainer = WaterSegmentationTrainer(cfg, device=args.device)
    if args.synthetic:
        from coastline_torch.data.synthetic import synthetic_device_dataset

        n = args.synthetic
        train_ds = synthetic_device_dataset(int(n * 0.8), args.image_size, seed=0,
                                            device=trainer.device)
        val_ds = synthetic_device_dataset(n - int(n * 0.8), args.image_size, seed=1,
                                          device=trainer.device)
    else:
        train_ds, val_ds = trainer.prepare_dataset(args.images_dir, args.labels_dir)

    print(f"training on {len(train_ds)} samples, validating on {len(val_ds)}")
    hist = trainer.train(train_ds, val_ds, resume=args.resume)
    best = max(hist["iou_scores"]) if hist["iou_scores"] else float("nan")
    print(f"done: best IoU {best:.4f} (epoch {hist['best_model_epoch'] + 1}), "
          f"{hist['training_time']:.1f}s; checkpoints in {args.save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
