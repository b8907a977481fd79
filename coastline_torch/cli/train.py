"""Production training CLI (counterpart of `coastline/cli/train.py`): the
reference's interactive prompts (`train_water_segmentation.py:832-875`) as
flags.

Usage:
  python -m coastline_torch.cli.train --images-dir D --labels-dir L --epochs 200
  python -m coastline_torch.cli.train --synthetic 16 --epochs 5 --image-size 64
  python -m coastline_torch.cli.train --synthetic 16 --epochs 2 --image-size 64 --device cpu
  python -m coastline_torch.cli.train --synthetic 16 --data-parallel 2 --sharded-data

`--data-parallel N` runs N ranks, one process a device (`parallel/launch.py`:
NCCL with a card a rank, or gloo with `--device cpu`); under `torchrun
--nproc-per-node N` each rank joins the launcher's group instead.
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
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard batches over N devices (0 = single chip)")
    p.add_argument("--sharded-data", action="store_true",
                   help="sample-shard the dataset over the mesh's data "
                        "axis (each chip holds 1/k; requires "
                        "--data-parallel and batch divisible by the axis)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel factor carved out of the "
                        "--data-parallel device count: channel-shards "
                        "params + Adam moments over a 'model' mesh axis "
                        "(data groups = devices / model)")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card only 'cpu' runs")
    args = p.parse_args(argv)

    if args.data_parallel:
        from coastline_torch.parallel.mesh import mesh_shape

        mesh_shape(args.data_parallel, model=args.model_parallel)  # the sizes, before any rank
    sharded = False
    if args.sharded_data:
        k = args.data_parallel // args.model_parallel  # the data axis
        if not args.data_parallel:
            print("--sharded-data requires --data-parallel; ignoring")
        elif args.batch_size % k:
            print(f"--sharded-data needs batch {args.batch_size} divisible "
                  f"by the data axis ({k}); ignoring")
        else:
            sharded = True
    if args.data_parallel:
        from coastline_torch.parallel import launch

        launch.run(_train, args.data_parallel, device=args.device, args=(args, sharded),
                   quiet=True)
    else:
        _train(args, False)
    return 0


def _train(args, sharded: bool):
    """The run on one device, or on this rank of a `--data-parallel` mesh."""
    from coastline_torch.train.trainer import TrainerConfig, WaterSegmentationTrainer

    mesh, device = None, args.device
    if args.data_parallel:
        from coastline_torch.parallel.launch import local_device
        from coastline_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.data_parallel, model=args.model_parallel)
        device = local_device()
    cfg = TrainerConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                        image_size=args.image_size, save_dir=args.save_dir,
                        augment=not args.no_augment, image_only_geometric=args.strict_parity_aug,
                        dtype=args.dtype, checkpoint_every=args.checkpoint_every)
    trainer = WaterSegmentationTrainer(cfg, mesh=mesh, sharded_data=sharded, device=device)
    if args.synthetic:
        from coastline_torch.data.synthetic import synthetic_device_dataset

        n = args.synthetic
        train_ds = synthetic_device_dataset(int(n * 0.8), args.image_size, seed=0,
                                            device=trainer.device)
        val_ds = synthetic_device_dataset(n - int(n * 0.8), args.image_size, seed=1,
                                          device=trainer.device)
    else:
        train_ds, val_ds = trainer.prepare_dataset(args.images_dir, args.labels_dir)

    if sharded:
        from coastline_torch.data.pipeline import DeviceDataset
        from coastline_torch.parallel.mesh import data_axis_size, shard_device_dataset

        if isinstance(train_ds, DeviceDataset) and isinstance(val_ds, DeviceDataset):
            train_ds, val_ds = (shard_device_dataset(mesh, ds.images.cpu().numpy(),
                                                     ds.masks.cpu().numpy(), ds.paths)
                                for ds in (train_ds, val_ds))
            print(f"datasets sample-sharded over {data_axis_size(mesh)} chips")
        else:
            print("--sharded-data applies to device-resident datasets only; "
                  "ignoring (host-chunked uploads already bound per-chip HBM)")
            trainer = WaterSegmentationTrainer(cfg, mesh=mesh, device=device)

    print(f"training on {len(train_ds)} samples, validating on {len(val_ds)}")
    hist = trainer.train(train_ds, val_ds, resume=args.resume)
    best = max(hist["iou_scores"]) if hist["iou_scores"] else float("nan")
    print(f"done: best IoU {best:.4f} (epoch {hist['best_model_epoch'] + 1}), "
          f"{hist['training_time']:.1f}s; checkpoints in {args.save_dir}")


if __name__ == "__main__":
    sys.exit(main())
