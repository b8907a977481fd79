"""The comparison protocol on one device (counterpart of
`coastline/cli/bench_all.py`): for each model, `create_model` ->
`Evaluator.train_model` -> `evaluate_model`, then the figures, the results
table and `benchmark_results.json` in the JAX package's layout.

Per-model epochs follow the reference harness that benchmarked the model:
DeepLabV3+ 25 (`Main_Final.py:862-865`), SegNet 15 / PSPNet 20 / Fast-SCNN
25 / ENet 20 (`comne.py:978-983`), everything else 20. Every model of the
registry runs; the default `--models` is the JAX CLI's list of eleven (the
Robust U-Net and its ten baselines), and an unknown name fails with the
registry's KeyError before any training. The JAX CLI's multi-device flags
(--data-parallel, --model-parallel, --sharded-data) are not ported yet and
exit non-zero.

Usage:
  python -m coastline_torch.cli.bench_all --images-dir D --labels-dir L
  python -m coastline_torch.cli.bench_all --synthetic 20 --models "Robust UNet,SegNet"
  python -m coastline_torch.cli.bench_all --synthetic 6 --image-size 32 --epochs 1 \
      --device cpu
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

from coastline_torch.data.pipeline import prepare_datasets
from coastline_torch.data.synthetic import synthetic_device_dataset
from coastline_torch.models.registry import create_model, model_class
from coastline_torch.train.loop import Evaluator, TrainConfig, normalize_images
from coastline_torch.utils.device import resolve_device
from coastline_torch.utils.tables import format_results_table

REFERENCE_EPOCHS = {
    "DeepLabV3+": 25,
    "SegNet": 15,
    "PSPNet": 20,
    "Fast-SCNN": 25,
    "ENet": 20,
}
COMNE_MODELS = ("SegNet", "PSPNet", "Fast-SCNN", "ENet")
# Scheduler wiring differs per source harness: Main_Final/Extended step
# ReduceLROnPlateau on TRAIN loss with patience 5 (`Main_Final.py:555,605`),
# the comne subset steps on VAL loss with patience 3 (`comne.py:654,723`).
PROTOCOLS = {"main": ("train", 5), "comne": ("val", 3)}
DEFAULT_BENCH_MODELS = [
    "Robust UNet", "DeepLabV3+", "YOLO-SEG", "SegNet", "PSPNet", "Fast-SCNN",
    "ENet", "WaterNet", "MSWNet", "HRNet-Water", "SegFormer-Lite",
]


def model_train_config(name, epochs=None, lr=1e-4, batch_size=2, seed=0, protocol="auto"):
    """The TrainConfig the protocol uses for a registry model, reproducing
    whichever reference harness benchmarked it (epochs and scheduler
    wiring). `protocol` forces 'main' or 'comne' for every model."""
    if protocol == "auto":
        protocol = "comne" if name in COMNE_MODELS else "main"
    plateau_on, patience = PROTOCOLS[protocol]
    return TrainConfig(
        epochs=epochs or REFERENCE_EPOCHS.get(name, 20), lr=lr,
        batch_size=batch_size, eval_batch_size=batch_size, loss="bce",
        plateau_on=plateau_on, plateau_patience=patience, seed=seed,
    )


def _figure(what, fn, *args):
    """Draw one figure; a figure that fails says why and does not fail the
    run (matplotlib may be missing)."""
    try:
        fn(*args)
    except Exception as e:  # a figure never fails the run
        print(f"{what} not drawn: {type(e).__name__}: {e}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images-dir", default="./labelme_images/converted")
    p.add_argument("--labels-dir", default="./labelme_images/annotations/")
    p.add_argument("--models", default=",".join(DEFAULT_BENCH_MODELS),
                   help="comma-separated registry names or aliases")
    p.add_argument("--epochs", type=int, default=None,
                   help="override per-model reference epochs")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic scenes instead of a real dataset")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--error-maps", action="store_true",
                   help="also render per-model error maps (Extended protocol)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="not ported yet: any value but 0 exits non-zero")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="not ported yet: any value but 1 exits non-zero")
    p.add_argument("--sharded-data", action="store_true",
                   help="not ported yet: exits non-zero")
    p.add_argument("--throughput-batch", type=int, default=64,
                   help="also time inference at this batch and add an img/s "
                        "column to the tables (0 = protocol timing only)")
    p.add_argument("--protocol", choices=["auto", "main", "comne"], default="auto",
                   help="scheduler wiring: auto = per-model reference protocol "
                        "(comne four step plateau on val/3, rest train/5)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card only 'cpu' runs")
    args = p.parse_args(argv)

    if args.data_parallel or args.model_parallel != 1 or args.sharded_data:
        print("--data-parallel, --model-parallel and --sharded-data are not ported yet: "
              "the port's comparison protocol runs on one device", file=sys.stderr)
        return 2
    names = [m.strip() for m in args.models.split(",") if m.strip()]
    for name in names:
        model_class(name)  # fail on an unknown name before any training
    dev = resolve_device(args.device)

    if args.synthetic:
        n = args.synthetic
        train_ds = synthetic_device_dataset(int(n * 0.8), args.image_size, seed=args.seed,
                                            device=dev)
        val_ds = synthetic_device_dataset(n - int(n * 0.8), args.image_size,
                                          seed=args.seed + 1, device=dev)
        print(f"synthetic dataset: {len(train_ds)} train / {len(val_ds)} val "
              f"@ {args.image_size}^2")
    else:
        if not (os.path.isdir(args.images_dir) and os.path.isdir(args.labels_dir)):
            print("Dataset directories not found. Please check paths "
                  "(or pass --synthetic N).")
            return 1
        out = prepare_datasets(args.images_dir, args.labels_dir,
                               (args.image_size, args.image_size), device=dev)
        if out is None:
            print("no image/label pairs found")
            return 1
        train_ds, val_ds = out
        print(f"Found {len(train_ds) + len(val_ds)} valid image-label pairs")

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    results, histories, param_counts, predictions = {}, {}, {}, {}
    per_model_config = {}
    for name in names:
        model = create_model(name, dtype=dtype)
        cfg = model_train_config(name, epochs=args.epochs, lr=args.lr,
                                 batch_size=args.batch_size, seed=args.seed,
                                 protocol=args.protocol)
        per_model_config[name] = {"epochs": cfg.epochs, "plateau_on": cfg.plateau_on,
                                  "plateau_patience": cfg.plateau_patience}
        param_counts[name] = sum(p.numel() for p in model.parameters())
        print(f"\n{'=' * 40}\nTraining {name}... "
              f"({param_counts[name]:,} params, {cfg.epochs} epochs)")
        ev = Evaluator(model, cfg, device=dev)
        tr = ev.train_model(train_ds, val_ds)
        histories[name] = tr["history"]
        print(f"Best IoU during training: {tr['best_iou']:.4f}")
        res = ev.evaluate_model(val_ds, throughput_batch=args.throughput_batch)
        results[name] = res
        print(f"  IoU: {res['mean_iou']:.4f} ± {res['std_iou']:.3f}")
        print(f"  F1-Score: {res['mean_f1_score']:.4f} ± {res['std_f1_score']:.3f}")
        print(f"  Accuracy: {res['mean_accuracy']:.4f} ± {res['std_accuracy']:.3f}")
        print(f"  Inference Time: {res['avg_inference_time'] * 1000:.2f}ms "
              f"(per image, protocol batch {res['inference_batch_size']})")
        if res.get("throughput_images_per_sec") is not None:
            print(f"  Throughput: {res['throughput_images_per_sec']:.1f} "
                  f"img/s @ batch {res['throughput_batch_size']}")
        if args.error_maps:
            x = normalize_images(torch.as_tensor(val_ds.images[:6]).to(dev))
            with torch.inference_mode():
                probs = ev.state.model.eval()(x.permute(0, 3, 1, 2))
            predictions[name] = probs[:, 0].float().cpu().numpy()
        del model, ev
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    from coastline_torch.report.comparison import plot_comparison, plot_extended_comparison
    from coastline_torch.report.curves import plot_training_curves

    os.makedirs(args.out_dir, exist_ok=True)
    out = args.out_dir
    _figure("training_curves.png", plot_training_curves, histories,
            os.path.join(out, "training_curves.png"))
    _figure("coastal_comparison.png", plot_comparison, results,
            os.path.join(out, "coastal_comparison.png"))
    _figure("extended_comparison.png", plot_extended_comparison, results,
            os.path.join(out, "extended_comparison.png"))
    # The comne script family emits its own artifact names for the
    # remote-sensing model subset (`comne.py:815-925`):
    comne_results = {k: v for k, v in results.items() if k in COMNE_MODELS}
    if comne_results:
        _figure("training_curves_rs.png", plot_training_curves,
                {k: v for k, v in histories.items() if k in COMNE_MODELS},
                os.path.join(out, "training_curves_rs.png"))
        _figure("rs_comparison.png", plot_comparison, comne_results,
                os.path.join(out, "rs_comparison.png"))
    if args.error_maps and predictions:
        from coastline_torch.report.error_maps import generate_error_maps

        _figure("error maps", generate_error_maps, np.asarray(torch.as_tensor(
            val_ds.images[:6]).cpu()), np.asarray(torch.as_tensor(val_ds.masks[:6]).cpu()),
            predictions, os.path.join(out, "error_maps"))

    print("\n" + format_results_table(results, param_counts))
    with open(os.path.join(out, "benchmark_results.json"), "w") as f:
        json.dump(
            {
                "config": {**vars(args), "per_model": per_model_config,
                           "inference_time_batch_size": args.batch_size},
                "results": results,
                "param_counts": param_counts,
                "histories": histories,
            },
            f, indent=2,
        )
    print(f"\nartifacts written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
