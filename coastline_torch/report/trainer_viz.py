"""Production-trainer figures (the port's copy of
`coastline/report/trainer_viz.py`; parity with
`train_water_segmentation.py:401-512,647-739`): the periodic 2x2 progress
panel, the confusion matrix and the final training report. matplotlib is
imported inside each function (Agg backend), so the trainer imports on a
machine without it."""

import os

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_progress_figure(history, epoch, out_dir):
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    epochs = range(1, len(history["train_losses"]) + 1)
    axes[0, 0].plot(epochs, history["train_losses"], label="train")
    axes[0, 0].plot(epochs, history["val_losses"], label="val")
    axes[0, 0].set_title("Loss")
    axes[0, 0].legend()
    axes[0, 1].plot(epochs, history["iou_scores"], color="green")
    axes[0, 1].set_title("Validation IoU")
    axes[1, 0].plot(epochs, history["accuracies"], color="purple")
    axes[1, 0].set_title("Validation Accuracy")
    axes[1, 1].semilogy(epochs, history["learning_rates"], color="orange")
    axes[1, 1].set_title("Learning Rate")
    for ax in axes.flat:
        ax.grid(True, alpha=0.3)
        ax.set_xlabel("Epoch")
    fig.suptitle(f"Training progress — epoch {epoch + 1}")
    path = os.path.join(out_dir, f"progress_epoch_{epoch + 1:04d}.png")
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close(fig)
    return path


def save_confusion_matrix(targets, predictions, epoch, out_dir):
    """2-class pixel confusion matrix (sklearn-equivalent counts)."""
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    t = np.asarray(targets).astype(np.int64).ravel()
    p = np.asarray(predictions).astype(np.int64).ravel()
    cm = np.zeros((2, 2), np.int64)
    for ti in (0, 1):
        for pi in (0, 1):
            cm[ti, pi] = np.sum((t == ti) & (p == pi))
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(cm, cmap="Blues")
    for (i, j), v in np.ndenumerate(cm):
        ax.text(j, i, f"{v:,}", ha="center", va="center",
                color="white" if v > cm.max() / 2 else "black")
    ax.set_xticks([0, 1], ["land", "water"])
    ax.set_yticks([0, 1], ["land", "water"])
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_title(f"Confusion matrix — epoch {epoch + 1}")
    fig.colorbar(im)
    path = os.path.join(out_dir, f"confusion_epoch_{epoch + 1:04d}.png")
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close(fig)
    return path


def save_final_report(history, out_dir):
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(2, 3, figsize=(16, 9))
    epochs = range(1, len(history["train_losses"]) + 1)
    axes[0, 0].plot(epochs, history["train_losses"])
    axes[0, 0].set_title("Train loss")
    axes[0, 1].plot(epochs, history["val_losses"], color="red")
    axes[0, 1].set_title("Val loss")
    axes[0, 2].plot(epochs, history["iou_scores"], color="green")
    axes[0, 2].set_title("Val IoU")
    axes[1, 0].plot(epochs, history["accuracies"], color="purple")
    axes[1, 0].set_title("Val accuracy")
    axes[1, 1].semilogy(epochs, history["learning_rates"], color="orange")
    axes[1, 1].set_title("Learning rate")
    ax = axes[1, 2]
    ax.axis("off")
    best_iou = max(history["iou_scores"]) if history["iou_scores"] else float("nan")
    stats = (
        f"epochs trained: {len(history['train_losses'])}\n"
        f"best IoU: {best_iou:.4f}\n"
        f"best epoch: {history.get('best_model_epoch', 0) + 1}\n"
        f"final val loss: {history['val_losses'][-1]:.4f}\n"
        f"training time: {history.get('training_time', 0):.1f}s"
    )
    ax.text(0.05, 0.9, "Training summary", fontsize=14, fontweight="bold",
            va="top")
    ax.text(0.05, 0.75, stats, fontsize=11, va="top", family="monospace")
    for a in axes.flat[:5]:
        a.grid(True, alpha=0.3)
        a.set_xlabel("Epoch")
    path = os.path.join(out_dir, "training_report.png")
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close(fig)
    return path
