"""Training-curve comparison figure (the port's copy of
`coastline/report/curves.py`; parity with `Main_Final.py:714-787` ->
training_curves.png). matplotlib is imported when a figure is drawn."""

from coastline_torch.report.trainer_viz import _pyplot

DEFAULT_COLORS = {
    "DeepLabV3+": "red",
    "YOLO-SEG": "blue",
    "Robust UNet": "green",
    "SegNet": "purple",
    "PSPNet": "orange",
    "Fast-SCNN": "brown",
    "ENet": "teal",
    "WaterNet": "navy",
    "MSWNet": "magenta",
    "HRNet-Water": "olive",
    "SegFormer-Lite": "crimson",
}
DEFAULT_STYLES = {"DeepLabV3+": "-", "YOLO-SEG": "--", "Robust UNet": "-."}
_PANELS = [
    ("train_loss", "Training Loss", "Loss", "o"),
    ("val_loss", "Validation Loss", "Loss", "s"),
    ("val_iou", "Validation IoU", "IoU", "^"),
    ("val_f1", "Validation F1-Score", "F1-Score", "d"),
]


def plot_training_curves(histories, save_path="./training_curves.png"):
    """histories: {model_name: history dict with train_loss/val_loss/val_iou/
    val_f1 lists}. 2x2 grid, dpi 300."""
    if not histories:
        return None
    plt = _pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(15, 10))
    fig.suptitle("Training Curves Comparison", fontsize=16, fontweight="bold")
    for ax, (key, title, ylabel, marker) in zip(axes.flat, _PANELS):
        for name, hist in histories.items():
            epochs = range(1, len(hist[key]) + 1)
            ax.plot(
                epochs,
                hist[key],
                color=DEFAULT_COLORS.get(name, "gray"),
                linestyle=DEFAULT_STYLES.get(name, "-"),
                label=name,
                linewidth=2,
                marker=marker,
                markersize=4,
            )
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.set_ylabel(ylabel)
        ax.legend()
        ax.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return save_path
