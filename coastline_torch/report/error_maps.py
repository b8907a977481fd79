"""Per-model error-map grid (the port's copy of
`coastline/report/error_maps.py`; parity with
`Extended_Baseline_Comparison.py:863-977` ->
error_maps/error_maps_comparison.png). matplotlib is imported when the
figure is drawn.

Rows = validation samples; columns = input, ground truth, then per model a
TP/FP/FN/TN overlay with an IoU badge and an |error| heat map with MAE.
The predictions arrive as host arrays.
"""

import os

import numpy as np

from coastline_torch.report.trainer_viz import _pyplot

# TP green, FP red, FN blue, TN black (reference color coding)
_TP = np.array([0.0, 0.8, 0.0])
_FP = np.array([0.9, 0.0, 0.0])
_FN = np.array([0.0, 0.2, 0.9])
_TN = np.array([0.05, 0.05, 0.05])


def _overlay(pred, targ):
    h, w = pred.shape
    out = np.zeros((h, w, 3))
    tp = pred & targ
    fp = pred & ~targ
    fn = ~pred & targ
    tn = ~pred & ~targ
    for mask, color in [(tp, _TP), (fp, _FP), (fn, _FN), (tn, _TN)]:
        out[mask] = color
    return out


def generate_error_maps(
    images_u8,  # (N,H,W,3) uint8 originals (pre-normalization)
    targets,  # (N,H,W) {0,1}
    predictions,  # {model_name: (N,H,W) probs or binary}
    out_dir="./error_maps",
    n_samples=6,
    threshold=0.5,
):
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    n = min(n_samples, images_u8.shape[0])
    models = list(predictions)
    cols = 2 + 2 * len(models)
    fig, axes = plt.subplots(n, cols, figsize=(3 * cols, 3 * n), squeeze=False)

    for i in range(n):
        targ = targets[i] > 0.5
        axes[i][0].imshow(images_u8[i])
        axes[i][0].set_ylabel(f"sample {i}", fontsize=9)
        if i == 0:
            axes[i][0].set_title("Input")
        axes[i][1].imshow(targ, cmap="gray")
        if i == 0:
            axes[i][1].set_title("Ground Truth")
        for j, name in enumerate(models):
            prob = np.asarray(predictions[name][i], np.float32)
            pred = prob > threshold
            inter = np.logical_and(pred, targ).sum()
            union = np.logical_or(pred, targ).sum()
            iou = inter / (union + 1e-8)
            ax = axes[i][2 + 2 * j]
            ax.imshow(_overlay(pred, targ))
            ax.text(
                4, 18, f"IoU {iou:.3f}", color="yellow", fontsize=8,
                bbox=dict(facecolor="black", alpha=0.6, pad=1),
            )
            if i == 0:
                ax.set_title(f"{name}\nTP/FP/FN/TN", fontsize=9)
            err = np.abs(prob - targ.astype(np.float32))
            axh = axes[i][3 + 2 * j]
            axh.imshow(err, cmap="hot", vmin=0, vmax=1)
            axh.text(
                4, 18, f"MAE {err.mean():.3f}", color="cyan", fontsize=8,
                bbox=dict(facecolor="black", alpha=0.6, pad=1),
            )
            if i == 0:
                axh.set_title(f"{name}\n|error|", fontsize=9)
    for ax in fig.axes:
        ax.set_xticks([])
        ax.set_yticks([])

    import matplotlib.patches as mpatches

    fig.legend(
        handles=[
            mpatches.Patch(color=_TP, label="TP"),
            mpatches.Patch(color=_FP, label="FP"),
            mpatches.Patch(color=_FN, label="FN"),
            mpatches.Patch(color=_TN, label="TN"),
        ],
        loc="lower center",
        ncol=4,
    )
    path = os.path.join(out_dir, "error_maps_comparison.png")
    plt.tight_layout(rect=(0, 0.03, 1, 1))
    plt.savefig(path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return path
