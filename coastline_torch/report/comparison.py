"""Benchmark comparison bar charts (the port's copy of
`coastline/report/comparison.py`; matplotlib is imported when a figure is
drawn).

Parity targets: 1x3 IoU/F1/Acc bars with value labels
(`Main_Final.py:790-817` -> coastal_comparison.png) and the
extended 2x3 variant with inference time and best-bar highlighting
(`Extended_Baseline_Comparison.py:980-1028` -> extended_comparison.png).
"""

from coastline_torch.report.trainer_viz import _pyplot


def plot_comparison(results, save_path="./coastal_comparison.png"):
    """results: {model: {'mean_iou':..,'mean_f1_score':..,'mean_accuracy':..}}"""
    if not results:
        return None
    plt = _pyplot()
    methods = list(results)
    panels = [("mean_iou", "IoU"), ("mean_f1_score", "F1-Score"), ("mean_accuracy", "Accuracy")]
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    palette = ["lightcoral", "lightblue", "lightgreen", "wheat", "plum", "lightgray"]
    for ax, (metric, name) in zip(axes, panels):
        values = [results[m][metric] for m in methods]
        bars = ax.bar(methods, values, color=[palette[i % len(palette)] for i in range(len(methods))])
        ax.set_title(f"{name} Comparison")
        ax.set_ylabel(name)
        ax.tick_params(axis="x", rotation=45)
        for bar, value in zip(bars, values):
            ax.text(
                bar.get_x() + bar.get_width() / 2.0,
                bar.get_height() + 0.001,
                f"{value:.3f}",
                ha="center",
                va="bottom",
            )
    plt.tight_layout()
    plt.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_extended_comparison(results, save_path="./extended_comparison.png"):
    """2x3 bars: IoU/F1/Acc/Precision/Recall/inference-ms; best bar gets a
    red edge (Extended_Baseline_Comparison.py:1006-1016)."""
    if not results:
        return None
    plt = _pyplot()
    methods = list(results)
    # label the panel with the batch the timing was measured at (per-image
    # ms depends on it; evaluate_model records inference_batch_size)
    batches = {results[m].get("inference_batch_size") for m in methods}
    b = batches.pop() if len(batches) == 1 else None
    time_label = f"Inference Time (ms, batch {b})" if b else "Inference Time (ms)"
    panels = [
        ("mean_iou", "IoU", True),
        ("mean_f1_score", "F1-Score", True),
        ("mean_accuracy", "Accuracy", True),
        ("mean_precision", "Precision", True),
        ("mean_recall", "Recall", True),
        ("avg_inference_time", time_label, False),  # lower better
    ]
    fig, axes = plt.subplots(2, 3, figsize=(18, 10))
    for ax, (metric, name, higher_better) in zip(axes.flat, panels):
        values = [
            results[m][metric] * (1000.0 if metric == "avg_inference_time" else 1.0)
            for m in methods
        ]
        best = max(range(len(values)), key=lambda i: values[i] if higher_better else -values[i])
        bars = ax.bar(methods, values, color="lightsteelblue")
        bars[best].set_edgecolor("red")
        bars[best].set_linewidth(2.5)
        ax.set_title(name)
        ax.tick_params(axis="x", rotation=60)
        for bar, value in zip(bars, values):
            ax.text(
                bar.get_x() + bar.get_width() / 2.0,
                bar.get_height(),
                f"{value:.3f}" if value < 10 else f"{value:.1f}",
                ha="center",
                va="bottom",
                fontsize=8,
            )
    plt.tight_layout()
    plt.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return save_path
