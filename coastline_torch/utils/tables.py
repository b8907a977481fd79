"""Console result tables (the port's copy of `coastline/utils/tables.py`;
parity with the reference's final-comparison printout,
`Main_Final.py:886-909`)."""

from typing import Dict


def format_results_table(results: Dict[str, dict], param_counts: Dict[str, int]) -> str:
    """Time(ms) is per-image at the PROTOCOL batch (eval_batch_size —
    `Main_Final.py:644` semantics); the img/s column, present when
    `evaluate_model(throughput_batch=...)` measured one, is the chip's
    throughput at the bench-headline batch, so the protocol latency can't
    be misread as the hardware ceiling."""
    has_tp = any("throughput_images_per_sec" in r for r in results.values())
    tp_batch = next(
        (r["throughput_batch_size"] for r in results.values()
         if "throughput_batch_size" in r), 0)
    header = (
        f"{'Method':<15} {'IoU':<10} {'F1-Score':<10} {'Accuracy':<10} "
        f"{'Parameters':<12} {'Time(ms)':<10}"
    )
    if has_tp:
        header += f" {f'img/s@B{tp_batch}':<10}"
    width = max(75, len(header))
    lines = []
    lines.append("=" * width)
    lines.append("FINAL COMPARISON RESULTS")
    lines.append("=" * width)
    lines.append(header)
    lines.append("-" * width)
    for name, r in results.items():
        row = (
            f"{name:<15} "
            f"{r['mean_iou']:.4f}    "
            f"{r['mean_f1_score']:.4f}     "
            f"{r['mean_accuracy']:.4f}     "
            f"{param_counts.get(name, 0) / 1e6:.1f}M        "
            f"{r['avg_inference_time'] * 1000:.2f}"
        )
        if has_tp:
            tp = r.get("throughput_images_per_sec")
            row += f"      {tp:.1f}" if tp is not None else "      -"
        lines.append(row)
    if results:
        best_iou = max(results.items(), key=lambda kv: kv[1]["mean_iou"])
        best_f1 = max(results.items(), key=lambda kv: kv[1]["mean_f1_score"])
        best_acc = max(results.items(), key=lambda kv: kv[1]["mean_accuracy"])
        lines.append("")
        lines.append("WINNER ANALYSIS:")
        lines.append(f"  Best IoU: {best_iou[0]} ({best_iou[1]['mean_iou']:.4f})")
        lines.append(f"  Best F1-Score: {best_f1[0]} ({best_f1[1]['mean_f1_score']:.4f})")
        lines.append(f"  Best Accuracy: {best_acc[0]} ({best_acc[1]['mean_accuracy']:.4f})")
    return "\n".join(lines)
