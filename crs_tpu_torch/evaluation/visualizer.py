"""Results visualizer (port of ``crs_tpu.evaluation.visualizer``).

Matplotlib bar charts (one metric, and the efficiency, performance and
retrieval panels), task accuracy and context quality, a radar chart, a
multi-panel dashboard, and a command line. Without matplotlib a plot is
skipped with a warning, as in ``crs_tpu``. The plot files have
``crs_tpu``'s names.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict, List, Optional, Sequence

from .summary import ResultsSummary

logger = logging.getLogger(__name__)

__all__ = ["ResultsVisualizer"]


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:  # pragma: no cover
        return None


class ResultsVisualizer:
    EFFICIENCY_METRICS = ("latency_ms_per_token", "throughput_tokens_per_sec", "model_size_gb", "energy_per_token_mj")
    PERFORMANCE_METRICS = ("perplexity", "average_accuracy")
    RETRIEVAL_METRICS = ("avg_retrieval_time_ms", "f1_score", "context_sufficiency", "faithfulness")

    def __init__(self, results: Optional[Dict[str, Dict[str, Any]]] = None, out_dir: str = "plots"):
        self.results = results or {}
        self.out_dir = out_dir

    @classmethod
    def from_directories(cls, dirs: Sequence[str], out_dir: str = "plots") -> "ResultsVisualizer":
        return cls(ResultsSummary(list(dirs)).results, out_dir)

    def _values(self, metric: str) -> Dict[str, float]:
        out = {}
        for label, tree in self.results.items():
            v = ResultsSummary.find_metric(tree, metric)
            if isinstance(v, (int, float)):
                out[label] = float(v)
        return out

    def plot_metric_comparison(self, metric: str, path: Optional[str] = None) -> Optional[str]:
        plt = _mpl()
        if plt is None:
            logger.warning("matplotlib unavailable; skipping plot")
            return None
        vals = self._values(metric)
        if not vals:
            return None
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.bar(list(vals), list(vals.values()), color="#4c72b0")
        ax.set_title(metric)
        ax.set_ylabel(metric)
        ax.tick_params(axis="x", rotation=30)
        fig.tight_layout()
        path = path or os.path.join(self.out_dir, f"{metric}.png")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path

    def plot_group(self, metrics: Sequence[str], name: str) -> List[str]:
        return [p for m in metrics if (p := self.plot_metric_comparison(m))]

    # -- domain-specific layouts ---------------------------------------------
    def _panel(self, metrics: Sequence[str], name: str, title: str) -> Optional[str]:
        """Multi-panel bar figure with best/worst bar coloring + value labels
        (the per-domain layouts)."""
        plt = _mpl()
        if plt is None:
            return None
        from .base import higher_is_better

        panels = [(m, self._values(m)) for m in metrics]
        panels = [(m, v) for m, v in panels if v]
        if not panels:
            return None
        cols = min(len(panels), 2)
        rows = -(-len(panels) // cols)
        fig, axes = plt.subplots(rows, cols, figsize=(6 * cols, 3.6 * rows), squeeze=False)
        for ax, (metric, vals) in zip(axes.flat, panels):
            labels = list(vals)
            values = [vals[l] for l in labels]
            hib = higher_is_better(metric)
            best = max(values) if hib is not False else min(values)
            worst = min(values) if hib is not False else max(values)
            colors = [
                "#2e7d32" if v == best else ("#c62828" if v == worst and len(set(values)) > 1 else "#4c72b0")
                for v in values
            ]
            bars = ax.bar(labels, values, color=colors)
            for bar, v in zip(bars, values):
                ax.annotate(f"{v:.4g}", (bar.get_x() + bar.get_width() / 2, bar.get_height()),
                            ha="center", va="bottom", fontsize=7)
            ax.set_title(metric, fontsize=10)
            ax.tick_params(axis="x", rotation=30, labelsize=7)
        for ax in axes.flat[len(panels):]:
            ax.axis("off")
        fig.suptitle(title)
        fig.tight_layout()
        path = os.path.join(self.out_dir, f"{name}.png")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path

    def plot_task_accuracies(self, path: Optional[str] = None) -> Optional[str]:
        """Grouped per-task accuracy bars across models."""
        plt = _mpl()
        if plt is None:
            return None
        import numpy as np

        def find_tasks(tree):
            if isinstance(tree, dict):
                if isinstance(tree.get("tasks"), dict):
                    return tree["tasks"]
                for v in tree.values():
                    found = find_tasks(v)
                    if found is not None:
                        return found
            return None

        per_model: Dict[str, Dict[str, float]] = {}
        for label, tree in self.results.items():
            tasks = find_tasks(tree)
            if isinstance(tasks, dict):
                scores = {
                    t: d.get("score") for t, d in tasks.items()
                    if isinstance(d, dict) and isinstance(d.get("score"), (int, float))
                }
                if scores:
                    per_model[label] = scores
        if not per_model:
            return None
        task_names = sorted({t for s in per_model.values() for t in s})
        x = np.arange(len(task_names))
        width = 0.8 / max(len(per_model), 1)
        fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(task_names)), 4))
        for i, (label, scores) in enumerate(per_model.items()):
            vals = [scores.get(t, 0.0) for t in task_names]
            ax.bar(x + i * width, vals, width, label=label)
        ax.set_xticks(x + width * (len(per_model) - 1) / 2)
        ax.set_xticklabels(task_names, rotation=30, fontsize=7)
        ax.set_ylabel("accuracy")
        ax.set_title("task accuracy by model")
        ax.legend(fontsize=7)
        fig.tight_layout()
        path = path or os.path.join(self.out_dir, "task_accuracy.png")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path

    def plot_context_quality(self, path: Optional[str] = None) -> Optional[str]:
        """Grouped sufficiency/precision/coverage bars per model."""
        plt = _mpl()
        if plt is None:
            return None
        import numpy as np

        triplet = ("context_sufficiency", "context_precision", "context_coverage")
        vals = {m: self._values(m) for m in triplet}
        labels = sorted({l for v in vals.values() for l in v})
        if not labels:
            return None
        x = np.arange(len(labels))
        width = 0.8 / len(triplet)
        fig, ax = plt.subplots(figsize=(max(6, 1.4 * len(labels)), 4))
        for i, m in enumerate(triplet):
            ax.bar(x + i * width, [vals[m].get(l, 0.0) for l in labels], width,
                   label=m.replace("context_", ""))
        ax.set_xticks(x + width)
        ax.set_xticklabels(labels, rotation=30, fontsize=8)
        ax.set_ylim(0, 1.05)
        ax.set_title("context quality")
        ax.legend(fontsize=8)
        fig.tight_layout()
        path = path or os.path.join(self.out_dir, "context_quality.png")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path

    def plot_efficiency(self) -> List[str]:
        out = [self._panel(self.EFFICIENCY_METRICS, "efficiency", "efficiency")]
        return [p for p in out if p]

    def plot_performance(self) -> List[str]:
        out = [
            self._panel(self.PERFORMANCE_METRICS, "performance", "performance"),
            self.plot_task_accuracies(),
        ]
        return [p for p in out if p]

    def plot_retrieval(self) -> List[str]:
        out = [
            self._panel(self.RETRIEVAL_METRICS, "retrieval", "retrieval"),
            self.plot_context_quality(),
        ]
        return [p for p in out if p]

    def plot_radar(self, metrics: Sequence[str], path: Optional[str] = None) -> Optional[str]:
        """Normalized radar chart across models."""
        plt = _mpl()
        if plt is None:
            return None
        import numpy as np

        from .base import higher_is_better

        metric_vals = {m: self._values(m) for m in metrics}
        metric_vals = {m: v for m, v in metric_vals.items() if len(v) >= 1}
        if not metric_vals:
            return None
        labels = sorted({l for v in metric_vals.values() for l in v})
        angles = np.linspace(0, 2 * np.pi, len(metric_vals), endpoint=False).tolist()
        angles += angles[:1]
        fig, ax = plt.subplots(figsize=(6, 6), subplot_kw={"polar": True})
        for label in labels:
            scores = []
            for m, vals in metric_vals.items():
                v = vals.get(label)
                lo, hi = min(vals.values()), max(vals.values())
                s = 0.5 if hi == lo or v is None else (v - lo) / (hi - lo)
                if higher_is_better(m) is False:
                    s = 1.0 - s
                scores.append(s)
            scores += scores[:1]
            ax.plot(angles, scores, label=label)
            ax.fill(angles, scores, alpha=0.1)
        ax.set_xticks(angles[:-1])
        ax.set_xticklabels(list(metric_vals), fontsize=7)
        ax.legend(loc="upper right", fontsize=7)
        path = path or os.path.join(self.out_dir, "radar.png")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path

    def plot_dashboard(self, path: Optional[str] = None) -> Optional[str]:
        """Multi-panel dashboard."""
        plt = _mpl()
        if plt is None:
            return None
        panels = [
            m for m in (
                self.EFFICIENCY_METRICS + self.PERFORMANCE_METRICS + self.RETRIEVAL_METRICS
            ) if self._values(m)
        ][:6]
        if not panels:
            return None
        fig, axes = plt.subplots(2, 3, figsize=(13, 7))
        for ax, metric in zip(axes.flat, panels):
            vals = self._values(metric)
            ax.bar(list(vals), list(vals.values()), color="#55a868")
            ax.set_title(metric, fontsize=9)
            ax.tick_params(axis="x", rotation=30, labelsize=7)
        for ax in axes.flat[len(panels):]:
            ax.axis("off")
        fig.tight_layout()
        path = path or os.path.join(self.out_dir, "dashboard.png")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=100)
        plt.close(fig)
        return path


def main(argv=None) -> int:  # the command line
    ap = argparse.ArgumentParser(description="Plot result comparisons")
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--out", default="plots")
    ap.add_argument("--metric", help="single metric bar chart")
    args = ap.parse_args(argv)
    v = ResultsVisualizer.from_directories(args.dirs, args.out)
    if args.metric:
        print(v.plot_metric_comparison(args.metric))
    else:
        print(v.plot_efficiency() + v.plot_performance() + v.plot_retrieval())
        print(v.plot_dashboard())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
