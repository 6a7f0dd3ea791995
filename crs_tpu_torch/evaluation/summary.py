"""Results summary tool (port of ``crs_tpu.evaluation.summary``).

Loads result JSONs from disk, pretty-prints sections, finds a metric
anywhere in the nested JSON, builds a side-by-side comparison table, ranks
best to worst by the metric's direction, and has its own command line.
Host code only; its text equals ``crs_tpu``'s.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

from .base import higher_is_better

__all__ = ["ResultsSummary"]


class ResultsSummary:
    def __init__(self, results_dirs: Optional[List[str]] = None):
        self.results: Dict[str, Dict[str, Any]] = {}
        for d in results_dirs or []:
            self.load_directory(d)

    def load_directory(self, path: str, label: Optional[str] = None) -> None:
        label = label or os.path.basename(os.path.normpath(path))
        merged: Dict[str, Any] = {}
        for fname in sorted(os.listdir(path)):
            if fname.endswith(".json"):
                with open(os.path.join(path, fname)) as f:
                    try:
                        merged[fname[:-5]] = json.load(f)
                    except json.JSONDecodeError:
                        continue
        if merged:
            self.results[label] = merged

    def load_file(self, path: str, label: Optional[str] = None) -> None:
        label = label or os.path.basename(path)
        with open(path) as f:
            self.results[label] = json.load(f)

    # nested-metric search
    @classmethod
    def find_metric(cls, tree: Any, metric: str) -> Optional[Any]:
        if isinstance(tree, dict):
            if metric in tree and isinstance(tree[metric], (int, float)):
                return tree[metric]
            for v in tree.values():
                found = cls.find_metric(v, metric)
                if found is not None:
                    return found
        return None

    def metric_across_results(self, metric: str) -> Dict[str, Any]:
        return {
            label: self.find_metric(tree, metric) for label, tree in self.results.items()
        }

    def comparison_table(self, metrics: List[str]) -> str:
        """Side-by-side table."""
        labels = list(self.results)
        widths = [max(len(m), 18) for m in metrics]
        header = f"{'model':<22}" + "".join(f"{m:<{w + 2}}" for m, w in zip(metrics, widths))
        lines = [header, "-" * len(header)]
        for label in labels:
            row = f"{label:<22}"
            for m, w in zip(metrics, widths):
                v = self.find_metric(self.results[label], m)
                row += f"{v:<{w + 2}.4f}" if isinstance(v, float) else f"{str(v):<{w + 2}}"
            lines.append(row)
        return "\n".join(lines)

    def rank(self, metric: str) -> List[Dict[str, Any]]:
        """Best→worst ranking with direction awareness."""
        vals = {
            label: v for label, v in self.metric_across_results(metric).items() if v is not None
        }
        hib = higher_is_better(metric)
        ordered = sorted(vals.items(), key=lambda kv: kv[1], reverse=(hib is not False))
        return [
            {"rank": i + 1, "label": label, "value": v} for i, (label, v) in enumerate(ordered)
        ]

    def print_summary(self) -> str:
        lines = []
        for label, tree in self.results.items():
            lines.append(f"=== {label} ===")
            for section, content in tree.items():
                lines.append(f"  [{section}]")
                metrics = content.get("metrics", content) if isinstance(content, dict) else {}
                if isinstance(metrics, dict):
                    for k, v in list(metrics.items())[:20]:
                        if isinstance(v, float):
                            lines.append(f"    {k}: {v:.4f}")
                        elif isinstance(v, (int, str, bool)):
                            lines.append(f"    {k}: {v}")
        return "\n".join(lines)


def main(argv=None) -> int:  # the command line
    ap = argparse.ArgumentParser(description="Summarize result JSONs")
    ap.add_argument("dirs", nargs="+", help="result directories")
    ap.add_argument("--metric", help="rank by this metric")
    ap.add_argument("--compare", nargs="+", help="comparison table for these metrics")
    args = ap.parse_args(argv)
    s = ResultsSummary(args.dirs)
    if args.metric:
        for row in s.rank(args.metric):
            print(f"{row['rank']}. {row['label']}: {row['value']}")
    elif args.compare:
        print(s.comparison_table(args.compare))
    else:
        print(s.print_summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
