"""Results exporter (port of ``crs_tpu.evaluation.export``).

Result JSONs → a CSV, a Markdown table, a LaTeX booktabs table with
escaping and a styled HTML table with the best and worst values marked;
all four at once, the automatic choice of metrics, and a command line.
Host code only; every file equals ``crs_tpu``'s byte for byte.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Any, Dict, List, Optional, Sequence

from .base import higher_is_better
from .summary import ResultsSummary

__all__ = ["ResultsExporter"]

_LATEX_ESCAPES = {
    "&": r"\&", "%": r"\%", "$": r"\$", "#": r"\#", "_": r"\_",
    "{": r"\{", "}": r"\}", "~": r"\textasciitilde{}", "^": r"\^{}",
}


def _latex_escape(s: str) -> str:
    return "".join(_LATEX_ESCAPES.get(c, c) for c in str(s))


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return "" if v is None else str(v)


class ResultsExporter:
    def __init__(self, results: Optional[Dict[str, Dict[str, Any]]] = None):
        self.results = results or {}

    @classmethod
    def from_directories(cls, dirs: Sequence[str]) -> "ResultsExporter":
        return cls(ResultsSummary(list(dirs)).results)

    def _value(self, label: str, metric: str):
        return ResultsSummary.find_metric(self.results[label], metric)

    def auto_metrics(self, limit: int = 8) -> List[str]:
        """Pick common numeric metrics across results."""
        candidates = [
            "latency_ms_per_token", "ttft_ms", "throughput_tokens_per_sec",
            "model_size_gb", "mfu_percent", "energy_per_token_mj", "perplexity",
            "average_accuracy", "avg_retrieval_time_ms", "f1_score",
            "context_sufficiency", "recall_at_10", "mrr",
        ]
        out = [
            m for m in candidates
            if all(self._value(l, m) is not None for l in self.results)
        ]
        return out[:limit]

    def _table(self, metrics: Optional[Sequence[str]]) -> (List[str], List[List[str]]):
        metrics = list(metrics or self.auto_metrics())
        rows = [
            [label] + [_fmt(self._value(label, m)) for m in metrics]
            for label in self.results
        ]
        return ["model"] + list(metrics), rows

    def _best_flags(self, metrics: Sequence[str]) -> Dict[str, str]:
        """label of the best value per metric (for highlighting)."""
        return {m: pair[0] for m, pair in self._extreme_flags(metrics).items()}

    def _extreme_flags(self, metrics: Sequence[str]) -> Dict[str, tuple]:
        """(best_label, worst_label) per metric; worst is None when it would
        equal best (fewer than two distinct values)."""
        out: Dict[str, tuple] = {}
        for m in metrics:
            vals = {l: self._value(l, m) for l in self.results}
            vals = {l: v for l, v in vals.items() if isinstance(v, (int, float))}
            if not vals:
                continue
            hib = higher_is_better(m)
            best = max(vals, key=vals.get) if hib is not False else min(vals, key=vals.get)
            worst = min(vals, key=vals.get) if hib is not False else max(vals, key=vals.get)
            out[m] = (best, worst if worst != best and vals[worst] != vals[best] else None)
        return out

    # -- formats --------------------------------------------------------------
    def to_csv(self, path: str, metrics: Optional[Sequence[str]] = None) -> None:
        header, rows = self._table(metrics)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(rows)

    def to_markdown(self, path: Optional[str] = None, metrics: Optional[Sequence[str]] = None) -> str:
        header, rows = self._table(metrics)
        lines = ["| " + " | ".join(header) + " |", "|" + "|".join("---" for _ in header) + "|"]
        for r in rows:
            lines.append("| " + " | ".join(r) + " |")
        md = "\n".join(lines)
        if path:
            with open(path, "w") as f:
                f.write(md + "\n")
        return md

    def to_latex(self, path: Optional[str] = None, metrics: Optional[Sequence[str]] = None,
                 caption: str = "Benchmark results") -> str:
        header, rows = self._table(metrics)
        cols = "l" + "r" * (len(header) - 1)
        lines = [
            r"\begin{table}[ht]", r"\centering",
            rf"\caption{{{_latex_escape(caption)}}}",
            rf"\begin{{tabular}}{{{cols}}}", r"\toprule",
            " & ".join(_latex_escape(h) for h in header) + r" \\", r"\midrule",
        ]
        for r in rows:
            lines.append(" & ".join(_latex_escape(c) for c in r) + r" \\")
        lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
        tex = "\n".join(lines)
        if path:
            with open(path, "w") as f:
                f.write(tex + "\n")
        return tex

    def to_html(self, path: Optional[str] = None, metrics: Optional[Sequence[str]] = None) -> str:
        metrics = list(metrics or self.auto_metrics())
        flags = self._extreme_flags(metrics)
        head = "".join(f"<th>{m}</th>" for m in ["model"] + metrics)
        body_rows = []
        for label in self.results:
            cells = [f"<td>{label}</td>"]
            for m in metrics:
                v = self._value(label, m)
                best, worst = flags.get(m, (None, None))
                cls = ""
                if best == label:
                    cls = ' class="best"'
                elif worst == label:
                    cls = ' class="worst"'
                cells.append(f"<td{cls}>{_fmt(v)}</td>")
            body_rows.append("<tr>" + "".join(cells) + "</tr>")
        html = (
            "<html><head><style>"
            "table{border-collapse:collapse;font-family:sans-serif}"
            "td,th{border:1px solid #999;padding:4px 8px}"
            "td.best{background:#c8e6c9;font-weight:bold}"
            "td.worst{background:#ffcdd2}"
            "</style></head><body><table>"
            f"<tr>{head}</tr>{''.join(body_rows)}</table></body></html>"
        )
        if path:
            with open(path, "w") as f:
                f.write(html)
        return html

    def export_all(self, out_dir: str, metrics: Optional[Sequence[str]] = None) -> Dict[str, str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = {
            "csv": os.path.join(out_dir, "results.csv"),
            "markdown": os.path.join(out_dir, "results.md"),
            "latex": os.path.join(out_dir, "results.tex"),
            "html": os.path.join(out_dir, "results.html"),
        }
        self.to_csv(paths["csv"], metrics)
        self.to_markdown(paths["markdown"], metrics)
        self.to_latex(paths["latex"], metrics)
        self.to_html(paths["html"], metrics)
        return paths


def main(argv=None) -> int:  # the command line
    ap = argparse.ArgumentParser(description="Export result JSONs to tables")
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--format", choices=["csv", "markdown", "latex", "html", "all"], default="markdown")
    ap.add_argument("--out", default="export")
    ap.add_argument("--metrics", nargs="+")
    args = ap.parse_args(argv)
    ex = ResultsExporter.from_directories(args.dirs)
    if args.format == "all":
        print(ex.export_all(args.out, args.metrics))
    elif args.format == "csv":
        ex.to_csv(os.path.join(args.out, "results.csv"), args.metrics)
    elif args.format == "markdown":
        print(ex.to_markdown(None, args.metrics))
    elif args.format == "latex":
        print(ex.to_latex(None, args.metrics))
    else:
        print(ex.to_html(None, args.metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
