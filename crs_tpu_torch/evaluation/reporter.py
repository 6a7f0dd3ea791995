"""Self-contained HTML report generator (port of
``crs_tpu.evaluation.reporter``).

An executive summary, the plots embedded in base64 (through the
visualizer), metric tables with best / worst cell classes, a section per
benchmark, pairwise comparison sections, and metadata. Host code only; the
report equals ``crs_tpu``'s but for its time stamp.
"""

from __future__ import annotations

import base64
import html
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from .comparator import ResultsComparator
from .export import ResultsExporter
from .summary import ResultsSummary
from .visualizer import ResultsVisualizer

__all__ = ["ReportGenerator"]

_STYLE = """
body{font-family:sans-serif;margin:2em;max-width:1100px}
h1,h2{color:#223} table{border-collapse:collapse;margin:1em 0}
td,th{border:1px solid #aaa;padding:4px 10px;font-size:14px}
td.best{background:#c8e6c9;font-weight:bold}
td.worst{background:#ffcdd2}
.meta{color:#666;font-size:12px} img{max-width:100%}
.section{margin-top:2em}
"""


class ReportGenerator:
    def __init__(self, results: Optional[Dict[str, Dict[str, Any]]] = None):
        self.results = results or {}

    @classmethod
    def from_directories(cls, dirs: Sequence[str]) -> "ReportGenerator":
        return cls(ResultsSummary(list(dirs)).results)

    def generate(self, out_path: str = "report.html", title: str = "Evaluation Report") -> str:
        exporter = ResultsExporter(self.results)
        comparator = ResultsComparator(self.results)
        metrics = exporter.auto_metrics()

        parts: List[str] = [
            f"<html><head><title>{html.escape(title)}</title><style>{_STYLE}</style></head><body>",
            f"<h1>{html.escape(title)}</h1>",
            f'<p class="meta">generated {time.strftime("%Y-%m-%d %H:%M:%S")} · '
            f"{len(self.results)} result sets · metrics: {', '.join(metrics) or 'n/a'}</p>",
        ]

        # executive summary: best model per metric
        parts.append('<div class="section"><h2>Executive summary</h2><ul>')
        for m in metrics:
            best = comparator.best_model(m)
            if best:
                parts.append(f"<li><b>{html.escape(m)}</b>: best = {html.escape(best[0])} ({best[1]:.4g})</li>")
        parts.append("</ul></div>")

        # main metric table (best-value highlighting via exporter)
        table_html = exporter.to_html(None, metrics)
        table_body = table_html.split("<body>")[1].split("</body>")[0]
        parts.append(f'<div class="section"><h2>Results</h2>{table_body}</div>')

        # per-domain sections: that domain's metric table + its plots
        plots = self._plots()
        for domain, domain_metrics in (
            ("Efficiency", ResultsVisualizer.EFFICIENCY_METRICS),
            ("Performance", ResultsVisualizer.PERFORMANCE_METRICS),
            ("Retrieval", ResultsVisualizer.RETRIEVAL_METRICS),
        ):
            present = [
                m for m in domain_metrics
                if any(m in self._flat(r) for r in self.results.values())
            ]
            section_plots = plots.get(domain.lower(), [])
            if not present and not section_plots:
                continue
            parts.append(f'<div class="section"><h2>{domain}</h2>')
            if present:
                t = exporter.to_html(None, present)
                parts.append(t.split("<body>")[1].split("</body>")[0])
            for p in section_plots:
                parts.append(f'<img src="data:image/png;base64,{p}"/>')
            parts.append("</div>")
        if plots.get("dashboard"):
            parts.append('<div class="section"><h2>Dashboard</h2>')
            for p in plots["dashboard"]:
                parts.append(f'<img src="data:image/png;base64,{p}"/>')
            parts.append("</div>")

        # pairwise comparisons
        pairs = comparator.compare_all_pairs(metrics)
        if pairs:
            parts.append('<div class="section"><h2>Pairwise comparisons</h2>')
            for cmp in pairs:
                parts.append(
                    f"<h3>{html.escape(cmp['a'])} vs {html.escape(cmp['b'])} "
                    f"(improved {cmp['improved']}, regressed {cmp['regressed']})</h3><ul>"
                )
                for m, d in cmp["metrics"].items():
                    if d["direction"]:
                        parts.append(
                            f"<li>{html.escape(m)}: {d['a']:.4g} vs {d['b']:.4g} "
                            f"({d['pct']:+.1f}%, {d['direction']})</li>"
                        )
                parts.append("</ul>")
            parts.append("</div>")

        parts.append("</body></html>")
        doc = "\n".join(parts)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            f.write(doc)
        return out_path

    @staticmethod
    def _flat(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(ReportGenerator._flat(v, f"{prefix}{k}."))
            else:
                out[k] = v  # leaf metric names are unique across domains
        return out

    def _plots(self) -> Dict[str, List[str]]:
        """Render plots to a temp dir; return {domain: [base64 png, ...]}."""
        import tempfile

        out: Dict[str, List[str]] = {}

        def collect(domain: str, paths: Sequence[Optional[str]]) -> None:
            for p in paths:
                if not p:
                    continue
                try:
                    with open(p, "rb") as f:
                        out.setdefault(domain, []).append(
                            base64.b64encode(f.read()).decode("ascii")
                        )
                except OSError:
                    continue

        with tempfile.TemporaryDirectory() as td:
            viz = ResultsVisualizer(self.results, out_dir=td)
            collect("efficiency", viz.plot_efficiency())
            collect("retrieval", viz.plot_retrieval())
            collect("performance", viz.plot_performance())
            collect("dashboard", [viz.plot_dashboard()])
        return out
