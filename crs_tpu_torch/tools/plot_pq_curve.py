"""Recall-vs-latency Pareto figure from pq_recall_curve JSON output (port of
``tools/plot_pq_curve.py``).

Connected scatter: one line per (loss, m, coarse) configuration, points at
the candidate depths, x = ms/query, y = recall@10 after rescore vs the exact
fp32 oracle. Colors: isotropic = blue, anisotropic = orange (fixed
categorical order); marker shape encodes m as a secondary (CVD-safe)
channel; solid lines c=2048, dashed c=4096. Emits PNG and PDF. The series,
colours and markers are the JAX tool's; the title names the rows and the
device of the files' rows instead of the JAX tool's fixed "4M×384, TPU
v5e". It needs matplotlib, and raises without it, or when no row is left to
draw, instead of writing an empty figure. It reads only the files;
``--device`` follows the port's device rule (the card unless ``--device
cpu``), as every entry point of the port does.

Usage:
  python -m crs_tpu_torch.tools.plot_pq_curve curve_4m.json curve_4m_aniso.json --out DIR/pq_curve
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..device import resolve_device
from . import output_dir

__all__ = ["ISO", "ANISO", "MARKERS", "pyplot", "select_rows", "draw", "main"]

ISO, ANISO = "#2a78d6", "#eb6834"  # categorical slots 1-2, fixed order
INK, INK2 = "#0b0b0b", "#52514e"
MARKERS = {12: "o", 16: "s", 24: "^"}


def pyplot():
    """matplotlib's pyplot on the Agg backend; raises when matplotlib is
    missing (no figure is written then)."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("plot_pq_curve needs matplotlib, which is not installed here; "
                           "no figure was written") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def select_rows(rows, min_cand: int, report=print):
    """The rows drawn: cand ≥ ``min_cand``, less the timing-artifact cells
    (scan_ms under 1 ms or over 1.3× the median of the same m's other
    cells), each dropped one reported."""
    rows = [r for r in rows if r["cand"] >= min_cand]

    # Median scan_ms across the grid's same-m cells is within ±6% on a
    # steady device, so exclude outliers rather than impute them.
    def _artifact(r):
        sib = [s["scan_ms"] for s in rows
               if s["m"] == r["m"] and s is not r and s["scan_ms"] > 1.0]
        med = sorted(sib)[len(sib) // 2] if sib else r["scan_ms"]
        return r["scan_ms"] < 1.0 or r["scan_ms"] > 1.3 * med

    for r in [r for r in rows if _artifact(r)]:
        report(f"dropped timing-artifact cell: m={r['m']} c={r['coarse']} "
               f"cand={r['cand']} scan_ms={r['scan_ms']}")
    return [r for r in rows if not _artifact(r)]


def _title(rows) -> str:
    sizes = sorted({r["rows"] for r in rows})
    size = ", ".join(f"{n // 1_000_000}M" if n % 1_000_000 == 0 else f"{n:,}" for n in sizes)
    devices = ", ".join(sorted({str(r.get("device", "unknown device")) for r in rows}))
    return (f"Residual-PQ operating points, {size} rows, {devices}\n"
            "(cand 200→400 along each line; solid c=2048, dashed c=4096)")


def draw(plt, rows):
    """The figure of ``rows`` (already selected)."""
    series = {}  # (aniso, m, coarse) -> [(ms, recall, cand)]
    for r in rows:
        key = (r.get("aniso_eta", 0.0) > 0.0, r["m"], r["coarse"])
        series.setdefault(key, []).append((r["ms_per_query"], r["recall_host"], r["cand"]))

    fig, ax = plt.subplots(figsize=(5.4, 3.6), dpi=200)
    fig.patch.set_facecolor("white")
    ax.set_facecolor("white")

    seen = set()
    for (aniso, m, coarse), pts in sorted(series.items()):
        pts.sort(key=lambda p: p[2])  # order along the cand lever
        color = ANISO if aniso else ISO
        ls = "-" if coarse == 2048 else (0, (4, 2))
        xs, ys = [p[0] for p in pts], [p[1] for p in pts]
        label = f"{'aniso' if aniso else 'iso'} m={m}"
        ax.plot(xs, ys, color=color, linewidth=2, linestyle=ls, marker=MARKERS[m],
                markersize=7, markerfacecolor=color, markeredgecolor="white",
                markeredgewidth=1.2, label=label if label not in seen else None,
                alpha=0.95, zorder=3)
        seen.add(label)

    # direct labels: one per (loss, m) family, at its rightmost point
    fams = {}
    for (aniso, m, coarse), pts in series.items():
        best = max(pts)
        cur = fams.get((aniso, m))
        if cur is None or best[0] > cur[0]:
            fams[(aniso, m)] = best
    for (aniso, m), (x, y, c) in fams.items():
        ax.annotate(f"{'aniso' if aniso else 'iso'} m={m}", (x, y), textcoords="offset points",
                    xytext=(6, -2), fontsize=8, color=INK)

    ax.set_xlabel("latency (ms/query, scan + rescore)", fontsize=9, color=INK)
    ax.set_ylabel("recall@10 after rescore", fontsize=9, color=INK)
    ax.tick_params(labelsize=8, colors=INK2, length=0)
    ax.grid(True, color="#e8e7e3", linewidth=0.7, zorder=0)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color("#c3c2b7")
    ax.legend(fontsize=8, frameon=False, loc="lower right", ncol=2)
    ax.set_title(_title(rows), fontsize=9, color=INK)
    fig.tight_layout()
    return fig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--out", default=os.path.join(output_dir("plot_pq_curve"), "pq_curve"))
    ap.add_argument("--min-cand", type=int, default=200,
                    help="drop cells below this cand (keep the comparison apples-even)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    plt = pyplot()

    rows = []
    for f in args.files:
        with open(f) as fh:
            rows.extend(json.load(fh))
    rows = select_rows(rows, args.min_cand)
    if not rows:
        raise ValueError(f"no row of {args.files} is left to draw (cand >= {args.min_cand}, "
                         "timing artifacts dropped); no figure was written")
    fig = draw(plt, rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for ext in ("png", "pdf"):
        fig.savefig(f"{args.out}.{ext}", bbox_inches="tight")
        print(f"wrote {args.out}.{ext}")
    plt.close(fig)
    return 0


if __name__ == "__main__":
    sys.exit(main())
