"""Summarize pq_recall_curve output (port of ``tools/curve_report.py``):
markdown table + per-budget winners.

Reads one or more curve JSON files (lists of row dicts, the port's
``pq_recall_curve`` or the JAX tool's), merges them, and prints (a) a
markdown table sorted by (bytes_per_vec, m, coarse, cand, aniso_eta), (b) the
Pareto winners: for each bytes/vec budget, the config with the highest
recall_host, and the cheapest config reaching the ``--target`` recall (the
>=0.9-at-<=16B criterion). The output is the JAX tool's, byte for byte. It
reads only the files; ``--device`` follows the port's device rule (the card
unless ``--device cpu``), as every entry point of the port does.

Usage:
  python -m crs_tpu_torch.tools.curve_report curve_1m.json --target 0.9 --budget 16
"""

from __future__ import annotations

import argparse
import json
import sys

from ..device import resolve_device

__all__ = ["COLS", "main"]

COLS = ["rows", "m", "coarse", "cand", "aniso_eta", "opq_init", "bytes_per_vec", "recall_none",
        "recall_in_cand", "recall_host", "ms_per_query", "device"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--target", type=float, default=0.9)
    ap.add_argument("--budget", type=int, default=16, help="max bytes/vec")
    ap.add_argument("--metric", default="recall_host",
                    choices=("recall_host", "recall_none", "recall_in_cand"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    rows = []
    for f in args.files:
        with open(f) as fh:
            rows.extend(json.load(fh))
    if not rows:
        print("no rows", file=sys.stderr)
        return 1
    for r in rows:  # older rows predate these fields
        r.setdefault("aniso_eta", 0.0)
        r.setdefault("opq_init", "identity")
    rows.sort(key=lambda r: (r["bytes_per_vec"], r["m"], r["coarse"], r["cand"], r["aniso_eta"],
                             r["opq_init"]))

    print("| " + " | ".join(COLS) + " |")
    print("|" + "---|" * len(COLS))
    for r in rows:
        print("| " + " | ".join(str(r.get(c, "")) for c in COLS) + " |")

    print()
    by_budget = {}
    for r in rows:
        b = r["bytes_per_vec"]
        if b not in by_budget or r[args.metric] > by_budget[b][args.metric]:
            by_budget[b] = r
    print(f"Best {args.metric} per bytes/vec budget:")
    for b in sorted(by_budget):
        r = by_budget[b]
        print(f"  {b:3d} B/vec: {r[args.metric]:.4f}  "
              f"(m={r['m']} coarse={r['coarse']} cand={r['cand']} "
              f"eta={r['aniso_eta']} init={r['opq_init']} "
              f"{r['ms_per_query']} ms/q)")

    hit = [r for r in rows
           if r["bytes_per_vec"] <= args.budget and r[args.metric] >= args.target]
    if hit:
        # cheapest = lowest bytes, then lowest latency
        best = min(hit, key=lambda r: (r["bytes_per_vec"], r.get("ms_per_query", 1e9)))
        print(f"\nVERDICT criterion MET: {args.metric} >= {args.target} at "
              f"<= {args.budget} B/vec:")
        print("  " + json.dumps(best))
    else:
        best = max((r for r in rows if r["bytes_per_vec"] <= args.budget),
                   key=lambda r: r[args.metric], default=None)
        print(f"\nVERDICT criterion NOT met within {args.budget} B/vec; "
              f"best: {json.dumps(best) if best else 'n/a'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
