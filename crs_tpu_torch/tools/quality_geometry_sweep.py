"""Chunk-geometry sweep at matched total context (port of
``tools/quality_geometry_sweep.py``): within a context budget of about the
reference's (~1.5k chars), the chunk size / top_k split is a free
retrieval-design axis. Finer chunks, and more of them, buy union coverage
if the retriever can rank them; this sweep measures that trade on the 10q
and 41q sets. Writes ``geometry_sweep.json`` under the tool's output
directory.

Usage: python -m crs_tpu_torch.tools.quality_geometry_sweep [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import output_dir, quality_common as qc

__all__ = ["GEOMETRIES", "run", "main"]

GEOMETRIES = (  # chunk size, overlap, minimum (words), top_k
    (90, 18, 25, 3),  # the matched row
    (60, 12, 18, 5),
    (45, 9, 14, 6),
    (45, 9, 14, 7),
    (30, 6, 10, 9),
    (30, 6, 10, 10),
    (60, 12, 18, 4),
    (22, 4, 8, 13),
)


def run(qa, cs, ov, ms, top_k, nq, corpus: str = qc.DEFAULT_CORPUS, dev="cuda"):
    """(avg context chars, sufficiency, precision, coverage) over ``qa[:nq]``."""
    p = qc.lexical_pipeline(corpus, dev, dict(qc.SHIP_EMB),
                            {"top_k": top_k, "similarity_threshold": 0.0}, (cs, ov, ms))
    m = qc.benchmark_metrics(p, qa[:nq])
    return (m["avg_context_length_chars"], m["context_sufficiency"], m["context_precision"],
            m["context_coverage"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    qc.add_input_args(ap)
    args = ap.parse_args(argv)
    dev = qc.device_of(args)
    qa = qc.load_qa(args.qa)

    print(f"{'geom':18s} {'ctx':>6s} {'10q suf/prec/cov':>22s} {'41q suf/prec/cov':>22s}")
    print(f"{'reference':18s} {'~1500':>6s} {'0.756 0.634 0.716':>22s} {'':>22s}")
    rows = []
    for cs, ov, ms, k in GEOMETRIES:
        c10, s10, p10, v10 = run(qa, cs, ov, ms, k, 10, args.corpus, dev)
        c41, s41, p41, v41 = run(qa, cs, ov, ms, k, 41, args.corpus, dev)
        tag = f"cs{cs}/ov{ov}/k{k}"
        print(f"{tag:18s} {c10:6.0f} {s10:.3f} {p10:.3f} {v10:.3f}        "
              f"{s41:.3f} {p41:.3f} {v41:.3f}", flush=True)
        rows.append({"cs": cs, "ov": ov, "ms": ms, "k": k, "ctx10": c10, "q10": [s10, p10, v10],
                     "ctx41": c41, "q41": [s41, p41, v41]})
    out_dir = output_dir("quality_geometry_sweep")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "geometry_sweep.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
