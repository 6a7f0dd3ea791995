"""Index-side lever sweep for the 10q matched-context gap (port of
``tools/quality_docside_sweep.py``): section-title features,
neighbor-context features and document-side PPMI expansion, rebuilt
lexically at index time.

Baseline to beat (the reference's MiniLM, 10q matched context, BASELINE.md):
sufficiency 0.756 / precision 0.634 / coverage 0.716.

Usage: python -m crs_tpu_torch.tools.quality_docside_sweep [--stage 1|2] [--out FILE] [--device cpu]
Stage 1 sweeps each lever alone; stage 2 combines the stage-1 winners.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

from . import output_dir, quality_common as qc

__all__ = ["BASE_EMB", "grid", "run_config", "main"]

BASE_EMB = dict(qc.SHIP_EMB)  # the shipping embedding (config.json)


def run_config(emb_overrides, qa, chunk=qc.MATCHED, corpus: str = qc.DEFAULT_CORPUS, dev="cuda"):
    """One row: the overrides and each question slice's rounded context
    metrics. An ``_retrieval`` key of the overrides holds retriever knobs."""
    emb = dict(BASE_EMB)
    emb.update(emb_overrides)
    retr = {"top_k": 3, "similarity_threshold": 0.0}
    retr.update(emb.pop("_retrieval", {}))
    p = qc.lexical_pipeline(corpus, dev, emb, retr, chunk)
    row = {"emb": emb_overrides}
    for nq in (10, 41):
        m = qc.benchmark_metrics(p, qa[:nq])
        row[f"{nq}q"] = {
            "suf": round(m["context_sufficiency"], 4),
            "prec": round(m["context_precision"], 4),
            "cov": round(m["context_coverage"], 4),
            "ctx_chars": round(m["avg_context_length_chars"], 0),
        }
    return row


def grid(stage: int):
    """The embedding overrides of ``stage``."""
    if stage == 1:
        rows = [{}]  # the shipping baseline, for reference
        rows += [{"section_weight": w} for w in (0.15, 0.3, 0.45, 0.6)]
        rows += [{"neighbor_weight": w} for w in (0.1, 0.2, 0.3)]
        rows += [{"doc_expansion_terms": 4, "doc_expansion_weight": w} for w in (0.1, 0.2)]
        return rows
    sw = (0.3, 0.45)  # stage 2: combinations
    nw = (0.0, 0.1, 0.2)
    de = ((0, 0.0), (4, 0.1))
    return [{"section_weight": s, "neighbor_weight": n, "doc_expansion_terms": t,
             "doc_expansion_weight": w} for s, n, (t, w) in itertools.product(sw, nw, de)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(output_dir("quality_docside_sweep"),
                                                  "docside_sweep.json"))
    ap.add_argument("--configs", default=None,
                    help="JSON list of emb-override dicts (overrides stage)")
    qc.add_input_args(ap)
    args = ap.parse_args(argv)
    dev = qc.device_of(args)
    qa = qc.load_qa(args.qa)

    rows = []
    for cfg in json.loads(args.configs) if args.configs else grid(args.stage):
        row = run_config(cfg, qa, corpus=args.corpus, dev=dev)
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as fh:
            existing = json.load(fh)
    with open(args.out, "w") as fh:
        json.dump(existing + rows, fh, indent=1)
    print(f"wrote {len(rows)} rows -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
