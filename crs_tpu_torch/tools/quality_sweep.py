"""Retrieval-knob sweep for the matched-context quality comparison (port of
``tools/quality_sweep.py``): settings that lift sufficiency / coverage on the
first 10 questions at matched context, each checked on the first 41 too so
as not to overfit the subset.

Knobs swept: query expansion (terms / weight / threshold), the MMR
diversity penalty, the hybrid rerank. Metric definitions are the
reference's. Writes ``sweep.json`` under the tool's output directory.

Usage: python -m crs_tpu_torch.tools.quality_sweep [--full] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

from . import output_dir, quality_common as qc

__all__ = ["SHIP_EXPANSION", "grid", "run_config", "main"]

SHIP_EXPANSION = {"expansion_terms": 4, "expansion_weight": 0.3, "expansion_sim_threshold": 0.35}


def run_config(qa, emb_over, ret_over, corpus: str = qc.DEFAULT_CORPUS, dev="cuda"):
    """{10: (suf, prec, cov), 41: ...} of the lexical pipeline with
    ``emb_over`` on the embedding and ``ret_over`` on the retriever."""
    emb = {"backend": "lexical", "embedding_dim": 384, "bm25_k1": 0.6}
    emb.update(emb_over)
    ret = {"top_k": 3, "similarity_threshold": 0.0}
    ret.update(ret_over)
    p = qc.lexical_pipeline(corpus, dev, emb, ret)
    out = {}
    for nq in (10, 41):
        m = qc.benchmark_metrics(p, qa[:nq])
        out[nq] = (m["context_sufficiency"], m["context_precision"], m["context_coverage"])
    return out


def grid(full: bool):
    """(tag, emb_over, ret_over) of the sweep; ``full`` adds the expansion
    grid and two more MMR penalties."""
    rows = [
        ("ship", dict(SHIP_EXPANSION), {}),
        ("noexp", {}, {}),
        ("exp8w5", {"expansion_terms": 8, "expansion_weight": 0.5,
                    "expansion_sim_threshold": 0.25}, {}),
        ("exp8w5+mmr2", {"expansion_terms": 8, "expansion_weight": 0.5,
                         "expansion_sim_threshold": 0.25}, {"diversity_penalty": 0.2}),
        ("ship+mmr2", dict(SHIP_EXPANSION), {"diversity_penalty": 0.2}),
        ("ship+mmr4", dict(SHIP_EXPANSION), {"diversity_penalty": 0.4}),
        ("ship+rerank", dict(SHIP_EXPANSION), {"rerank": True}),
        ("ship+rerank+mmr2", dict(SHIP_EXPANSION), {"rerank": True, "diversity_penalty": 0.2}),
    ]
    if full:
        for t, w, thr in itertools.product((4, 8, 16), (0.3, 0.5, 0.8), (0.15, 0.25)):
            rows.append((f"e{t}w{w}t{thr}", {"expansion_terms": t, "expansion_weight": w,
                                             "expansion_sim_threshold": thr}, {}))
        for dp in (0.1, 0.3):
            rows.append((f"mmr{dp}", dict(SHIP_EXPANSION), {"diversity_penalty": dp}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    qc.add_input_args(ap)
    args = ap.parse_args(argv)
    dev = qc.device_of(args)
    qa = qc.load_qa(args.qa)

    print(f"{'tag':24s} {'10q suf/prec/cov':>24s} {'41q suf/prec/cov':>24s}")
    print(f"{'reference':24s} {'0.756 0.634 0.716':>24s} {'-':>24s}")
    rows = []
    for tag, emb_over, ret_over in grid(args.full):
        r = run_config(qa, emb_over, ret_over, args.corpus, dev)
        s10 = " ".join(f"{x:.3f}" for x in r[10])
        s41 = " ".join(f"{x:.3f}" for x in r[41])
        print(f"{tag:24s} {s10:>24s} {s41:>24s}", flush=True)
        rows.append({"tag": tag, "emb": emb_over, "ret": ret_over, "q10": r[10], "q41": r[41]})
    out_dir = output_dir("quality_sweep")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "sweep.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
