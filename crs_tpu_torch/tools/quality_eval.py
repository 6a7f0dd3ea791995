"""Retrieval-quality parity runs of the port (port of ``tools/quality_eval.py``).

Runs the retrieval benchmark with the corpus-fitted lexical encoder on
``--corpus`` and ``--qa`` (by default the repository's held-out corpus and
questions), at the shipping default chunking (240 words) and at a context
length matched to the reference's (~1.5k chars, 90 words), on the first 41
questions and on the first 10. Writes one JSON a run to ``--output-dir``.

Usage: python -m crs_tpu_torch.tools.quality_eval [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import output_dir, quality_common as qc

__all__ = ["GEOMETRIES", "main"]

# tag → chunk size, overlap, minimum (words)
GEOMETRIES = (("default240", (240, 48, 50)), ("matched-ctx90", qc.MATCHED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output-dir", default=output_dir("quality_eval"))
    qc.add_input_args(ap, cpu=True)
    args = ap.parse_args(argv)
    dev = qc.device_of(args)

    qa = qc.load_qa(args.qa)
    os.makedirs(args.output_dir, exist_ok=True)
    for tag, (cs, ov, ms) in GEOMETRIES:
        p = qc.lexical_pipeline(args.corpus, dev, dict(qc.SHIP_EMB),
                                {"top_k": 3, "similarity_threshold": 0.0}, (cs, ov, ms))
        for nq in (41, 10):
            m = qc.benchmark_metrics(p, qa[:nq])
            m["config"] = {"chunking": tag, "chunk_size_words": cs, "num_questions": nq,
                           "backend": "lexical", "format": "int8", "top_k": 3}
            out = os.path.join(args.output_dir, f"retrieval_quality_{tag}_{nq}q.json")
            with open(out, "w") as fh:
                json.dump(m, fh, indent=1)
            print(f"{tag} {nq}q: ctx={m['avg_context_length_chars']:.0f}ch "
                  f"suf={m['context_sufficiency']:.3f} prec={m['context_precision']:.3f} "
                  f"cov={m['context_coverage']:.3f} score={m['avg_retrieval_score']:.3f} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
