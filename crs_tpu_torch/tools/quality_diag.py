"""Per-question diagnosis of the matched-context 10q gap (port of
``tools/quality_diag.py``): our picks against the per-column oracle picks,
with the reference's metric definitions. Prints, for each question, our
sufficiency / coverage, the oracle's, and the oracle chunks we failed to
retrieve (with their retrieval ranks).

Usage: python -m crs_tpu_torch.tools.quality_diag [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import re
import sys

from . import quality_common as qc

__all__ = ["toks", "coverage", "sufficiency", "main"]

TOKEN = re.compile(r"[a-z0-9]+")


def toks(s):
    return set(TOKEN.findall(s.lower()))


def coverage(target, texts):
    t = toks(target)
    if not t:
        return 0.0
    got = set()
    for x in texts:
        got |= t & toks(x)
    return len(got) / len(t)


def sufficiency(answer, texts):
    ctx = " ".join(texts).lower()
    if answer.lower() in ctx:
        return 1.0
    ov = coverage(answer, texts)
    return 1.0 if ov >= 0.8 else ov


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    qc.add_input_args(ap)
    args = ap.parse_args(argv)
    dev = qc.device_of(args)

    qa = qc.load_qa(args.qa)[:10]
    p = qc.lexical_pipeline(args.corpus, dev, dict(qc.SHIP_EMB),
                            {"top_k": 3, "similarity_threshold": 0.0})
    chunks = list(p.store.documents)
    chunk_tok = [toks(c) for c in chunks]

    # wide retrieval: ranks of every chunk per question
    retr = p.retriever
    for qi, item in enumerate(qa):
        q, ans = item["question"], item["answer"]
        res = retr.retrieve_batch([q], top_k=len(chunks))[0]
        ranked = [r["text"] for r in res]
        ours = ranked[:3]
        rank_of = {t: i for i, t in enumerate(ranked)}

        at = toks(ans)
        # the oracle for sufficiency / coverage: exhaustive over the best 24
        scored = sorted(range(len(chunks)), key=lambda i: -len(at & chunk_tok[i]))[:24]
        best_cov, best_pick = -1.0, None
        for combo in itertools.combinations(scored, 3):
            c = coverage(ans, [chunks[i] for i in combo])
            if c > best_cov:
                best_cov, best_pick = c, combo
        o_texts = [chunks[i] for i in best_pick]
        print(f"\nQ{qi}: {q[:70]}")
        print(f"  ours:   suf={sufficiency(ans, ours):.3f} cov={coverage(ans, ours):.3f}")
        print(f"  oracle: suf={sufficiency(ans, o_texts):.3f} cov={best_cov:.3f}")
        for i in [i for i in best_pick if chunks[i] not in ours]:
            r = rank_of.get(chunks[i], -1)
            ctk = len(at & chunk_tok[i])
            print(f"  missed chunk #{i} (retrieval rank {r}, {ctk} answer-token hits): "
                  f"{chunks[i][:100]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
