"""IR-mode evaluation of the port with derived relevance judgments (port of
``tools/ir_eval.py``).

The reference's published IR metrics are all null: no relevance judgments
were ever provided. This tool derives judgments two ways and runs the
retrieval benchmark in ``ir`` mode for every index format, giving
recall@{1,3,5,10} / MRR / MAP:

- ``section``: a chunk is relevant iff its text or section matches the
  question's topic-section keywords (coarse: many relevant chunks a question);
- ``answer``: answer-SPAN containment, the reference's context-sufficiency
  rule (the answer substring present, or ≥ 0.8 of the answer's tokens)
  applied per chunk (sharper: ~1–4 relevant chunks a question).

A judgment under which no question has a relevant chunk has nothing to
evaluate: the benchmark refuses it and the tool exits non-zero (the
held-out answers are paraphrases, so the default ``--qa`` gives no answer
judgment: run it with ``--judgments section``).

Usage: python -m crs_tpu_torch.tools.ir_eval [--out DIR] [--judgments both] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

from . import output_dir, quality_common as qc

__all__ = ["SECTION_KEYWORDS", "build_judgments", "build_judgments_answer_span", "main"]

# QA section label → keywords that mark a chunk as on-topic
SECTION_KEYWORDS = {
    "quantization": ("quantization", "quantize", "ptq", "qat", "int8", "int4", "bit"),
    "pruning": ("pruning", "prune", "sparsity", "sparse"),
    "distillation": ("distillation", "distill", "teacher", "student"),
    "low-rank factorization": ("low-rank", "factorization", "decompos"),
    "abstract": ("survey", "compression", "large language"),
    "introduction": ("challenge", "gpt", "deployment", "resource"),
    "metrics": ("metric", "flops", "mfu", "inference time", "speedup", "parameter count"),
    "benchmarks": ("benchmark", "evaluat", "harness", "dataset"),
    "conclusion": ("future", "direction", "conclusion"),
}


def build_judgments(chunks, qa):
    """question → relevant chunk ids, by section-keyword matching."""
    judgments = []
    for item in qa:
        section = item.get("section", "").lower()
        keywords = None
        for name, kws in SECTION_KEYWORDS.items():
            if name in section:
                keywords = kws
                break
        if keywords is None:
            keywords = tuple(w for w in section.split() if len(w) > 4) or (section,)
        relevant = [
            c.chunk_id for c in chunks
            if any(kw in c.text.lower() or kw in (c.section or "").lower() for kw in keywords)
        ]
        judgments.append({
            "question": item["question"],
            "answer": item.get("answer", ""),
            "relevant_doc_ids": relevant,
            "section": section,
        })
    return judgments


def _tokens(s: str):
    return re.findall(r"[a-z0-9]+", s.lower())


def build_judgments_answer_span(chunks, qa, overlap_threshold: float = 0.8):
    """question → relevant chunk ids by ANSWER containment: the chunk holds
    the answer verbatim, or ≥ ``overlap_threshold`` of the answer's distinct
    tokens (the reference's sufficiency rule, applied per chunk instead of to
    the concatenated context)."""
    judgments = []
    for item in qa:
        answer = item.get("answer", "")
        a_norm = " ".join(_tokens(answer))
        a_toks = set(_tokens(answer))
        relevant = []
        for c in chunks:
            c_norm = " ".join(_tokens(c.text))
            if a_norm and a_norm in c_norm:
                relevant.append(c.chunk_id)
            elif a_toks and len(a_toks & set(_tokens(c.text))) / len(a_toks) >= overlap_threshold:
                relevant.append(c.chunk_id)
        judgments.append({
            "question": item["question"],
            "answer": answer,
            "relevant_doc_ids": relevant,
            "section": item.get("section", ""),
        })
    return judgments


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=output_dir("ir_eval"))
    ap.add_argument("--formats", nargs="+", default=["fp32", "int8", "pq"])
    ap.add_argument("--judgments", choices=("section", "answer", "both"), default="both")
    qc.add_input_args(ap)
    args = ap.parse_args(argv)
    dev = qc.device_of(args)

    from ..evaluation.retrieval.benchmark import RetrievalBenchmark
    from ..rag.chunking import TextChunker
    from ..rag.document_processing import DocumentProcessor
    from ..rag.embedding import EmbeddingModel
    from ..rag.index import VectorStore
    from ..rag.pipeline import RAGPipeline
    from ..rag.retrieval import ContextRetriever

    dp = DocumentProcessor({})
    pages = dp.process_file(args.corpus)
    ck = TextChunker({"strategy": "semantic", "chunk_size": 160, "chunk_overlap": 30,
                      "min_chunk_size": 10})
    chunks = []
    for text, page in pages:
        for title, body in dp.extract_sections(text):
            chunks.extend(ck.chunk(body, page_number=page, section=title or None))
    qa = qc.load_qa(args.qa)
    judgment_sets = {}
    if args.judgments in ("section", "both"):
        judgment_sets["section"] = build_judgments(chunks, qa)
    if args.judgments in ("answer", "both"):
        judgment_sets["answer"] = build_judgments_answer_span(chunks, qa)

    em = EmbeddingModel({"backend": "hashed", "embedding_dim": 384}, device=dev)
    emb = em.embed_chunks(chunks)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    summary = {}
    retrieval = {"top_k": 10, "similarity_threshold": -1.0}
    for jname, judgments in judgment_sets.items():
        counts = [len(j["relevant_doc_ids"]) for j in judgments]
        usable = [j for j in judgments if j["relevant_doc_ids"]]
        print(f"[{jname}] {len(chunks)} chunks; {len(usable)}/{len(judgments)} "
              f"questions judged; mean relevant/question = "
              f"{sum(counts) / max(len(counts), 1):.1f}")
        (out_dir / f"judgments_{jname}.json").write_text(json.dumps(judgments, indent=2))
        jsum = {"mean_relevant_per_question": sum(counts) / max(len(counts), 1),
                "questions_with_judgments": len(usable)}
        for fmt in args.formats:
            store = VectorStore({"format": fmt, "block_size": 256, "rescore_k": 64}, device=dev)
            store.create_index(chunks, emb)
            pipe = RAGPipeline({"retrieval": dict(retrieval)}, device=dev).setup()
            pipe.store = store
            pipe.embedder = em
            pipe.retriever = ContextRetriever(store, em, dict(retrieval))
            bench = RetrievalBenchmark(pipe, {"test_questions": usable, "compare_no_rag": False,
                                              "retrieval_warmup": True})
            res = bench.run_all()
            keep = {k: v for k, v in res.metrics.items() if any(
                k.startswith(p) for p in ("precision_at", "recall_at", "f1_at", "mrr", "map",
                                          "avg_retrieval_time", "retrieval_qps"))}
            jsum[fmt] = keep
            res.to_json(str(out_dir / f"ir_results_{jname}_{fmt}.json"))
            print(f"[{jname}/{fmt}] recall@10={keep.get('recall_at_10'):.3f} "
                  f"mrr={keep.get('mrr'):.3f} map={keep.get('map'):.3f}")
        summary[jname] = jsum
    (out_dir / "ir_summary.json").write_text(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
