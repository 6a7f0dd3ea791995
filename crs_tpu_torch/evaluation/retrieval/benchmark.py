"""Retrieval and RAG benchmark (port of ``crs_tpu.evaluation.retrieval.benchmark``).

- Three modes, by the labels the questions carry: ``ir`` (relevant doc
  ids), ``qa`` (reference answers), ``retrieval_only``.
- Retrieval: one batched retrieve of every question (after an unmeasured
  one), ms per question, scores, repeat consistency, context length and
  quality (sufficiency, coverage, precision); IR metrics P/R/F1@k, MRR and
  MAP in ``ir`` mode.
- Answers (``ir`` / ``qa`` with a generator): one batched generate with the
  retrieved contexts and, optionally, one without, timed; EM, F1, BLEU,
  ROUGE, relevance, faithfulness and the no-RAG deltas.
- The detailed responses as JSON, TXT and CSV; a top-k ablation study;
  the dataset-file loader. An empty store is refused.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..base import BenchmarkResult, ModelBenchmark
from .rag_metrics import RAGMetrics
from .retrieval_metrics import RetrievalMetrics

logger = logging.getLogger(__name__)

__all__ = ["RetrievalBenchmark", "RetrievalResults"]


class RetrievalResults(BenchmarkResult):
    pass


class RetrievalBenchmark(ModelBenchmark[RetrievalResults]):
    def __init__(self, pipeline, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.pipeline = pipeline
        cfg = self.config
        self.k_values = tuple(cfg.get("k_values", (1, 3, 5, 10)))
        self.test_questions: List[Dict[str, Any]] = list(cfg.get("test_questions", []))
        self.max_questions = cfg.get("max_questions")
        self.compare_no_rag = bool(cfg.get("compare_no_rag", True))
        self.save_detailed_responses = bool(cfg.get("save_detailed_responses", False))
        self.output_dir = cfg.get("output_dir", "results/retrieval")
        self.rag_metrics = RAGMetrics(cfg)

    # -- mode detection ---------------------------------
    def _mode(self, questions: Sequence[Dict[str, Any]]) -> str:
        if any(q.get("relevant_doc_ids") for q in questions):
            return "ir"
        if any(q.get("answer") for q in questions):
            return "qa"
        return "retrieval_only"

    def run_all(self) -> RetrievalResults:
        questions = self.test_questions
        if self.max_questions:
            questions = questions[: int(self.max_questions)]
        if not questions:
            raise ValueError("no test questions configured")
        if getattr(self.pipeline, "store", None) is not None and self.pipeline.store.n == 0:
            raise ValueError(
                "vector store is empty — index a corpus before the retrieval "
                "benchmark (silent zero-metrics otherwise)"
            )
        mode = self._mode(questions)
        texts = [q["question"] for q in questions]
        n = len(texts)
        m: Dict[str, Any] = {"mode": mode, "num_questions": n}

        # -- retrieval (batched, timed) -------------------------------------
        if self.config.get("retrieval_warmup", True):
            # an unmeasured pass: first calls build kernels and warm the
            # allocator, and would dominate the timing otherwise
            self.pipeline.retrieve_batch(texts)
        t0 = time.perf_counter()
        all_chunks = self.pipeline.retrieve_batch(texts)
        retrieval_s = time.perf_counter() - t0
        m["avg_retrieval_time_ms"] = retrieval_s * 1000.0 / n
        m["retrieval_qps"] = n / retrieval_s if retrieval_s > 0 else None

        scores = [c["score"] for chunks in all_chunks for c in chunks]
        m["avg_retrieval_score"] = float(np.mean(scores)) if scores else None
        m["retrieval_consistency"] = float(np.std(scores)) if scores else None
        m["avg_chunks_retrieved"] = float(np.mean([len(c) for c in all_chunks]))

        # repeat-based consistency: re-run a subsample, Jaccard of returned id sets
        repeat = self.pipeline.retrieve_batch(texts[: min(5, n)])
        jac = []
        for first, second in zip(all_chunks[: len(repeat)], repeat):
            a = {c["id"] for c in first}
            b = {c["id"] for c in second}
            if a or b:
                jac.append(len(a & b) / len(a | b))
        m["retrieval_repeat_consistency"] = float(np.mean(jac)) if jac else None

        contexts = ["\n\n".join(c["text"] for c in chunks) for chunks in all_chunks]
        m["avg_context_length_chars"] = float(np.mean([len(c) for c in contexts]))

        # context quality
        m.update(self._context_quality(questions, all_chunks, contexts))

        # -- IR metrics (ir mode) --------------------------------------------
        if mode == "ir":
            retrieved_ids = [[c["id"] for c in chunks] for chunks in all_chunks]
            relevant_ids = [q.get("relevant_doc_ids", []) for q in questions]
            m.update(
                RetrievalMetrics.evaluate_retrieval(retrieved_ids, relevant_ids, self.k_values)
            )

        # -- answer quality (qa mode, needs a generator) ----------------------
        rag_answers: Optional[List[str]] = None
        no_rag_answers: Optional[List[str]] = None
        if mode in ("ir", "qa") and self.pipeline.generator is not None and any(
            q.get("answer") for q in questions
        ):
            refs = [q.get("answer", "") for q in questions]
            if self.config.get("generation_warmup", True):
                # one unmeasured pass, so first-call costs stay out of the
                # generation timing
                self.pipeline.generator.generate_batch(texts[:1], contexts[:1])
            t0 = time.perf_counter()
            rag_answers = self.pipeline.generator.generate_batch(texts, contexts)
            rag_s = time.perf_counter() - t0
            m["avg_rag_generation_time_ms"] = rag_s * 1000.0 / n
            gen_tokens = sum(len(a.split()) for a in rag_answers)
            m["rag_tokens_per_sec"] = gen_tokens / rag_s if rag_s > 0 else None
            if self.compare_no_rag:
                t0 = time.perf_counter()
                no_rag_answers = self.pipeline.generator.generate_batch(texts, [""] * n)
                no_rag_s = time.perf_counter() - t0
                m["avg_no_rag_generation_time_ms"] = no_rag_s * 1000.0 / n
                if rag_s > 0:
                    m["generation_speedup_no_rag_vs_rag"] = no_rag_s / rag_s
            m.update(
                self.rag_metrics.evaluate_rag_system(
                    texts, rag_answers, refs, contexts, no_rag_answers,
                    compute_bertscore=bool(self.config.get("compute_bertscore", False)),
                )
            )

        if self.save_detailed_responses:
            self._save_detailed(questions, all_chunks, contexts, rag_answers, no_rag_answers, m)

        return RetrievalResults(
            name="retrieval",
            metrics=m,
            metadata={"mode": mode, "k_values": list(self.k_values)},
        )

    # -- context quality --------------------------------
    def _context_quality(
        self,
        questions: Sequence[Dict[str, Any]],
        all_chunks: Sequence[Sequence[Dict[str, Any]]],
        contexts: Sequence[str],
    ) -> Dict[str, Any]:
        # Whitespace tokens WITHOUT
        # punctuation stripping, sufficiency gives partial credit below the
        # 0.8 threshold, and precision is the relevance of the FULL joined
        # context to the question (not a per-chunk average).
        threshold = float(self.config.get("sufficiency_token_threshold", 0.8))
        sufficiency, precision, coverage = [], [], []
        for q, chunks, ctx in zip(questions, all_chunks, contexts):
            answer = q.get("answer", "")
            c_tokens = set(ctx.lower().split())
            if answer:
                a_tokens = set(answer.lower().split())
                overlap = len(a_tokens & c_tokens) / len(a_tokens) if a_tokens else 0.0
                if answer.lower() in ctx.lower():
                    sufficiency.append(1.0)
                else:
                    sufficiency.append(1.0 if overlap >= threshold else overlap)
                coverage.append(overlap)
            if chunks:
                q_tokens = set(q["question"].lower().split())
                precision.append(
                    len(q_tokens & c_tokens) / len(q_tokens) if q_tokens else 0.0
                )
        out: Dict[str, Any] = {}
        if sufficiency:
            out["context_sufficiency"] = float(np.mean(sufficiency))
            out["context_coverage"] = float(np.mean(coverage))
        if precision:
            out["context_precision"] = float(np.mean(precision))
        return out

    # -- detailed responses ------------------------------
    def _save_detailed(self, questions, all_chunks, contexts, rag_answers, no_rag_answers, metrics):
        os.makedirs(self.output_dir, exist_ok=True)
        details = []
        for i, q in enumerate(questions):
            details.append(
                {
                    "question": q["question"],
                    "expected_answer": q.get("answer"),
                    "rag_answer": rag_answers[i] if rag_answers else None,
                    "no_rag_answer": no_rag_answers[i] if no_rag_answers else None,
                    "retrieved_chunks": [
                        {"id": c["id"], "score": c["score"], "text": c["text"][:500]}
                        for c in all_chunks[i]
                    ],
                    "context_length": len(contexts[i]),
                }
            )
        with open(os.path.join(self.output_dir, "detailed_responses.json"), "w") as f:
            json.dump(details, f, indent=2)
        with open(os.path.join(self.output_dir, "detailed_responses.txt"), "w") as f:
            for d in details:
                f.write(f"Q: {d['question']}\n")
                f.write(f"Expected: {d['expected_answer']}\n")
                f.write(f"RAG: {d['rag_answer']}\n")
                f.write(f"No-RAG: {d['no_rag_answer']}\n")
                for c in d["retrieved_chunks"]:
                    f.write(f"  [{c['score']:.3f}] {c['id']}: {c['text'][:120]}\n")
                f.write("-" * 70 + "\n")
        with open(os.path.join(self.output_dir, "detailed_responses.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["question", "expected", "rag_answer", "no_rag_answer", "top_score"])
            for d in details:
                top = d["retrieved_chunks"][0]["score"] if d["retrieved_chunks"] else None
                w.writerow([d["question"], d["expected_answer"], d["rag_answer"], d["no_rag_answer"], top])
        with open(os.path.join(self.output_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2, default=str)
        logger.info("saved detailed responses to %s", self.output_dir)

    # -- ablation study ----------------------------------
    def ablation_study(self, k_values: Optional[Sequence[int]] = None) -> Dict[str, Any]:
        """Sweep retriever top_k; return per-k summary + best k."""
        ks = list(k_values or (1, 2, 3, 5, 8))
        retriever = self.pipeline.retriever
        original_k = retriever.top_k
        rows = []
        try:
            for k in ks:
                retriever.top_k = k
                res = self.run_all()
                rows.append({"top_k": k, **{
                    key: res.metrics.get(key)
                    for key in (
                        "avg_retrieval_score", "context_sufficiency", "context_precision",
                        "context_coverage", "f1_score", "avg_retrieval_time_ms",
                    )
                }})
        finally:
            retriever.top_k = original_k
        # pick best k by f1 if present else context sufficiency else score
        def key_fn(r):
            for key in ("f1_score", "context_sufficiency", "avg_retrieval_score"):
                if r.get(key) is not None:
                    return r[key]
            return 0.0

        best = max(rows, key=key_fn) if rows else None
        return {"rows": rows, "best_k": best["top_k"] if best else None}

    # -- dataset loading ---------------------------------
    @staticmethod
    def load_dataset_file(path: str) -> List[Dict[str, Any]]:
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data.get("questions", data.get("data", []))
        out = []
        for item in data:
            if isinstance(item, dict) and "question" in item:
                out.append(item)
        return out

    def evaluate_from_file(self, path: str) -> RetrievalResults:
        self.test_questions = self.load_dataset_file(path)
        return self.run_all()
