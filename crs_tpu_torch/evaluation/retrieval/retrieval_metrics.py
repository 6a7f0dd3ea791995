"""Classic IR metrics (port of ``crs_tpu.evaluation.retrieval.retrieval_metrics``).

P@k, R@k, F1@k, MRR, AP / MAP and nDCG@k (exponential or linear gain) over
de-duplicated id lists, token-overlap context relevance, and
``evaluate_retrieval`` averaging them across queries for each k. Pure
Python.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Sequence

__all__ = ["RetrievalMetrics"]


def _dedupe(seq: Sequence[str]) -> list:
    """Order-preserving dedup — a duplicated id must not count twice
    (hypothesis-found: duplicates pushed recall/AP above 1.0)."""
    seen = set()
    out = []
    for s in seq:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


class RetrievalMetrics:
    @staticmethod
    def precision_at_k(retrieved: Sequence[str], relevant: Sequence[str], k: int) -> float:
        if k <= 0:
            return 0.0
        top = _dedupe(retrieved)[:k]
        if not top:
            return 0.0
        rel = set(relevant)
        return sum(1 for r in top if r in rel) / k

    @staticmethod
    def recall_at_k(retrieved: Sequence[str], relevant: Sequence[str], k: int) -> float:
        rel = set(relevant)
        if not rel:
            return 0.0
        top = _dedupe(retrieved)[:k]
        return sum(1 for r in top if r in rel) / len(rel)

    @classmethod
    def f1_at_k(cls, retrieved: Sequence[str], relevant: Sequence[str], k: int) -> float:
        p = cls.precision_at_k(retrieved, relevant, k)
        r = cls.recall_at_k(retrieved, relevant, k)
        return 2 * p * r / (p + r) if p + r > 0 else 0.0

    @staticmethod
    def mrr(retrieved: Sequence[str], relevant: Sequence[str]) -> float:
        rel = set(relevant)
        for i, r in enumerate(_dedupe(retrieved), start=1):
            if r in rel:
                return 1.0 / i
        return 0.0

    @staticmethod
    def average_precision(retrieved: Sequence[str], relevant: Sequence[str]) -> float:
        rel = set(relevant)
        if not rel:
            return 0.0
        hits, total = 0, 0.0
        for i, r in enumerate(_dedupe(retrieved), start=1):
            if r in rel:
                hits += 1
                total += hits / i
        return total / len(rel)

    @staticmethod
    def ndcg_at_k(
        retrieved: Sequence[str],
        relevance_scores: Dict[str, float],
        k: int,
        gain: str = "exponential",
    ) -> float:
        def g(rel: float) -> float:
            return (2.0**rel - 1.0) if gain == "exponential" else rel

        dcg = 0.0
        for i, r in enumerate(_dedupe(retrieved)[:k], start=1):
            dcg += g(relevance_scores.get(r, 0.0)) / math.log2(i + 1)
        ideal = sorted(relevance_scores.values(), reverse=True)[:k]
        idcg = sum(g(rel) / math.log2(i + 1) for i, rel in enumerate(ideal, start=1))
        return dcg / idcg if idcg > 0 else 0.0

    @staticmethod
    def context_relevance(question: str, context: str) -> float:
        """Token-overlap relevance."""
        q = set(re.findall(r"[a-z0-9]+", question.lower()))
        c = set(re.findall(r"[a-z0-9]+", context.lower()))
        if not q:
            return 0.0
        return len(q & c) / len(q)

    @classmethod
    def evaluate_retrieval(
        cls,
        all_retrieved: Sequence[Sequence[str]],
        all_relevant: Sequence[Sequence[str]],
        k_values: Sequence[int] = (1, 3, 5, 10),
    ) -> Dict[str, Any]:
        """Average IR metrics across queries."""
        n = len(all_retrieved)
        if n == 0 or n != len(all_relevant):
            return {}
        out: Dict[str, Any] = {}
        for k in k_values:
            out[f"precision_at_{k}"] = sum(
                cls.precision_at_k(r, rel, k) for r, rel in zip(all_retrieved, all_relevant)
            ) / n
            out[f"recall_at_{k}"] = sum(
                cls.recall_at_k(r, rel, k) for r, rel in zip(all_retrieved, all_relevant)
            ) / n
            out[f"f1_at_{k}"] = sum(
                cls.f1_at_k(r, rel, k) for r, rel in zip(all_retrieved, all_relevant)
            ) / n
        out["mrr"] = sum(cls.mrr(r, rel) for r, rel in zip(all_retrieved, all_relevant)) / n
        out["map"] = sum(
            cls.average_precision(r, rel) for r, rel in zip(all_retrieved, all_relevant)
        ) / n
        return out
