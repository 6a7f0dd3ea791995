"""Answer-quality metrics of RAG (port of ``crs_tpu.evaluation.retrieval.rag_metrics``).

Normalised exact match, token F1 (counter intersection), smoothed sentence
BLEU, ROUGE-1/2/L, answer relevance (answer ∩ question tokens),
faithfulness (answer tokens found in the context), and
``evaluate_rag_system``, which averages them and the no-RAG deltas.
BERTScore needs the optional ``bert_score`` package and is None without it.
Pure Python.
"""

from __future__ import annotations

import logging
import math
import string
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["RAGMetrics"]


def _normalize(text: str, lowercase: bool = True, strip_punct: bool = True) -> str:
    if lowercase:
        text = text.lower()
    if strip_punct:
        text = text.translate(str.maketrans("", "", string.punctuation))
    return " ".join(text.split())


def _tokens(text: str) -> List[str]:
    return _normalize(text).split()


class RAGMetrics:
    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}

    # -- string metrics ------------------------------------------------------
    @staticmethod
    def exact_match(prediction: str, reference: str) -> float:
        return float(_normalize(prediction) == _normalize(reference))

    @staticmethod
    def token_f1(prediction: str, reference: str) -> float:
        p, r = _tokens(prediction), _tokens(reference)
        if not p or not r:
            return float(p == r)
        common = Counter(p) & Counter(r)
        overlap = sum(common.values())
        if overlap == 0:
            return 0.0
        precision = overlap / len(p)
        recall = overlap / len(r)
        return 2 * precision * recall / (precision + recall)

    @staticmethod
    def bleu(prediction: str, reference: str, max_n: int = 4) -> float:
        """Smoothed sentence BLEU (add-1 smoothing, reference :130-158)."""
        p, r = _tokens(prediction), _tokens(reference)
        if not p or not r:
            return 0.0
        log_sum = 0.0
        for n in range(1, max_n + 1):
            p_ngrams = Counter(tuple(p[i : i + n]) for i in range(len(p) - n + 1))
            r_ngrams = Counter(tuple(r[i : i + n]) for i in range(len(r) - n + 1))
            overlap = sum((p_ngrams & r_ngrams).values())
            total = max(sum(p_ngrams.values()), 1)
            log_sum += math.log((overlap + 1.0) / (total + 1.0))
        bp = 1.0 if len(p) >= len(r) else math.exp(1.0 - len(r) / len(p))
        return bp * math.exp(log_sum / max_n)

    @staticmethod
    def _lcs_len(a: List[str], b: List[str]) -> int:
        if not a or not b:
            return 0
        prev = [0] * (len(b) + 1)
        for i in range(1, len(a) + 1):
            cur = [0] * (len(b) + 1)
            for j in range(1, len(b) + 1):
                cur[j] = prev[j - 1] + 1 if a[i - 1] == b[j - 1] else max(prev[j], cur[j - 1])
            prev = cur
        return prev[-1]

    @classmethod
    def rouge_n(cls, prediction: str, reference: str, n: int = 1) -> float:
        p, r = _tokens(prediction), _tokens(reference)
        r_ngrams = Counter(tuple(r[i : i + n]) for i in range(len(r) - n + 1))
        if not r_ngrams:
            return 0.0
        p_ngrams = Counter(tuple(p[i : i + n]) for i in range(len(p) - n + 1))
        overlap = sum((p_ngrams & r_ngrams).values())
        return overlap / sum(r_ngrams.values())

    @classmethod
    def rouge_l(cls, prediction: str, reference: str) -> float:
        p, r = _tokens(prediction), _tokens(reference)
        if not p or not r:
            return 0.0
        lcs = cls._lcs_len(p, r)
        prec = lcs / len(p)
        rec = lcs / len(r)
        return 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0

    @staticmethod
    def bert_score(prediction: str, reference: str) -> Optional[float]:
        """Gated on the optional bert-score package."""
        try:  # pragma: no cover - optional heavy dependency
            from bert_score import score as bs  # type: ignore

            _, _, f1 = bs([prediction], [reference], lang="en", verbose=False)
            return float(f1[0])
        except Exception:
            return None

    @staticmethod
    def answer_relevance(answer: str, question: str) -> float:
        """answer∩question token overlap."""
        a, q = set(_tokens(answer)), set(_tokens(question))
        if not a:
            return 0.0
        return len(a & q) / len(a)

    @staticmethod
    def faithfulness(answer: str, context: str) -> float:
        """Fraction of answer tokens present in the context."""
        a = _tokens(answer)
        if not a:
            return 0.0
        c = set(_tokens(context))
        return sum(1 for t in a if t in c) / len(a)

    # -- aggregation ---------------------------------------------------------
    def evaluate_rag_system(
        self,
        questions: Sequence[str],
        predictions: Sequence[str],
        references: Sequence[str],
        contexts: Optional[Sequence[str]] = None,
        no_rag_predictions: Optional[Sequence[str]] = None,
        compute_bertscore: bool = False,
    ) -> Dict[str, Any]:
        n = len(questions)
        if n == 0:
            return {}
        contexts = contexts or [""] * n

        def avg(fn, *seqs):
            return sum(fn(*args) for args in zip(*seqs)) / n

        out: Dict[str, Any] = {
            "exact_match": avg(self.exact_match, predictions, references),
            "f1_score": avg(self.token_f1, predictions, references),
            "bleu": avg(self.bleu, predictions, references),
            "rouge1": avg(self.rouge_n, predictions, references),
            "rouge2": avg(lambda p, r: self.rouge_n(p, r, 2), predictions, references),
            "rougeL": avg(self.rouge_l, predictions, references),
            "answer_relevance": avg(self.answer_relevance, predictions, questions),
            "faithfulness": avg(self.faithfulness, predictions, contexts),
        }
        if compute_bertscore:
            scores = [self.bert_score(p, r) for p, r in zip(predictions, references)]
            valid = [s for s in scores if s is not None]
            out["bertscore_f1"] = sum(valid) / len(valid) if valid else None
        if no_rag_predictions is not None:
            no_f1 = avg(self.token_f1, no_rag_predictions, references)
            no_em = avg(self.exact_match, no_rag_predictions, references)
            out["no_rag_f1"] = no_f1
            out["no_rag_exact_match"] = no_em
            out["f1_improvement"] = out["f1_score"] - no_f1
            out["em_improvement"] = out["exact_match"] - no_em
        return out
