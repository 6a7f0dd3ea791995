"""What the port's retrieval-quality tools share: their inputs (``--corpus``,
``--qa``, ``--device``), the corpus-fitted lexical pipeline at a chunk
geometry (the body of the JAX sweeps' ``run_config``), one benchmark run's
metrics.

The inputs default to the repository's held-out corpus and its questions
(``results/selftrained/heldout_corpus.txt``, ``heldout_qa.json``); the JAX
tools read a survey PDF and its 41 questions from outside the repository.
The "41q" and "10q" runs keep their names and slices (``qa[:41]``,
``qa[:10]``): on the 10-question file both hold the same questions.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Sequence, Tuple

import torch

from ..device import resolve_device

__all__ = ["DEFAULT_CORPUS", "DEFAULT_QA", "SHIP_EMB", "MATCHED", "add_input_args", "device_of",
           "load_qa", "lexical_pipeline", "benchmark_metrics"]

_REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
DEFAULT_CORPUS = os.path.join(_REPO, "results", "selftrained", "heldout_corpus.txt")
DEFAULT_QA = os.path.join(_REPO, "results", "selftrained", "heldout_qa.json")

# the shipping embedding (config.json): mild PPMI+SVD query expansion and bm25_k1 0.6
SHIP_EMB = {"backend": "lexical", "embedding_dim": 384, "bm25_k1": 0.6, "expansion_terms": 4,
            "expansion_weight": 0.3, "expansion_sim_threshold": 0.35}
MATCHED = (90, 18, 25)  # the matched-context chunk geometry: size, overlap, minimum (words)


def add_input_args(ap, cpu: bool = False) -> None:
    """``--corpus``, ``--qa``, ``--device`` and, with ``cpu``, the JAX tool's ``--cpu``."""
    ap.add_argument("--corpus", default=DEFAULT_CORPUS, help="the document to index (.txt, .pdf)")
    ap.add_argument("--qa", default=DEFAULT_QA,
                    help="JSON list of {question, answer, section} items")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    if cpu:
        ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")


def device_of(args) -> torch.device:
    return resolve_device("cpu" if getattr(args, "cpu", False) else args.device)


def load_qa(path: str):
    with open(path) as fh:
        return json.load(fh)


def lexical_pipeline(corpus: str, dev, emb: Dict[str, Any], retrieval: Dict[str, Any],
                     chunk: Tuple[int, int, int] = MATCHED):
    """A RAGPipeline over ``corpus``: semantic chunks of ``chunk`` (size,
    overlap, minimum words), the embedding ``emb`` fitted on them, the int8
    store (block 128) and the retriever ``retrieval``; indexed."""
    from ..rag.pipeline import RAGPipeline

    cs, ov, ms = chunk
    p = RAGPipeline({
        "chunking": {"strategy": "semantic", "chunk_size": cs, "chunk_overlap": ov,
                     "min_chunk_size": ms},
        "embedding": emb,
        "vector_store": {"format": "int8", "block_size": 128},
        "retrieval": retrieval,
    }, device=dev).setup()
    p.index_documents(corpus)
    return p


def benchmark_metrics(p, questions: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The retrieval benchmark's metrics over ``questions`` (no no-RAG run)."""
    from ..evaluation.retrieval.benchmark import RetrievalBenchmark

    return RetrievalBenchmark(p, {"test_questions": list(questions),
                                  "compare_no_rag": False}).run_all().metrics

