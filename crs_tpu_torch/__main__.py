"""The port's command line (counterpart of the repository's ``main.py``).

    python -m crs_tpu_torch --config config.json --index doc.pdf
    python -m crs_tpu_torch --config config.json --query "what is quantization?"
    python -m crs_tpu_torch --config config.json --no-model --query "What is GPTQ?"

Runs on the card unless ``--device cpu``. ``--index`` chunks, embeds and
stores a document into the config's ``rag.vector_store.persist_directory``
(the lexical backend's fitted state beside it); ``--query`` loads that
index and answers, retrieving only when ``should_retrieve`` says so. The
evaluation flags (``--evaluate``, ``--eval-*``) come with the evaluation
slice and raise.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .models.model_interface import create_model_interface
from .rag.pipeline import RAGPipeline
from .utils.config import ConfigLoader
from .utils.logging_setup import setup_logging

logger = logging.getLogger("crs_tpu_torch.main")

_RETRIEVE_KEYWORDS = (
    "what", "how", "why", "when", "where", "who", "which",
    "explain", "describe", "define", "compare", "summarize",
)


def should_retrieve(query: str) -> bool:
    """Keyword heuristic: retrieve for questions and requests to explain."""
    q = query.lower()
    return any(k in q for k in _RETRIEVE_KEYWORDS) or q.endswith("?")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m crs_tpu_torch",
                                 description="compressed-RAG suite on the GPU")
    ap.add_argument("--config", default=None, help="config JSON path")
    ap.add_argument("--index", metavar="PATH", help="index a document (pdf/txt/md)")
    ap.add_argument("--query", metavar="TEXT", help="run a single query")
    ap.add_argument("--evaluate", action="store_true", help="run all benchmarks")
    ap.add_argument("--eval-efficiency", action="store_true")
    ap.add_argument("--eval-performance", action="store_true")
    ap.add_argument("--eval-retrieval", action="store_true")
    ap.add_argument("--no-model", action="store_true", help="retrieval-only (skip LLM load)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.evaluate or args.eval_efficiency or args.eval_performance or args.eval_retrieval:
        raise NotImplementedError("--evaluate and --eval-* come with the evaluation slice "
                                  "(ROADMAP: modules to port, evaluation)")
    setup_logging(level=logging.DEBUG if args.verbose else logging.INFO)
    try:
        cfg = ConfigLoader(args.config)
    except FileNotFoundError:
        print(f"error: config file not found: {args.config}", file=sys.stderr)
        return 2

    model = None
    if not args.no_model:
        mc = cfg.get_model_config()
        model = create_model_interface(mc.get("type", "jax"), mc, device=args.device)
        model.load()
        logger.info("model: %s", model.get_model_info())

    pipeline = RAGPipeline(cfg.get_rag_config(), device=args.device).setup(model)

    persist = cfg.get("rag.vector_store.persist_directory")
    if persist and pipeline.store.n > 0:
        logger.info("loaded persisted index (%d vectors)", pipeline.store.n)

    if args.index:
        secs = pipeline.index_documents(args.index)
        print(f"indexed {pipeline.store.n} chunks in {secs:.2f}s")
        return 0

    if args.query:
        if pipeline.store.n == 0:
            print("no index loaded — run --index first (retrieval disabled)")
        use_rag = should_retrieve(args.query) and pipeline.store.n > 0
        out = pipeline.query(args.query, return_context=False, return_chunks=True,
                             use_rag=use_rag)
        for c in out.get("chunks", []):
            print(f"  [{c['score']:.3f}] p{c['metadata'].get('page_number')}: {c['text'][:100]}")
        print(f"\nanswer: {out['answer']}")
        return 0

    ap.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
