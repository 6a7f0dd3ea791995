"""Quickstart: the whole workflow in one run (port of ``examples/quickstart.py``).

    python -m crs_tpu_torch.examples.quickstart [path/to/document.pdf] [--device cpu]

Indexes a document, asks a question with RAG, runs the retrieval benchmark,
and finetunes a LoRA adapter on a synthetic dataset, everything offline
(deterministic-init models; real checkpoints go in through ``model_path`` /
``weights_path``). The document defaults to the repository's own PDF,
``report/paper/figures/pq_curve_4m.pdf``. It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..device import resolve_device

__all__ = ["DEFAULT_DOCUMENT", "main"]

DEFAULT_DOCUMENT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "report",
                                "paper", "figures", "pq_curve_4m.pdf")


def main(argv=None, results_dir: str = "/tmp/quickstart_results",
         ft_dir: str = "/tmp/quickstart_ft") -> int:
    """Run the workflow; ``results_dir`` takes the retrieval benchmark's
    files, ``ft_dir`` the finetuner's checkpoints."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("document", nargs="?", default=os.path.normpath(DEFAULT_DOCUMENT))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..evaluation import EvaluationRunner
    from ..finetuning import QuantizedModelFinetuner
    from ..finetuning.code_generation import SyntheticCodeLoader
    from ..models.model_interface import create_model_interface
    from ..rag import RAGPipeline
    from ..utils import ConfigLoader

    # 1. model (int8 weight-only quantized) + pipeline
    cfg = ConfigLoader()  # built-in defaults; pass a path for your own config
    cfg.update_config("rag.chunking.chunk_size", 160)
    cfg.update_config("rag.vector_store.format", "int8")
    cfg.update_config("rag.retrieval.similarity_threshold", 0.05)
    model = create_model_interface("int8", {"config": "small"}, device=dev)
    pipe = RAGPipeline(cfg.get_rag_config(), device=dev).setup(model)

    # 2. index + query
    secs = pipe.index_documents(args.document)
    print(f"indexed {pipe.store.n} chunks in {secs:.1f}s")
    out = pipe.query("What is quantization-aware training?", return_chunks=True)
    for c in out["chunks"]:
        print(f"  [{c['score']:.3f}] {c['text'][:80]}")
    print("answer:", out["answer"][:120])

    # 3. evaluate retrieval
    runner = EvaluationRunner(
        model=model, pipeline=pipe,
        config={"retrieval": {"test_questions": [
            {"question": "What is post-training quantization?",
             "answer": "quantizing without retraining"},
        ], "compare_no_rag": False}},
        output_dir=results_dir,
    )
    res = runner.run_retrieval_only()
    print("retrieval metrics:", {k: v for k, v in (res.retrieval or {}).items()
                                 if k in ("avg_retrieval_time_ms", "context_sufficiency")})

    # 4. LoRA finetune on synthetic data
    ft = QuantizedModelFinetuner(model, {"lora_rank": 4, "num_epochs": 1, "batch_size": 2,
                                         "max_seq_len": 64, "output_dir": ft_dir})
    train, _ = SyntheticCodeLoader({"num_samples": 8}).load()
    result = ft.train(train, resume=False)
    print(f"finetune: loss {result['history'][0]['loss']:.3f} after epoch 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
