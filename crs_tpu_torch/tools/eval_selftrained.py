"""Quality columns on the self-trained generator, once per quantization
variant (port of ``tools/eval_selftrained.py``).

Runs the evaluation suite (efficiency, performance, retrieval) of ``python
-m crs_tpu_torch --evaluate``, in this process, on the checkpoint written by
``selftrain_lm`` (``--ckpt``, by default the repository's
``checkpoints/selftrained_small``, only read), once per variant of
``VARIANTS``. Each variant's config is a copy of ``--base-config`` (by
default config.json) with the model pointed at the checkpoint and the JAX
tool's overrides, and is written to ``<out>/config_<name>.json``; its
results go to ``<out>/<name>/`` (the detailed responses to
``<out>/<name>/retrieval/``); ``<out>/summary.json`` is rewritten after each
variant. The held-out data:

- questions: with ``--qa`` (the full QA file of the training run) the
  ``qa_eval_indices`` of the checkpoint's ``selftrain_result.json``; by
  default the repository's ``results/selftrained/heldout_qa.json``, which
  holds exactly those;
- perplexity text: with ``--corpus`` the tail past ``1 - --holdout-frac`` of
  the corpus; by default the repository's
  ``results/selftrained/heldout_corpus.txt``, which is that tail.

The store is indexed from ``--corpus`` when given, else from the held-out
text, into ``<out>/index_<name>``.

Usage: python -m crs_tpu_torch.tools.eval_selftrained [--ckpt DIR]
       [--variants bf16,int8,...] [--out DIR] [--device cpu]

Runs on the card unless ``--device cpu`` (or ``--cpu``). ``--out`` defaults
to ``output_dir("eval_selftrained")``, outside the repository.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from . import output_dir

__all__ = ["VARIANTS", "DEFAULT_CKPT", "HELDOUT_QA", "HELDOUT_CORPUS", "variant_config",
           "summary_row", "main"]

REPO = Path(__file__).resolve().parents[2]
DEFAULT_CKPT = REPO / "checkpoints" / "selftrained_small"
HELDOUT_QA = REPO / "results" / "selftrained" / "heldout_qa.json"
HELDOUT_CORPUS = REPO / "results" / "selftrained" / "heldout_corpus.txt"

VARIANTS = {
    "bf16": {"type": "jax", "quantization": None},
    "int8": {"type": "int8", "quantization": "int8"},
    "int4": {"type": "int4", "quantization": "int4"},
    "nf4": {"type": "nf4", "quantization": "nf4"},
    "gptq": {"type": "gptq", "quantization": "gptq4"},
    "awq": {"type": "awq", "quantization": "awq4"},
}


def variant_config(base: Dict[str, Any], name: str, ckpt: str, held_txt: str, qa_path: str,
                   mc_qa_path: str, corpus_file: str, persist: str,
                   responses_dir: str) -> Dict[str, Any]:
    """``base`` with the JAX tool's overrides for variant ``name`` and the
    port's paths: the MC task's QA file (``crs_tpu`` reads a fixed one), the
    retrieval corpus, the store's directory and the detailed responses'
    directory (the benchmark's default is ``results/retrieval`` under the
    working directory)."""
    spec = VARIANTS[name]
    cfg = copy.deepcopy(base)
    cfg["model"].update({
        "model_path": ckpt,
        "type": spec["type"],
        "quantization": spec["quantization"],
        "max_seq_len": 2048,
    })
    # the training context budget (byte-level model, seq 1536)
    cfg["rag"]["generation"]["max_context_chars"] = 1200
    cfg["rag"]["generation"]["max_new_tokens"] = 96
    cfg["rag"]["vector_store"]["persist_directory"] = persist
    p = cfg["evaluation"]["performance"]["perplexity"]
    p["dataset_path"] = held_txt
    p["max_samples"] = 24
    p["max_length"] = 1024
    cfg["evaluation"]["performance"]["tasks"]["corpus_qa_mc"]["qa_path"] = mc_qa_path
    cfg["evaluation"]["retrieval"]["test_questions_file"] = qa_path
    cfg["evaluation"]["retrieval"]["save_detailed_responses"] = True
    cfg["evaluation"]["retrieval"]["output_dir"] = responses_dir
    cfg["evaluation"]["retrieval"]["corpus_file"] = corpus_file
    return cfg


def summary_row(rc: int, seconds: float, comp: Path, kind: str) -> Dict[str, Any]:
    """The JAX tool's row from ``comprehensive_results.json``, plus ``device``."""
    row: Dict[str, Any] = {"rc": rc, "seconds": round(seconds, 1)}
    if comp.exists():
        doc = json.loads(comp.read_text())
        perf = doc.get("performance") or {}
        retr = doc.get("retrieval") or {}
        eff = doc.get("efficiency") or {}
        row.update({
            "perplexity": perf.get("perplexity"),
            "f1_score": retr.get("f1_score"),
            "exact_match": retr.get("exact_match"),
            "faithfulness": retr.get("faithfulness"),
            "f1_improvement": retr.get("f1_improvement"),
            "context_sufficiency": retr.get("context_sufficiency"),
            "latency_ms_per_token": eff.get("latency_ms_per_token"),
            "model_size_gb": eff.get("model_size_gb"),
        })
    row["device"] = kind
    return row


def _held_out(args, out: Path):
    """(held-out questions file, held-out text file) written into ``out``."""
    if args.qa:
        meta = json.loads((Path(args.ckpt) / "selftrain_result.json").read_text())
        items = json.loads(Path(args.qa).read_text())
        held_qa = [items[i] for i in sorted(set(meta["qa_eval_indices"]))]
    else:
        held_qa = json.loads(HELDOUT_QA.read_text())
    if args.corpus:
        from .selftrain_lm import build_text

        text = build_text(args.corpus)
        tail = text[int(len(text) * (1.0 - args.holdout_frac)):]
    else:
        tail = HELDOUT_CORPUS.read_text()
    qa_path, held_txt = out / "heldout_qa.json", out / "heldout_corpus.txt"
    qa_path.write_text(json.dumps(held_qa, indent=2))
    held_txt.write_text(tail)
    return qa_path, held_txt


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default=output_dir("eval_selftrained"))
    ap.add_argument("--holdout-frac", type=float, default=0.08,
                    help="must match the selftrain run (with --corpus)")
    ap.add_argument("--qa", default=None,
                    help="the training run's full QA file (default: the repository's held-out "
                         "questions)")
    ap.add_argument("--corpus", default=None,
                    help="the training run's corpus (default: the repository's held-out tail)")
    ap.add_argument("--base-config", default=str(REPO / "config.json"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    from .. import __main__ as cli
    from ..utils.config import ConfigLoader

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    qa_path, held_txt = _held_out(args, out)
    base = ConfigLoader(args.base_config).config
    summary = {}
    for name in args.variants.split(","):
        t0 = time.perf_counter()
        cfg = variant_config(base, name, str(args.ckpt), str(held_txt), str(qa_path),
                             args.qa or str(qa_path), args.corpus or str(held_txt),
                             str(out / f"index_{name}"), str(out / name / "retrieval"))
        cfg_path = out / f"config_{name}.json"
        cfg_path.write_text(json.dumps(cfg, indent=2))
        out_dir = out / name
        print(f"== {name}: evaluating into {out_dir}", flush=True)
        rc = cli.main(["--config", str(cfg_path), "--evaluate", "--output-dir", str(out_dir),
                       "--device", str(dev)])
        summary[name] = summary_row(rc, time.perf_counter() - t0,
                                    out_dir / "comprehensive_results.json", kind)
        print(json.dumps({name: summary[name]}), flush=True)
        (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
