"""Self-train the generator LM on a corpus (port of ``tools/selftrain_lm.py``).

A byte-level Mistral-family LM (vocab 384, f32 weights) pretrained from the
seeded init on ``--corpus`` (a PDF or a text file), with QA-instruct samples
from ``--qa`` mixed in, in the prompt formats the RAG generator emits at
inference (``crs_tpu_torch/rag/generation.py``):

- corpus next-byte windows (stride seq/2), the loss on every real token;
- every ``--qa-every``-th step a batch of QA-instruct samples from the TRAIN
  split (10 questions are held out for the evaluation), in three prompt
  variants (the chat fallback ``[INST] .. [/INST]``, the simple retry
  prompt, no context), the loss on the answer's tokens only;
- the samples' contexts from the port's own retriever over the corpus
  (config.json's lexical encoder, an fp32 store), built in this process and
  kept in ``<out>/train_contexts.json`` for the next run.

The optimizer is optax's ``chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps + warmup),
weight_decay=0.01))`` written out (``finetuning.trainer``'s ``_AdamW`` over
every tensor, the norm summed in f32); the products are f32 (TF32 off). After
training: the byte perplexity of the held-out tail of the corpus, the
checkpoint in ``crs_tpu``'s layout (``save_pretrained``) and
``selftrain_result.json`` (the JAX tool's keys, plus ``device``: the device,
the median step time between CUDA events, tokens/s and the peak memory).

Usage: python -m crs_tpu_torch.tools.selftrain_lm --corpus DOC --qa QA.json
       [--out DIR] [--steps N] [--device cpu]

Runs on the card unless ``--device cpu`` (or ``--cpu``). ``--out`` defaults
to ``output_dir("selftrain_lm")``, outside the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import output_dir

__all__ = ["build_text", "qa_split", "retrieve_contexts", "qa_sample_texts", "corpus_windows",
           "encode_qa", "Batches", "model_config", "param_leaves", "on_device", "loss_fn",
           "heldout_perplexity", "parse_args", "prepare", "run", "main"]

REPO = Path(__file__).resolve().parents[2]
VOCAB = 384  # bytes, BOS / EOS / PAD and headroom
MAX_SEQ_LEN = 2048


def build_text(corpus: str) -> str:
    """The corpus's pages (a PDF's, or a text file's one page) joined by blank lines."""
    from ..rag.document_processing import DocumentProcessor

    return "\n\n".join(t for t, _ in DocumentProcessor({}).process_file(corpus))


def qa_split(qa_path: str, seed: int = 0, n_eval: int = 10):
    """(train items, held-out items, held-out indices): the first ``n_eval``
    of a ``default_rng(seed)`` permutation are held out."""
    items = json.loads(Path(qa_path).read_text())
    order = np.random.default_rng(seed).permutation(len(items))
    eval_idx = sorted(int(i) for i in order[:n_eval])
    held = set(eval_idx)
    train = [items[i] for i in range(len(items)) if i not in held]
    return train, [items[i] for i in eval_idx], eval_idx


def retrieve_contexts(questions: Sequence[str], corpus: str, dev, top_k: int = 3,
                      max_chars: int = 1200) -> List[str]:
    """Top-k chunk contexts from the port's pipeline over ``corpus``
    (config.json's processing, chunking, embedding and retrieval; an fp32
    store of 256-row blocks): the evaluator's context distribution."""
    from ..rag.chunking import TextChunker
    from ..rag.document_processing import DocumentProcessor
    from ..rag.embedding import EmbeddingModel
    from ..rag.index import VectorStore
    from ..rag.retrieval import ContextRetriever
    from ..utils.config import ConfigLoader

    cfg = ConfigLoader(str(REPO / "config.json"))
    pages = DocumentProcessor(cfg.get("rag.document_processing") or {}).process_file(corpus)
    ck = TextChunker(cfg.get("rag.chunking") or {})
    chunks = [c for t, p in pages for c in ck.chunk(t, page_number=p)]
    em = EmbeddingModel(cfg.get("rag.embedding") or {}, device=dev)
    store = VectorStore({"format": "fp32", "block_size": 256}, device=dev)
    store.create_index(chunks, em.embed_chunks(chunks))
    retr = ContextRetriever(store, em, cfg.get("rag.retrieval") or {})
    return ["\n\n".join(h["text"] for h in retr.retrieve(q, top_k=top_k))[:max_chars]
            for q in questions]


def qa_sample_texts(item: Dict[str, Any], ctx: str) -> List[Tuple[str, str]]:
    """(prompt, answer) pairs in the generator's inference formats."""
    q, a = item["question"], item["answer"]
    user = (
        "Use the following context to answer the question. "
        "Answer concisely based only on the context.\n\n"
        f"Context:\n{ctx}\n\nQuestion: {q}"
    )
    return [
        (f"[INST] {user} [/INST]", " " + a),
        (f"Context: {ctx}\n\nQuestion: {q}\nAnswer:", " " + a),
        (f"[INST] {q} [/INST]", " " + a),
    ]


def corpus_windows(ids: np.ndarray, seq: int) -> List[np.ndarray]:
    """Windows of ``seq`` tokens at a stride of seq/2."""
    return [ids[s:s + seq] for s in range(0, max(len(ids) - seq, 1), seq // 2)]


def encode_qa(tok, qa_texts: Sequence[Tuple[str, str]], seq: int):
    """[(ids, first position of the loss)]: the prompt with BOS, then the
    answer with EOS (its BOS dropped), cut to ``seq``."""
    out = []
    for prompt, ans in qa_texts:
        p_ids = tok.encode(prompt, max_length=None)
        a_ids = tok.encode(ans, max_length=None, add_eos=True)[1:]
        ids = (p_ids + a_ids)[:seq]
        out.append((np.array(ids, np.int32), min(len(p_ids), len(ids))))
    return out


class Batches:
    """The training batches (ids, mask, loss mask), each [batch, seq]: a
    QA batch every ``qa_every``-th step, else a corpus batch, the rows drawn
    from one ``default_rng(seed)`` in call order."""

    def __init__(self, windows, qa_encoded, batch: int, seq: int, pad_id: int,
                 qa_every: int, seed: int = 1):
        self.windows, self.qa_encoded = windows, qa_encoded
        self.batch, self.seq, self.pad_id, self.qa_every = batch, seq, pad_id, qa_every
        self.rng = np.random.default_rng(seed)

    def _empty(self):
        return (np.full((self.batch, self.seq), self.pad_id, np.int32),
                np.zeros((self.batch, self.seq), np.bool_))

    def corpus_batch(self):
        ids, mask = self._empty()
        for r in range(self.batch):
            w = self.windows[self.rng.integers(len(self.windows))]
            ids[r, :len(w)] = w
            mask[r, :len(w)] = True
        return ids, mask, mask.copy()

    def qa_batch(self):
        ids, mask = self._empty()
        lmask = np.zeros_like(mask)
        for r in range(self.batch):
            seq, loss_from = self.qa_encoded[self.rng.integers(len(self.qa_encoded))]
            ids[r, :len(seq)] = seq
            mask[r, :len(seq)] = True
            lmask[r, loss_from:len(seq)] = True
        return ids, mask, lmask

    def for_step(self, i: int):
        return self.qa_batch() if self.qa_every and i % self.qa_every == 0 else self.corpus_batch()


def model_config(args):
    from ..models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=VOCAB, hidden_size=args.hidden, num_layers=args.layers,
        num_heads=args.heads, num_kv_heads=args.kv_heads, intermediate_size=args.inter,
        max_seq_len=MAX_SEQ_LEN, dtype=torch.float32)


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a params tree in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in param_leaves(p)]
    return [params]


def loss_fn(params, cfg, ids: torch.Tensor, mask: torch.Tensor,
            lmask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over ``lmask[:, 1:] & mask[:, :-1]``."""
    from ..finetuning.trainer import masked_loss
    from ..models.transformer import forward

    return masked_loss(forward(params, cfg, ids, mask), ids, mask, lmask)


def on_device(dev, *arrays) -> List[torch.Tensor]:
    """Batch arrays (int32 ids, bool masks) as int64 / bool tensors on ``dev``."""
    return [torch.from_numpy(a).to(dev, torch.int64 if a.dtype == np.int32 else torch.bool)
            for a in arrays]


@torch.no_grad()
def heldout_perplexity(params, cfg, text: str, seq: int) -> Tuple[float, int]:
    """(byte perplexity, bytes scored) of ``text``: windows of ``seq`` tokens
    at a stride of ``seq``, each window's mean loss weighted by
    max(its length − 1, 1)."""
    from ..models.bytes_tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    dev = params["embed"].device
    held_ids = np.array(tok.encode(text, max_length=None), np.int32)
    nll, count = 0.0, 0
    for s in range(0, max(len(held_ids) - 16, 1), seq):
        w = held_ids[s:s + seq]
        ids = np.full((1, seq), tok.pad_id, np.int32)
        mask = np.zeros((1, seq), np.bool_)
        ids[0, :len(w)] = w
        mask[0, :len(w)] = True
        ids_t, mask_t = on_device(dev, ids, mask)
        lv = float(loss_fn(params, cfg, ids_t, mask_t, mask_t))
        n = max(len(w) - 1, 1)
        nll += lv * n
        count += n
    return float(np.exp(nll / max(count, 1))), count


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True, help="the training document (.pdf, .txt, .md)")
    ap.add_argument("--qa", required=True,
                    help="JSON list of {question, answer}; 10 are held out for evaluation")
    ap.add_argument("--out", default=output_dir("selftrain_lm"))
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1536)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--inter", type=int, default=1536)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--qa-every", type=int, default=4,
                    help="every Nth step trains a QA-instruct batch")
    ap.add_argument("--holdout-frac", type=float, default=0.08)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--make-contexts", default=None, metavar="JSON",
                    help="build the QA retrieval contexts into JSON and exit")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap.parse_args(argv)


def prepare(args, dev) -> Dict[str, Any]:
    """The data of a run: the text split, the corpus windows, the QA split
    and its encoded samples (the contexts built or read from
    ``<out>/train_contexts.json``). Prints the JAX tool's lines."""
    from ..models.bytes_tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    text = build_text(args.corpus)
    cut = int(len(text) * (1.0 - args.holdout_frac))
    train_text, held_text = text[:cut], text[cut:]
    print(f"corpus: {len(text)} chars ({cut} train / {len(held_text)} held out)", flush=True)
    windows = corpus_windows(np.array(tok.encode(train_text, max_length=None), np.int32),
                             args.seq)
    print(f"{len(windows)} corpus windows of {args.seq}", flush=True)

    qa_train, qa_eval, eval_idx = qa_split(args.qa)
    if args.qa_every and not qa_train:
        raise ValueError(f"{args.qa} holds {len(qa_eval)} questions: all are held out for the "
                         "evaluation and none is left to train the QA batches on "
                         "(--qa-every 0 trains on the corpus alone)")
    ctx_json = Path(args.out) / "train_contexts.json"
    if not ctx_json.exists():
        os.makedirs(args.out, exist_ok=True)
        ctx_json.write_text(json.dumps(
            retrieve_contexts([x["question"] for x in qa_train], args.corpus, dev)))
    ctxs = json.loads(ctx_json.read_text())
    if len(ctxs) != len(qa_train):
        raise ValueError(f"{ctx_json} holds {len(ctxs)} contexts for {len(qa_train)} training "
                         "questions: it was built from another QA file")
    qa_texts = [pair for item, ctx in zip(qa_train, ctxs) for pair in qa_sample_texts(item, ctx)]
    print(f"{len(qa_texts)} QA-instruct samples (train={len(qa_train)}, "
          f"eval held out={len(qa_eval)})", flush=True)
    return {"held_text": held_text, "windows": windows, "eval_idx": eval_idx,
            "qa_encoded": encode_qa(tok, qa_texts, args.seq), "pad_id": tok.pad_id}


def run(args):
    """Train, score the held-out text and save: (params, cfg, result)."""
    from ..finetuning.trainer import _AdamW, warmup_cosine_lr
    from ..models.bytes_tokenizer import ByteTokenizer
    from ..models.model_interface import TorchModel
    from ..models.transformer import init_params
    from .timing import EagerCall

    dev = resolve_device("cpu" if args.cpu else args.device)
    if args.make_contexts:
        qa_train, _, _ = qa_split(args.qa)
        Path(args.make_contexts).write_text(json.dumps(
            retrieve_contexts([x["question"] for x in qa_train], args.corpus, dev)))
        return None
    data = prepare(args, dev)

    cfg = model_config(args)
    params = init_params(0, cfg, device=dev)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    n_params = sum(t.numel() for t in leaves)
    print(f"model: {n_params/1e6:.1f}M params", flush=True)

    batches = Batches(data["windows"], data["qa_encoded"], args.batch, args.seq, data["pad_id"],
                      args.qa_every)
    warmup = min(max(args.steps // 50, 10), max(args.steps // 2, 1))
    opt = _AdamW(leaves, lambda count: warmup_cosine_lr(count, args.lr, warmup,
                                                        args.steps + warmup),
                 weight_decay=0.01, max_norm=1.0, norm_dtype=torch.float32)

    def step(ids, mask, lmask):
        for t in leaves:
            t.grad = None
        loss = loss_fn(params, cfg, ids, mask, lmask)
        loss.backward()
        opt.step()
        return loss.detach()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    log, step_s = [], []
    for i in range(args.steps):
        ids, mask, lmask = on_device(dev, *batches.for_step(i))
        secs, loss = EagerCall(lambda: step(ids, mask, lmask), dev).run()
        step_s.append(secs)
        if i % args.log_every == 0 or i == args.steps - 1:
            lv = float(loss)
            dt = time.perf_counter() - t0
            print(f"step {i}: loss={lv:.4f} ({dt:.0f}s)", flush=True)
            log.append({"step": i, "loss": lv, "t": round(dt, 1)})
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    # the first step loads the libraries: the median is over the later steps
    step_ms = statistics.median(step_s[1:] or step_s) * 1e3 if step_s else None
    peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6 if dev.type == "cuda" else None

    ppl, count = heldout_perplexity(params, cfg, data["held_text"], args.seq)
    print(f"held-out byte perplexity: {ppl:.3f} over {count} bytes", flush=True)

    m = TorchModel({"config": "small", "max_seq_len": MAX_SEQ_LEN}, device=dev)
    m.cfg, m.params, m.tokenizer, m._loaded = cfg, params, ByteTokenizer(), True
    m.config_name = "selftrained_small"
    os.makedirs(args.out, exist_ok=True)
    m.save_pretrained(args.out)
    result = {
        "params_millions": round(n_params / 1e6, 2),
        "steps": args.steps,
        "final_loss": log[-1]["loss"] if log else None,
        "heldout_byte_perplexity": round(ppl, 4),
        "heldout_bytes": count,
        "qa_eval_indices": data["eval_idx"],
        "train_seconds": round(time.perf_counter() - t0, 1),
        "log": log,
        "device": {
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "step_ms_median": step_ms,
            "tokens_per_s": args.batch * args.seq / (step_ms / 1e3) if step_ms else None,
            "peak_mb": peak_mb,
        },
    }
    Path(args.out, "selftrain_result.json").write_text(json.dumps(result, indent=2))
    print(json.dumps({k: v for k, v in result.items() if k != "log"}), flush=True)
    return params, cfg, result


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
