"""Perplexity (port of ``crs_tpu.evaluation.performance.perplexity``).

Text sources, in order: ``texts`` from the config, a local text or JSON
file (``dataset_path``), a Hugging Face dataset already in the local cache
(never fetched), or the paragraphs of a local PDF (``corpus_pdf``, read by
the port's ``DocumentProcessor``). Texts of over 10 words, sampled evenly
down to ``max_samples``. Two modes:

- simple: each text's first ``max_length`` tokens, NLL summed over its
  tokens, exp(total NLL / total tokens),
- strided (``stride`` set): sliding windows of ``max_length`` that score
  only the tokens an earlier window did not.

The NLL is summed on the model's device. A failing text is skipped.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["PerplexityEvaluator"]

_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


class PerplexityEvaluator:
    def __init__(self, model, config: Optional[Dict[str, Any]] = None):
        self.model = model
        cfg = config or {}
        self.dataset = cfg.get("dataset", "wikitext-2-raw-v1")
        self.dataset_path = cfg.get("dataset_path")
        self.texts: Optional[Sequence[str]] = cfg.get("texts")
        self.max_samples = int(cfg.get("max_samples", 100))
        self.max_length = int(cfg.get("max_length", 512))
        self.stride = cfg.get("stride")  # set → sliding-window mode
        # the PDF whose paragraphs are the last text source
        self.corpus_pdf: Optional[str] = cfg.get("corpus_pdf")

    # -- text sourcing ----------------
    def _load_texts(self) -> List[str]:
        if self.texts:
            texts = list(self.texts)
        elif self.dataset_path and os.path.exists(self.dataset_path):
            texts = _load_local(self.dataset_path)
        else:
            texts = _load_hf(self.dataset) or _load_bundled(self.corpus_pdf)
        texts = [t for t in texts if t and len(t.split()) > 10]
        if len(texts) > self.max_samples:  # evenly spaced sampling like ref
            idx = np.linspace(0, len(texts) - 1, self.max_samples).astype(int)
            texts = [texts[i] for i in idx]
        return texts

    # -- scoring -------------------------------------------------------------
    def calculate(self) -> Dict[str, Any]:
        texts = self._load_texts()
        if not texts:
            return {"perplexity": None, "num_samples": 0}
        total_nll, total_tokens, used = 0.0, 0, 0
        for text in texts:
            try:
                if self.stride:
                    nll, n = self._score_strided(text)
                else:
                    nll, n = self._score_simple(text)
                if n > 0 and math.isfinite(nll):
                    total_nll += nll
                    total_tokens += n
                    used += 1
            except Exception as e:  # pragma: no cover - OOM-tolerant like ref
                logger.warning("perplexity sample failed: %s", e)
        if total_tokens == 0:
            return {"perplexity": None, "num_samples": 0}
        ppl = math.exp(total_nll / total_tokens)
        return {
            "perplexity": ppl,
            "avg_nll": total_nll / total_tokens,
            "num_samples": used,
            "num_tokens": total_tokens,
            "max_length": self.max_length,
            "mode": "strided" if self.stride else "simple",
        }

    def _token_nll(self, ids: List[int], score_from: int) -> float:
        """Sum of -log p(token | prefix) for positions >= score_from.

        ids are tail-padded to power-of-two buckets and scored on the
        model's device by ``_sequence_logprob``: one value crosses to the
        host, not the [1, S, V] logits.
        """
        import torch

        from ...models.model_interface import _sequence_logprob

        blen = _bucket(len(ids))
        arr = np.zeros((1, blen), np.int64)
        arr[0, : len(ids)] = ids
        mask = np.zeros((1, blen), np.bool_)
        mask[0, : len(ids)] = True
        dev = self.model.device
        lp, _ = _sequence_logprob(
            self.model.params, self.model.cfg, torch.from_numpy(arr).to(dev),
            torch.from_numpy(mask).to(dev), max(score_from, 1),
        )
        return -float(lp[0])

    def _score_simple(self, text: str):
        ids = self.model.tokenizer.encode(text, max_length=self.max_length)
        if len(ids) < 2:
            return 0.0, 0
        return self._token_nll(ids, 1), len(ids) - 1

    def _score_strided(self, text: str):
        """Sliding window with overlap exclusion."""
        ids = self.model.tokenizer.encode(text)
        stride = int(self.stride)
        total_nll, total_tokens = 0.0, 0
        prev_end = 0
        for start in range(0, max(len(ids) - 1, 1), stride):
            end = min(start + self.max_length, len(ids))
            window = ids[start:end]
            score_from = max(prev_end - start, 1)
            if len(window) >= 2 and score_from < len(window):
                total_nll += self._token_nll(window, score_from)
                total_tokens += len(window) - score_from
            prev_end = end
            if end == len(ids):
                break
        return total_nll, total_tokens


def _load_local(path: str) -> List[str]:
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, list):
            return [d if isinstance(d, str) else d.get("text", "") for d in data]
        return []
    with open(path, encoding="utf-8", errors="replace") as f:
        raw = f.read()
    return [p for p in raw.split("\n\n") if p.strip()]


def _load_hf(name: str) -> Optional[List[str]]:
    try:  # pragma: no cover - requires a local HF cache
        # offline by default: without a network the hub client spends ~30 s
        # in DNS retries before it fails; export HF_DATASETS_OFFLINE=0 to fetch
        os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        from datasets import load_dataset  # type: ignore

        ds = load_dataset("wikitext", name, split="test")
        return [r["text"] for r in ds]
    except Exception:
        return None


def _load_bundled(pdf_path: Optional[str]) -> List[str]:
    """The last fallback: the paragraphs (over 10 words) of a local PDF."""
    if not pdf_path or not os.path.exists(pdf_path):
        return []
    try:
        from ...rag.document_processing import DocumentProcessor

        pages = DocumentProcessor({}).process_pdf(pdf_path)
        out: List[str] = []
        for text, _ in pages:
            out.extend(p for p in text.split("\n") if len(p.split()) > 10)
        logger.info("perplexity: using the corpus PDF (%d paragraphs)", len(out))
        return out
    except Exception:
        return []
