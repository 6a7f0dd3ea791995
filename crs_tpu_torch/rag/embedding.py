"""Batched text embedding (port of ``crs_tpu.rag.embedding``, hashed backend).

``HashedEncoder``: word uni/bi-gram feature hashing (``hashed_features``),
sublinear tf weights, then a fixed Gaussian random projection to ``dim``,
L2-normalized. The projection is ``default_rng(seed)`` numpy, so it is
bit-identical to the JAX package's. The ``lexical`` and ``minilm`` backends
are not ported yet and raise.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["EmbeddingModel", "HashedEncoder"]

# upper bound on the [rows, K, dim] float32 gather of one projection step
_GATHER_MAX_ELEMS = 1 << 25


def _csr_to_padded(indices, weights, offsets, rows: int, k: int):
    """Vectorized CSR → padded [rows, k] (idx, w); features beyond k are
    dropped per row."""
    n_texts = len(offsets) - 1
    lens = np.minimum(offsets[1:] - offsets[:-1], k)
    cum = np.concatenate([[0], np.cumsum(lens)])
    total = int(cum[-1])
    idx = np.zeros((rows, k), np.int64)
    w = np.zeros((rows, k), np.float32)
    if total:
        row_of = np.repeat(np.arange(n_texts), lens)
        pos_in_row = np.arange(total) - np.repeat(cum[:-1], lens)
        src = np.repeat(offsets[:-1], lens) + pos_in_row
        idx[row_of, pos_in_row] = indices[src]
        w[row_of, pos_in_row] = weights[src]
    return idx, w


def hashed_projection(num_features: int, dim: int, seed: int) -> np.ndarray:
    """The fixed projection, computed exactly as the JAX package does (the
    float32 draws divided by a float64 √dim, then rounded to float32)."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((num_features, dim)).astype(np.float32) / np.sqrt(dim)
    return proj.astype(np.float32)


class HashedEncoder(nn.Module):
    """Feature-hashing + fixed random projection sentence encoder."""

    _NNZ_BUCKETS = (64, 128, 256, 512, 1024)

    def __init__(self, dim: int = 384, num_features: int = 32768, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.dim = dim
        self.num_features = num_features
        self.device = resolve_device(device)
        proj = torch.from_numpy(hashed_projection(num_features, dim, seed))
        self.register_buffer("proj", proj.to(self.device))

    def project(self, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """emb[b] = normalize(Σ_k w[b,k] · proj[idx[b,k]]), in row chunks so
        that the [rows, K, dim] gather never exceeds ``_GATHER_MAX_ELEMS``."""
        rows, k = idx.shape
        out = torch.empty((rows, self.dim), dtype=torch.float32, device=self.device)
        step = max(1, _GATHER_MAX_ELEMS // max(k * self.dim, 1))
        for r0 in range(0, rows, step):
            gathered = self.proj[idx[r0 : r0 + step]]  # [c, K, dim]
            o = torch.bmm(w[r0 : r0 + step, None, :], gathered)[:, 0]
            norm = torch.linalg.vector_norm(o, dim=-1, keepdim=True)
            out[r0 : r0 + step] = o / torch.clamp_min(norm, 1e-12)
        return out

    def encode_dev(self, texts: Sequence[str]) -> torch.Tensor:
        """Encode texts → [len(texts), dim] float32 on the encoder's device."""
        from .hashed_features import featurize_batch

        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        indices, weights, offsets = featurize_batch(texts, self.num_features)
        nnz = int(np.max(offsets[1:] - offsets[:-1]))
        k = next((bk for bk in self._NNZ_BUCKETS if nnz <= bk), self._NNZ_BUCKETS[-1])
        idx, w = _csr_to_padded(indices, weights, offsets, len(texts), k)
        return self.project(
            torch.from_numpy(idx).to(self.device), torch.from_numpy(w).to(self.device)
        )


class EmbeddingModel:
    """Config-driven embedding front end (``hashed`` backend only)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        config = config or {}
        self.backend = config.get("backend", "minilm")
        self.embedding_dim = int(config.get("embedding_dim", 384))
        self.batch_size = int(config.get("batch_size", 32))
        self.normalize = bool(config.get("normalize", True))
        self.device = resolve_device(device)
        seed = int(config.get("seed", 0))
        if self.backend == "hashed":
            self._hashed = HashedEncoder(dim=self.embedding_dim, seed=seed, device=self.device)
        elif self.backend in ("lexical", "minilm"):
            raise NotImplementedError(
                f"the {self.backend!r} embedding backend is not ported to crs_tpu_torch "
                "yet (ROADMAP: modules to port, rag/embedding.py)"
            )
        else:
            raise ValueError(f"unknown embedding backend: {self.backend}")
        logger.info("EmbeddingModel backend=%s dim=%d device=%s", self.backend,
                    self.embedding_dim, self.device)

    @property
    def encoder(self) -> HashedEncoder:
        return self._hashed

    def embed(self, texts: Union[str, Sequence[str]]) -> torch.Tensor:
        """Embed texts → [N, dim] L2-normalized float32 on the model's device,
        one projection per ≤512 texts."""
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            return torch.zeros((0, self.embedding_dim), dtype=torch.float32, device=self.device)
        outs = [
            self._hashed.encode_dev(texts[i : i + 512])
            for i in range(0, len(texts), 512)
        ]
        return outs[0] if len(outs) == 1 else torch.cat(outs, 0)

    # the hashed backend fits no corpus statistics: the pipeline's hooks are no-ops
    def fit(self, corpus_texts: Sequence[str]) -> None:
        pass

    def save_state(self, directory: str) -> None:
        pass

    def load_state(self, directory: str) -> bool:
        return False

    def get_stats(self) -> Dict[str, Any]:
        return {"backend": self.backend, "embedding_dim": self.embedding_dim,
                "batch_size": self.batch_size, "normalize": self.normalize}

    def embed_chunks(self, chunks: Sequence[Any]) -> torch.Tensor:
        return self.embed([c.text if hasattr(c, "text") else str(c) for c in chunks])

