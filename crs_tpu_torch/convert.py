"""Carry ``crs_tpu`` state across to the port.

Every function takes the JAX package's arrays as numpy (``np.asarray`` of
its device arrays) and returns the port's objects on ``device``, so both
packages can run on one state: the ``HashedEncoder`` projection, the int8
``VectorStore`` (codes, scales, n, ids, documents, metadatas) and the
retriever's per-chunk token ids.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .rag.embedding import EmbeddingModel
from .rag.index import VectorStore
from .rag.retrieval import ContextRetriever

__all__ = ["embedding_model_from_numpy", "int8_store_from_numpy", "retriever_from_numpy"]

Device = Optional[Union[str, torch.device]]


def embedding_model_from_numpy(proj: np.ndarray, config: Optional[Dict[str, Any]] = None,
                               device: Device = None) -> EmbeddingModel:
    """A hashed-backend ``EmbeddingModel`` whose projection is ``proj``
    [num_features, dim] (``crs_tpu``'s ``HashedEncoder._proj``)."""
    proj = np.array(proj, np.float32)  # a writable copy
    cfg = dict(config or {}, backend="hashed", embedding_dim=int(proj.shape[1]))
    model = EmbeddingModel(cfg, device=device)
    enc = model.encoder
    if proj.shape[0] != enc.num_features:
        raise ValueError(f"projection has {proj.shape[0]} features, encoder {enc.num_features}")
    enc.proj.copy_(torch.from_numpy(proj))
    return model


def int8_store_from_numpy(codes: np.ndarray, scales: np.ndarray, n: int, ids: Sequence[str],
                          documents: Sequence[str], metadatas: Sequence[Dict[str, Any]],
                          config: Optional[Dict[str, Any]] = None,
                          device: Device = None) -> VectorStore:
    """An int8 ``VectorStore`` holding ``crs_tpu``'s padded ``_codes``
    [rows, D] int8 and ``_scales`` [rows] f32 with its host metadata."""
    codes = np.array(codes, np.int8)
    scales = np.array(scales, np.float32)
    if codes.ndim != 2 or scales.shape != (codes.shape[0],) or not 0 <= n <= codes.shape[0]:
        raise ValueError("codes must be [rows, D], scales [rows], n <= rows")
    store = VectorStore(dict(config or {}, format="int8"), device=device)
    store.n, store.dim = int(n), int(codes.shape[1])
    store.ids, store.documents = list(ids), list(documents)
    store.metadatas = [dict(m) for m in metadatas]
    store._codes = torch.from_numpy(codes).to(store.device)
    store._scales = torch.from_numpy(scales).to(store.device)
    return store


def retriever_from_numpy(store: VectorStore, embedder: EmbeddingModel,
                         doc_token_ids: np.ndarray,
                         config: Optional[Dict[str, Any]] = None) -> ContextRetriever:
    """A ``ContextRetriever`` whose presence ids are ``crs_tpu``'s
    ``_doc_token_ids`` [padded rows, 128] int32 for ``store``."""
    toks = np.array(doc_token_ids, np.int32)
    if toks.shape[0] != store._padded_rows():
        raise ValueError("doc_token_ids needs one row per padded store row")
    retriever = ContextRetriever(store, embedder, config)
    retriever._doc_token_ids = torch.from_numpy(toks).to(store.device)
    retriever._presence_n = store.n
    return retriever
