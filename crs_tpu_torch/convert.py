"""Carry ``crs_tpu`` state across to the port.

Every function takes the JAX package's arrays as numpy (``np.asarray`` of
its device arrays) and returns the port's objects on ``device``, so both
packages can run on one state: the ``HashedEncoder`` projection, the
``VectorStore`` in each format (int8 codes and scales; fp32/bf16 vectors;
PQ codebooks, rotation, coarse centroids, coarse ids and codes with the
int8 mirror), the retriever's per-chunk token ids, and a model's params
tree (numpy arrays, bf16 ones included, quantized-tensor and LoRA nodes).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .ops.pq import PQCodebook, ResidualPQ
from .rag.embedding import EmbeddingModel
from .rag.index import _FLOAT_DTYPES, VectorStore
from .rag.retrieval import ContextRetriever

__all__ = [
    "params_from_numpy", "embedding_model_from_numpy", "int8_store_from_numpy", "float_store_from_numpy",
    "pq_store_from_numpy", "retriever_from_numpy",
]

Device = Optional[Union[str, torch.device]]


def _tensor_from_numpy(a) -> torch.Tensor:
    """An array as a tensor with the same bits; bfloat16 arrays (ml_dtypes)
    travel as their uint16 words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree: Any, device: Device = "cpu") -> Any:
    """A ``crs_tpu`` params tree (dicts, lists, arrays given as numpy,
    ``QuantizedTensor`` nodes whose codes / scales are arrays, and
    ``LoRAWeight`` nodes: base, A, B, alpha, rank) as the port's params on
    ``device``, bit for bit; a LoRA node's A and B are leaf tensors that
    require a gradient, as ``add_lora`` makes them."""
    from .finetuning.lora import LoRAWeight
    from .models.quantized import QuantizedTensor

    dev = torch.device(device)
    if all(hasattr(tree, a) for a in ("base", "lora_a", "lora_b", "alpha", "rank")):
        a, b = (_tensor_from_numpy(t).to(dev).requires_grad_(True)
                for t in (tree.lora_a, tree.lora_b))
        return LoRAWeight(params_from_numpy(tree.base, dev), a, b, float(tree.alpha),
                          int(tree.rank))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    if all(hasattr(tree, a) for a in ("codes", "scales", "bits", "group_size", "shape")):
        return QuantizedTensor(_tensor_from_numpy(tree.codes).to(dev),
                               _tensor_from_numpy(tree.scales).to(dev), tree.bits,
                               int(tree.group_size), tuple(int(d) for d in tree.shape))
    return _tensor_from_numpy(tree).to(dev)


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


def _store_shell(fmt: str, n: int, dim: int, ids, documents, metadatas, config,
                 device) -> VectorStore:
    store = VectorStore(dict(config or {}, format=fmt), device=device)
    store.n, store.dim = int(n), int(dim)
    store.ids, store.documents = list(ids), list(documents)
    store.metadatas = [dict(m) for m in metadatas]
    return store


def _dev(a: np.ndarray, dtype, store: VectorStore) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype)).to(store.device)


def int8_store_from_numpy(codes: np.ndarray, scales: np.ndarray, n: int, ids: Sequence[str],
                          documents: Sequence[str], metadatas: Sequence[Dict[str, Any]],
                          config: Optional[Dict[str, Any]] = None,
                          device: Device = None) -> VectorStore:
    """An int8 ``VectorStore`` holding ``crs_tpu``'s padded ``_codes``
    [rows, D] int8 and ``_scales`` [rows] f32 with its host metadata."""
    codes = np.asarray(codes)
    if codes.ndim != 2 or np.shape(scales) != (codes.shape[0],) or not 0 <= n <= codes.shape[0]:
        raise ValueError("codes must be [rows, D], scales [rows], n <= rows")
    store = _store_shell("int8", n, codes.shape[1], ids, documents, metadatas, config, device)
    store._codes = _dev(codes, np.int8, store)
    store._scales = _dev(scales, np.float32, store)
    return store


def float_store_from_numpy(vectors: np.ndarray, n: int, ids: Sequence[str],
                           documents: Sequence[str], metadatas: Sequence[Dict[str, Any]],
                           config: Optional[Dict[str, Any]] = None,
                           device: Device = None) -> VectorStore:
    """An fp32 or bf16 ``VectorStore`` (``config["format"]``, fp32 by
    default) holding ``crs_tpu``'s padded ``_vectors`` [rows, D], given as
    float32 (a bf16 store's vectors widen exactly)."""
    fmt = (config or {}).get("format", "fp32")
    if fmt not in _FLOAT_DTYPES:
        raise ValueError(f"float_store_from_numpy takes fp32 or bf16, got {fmt!r}")
    vectors = np.asarray(vectors, np.float32)
    if vectors.ndim != 2 or not 0 <= n <= vectors.shape[0]:
        raise ValueError("vectors must be [rows, D] with n <= rows")
    store = _store_shell(fmt, n, vectors.shape[1], ids, documents, metadatas, config, device)
    store._vectors = _dev(vectors, np.float32, store).to(_FLOAT_DTYPES[fmt])
    return store


def pq_store_from_numpy(n: int, dim: int, ids: Sequence[str], documents: Sequence[str],
                        metadatas: Sequence[Dict[str, Any]], centroids: np.ndarray,
                        pq_codes: np.ndarray, rotation: Optional[np.ndarray] = None,
                        coarse: Optional[np.ndarray] = None,
                        coarse_ids: Optional[np.ndarray] = None,
                        codes: Optional[np.ndarray] = None, scales: Optional[np.ndarray] = None,
                        codes_host: Optional[np.ndarray] = None,
                        scales_host: Optional[np.ndarray] = None,
                        config: Optional[Dict[str, Any]] = None,
                        device: Device = None) -> VectorStore:
    """A pq ``VectorStore`` holding ``crs_tpu``'s trained state: the codebook
    centroids [M, K, Dsub] and padded codes [rows, M] (uint8); for residual
    PQ the rotation [D, D], coarse centroids [C, D] and coarse ids [rows];
    the int8 mirror (``codes``/``scales`` on the device for
    ``pq_rescore="int8"``, ``codes_host``/``scales_host`` for ``"host"``).
    ``config`` carries ``pq_rescore``, ``block_size``, ``rescore_k``."""
    store = _store_shell("pq", n, dim, ids, documents, metadatas, config, device)
    pq_codes = np.asarray(pq_codes)
    store._pq_codes = torch.from_numpy(np.array(pq_codes)).to(store.device)
    store._pq_codebook = PQCodebook(_dev(centroids, np.float32, store))
    if rotation is not None:
        store._rpq = ResidualPQ(rotation=_dev(rotation, np.float32, store),
                                coarse=_dev(coarse, np.float32, store),
                                codebook=store._pq_codebook)
        store._pq_coarse_ids = _dev(coarse_ids, np.int32, store)
    if store.pq_rescore == "int8":
        if codes is None or scales is None:
            raise ValueError("pq_rescore='int8' needs the device mirror (codes, scales)")
        store._codes = _dev(codes, np.int8, store)
        store._scales = _dev(scales, np.float32, store)
    elif store.pq_rescore == "host":
        if codes_host is None or scales_host is None:
            raise ValueError("pq_rescore='host' needs the host mirror (codes_host, scales_host)")
        store._codes_host = np.array(codes_host, np.int8)
        store._scales_host = np.array(scales_host, np.float32)
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
