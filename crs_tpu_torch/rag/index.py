"""Device-resident int8 vector store (port of ``crs_tpu.rag.index``).

Corpus vectors live on the device as per-row int8 codes + float32 scales,
padded to a multiple of ``block_size`` rows. Search is the int8 scan
(``ops.scan`` through the CUDA kernel on the card) followed by an fp32
rescore of the top ``rescore_k`` candidates. Persistence uses the JAX
package's on-disk format (``index_meta.json`` + ``index_arrays.npz``), so an
index either package saved loads in the other.

Only the ``int8`` format is ported; ``fp32``, ``bf16`` and ``pq`` raise.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import int8_topk, scalar_quantize
from ..ops.scan import scan_topk_int8
from ..ops.topk import NEG_INF, topk_stable

logger = logging.getLogger(__name__)

__all__ = ["VectorStore", "INDEX_FORMATS"]

INDEX_FORMATS = ("fp32", "bf16", "int8", "pq")


def _pad_rows(arr: torch.Tensor, multiple: int) -> torch.Tensor:
    n = arr.shape[0]
    padded = -(-n // multiple) * multiple
    if padded == n:
        return arr
    pad = torch.zeros((padded - n,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], 0)


def _as_f32(x: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """float32 tensor of ``x``; host arrays are copied (they may be read-only)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _check_format(fmt: str) -> None:
    if fmt not in INDEX_FORMATS:
        raise ValueError(f"unknown index format: {fmt}")
    if fmt != "int8":
        raise NotImplementedError(
            f"the {fmt!r} index format is not ported to crs_tpu_torch yet "
            "(ROADMAP: modules to port, rag/index.py); use format='int8'"
        )


class VectorStore:
    """Stateful shell around the on-device int8 index + host metadata."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        config = config or {}
        self.format = config.get("format", "fp32")
        _check_format(self.format)
        self.device = resolve_device(device)
        self.block_size = int(config.get("block_size", 4096))
        self.persist_directory = config.get("persist_directory")
        self.rescore_k = int(config.get("rescore_k", 64))
        self._clear()
        if self.persist_directory and os.path.exists(
            os.path.join(self.persist_directory, "index_meta.json")
        ):
            self.load(self.persist_directory)

    def _clear(self) -> None:
        self.n = 0
        self.dim = 0
        self.ids: List[str] = []
        self.documents: List[str] = []
        self.metadatas: List[Dict[str, Any]] = []
        self._codes: Optional[torch.Tensor] = None  # [padded, D] int8
        self._scales: Optional[torch.Tensor] = None  # [padded] f32
        self._md_cols: Dict[str, Tuple[np.ndarray, np.ndarray, int]] = {}

    # -- build -------------------------------------------------------------
    def create_index(
        self,
        chunks: Sequence[Any],
        embeddings: Union[np.ndarray, torch.Tensor],
        ids: Optional[Sequence[str]] = None,
    ) -> None:
        """Build the index from chunks + their embeddings."""
        emb = _as_f32(embeddings)
        if emb.ndim != 2:
            raise ValueError("embeddings must be [N, D]")
        if len(chunks) != emb.shape[0]:
            raise ValueError("chunks and embeddings length mismatch")
        self._clear()
        self.n = int(emb.shape[0])
        self.dim = int(emb.shape[1])
        for i, c in enumerate(chunks):
            if hasattr(c, "text"):
                self.ids.append(c.chunk_id)
                self.documents.append(c.text)
                self.metadatas.append(c.to_metadata())
            else:
                self.ids.append(ids[i] if ids else f"chunk_{i}")
                self.documents.append(str(c))
                self.metadatas.append({})
        padded = _pad_rows(emb.to(self.device), self.block_size)
        self._codes, self._scales = scalar_quantize(padded)
        logger.info("Indexed %d vectors (dim=%d, format=%s)", self.n, self.dim, self.format)
        if self.persist_directory:
            self.save(self.persist_directory)

    def _padded_rows(self) -> int:
        return 0 if self._codes is None else self._codes.shape[0]

    # -- query -------------------------------------------------------------
    def search_batch(
        self,
        query_embeddings: Union[np.ndarray, torch.Tensor],  # [B, D]
        top_k: int = 3,
        where: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched top-k: (scores [B, k] cosine sim, ids [B, k] int64)."""
        q = _as_f32(query_embeddings).to(self.device)
        if self.n == 0:
            b = q.shape[0]
            return (torch.zeros((b, 0), device=self.device),
                    torch.zeros((b, 0), dtype=torch.int64, device=self.device))
        k = min(top_k, self.n)
        if where:
            return self._masked_search(q, k, where)
        return self.search_batch_dev(q, k)

    def search_batch_dev(self, q: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-level batched search, no host sync."""
        k = min(top_k, self.n)
        if self.device.type == "cuda" and self._codes.shape[0] >= 4 * self.block_size:
            cand_k = min(max(self.rescore_k, k), self.n)
            _, cand = scan_topk_int8(self._codes, self._scales, q, cand_k, self.n)
            return _rescore(self._codes, self._scales, q, cand, k, self.n)
        return int8_topk(self._codes, self._scales, q, k, self.n,
                         rescore_k=max(self.rescore_k, k))

    def gather_vectors_dev(self, rows: torch.Tensor) -> torch.Tensor:
        """Device-level dense-row gather (for MMR), no host sync."""
        rows = torch.clamp_min(rows, 0)
        return self._codes[rows].float() * self._scales[rows][..., None]

    def _md_column(self, key: str) -> Tuple[np.ndarray, np.ndarray]:
        """Typed per-key metadata column + missing mask, cached per key."""
        cached = self._md_cols.get(key)
        if cached is not None and cached[2] == len(self.metadatas):
            return cached[0], cached[1]
        vals = [md.get(key) for md in self.metadatas]
        missing = np.fromiter((v is None for v in vals), np.bool_, count=len(vals))
        present = [v for v in vals if v is not None]
        if present and all(isinstance(v, (bool, int, float)) for v in present):
            col = np.fromiter((0.0 if v is None else float(v) for v in vals),
                              np.float64, count=len(vals))
        elif present and all(isinstance(v, str) for v in present):
            col = np.array(["" if v is None else v for v in vals])
        else:
            col = np.array(vals, dtype=object)
        self._md_cols[key] = (col, missing, len(self.metadatas))
        return col, missing

    def _row_mask(self, where: Dict[str, Any]) -> Tuple[np.ndarray, int]:
        """Host-built metadata row mask over the padded rows."""
        n = len(self.metadatas)
        allowed = np.ones((n,), np.bool_)
        for key, val in where.items():
            col, missing = self._md_column(key)
            if val is None:
                eq = missing
            elif col.dtype == object:
                eq = (col == val) & ~missing
            elif isinstance(val, (bool, int, float)) and col.dtype.kind == "f":
                eq = (col == float(val)) & ~missing
            elif isinstance(val, str) and col.dtype.kind in ("U", "S"):
                eq = (col == val) & ~missing
            else:  # type mismatch between query value and column: no rows
                eq = np.zeros((n,), np.bool_)
            allowed &= np.asarray(eq, np.bool_)
        mask = np.zeros((self._padded_rows(),), np.bool_)
        mask[:n] = allowed
        return mask, int(allowed.sum())

    def _masked_search(self, q: torch.Tensor, k: int, where: Dict[str, Any]):
        """Metadata-filtered search; the mask applies to the scan's scores,
        the int8 codes are never densified."""
        mask_np, n_allowed = self._row_mask(where)
        k_eff = min(k, max(n_allowed, 1))
        mask = torch.from_numpy(mask_np).to(self.device)
        cand_k = min(max(self.rescore_k, k_eff), self.n)
        return int8_topk(self._codes, self._scales, q, k_eff, self.n,
                         rescore_k=cand_k, row_mask=mask)

    def search(
        self,
        query_embedding: Union[np.ndarray, torch.Tensor],  # [D] or [1, D]
        top_k: int = 3,
        where: Optional[Dict[str, Any]] = None,
        where_document: Optional[str] = None,
    ) -> Dict[str, List[List[Any]]]:
        """Single-query search with the reference's result envelope.
        ``where_document`` keeps hits whose text contains the substring,
        widening the fetch until ``top_k`` match or the corpus is exhausted."""
        q = _as_f32(query_embedding)
        if q.ndim == 1:
            q = q[None, :]
        fetch = top_k if not where_document else min(max(4 * top_k, 16), max(self.n, 1))
        while True:
            scores, idxs = self.search_batch(q, top_k=fetch, where=where)
            scores, idxs = scores.cpu().tolist(), idxs.cpu().tolist()
            rows = []
            enough = True
            for row_s, row_i in zip(scores, idxs):
                keep = [(s, i) for s, i in zip(row_s, row_i) if 0 <= i < self.n and s > -1e29]
                if where_document:
                    matched = [(s, i) for s, i in keep if where_document in self.documents[i]]
                    if len(matched) < top_k and len(keep) == fetch and fetch < self.n:
                        enough = False
                        break
                    keep = matched
                rows.append(keep)
            if enough:
                break
            fetch = min(4 * fetch, self.n)
        out_ids, out_docs, out_md, out_dist, out_sim = [], [], [], [], []
        for keep in rows:
            keep = keep[:top_k]
            out_ids.append([self.ids[i] for _, i in keep])
            out_docs.append([self.documents[i] for _, i in keep])
            out_md.append([self.metadatas[i] for _, i in keep])
            out_sim.append([float(s) for s, _ in keep])
            out_dist.append([1.0 - float(s) for s, _ in keep])
        return {
            "ids": out_ids,
            "documents": out_docs,
            "metadatas": out_md,
            "similarities": out_sim,
            "distances": out_dist,
        }

    # -- persistence (the JAX package's format) ------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez_compressed(
            os.path.join(directory, "index_arrays.npz"),
            codes=self._codes.cpu().numpy(), scales=self._scales.cpu().numpy(),
        )
        meta = {
            "n": self.n,
            "dim": self.dim,
            "format": self.format,
            "pq_rescore": "int8",
            "pq_aniso_eta": 0.0,
            "block_size": self.block_size,
            "ids": self.ids,
            "documents": self.documents,
            "metadatas": self.metadatas,
        }
        with open(os.path.join(directory, "index_meta.json"), "w") as f:
            json.dump(meta, f)
        logger.info("Saved index (%d vectors) to %s", self.n, directory)

    def load(self, directory: str) -> None:
        with open(os.path.join(directory, "index_meta.json")) as f:
            meta = json.load(f)
        _check_format(meta["format"])
        with np.load(os.path.join(directory, "index_arrays.npz")) as arrays:
            codes = arrays["codes"].astype(np.int8)
            scales = arrays["scales"].astype(np.float32)
        self._clear()
        self.n = meta["n"]
        self.dim = meta["dim"]
        self.format = meta["format"]
        self.block_size = meta.get("block_size", self.block_size)
        self.ids = meta["ids"]
        self.documents = meta["documents"]
        self.metadatas = meta["metadatas"]
        self._codes = torch.from_numpy(codes).to(self.device)
        self._scales = torch.from_numpy(scales).to(self.device)
        logger.info("Loaded index (%d vectors, %s) from %s", self.n, self.format, directory)


def _rescore(codes, scales, queries, cand_ids, k, valid_n):
    """fp32 rescore of candidate ids against int8-dequantized vectors;
    candidates at rows >= ``valid_n`` are padding and score -1e30."""
    cand_vecs = codes[cand_ids].float() * scales[cand_ids][..., None]
    exact = torch.bmm(cand_vecs, queries.float()[:, :, None])[..., 0]
    exact = torch.where(cand_ids < valid_n, exact, NEG_INF)
    s, sel = topk_stable(exact, min(k, cand_ids.shape[1]))
    return s, torch.gather(cand_ids, 1, sel)
