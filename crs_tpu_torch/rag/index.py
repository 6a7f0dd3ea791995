"""Device-resident compressed vector store (port of ``crs_tpu.rag.index``).

The corpus lives on the device, padded to a multiple of ``block_size`` rows,
in one of four formats:

- ``fp32`` / ``bf16`` — exact cosine scan (``ops.scan.scan_topk``, the CUDA
  float scan, on the card above ``4·block_size`` rows);
- ``int8`` — per-row scalar quantization, int8 scan + fp32 rescore;
- ``pq`` — residual (default) or plain product quantization, an ADC scan
  for candidates (``scan_topk_residual_pq_adc`` / ``scan_topk_pq_adc`` on
  the card; with ``pq_sorted``, ``scan_topk_residual_pq_adc_sorted`` over a
  cached copy of the rows sorted by coarse id, whose ids map back through
  the sort permutation) and the ``pq_rescore`` mode's rescore: ``int8`` (an
  int8 mirror on the device), ``host`` (the mirror in host RAM, optionally a
  memmap under ``pq_host_mmap``) or ``none`` (the ADC ranking).

``add`` writes new rows into the padding in place, growing the arrays when
full (``crs_tpu``'s capacities, so the scans see the same geometry); PQ
stores encode them with the existing codebooks and retrain once the corpus
has doubled since the last training.

Off the card, or below the threshold, search takes the route ``crs_tpu``
takes off the TPU (``exact_topk`` / ``blockwise_topk`` / the XLA-style ADC),
so the two packages agree on one state. Persistence uses the JAX package's
on-disk format (``index_meta.json`` + ``index_arrays.npz``), so an index
either package saved loads in the other.

Not ported: the ``mesh`` argument (a store sharded over devices).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.pq import (
    PQCodebook, ResidualPQ, _pq_reconstruct, aniso_eta_from_threshold, pq_adc_topk, pq_encode,
    residual_codes_ext, residual_pq_adc_topk, residual_pq_encode, sort_codes_by_coarse, train_pq,
    train_residual_pq,
)
from ..ops.quant import int8_topk, scalar_quantize
from ..ops.scan import (
    adc_auto_group, plan_sorted_coarse_windows, scan_topk, scan_topk_int8, scan_topk_pq_adc,
    scan_topk_residual_pq_adc, scan_topk_residual_pq_adc_sorted,
)
from ..ops.topk import NEG_INF, blockwise_topk, exact_topk, topk_stable

logger = logging.getLogger(__name__)

__all__ = ["VectorStore", "INDEX_FORMATS"]

INDEX_FORMATS = ("fp32", "bf16", "int8", "pq")
_FLOAT_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class VectorStore:
    """Stateful shell around the on-device index arrays + host metadata."""

    _MMAP_CODES = "mirror_codes.i8"
    _MMAP_SCALES = "mirror_scales.f32"

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        config = config or {}
        self.format = config.get("format", "fp32")
        _check_format(self.format)
        self.device = resolve_device(device)
        self.block_size = int(config.get("block_size", 4096))
        self.persist_directory = config.get("persist_directory")
        self.rescore_k = int(config.get("rescore_k", 64))
        self.pq_residual = bool(config.get("pq_residual", True))
        self.pq_subspaces = int(config.get("pq_subspaces", 12 if self.pq_residual else 48))
        self.pq_clusters = int(config.get("pq_clusters", 256))
        self.pq_iters = int(config.get("pq_iters", 25))
        self.pq_coarse_clusters = config.get("pq_coarse_clusters", "auto")
        self.pq_opq_iters = int(config.get("pq_opq_iters", 4))
        self.pq_aniso_eta = config.get("pq_aniso_eta", 0.0)
        self.pq_rescore = str(config.get("pq_rescore", "int8"))
        if self.pq_rescore not in ("int8", "host", "none"):
            raise ValueError(f"unknown pq_rescore mode: {self.pq_rescore}")
        self.pq_host_mmap = config.get("pq_host_mmap") or None
        # the residual ADC scan over rows sorted by coarse id (a derived cache;
        # saved state keeps insertion order)
        self.pq_sorted = bool(config.get("pq_sorted", False))
        self.seed = int(config.get("seed", 0))
        self.build_seconds: Dict[str, float] = {}
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
        self._vectors: Optional[torch.Tensor] = None  # fp32/bf16 formats
        self._codes: Optional[torch.Tensor] = None  # [padded, D] int8 (int8 / pq mirror)
        self._scales: Optional[torch.Tensor] = None  # [padded] f32
        self._pq_codebook: Optional[PQCodebook] = None
        self._pq_codes: Optional[torch.Tensor] = None  # [padded, M] uint8
        self._rpq: Optional[ResidualPQ] = None
        self._pq_coarse_ids: Optional[torch.Tensor] = None  # [padded] int32
        self._pq_codes_ext: Optional[torch.Tensor] = None  # scan layout cache
        # pq_sorted: (sorted rows, perm, counts per coarse id) and one window
        # plan per group; both caches are cleared at every mutation
        self._pq_sorted_cache: Optional[Tuple[torch.Tensor, torch.Tensor, np.ndarray]] = None
        self._pq_wbase: Dict[int, Optional[torch.Tensor]] = {}
        self._pq_trained_n: Optional[int] = None  # rows at the last PQ training
        self._codes_host: Optional[np.ndarray] = None  # pq_rescore="host" mirror
        self._scales_host: Optional[np.ndarray] = None
        self._md_cols: Dict[str, Tuple[np.ndarray, np.ndarray, int]] = {}

    # -- host rescore mirror (RAM or disk-backed) ---------------------------
    def _mirror_alloc(self, rows: int, cols: int) -> Tuple[np.ndarray, np.ndarray]:
        """A zeroed pq_rescore="host" mirror: RAM, or raw np.memmap files
        under ``pq_host_mmap``."""
        if self.pq_host_mmap:
            os.makedirs(self.pq_host_mmap, exist_ok=True)
            c = np.memmap(os.path.join(self.pq_host_mmap, self._MMAP_CODES), np.int8,
                          mode="w+", shape=(rows, cols))
            s = np.memmap(os.path.join(self.pq_host_mmap, self._MMAP_SCALES), np.float32,
                          mode="w+", shape=(rows,))
            return c, s
        return np.zeros((rows, cols), np.int8), np.zeros((rows,), np.float32)

    def _mirror_set(self, codes: np.ndarray, scales: np.ndarray) -> None:
        """Install a freshly computed mirror."""
        self._codes_host, self._scales_host = self._mirror_alloc(*codes.shape)
        self._codes_host[:] = codes
        self._scales_host[:] = scales

    def _mirror_grow(self, new_rows: int) -> None:
        """Grow the mirror to ``new_rows`` rows (zeros in the tail). RAM:
        concatenate. memmap: copy into new files a million rows at a time,
        then replace the old ones (a memmap cannot resize in place)."""
        old_c, old_s = self._codes_host, self._scales_host
        if old_c.shape[0] >= new_rows:
            return
        cols = old_c.shape[1]
        if not self.pq_host_mmap:
            pad = new_rows - old_c.shape[0]
            self._codes_host = np.concatenate([old_c, np.zeros((pad, cols), np.int8)])
            self._scales_host = np.concatenate([old_s, np.zeros((pad,), np.float32)])
            return
        cpath = os.path.join(self.pq_host_mmap, self._MMAP_CODES)
        spath = os.path.join(self.pq_host_mmap, self._MMAP_SCALES)
        nc = np.memmap(cpath + ".grow", np.int8, mode="w+", shape=(new_rows, cols))
        ns = np.memmap(spath + ".grow", np.float32, mode="w+", shape=(new_rows,))
        step = 1 << 20
        for lo in range(0, old_c.shape[0], step):
            hi = min(lo + step, old_c.shape[0])
            nc[lo:hi] = old_c[lo:hi]
            ns[lo:hi] = old_s[lo:hi]
        nc.flush()
        ns.flush()
        del old_c, old_s, nc, ns  # release the mappings before replacing the files
        self._codes_host = self._scales_host = None
        os.replace(cpath + ".grow", cpath)
        os.replace(spath + ".grow", spath)
        self._codes_host = np.memmap(cpath, np.int8, mode="r+", shape=(new_rows, cols))
        self._scales_host = np.memmap(spath, np.float32, mode="r+", shape=(new_rows,))

    def _aniso_eta(self) -> Optional[float]:
        """pq_aniso_eta config → η for ops/pq.py (None = isotropic)."""
        e = self.pq_aniso_eta
        if e == "auto":
            e = aniso_eta_from_threshold(0.2, max(self.dim, 2))
        else:
            e = float(e)
        return e if e > 1.0 else None

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
        self._build_device_arrays(_pad_rows(emb.to(self.device), self.block_size))
        logger.info("Indexed %d vectors (dim=%d, format=%s)", self.n, self.dim, self.format)
        if self.persist_directory:
            self.save(self.persist_directory)

    def _build_device_arrays(self, padded: torch.Tensor) -> None:
        """``crs_tpu``'s single-device ``_build_device_arrays``; PQ training
        takes a ``torch.Generator`` seeded with ``seed`` and its seconds go
        to ``build_seconds["pq_train"]``."""
        self.build_seconds = {}
        if self.format in _FLOAT_DTYPES:
            self._vectors = padded.to(_FLOAT_DTYPES[self.format])
            return
        if self.format == "int8":
            self._codes, self._scales = scalar_quantize(padded)
            return
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        valid = padded[: self.n] if self.n > 0 else padded
        m = min(self.pq_subspaces, self.dim)  # largest count ≤ configured dividing the dim
        while self.dim % m != 0:
            m -= 1
        eta = self._aniso_eta()
        t0 = time.perf_counter()
        if self.pq_residual:
            coarse = self.pq_coarse_clusters
            if coarse == "auto":
                coarse = min(2048, max(16, self.n // 8))
            self._rpq = train_residual_pq(gen, valid, m, self.pq_clusters, int(coarse),
                                          self.pq_iters, self.pq_opq_iters, aniso_eta=eta)
            self._pq_codebook = self._rpq.codebook
        else:
            dirs = None if eta is None else _directions(valid)
            self._pq_codebook = train_pq(gen, valid, m, self.pq_clusters, self.pq_iters,
                                         dirs=dirs, aniso_eta=eta)
        _sync(self.device)
        self.build_seconds["pq_train"] = time.perf_counter() - t0
        self._pq_coarse_ids, self._pq_codes = self._encode_pq(padded)
        if self.pq_rescore == "int8":
            self._codes, self._scales = scalar_quantize(padded)
        elif self.pq_rescore == "host":
            self._mirror_set(*_host_quantize(padded.cpu().numpy()))
        self._pq_trained_n = self.n  # the drift baseline of add

    def _encode_pq(self, rows: torch.Tensor) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(coarse ids or None, codes) of ``rows`` under the existing codebooks."""
        eta = self._aniso_eta()
        if self._rpq is not None:
            return residual_pq_encode(self._rpq, rows, eta)
        return None, pq_encode(self._pq_codebook, rows, None if eta is None else _directions(rows),
                               eta)

    def _padded_rows(self) -> int:
        for arr in (self._vectors, self._codes, self._pq_codes):
            if arr is not None:
                return arr.shape[0]
        return 0

    def add(self, chunks: Sequence[Any], embeddings: Union[np.ndarray, torch.Tensor]) -> None:
        """Incremental add (``crs_tpu``'s): the new rows, padded to a multiple
        of min(block_size, 128), are written in place at row ``n`` (growing
        the arrays to max(2·capacity, n + block) rows, rounded up to
        ``block_size``, when they do not fit); only the new rows are
        quantized or encoded. A PQ store retrains its codebooks (a rebuild
        from the dense rows) once the corpus has doubled since the last
        training. An empty store delegates to :meth:`create_index`."""
        if self.n == 0:
            self.create_index(chunks, embeddings)
            return
        emb = _as_f32(embeddings).cpu()
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"embeddings must be [M, {self.dim}]")
        for c in chunks:
            if hasattr(c, "text"):
                self.ids.append(c.chunk_id)
                self.documents.append(c.text)
                self.metadatas.append(c.to_metadata())
            else:
                self.ids.append(f"chunk_{len(self.ids)}")
                self.documents.append(str(c))
                self.metadatas.append({})
        new_n = self.n + emb.shape[0]
        trained = self._pq_trained_n if self._pq_trained_n is not None else self.n
        if self.format == "pq" and new_n >= 2 * trained:
            self._rebuild_from_dense(torch.cat([self._dense_vectors()[: self.n],
                                                emb.to(self.device)]))
        else:
            self._append_rows(_pad_rows(emb, min(self.block_size, 128)))
            self.n = new_n
            logger.info("Index grown to %d vectors (in-place append)", self.n)
        if self.persist_directory:
            self.save(self.persist_directory)

    def _append_rows(self, block: torch.Tensor) -> None:
        """Write ``block`` (host f32 rows, zero padding included) at row
        ``n`` of every array, in the store's format."""
        start, end = self.n, self.n + block.shape[0]
        if end > self._padded_rows():
            self._grow(max(2 * self._padded_rows(), end))
        blk = block.to(self.device)
        if self.format in _FLOAT_DTYPES:
            self._vectors[start:end] = blk.to(self._vectors.dtype)
            return
        if self.format == "int8":
            self._codes[start:end], self._scales[start:end] = scalar_quantize(blk)
            return
        cids, codes = self._encode_pq(blk)
        if cids is not None:
            self._pq_coarse_ids[start:end] = cids
        self._pq_codes[start:end] = codes
        self._pq_codes_ext = None  # the scan layouts are stale
        self._pq_sorted_cache = None
        self._pq_wbase = {}
        if self.pq_rescore == "int8":
            self._codes[start:end], self._scales[start:end] = scalar_quantize(blk)
        elif self.pq_rescore == "host":
            # the mirror is sized on its own: it may be shorter than the arrays
            codes_np, scales_np = _host_quantize(block.numpy())
            self._mirror_grow(end)
            self._codes_host[start:end] = codes_np
            self._scales_host[start:end] = scales_np

    def _rebuild_from_dense(self, all_emb: torch.Tensor) -> None:
        n = all_emb.shape[0]
        ids, docs, mds = self.ids, self.documents, self.metadatas
        self._clear()
        self.n, self.dim = n, int(all_emb.shape[1])
        self.ids, self.documents, self.metadatas = ids, docs, mds
        self._build_device_arrays(_pad_rows(all_emb, self.block_size))
        logger.info("Index rebuilt at %d vectors", self.n)

    def _grow(self, new_capacity: int) -> None:
        """Grow every padded array to ``new_capacity`` rows, rounded up to
        ``block_size`` (zeros in the new tail), the host mirror included."""
        cap = -(-new_capacity // self.block_size) * self.block_size
        old = self._padded_rows()
        if cap <= old:
            return
        for name in ("_vectors", "_codes", "_scales", "_pq_codes", "_pq_coarse_ids"):
            arr = getattr(self, name)
            if arr is not None:
                pad = torch.zeros((cap - old,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                                  device=arr.device)
                setattr(self, name, torch.cat([arr, pad], 0))
        if self._codes_host is not None:
            self._mirror_grow(cap)

    def _dense_vectors(self) -> torch.Tensor:
        """Every padded row as f32 on the device (dequantized or decoded)."""
        if self._vectors is not None:
            return self._vectors.float()
        if self._codes is not None:
            return self._codes.float() * self._scales[:, None]
        if self._codes_host is not None:
            return torch.from_numpy(self._codes_host.astype(np.float32)
                                    * self._scales_host[:, None]).to(self.device)
        return self._pq_reconstruct_rows(torch.arange(self._padded_rows(), device=self.device))

    def get_vectors(self, row_ids: Any) -> np.ndarray:
        """Dense f32 embeddings of ``row_ids`` (dequantized or decoded)."""
        rows_np = np.asarray(row_ids, np.int64)
        if self._codes_host is not None and self._vectors is None:
            return self._codes_host[rows_np].astype(np.float32) * \
                self._scales_host[rows_np][..., None]
        rows = torch.from_numpy(rows_np).to(self.device)
        if self._vectors is not None:
            out = self._vectors[rows].float()
        elif self._codes is not None:
            out = self._codes[rows].float() * self._scales[rows][..., None]
        else:
            out = self._pq_reconstruct_rows(rows)
        return out.cpu().numpy()

    # -- management -----------------------------------------------------------
    def delete_collection(self) -> None:
        self._clear()

    def reset(self) -> None:
        self._clear()

    # -- query -------------------------------------------------------------
    def _scan_here(self, rows: int) -> bool:
        """The kernel route: on the card and at ≥ 4·block_size rows (the
        size at which ``crs_tpu`` takes its Pallas kernels on a TPU)."""
        return self.device.type == "cuda" and rows >= 4 * self.block_size

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
        if self.format == "pq" and self.pq_rescore == "host":
            cand_k = min(max(self.rescore_k, k), self.n)
            adc_s, cand = self.search_batch_dev(q, cand_k)
            return self._host_rescore(q, adc_s, cand, k)
        return self.search_batch_dev(q, k)

    def search_batch_dev(self, q: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-level batched search, no host sync. For pq with the
        host/none rescore modes the result is the ADC ranking."""
        k = min(top_k, self.n)
        if self.format in _FLOAT_DTYPES:
            if self._scan_here(self._vectors.shape[0]):
                return scan_topk(self._vectors, q, k, self.n, self.block_size)
            if self._vectors.shape[0] > 65536:
                return blockwise_topk(self._vectors, q, k, self.n)
            return exact_topk(self._vectors, q, k, self.n)
        if self.format == "int8":
            if self._scan_here(self._codes.shape[0]):
                cand_k = min(max(self.rescore_k, k), self.n)
                _, cand = scan_topk_int8(self._codes, self._scales, q, cand_k, self.n,
                                         self.block_size)
                return _rescore(self._codes, self._scales, q, cand, k, self.n)
            return int8_topk(self._codes, self._scales, q, k, self.n,
                             rescore_k=max(self.rescore_k, k))
        if self.pq_rescore == "int8":
            cand_k = min(max(self.rescore_k, k), self.n)
            _, cand = self._pq_adc_candidates(q, cand_k)
            return _rescore(self._codes, self._scales, q, cand, k, self.n)
        return self._pq_adc_candidates(q, k)

    def _pq_adc_candidates(self, q: torch.Tensor, cand_k: int,
                           row_mask: Optional[torch.Tensor] = None):
        """ADC scan over the compressed codes → (scores, ids) of the top
        ``cand_k`` rows, through the ADC kernels on the route of
        :meth:`_scan_here` (residual: also C % 256 == 0 and C ≤ 65536)."""
        rows = self._pq_codes.shape[0]
        if self._rpq is not None:
            num_coarse = self._rpq.coarse.shape[0]
            if self._scan_here(rows) and num_coarse % 256 == 0 and num_coarse <= 65536:
                if self.pq_sorted:
                    res = self._sorted_adc_candidates(q, cand_k, row_mask)
                    if res is not None:
                        return res  # None: the planner refused, take the unsorted scan
                return scan_topk_residual_pq_adc(
                    self._rpq.rotation, self._rpq.coarse, self._rpq.codebook.centroids,
                    self._residual_ext(), q, cand_k, self.n, self.block_size, row_mask=row_mask)
            return residual_pq_adc_topk(self._rpq, self._pq_coarse_ids, self._pq_codes, q,
                                        cand_k, self.n, row_mask=row_mask)
        if self._scan_here(rows):
            return scan_topk_pq_adc(self._pq_codebook.centroids, self._pq_codes, q, cand_k,
                                    self.n, self.block_size, row_mask=row_mask)
        return pq_adc_topk(self._pq_codebook, self._pq_codes, q, cand_k, self.n,
                           row_mask=row_mask)

    def _sorted_adc_candidates(self, q: torch.Tensor, cand_k: int,
                               row_mask: Optional[torch.Tensor]):
        """pq_sorted: the residual ADC scan over the rows sorted by coarse id
        (kernel 4), ids mapped back to insertion order; None when the window
        planner refuses this corpus and geometry. The geometry is
        ``crs_tpu``'s: the group from ``n`` and its query block, the sorted
        scan padding the n sorted rows itself. The repair budget is the
        layout's (``layout_budget``), where ``crs_tpu`` keeps 256 pairs and
        falls back to the dense f32 ADC: the candidates then differ only
        where scores lie within the bf16 LUT's rounding, and the rescored
        search is the same."""
        if self._pq_sorted_cache is None:
            ext = self._residual_ext()[: self.n]
            sorted_ext, perm, counts = sort_codes_by_coarse(ext, int(self._rpq.coarse.shape[0]))
            self._pq_sorted_cache = (torch.from_numpy(sorted_ext).to(self.device),
                                     torch.from_numpy(perm).long().to(self.device), counts)
            self._pq_wbase = {}
        ext_s, perm, counts = self._pq_sorted_cache
        group = adc_auto_group(self.n, q.shape[0], self.block_size, ext_s.shape[1])
        if group not in self._pq_wbase:
            plan = plan_sorted_coarse_windows(counts, self.n, self.block_size, group)
            self._pq_wbase[group] = None if plan is None else torch.from_numpy(plan).to(
                self.device)
        wbase = self._pq_wbase[group]
        if wbase is None:
            return None
        mask_s = None if row_mask is None else row_mask[: self.n][perm]
        s, i = scan_topk_residual_pq_adc_sorted(
            self._rpq.rotation, self._rpq.coarse, self._rpq.codebook.centroids, ext_s, wbase,
            q, cand_k, self.n, self.block_size, row_mask=mask_s, group=group, layout_budget=True)
        return s, torch.where(i >= 0, perm[i.clamp_min(0)], -1)

    def _residual_ext(self) -> torch.Tensor:
        """Cached [padded, M+2] uint8 rows of the residual ADC scan (coarse
        id hi/lo bytes + residual codes); cleared by every rebuild/load."""
        if self._pq_codes_ext is None:
            self._pq_codes_ext = residual_codes_ext(self._pq_coarse_ids, self._pq_codes)
        return self._pq_codes_ext

    def _host_rescore(self, q: torch.Tensor, adc_s, cand, top_k: int):
        """pq_rescore="host": rescore the ADC candidates against the host
        int8 mirror (numpy, as ``crs_tpu`` does it); masked/padded candidates
        keep their -1e30 ADC score. Returns tensors on the store's device."""
        cand = cand.cpu().numpy()
        adc_s = adc_s.cpu().numpy()
        q_np = q.cpu().numpy().astype(np.float32)
        rows = np.clip(cand, 0, max(self.n - 1, 0))
        vecs = self._codes_host[rows].astype(np.float32) * self._scales_host[rows][..., None]
        exact = np.einsum("bd,bcd->bc", q_np, vecs)
        exact = np.where(adc_s <= -1e29, -1e30, exact)
        k_eff = min(top_k, exact.shape[1])
        sel = np.argpartition(-exact, k_eff - 1, axis=1)[:, :k_eff]
        part = np.take_along_axis(exact, sel, axis=1)
        sel = np.take_along_axis(sel, np.argsort(-part, axis=1), axis=1)
        s = np.take_along_axis(exact, sel, axis=1).astype(np.float32)
        i = np.take_along_axis(cand, sel, axis=1).astype(np.int64)
        return torch.from_numpy(s).to(self.device), torch.from_numpy(i).to(self.device)

    def gather_vectors_dev(self, rows: torch.Tensor) -> torch.Tensor:
        """Device-level dense-row gather (for MMR and PRF), no host sync."""
        rows = torch.clamp_min(rows, 0)
        if self._vectors is not None:
            return self._vectors[rows].float()
        if self._codes is not None:
            return self._codes[rows].float() * self._scales[rows][..., None]
        return self._pq_reconstruct_rows(rows)

    def _pq_reconstruct_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """PQ codes of ``rows`` decoded back to f32 (the stand-in for the
        dense gather when the pq store keeps no device mirror)."""
        rec = _pq_reconstruct(self._pq_codebook, self._pq_codes[rows])
        if self._rpq is not None:  # rotated space: add coarse, rotate back
            rec = rec + self._rpq.coarse[self._pq_coarse_ids[rows].long()]
            rec = rec @ self._rpq.rotation.T
        return rec

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
        """Metadata-filtered search in the index's own format (codes are
        never densified): the mask reaches the scan as its row mask — in the
        kernels, their bias row."""
        mask_np, n_allowed = self._row_mask(where)
        k_eff = min(k, max(n_allowed, 1))
        mask = torch.from_numpy(mask_np).to(self.device)
        cand_k = min(max(self.rescore_k, k_eff), self.n)
        if self.format in _FLOAT_DTYPES:
            return exact_topk(self._vectors, q, k_eff, self.n, row_mask=mask)
        if self.format == "pq" and self.pq_rescore != "int8":
            pq_host = self.pq_rescore == "host"
            adc_s, cand = self._pq_adc_candidates(q, cand_k if pq_host else k_eff, row_mask=mask)
            if pq_host:
                return self._host_rescore(q, adc_s, cand, k_eff)
            return adc_s, cand
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

    def get_stats(self) -> Dict[str, Any]:
        stats = {"num_vectors": self.n, "embedding_dim": self.dim, "format": self.format,
                 "memory_bytes": self.memory_bytes()}
        if self._codes_host is not None:  # pq_rescore="host": the mirror in host RAM
            stats["host_mirror_bytes"] = int(self._codes_host.nbytes + self._scales_host.nbytes)
            stats["host_mirror_mmap"] = bool(isinstance(self._codes_host, np.memmap))
        return stats

    def memory_bytes(self) -> int:
        """Device bytes of the index: vectors or codes, scales, PQ codes and
        coarse ids, codebooks, rotation and coarse centroids."""
        arrays = [self._vectors, self._codes, self._scales, self._pq_codes, self._pq_coarse_ids]
        if self._pq_codebook is not None:
            arrays.append(self._pq_codebook.centroids)
        if self._rpq is not None:
            arrays += [self._rpq.rotation, self._rpq.coarse]
        return sum(a.numel() * a.element_size() for a in arrays if a is not None)

    # -- persistence (the JAX package's format) ------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        for name in ("_vectors", "_codes", "_scales", "_pq_codes", "_pq_coarse_ids"):
            arr = getattr(self, name)
            if arr is not None:
                arrays[name.lstrip("_")] = (arr.float() if arr.dtype == torch.bfloat16
                                            else arr).cpu().numpy()
        if self._pq_codebook is not None:
            arrays["pq_centroids"] = self._pq_codebook.centroids.cpu().numpy()
        if self._rpq is not None:
            arrays["pq_rotation"] = self._rpq.rotation.cpu().numpy()
            arrays["pq_coarse"] = self._rpq.coarse.cpu().numpy()
        mmap_meta = None
        if self._codes_host is not None:
            if self.pq_host_mmap:
                self._codes_host.flush()
                self._scales_host.flush()
                mmap_meta = {"dir": os.path.abspath(self.pq_host_mmap),
                             "rows": int(self._codes_host.shape[0]),
                             "cols": int(self._codes_host.shape[1])}
            else:
                arrays["codes_host"] = self._codes_host
                arrays["scales_host"] = self._scales_host
        np.savez_compressed(os.path.join(directory, "index_arrays.npz"), **arrays)
        meta = {
            "n": self.n,
            "dim": self.dim,
            "format": self.format,
            "pq_rescore": self.pq_rescore,
            "pq_aniso_eta": self.pq_aniso_eta,
            "block_size": self.block_size,
            "ids": self.ids,
            "documents": self.documents,
            "metadatas": self.metadatas,
        }
        if mmap_meta:
            meta["host_mirror_mmap"] = mmap_meta
        with open(os.path.join(directory, "index_meta.json"), "w") as f:
            json.dump(meta, f)
        logger.info("Saved index (%d vectors) to %s", self.n, directory)

    def load(self, directory: str) -> None:
        with open(os.path.join(directory, "index_meta.json")) as f:
            meta = json.load(f)
        _check_format(meta["format"])
        dev = self.device

        def tensor(a: np.ndarray, dtype=None) -> torch.Tensor:
            t = torch.from_numpy(np.array(a))  # a writable copy
            return (t if dtype is None else t.to(dtype)).to(dev)

        with np.load(os.path.join(directory, "index_arrays.npz")) as arrays:
            self._clear()
            self.n = meta["n"]
            self.dim = meta["dim"]
            self.format = meta["format"]
            self.pq_rescore = meta.get("pq_rescore", self.pq_rescore)
            self.pq_aniso_eta = meta.get("pq_aniso_eta", self.pq_aniso_eta)
            self.block_size = meta.get("block_size", self.block_size)
            self.ids = meta["ids"]
            self.documents = meta["documents"]
            self.metadatas = meta["metadatas"]
            if "codes_host" in arrays:
                self._codes_host = arrays["codes_host"].astype(np.int8)
                self._scales_host = arrays["scales_host"].astype(np.float32)
            elif meta.get("host_mirror_mmap"):
                mm = meta["host_mirror_mmap"]
                self.pq_host_mmap = mm["dir"]
                self._codes_host = np.memmap(os.path.join(mm["dir"], self._MMAP_CODES), np.int8,
                                             mode="r+", shape=(mm["rows"], mm["cols"]))
                self._scales_host = np.memmap(os.path.join(mm["dir"], self._MMAP_SCALES),
                                              np.float32, mode="r+", shape=(mm["rows"],))
            if "vectors" in arrays:
                self._vectors = tensor(arrays["vectors"], _FLOAT_DTYPES.get(self.format,
                                                                             torch.float32))
            if "codes" in arrays:
                self._codes = tensor(arrays["codes"], torch.int8)
                self._scales = tensor(arrays["scales"], torch.float32)
            if "pq_codes" in arrays:
                self._pq_codes = tensor(arrays["pq_codes"])  # stored dtype (uint8)
                self._pq_codebook = PQCodebook(tensor(arrays["pq_centroids"], torch.float32))
            if "pq_rotation" in arrays:
                self._rpq = ResidualPQ(rotation=tensor(arrays["pq_rotation"], torch.float32),
                                       coarse=tensor(arrays["pq_coarse"], torch.float32),
                                       codebook=self._pq_codebook)
                self._pq_coarse_ids = tensor(arrays["pq_coarse_ids"], torch.int32)
            self._pq_trained_n = self.n
        logger.info("Loaded index (%d vectors, %s) from %s", self.n, self.format, directory)


def _directions(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit norm (the anisotropic loss's directions)."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-12)


def _host_quantize(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The pq_rescore="host" mirror's int8 rows, in numpy as ``crs_tpu``
    builds them (a true division by 127, not the reciprocal product)."""
    arr = arr.astype(np.float32)
    s_np = np.maximum(np.max(np.abs(arr), axis=-1), 1e-12) / 127.0
    codes = np.clip(np.round(arr / s_np[:, None]), -127, 127).astype(np.int8)
    return codes, s_np.astype(np.float32)


def _rescore(codes, scales, queries, cand_ids, k, valid_n):
    """fp32 rescore of candidate ids against int8-dequantized vectors;
    candidates at rows >= ``valid_n`` are padding and score -1e30."""
    cand_vecs = codes[cand_ids].float() * scales[cand_ids][..., None]
    exact = torch.bmm(cand_vecs, queries.float()[:, :, None])[..., 0]
    exact = torch.where(cand_ids < valid_n, exact, NEG_INF)
    s, sel = topk_stable(exact, min(k, cand_ids.shape[1]))
    return s, torch.gather(cand_ids, 1, sel)
