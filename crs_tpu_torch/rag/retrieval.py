"""Context retrieval: threshold filtering, hybrid rerank, MMR diversity
(port of ``crs_tpu.rag.retrieval``, every store format).

- ``retrieve_batch``: (optional pseudo-relevance feedback) → scan →
  candidate gather on the device, then the host token-overlap rerank
  (0.7·semantic + 0.3·overlap) and a batched MMR;
- ``retrieve_batch_fused`` (what ``retrieve_batch`` takes when the config
  sets ``fused``): scan → hashed-presence rerank → threshold →
  MMR all on the device, one host sync per batch. Its fp32/bf16 and pq
  branches take ``exact_topk`` and the f32 ``residual_pq_adc_topk``, as
  ``crs_tpu``'s do: they reach no scan kernel.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.mmr import mmr_select_batch
from ..ops.pq import residual_pq_adc_topk
from ..ops.quant import int8_topk
from ..ops.topk import NEG_INF, exact_topk, topk_stable
from .embedding import EmbeddingModel
from .hashed_features import _fnv1a
from .index import VectorStore

logger = logging.getLogger(__name__)

__all__ = ["ContextRetriever", "distance_to_similarity"]


def distance_to_similarity(distance: float, metric: str = "cosine") -> float:
    """A distance from an external store as a similarity: cosine (squared
    L2 of unit vectors) → 1 − d²/2; l2 → 1/(1+d); ip → (2 − d)/2."""
    if metric == "cosine":
        return 1.0 - distance * distance / 2.0
    if metric == "l2":
        return 1.0 / (1.0 + distance)
    if metric == "ip":
        return (2.0 - distance) / 2.0
    raise ValueError(f"unknown metric: {metric}")


def _tokenize(text: str) -> set:
    return set(re.findall(r"[a-z0-9]+", text.lower()))


def _sort_desc(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(-x)``: descending, stable among ties."""
    return torch.sort(-x, dim=1, stable=True).indices


class ContextRetriever:
    _PRESENCE_TOKENS = 128  # token ids kept per chunk
    _QUERY_TOKENS = 32  # token ids kept per query
    _TOKEN_SPACE = 1 << 30  # FNV space: collision odds ~1e-6 per doc-query

    def __init__(self, vector_store: VectorStore, embedding_model: EmbeddingModel,
                 config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.store = vector_store
        self.embedder = embedding_model
        self.top_k = int(config.get("top_k", 3))
        self.similarity_threshold = float(config.get("similarity_threshold", 0.3))
        self.rerank = bool(config.get("rerank", True))
        self.diversity_penalty = float(config.get("diversity_penalty", 0.1))
        self.rerank_semantic_weight = float(config.get("rerank_semantic_weight", 0.7))
        self.rerank_fetch_mult = int(config.get("rerank_fetch_mult", 2))
        # pseudo-relevance feedback: q' = normalize(q + β·centroid(top prf_k))
        self.prf_beta = float(config.get("prf_beta", 0.0))
        self.prf_k = int(config.get("prf_k", 3))
        # fused=True: batches take retrieve_batch_fused (hashed-presence rerank)
        self.fused = bool(config.get("fused", False))
        self._doc_tokens: Optional[List[set]] = None
        self._doc_tokens_n = -1
        self._doc_token_ids: Optional[torch.Tensor] = None
        self._presence_n = -1

    # -- single query / batch ------------------------------------------------
    def retrieve(self, query: str, top_k: Optional[int] = None,
                 where: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
        return self.retrieve_batch([query], top_k=top_k, where=where)[0]

    def retrieve_batch(self, queries: Sequence[str], top_k: Optional[int] = None,
                       where: Optional[Dict[str, Any]] = None) -> List[List[Dict[str, Any]]]:
        if self.fused:
            return self.retrieve_batch_fused(queries, top_k, where=where)
        k = top_k or self.top_k
        if self.store.n == 0 or not queries:
            return [[] for _ in queries]
        use_mmr = self.diversity_penalty > 0
        fetch_k = min(
            self.rerank_fetch_mult * k if (self.rerank or use_mmr) else k, self.store.n
        )
        q_emb = self.embedder.embed(list(queries), is_query=True).to(self.store.device)
        if self.prf_beta > 0:
            q_emb = self._prf_requery(q_emb, where)
        if where:
            s_dev, r_dev = self.store._masked_search(q_emb, fetch_k, where)
        else:
            s_dev, r_dev = self.store.search_batch_dev(q_emb, fetch_k)
        cand_vecs = self.store.gather_vectors_dev(r_dev).cpu().numpy() if use_mmr else None
        scores, rows = s_dev.cpu().numpy(), r_dev.cpu().numpy()
        b, f = scores.shape
        if f == 0:
            return [[] for _ in queries]

        valid = (rows >= 0) & (rows < self.store.n) & (scores >= self.similarity_threshold)
        ranked = scores.copy()
        if self.rerank:
            overlaps = self._overlap_matrix(queries, rows)
            w = self.rerank_semantic_weight
            ranked = w * scores + (1.0 - w) * overlaps
        ranked = np.where(valid, ranked, NEG_INF)
        order = np.argsort(-ranked, axis=1)
        scores = np.take_along_axis(scores, order, axis=1)
        rows = np.take_along_axis(rows, order, axis=1)
        ranked = np.take_along_axis(ranked, order, axis=1)
        valid = np.take_along_axis(valid, order, axis=1)

        if use_mmr and f > k and cand_vecs is not None:
            emb = np.take_along_axis(cand_vecs, order[:, :, None], axis=1)
            lam = 1.0 - self.diversity_penalty
            picks = mmr_select_batch(
                torch.from_numpy(emb).to(self.store.device),
                torch.from_numpy(np.asarray(ranked, np.float32)).to(self.store.device), k, lam,
            ).cpu().numpy()
            scores, rows, ranked, valid = _apply_picks(scores, rows, ranked, valid, picks)

        results: List[List[Dict[str, Any]]] = []
        for qi in range(b):
            out = []
            for s, rank_s, r, ok in zip(scores[qi], ranked[qi], rows[qi], valid[qi]):
                if not ok or len(out) >= k:
                    continue
                out.append(self._hit(r, s, rank_s))
            results.append(out)
        return results

    def _prf_requery(self, q_emb: torch.Tensor, where) -> torch.Tensor:
        """Rocchio PRF: blend the centroid of the top-``prf_k`` rows into the
        query embedding (one extra scan + gather, on the device)."""
        k0 = min(max(self.prf_k, 1), max(self.store.n, 1))
        if where:
            _, r0 = self.store._masked_search(q_emb, k0, where)
        else:
            _, r0 = self.store.search_batch_dev(q_emb, k0)
        cent = self.store.gather_vectors_dev(r0).mean(dim=1)  # [B, D]
        q2 = q_emb + self.prf_beta * cent
        return q2 / torch.clamp_min(torch.linalg.vector_norm(q2, dim=-1, keepdim=True), 1e-12)

    def _hit(self, r, s, rank_s) -> Dict[str, Any]:
        return {
            "id": self.store.ids[r],
            "text": self.store.documents[r],
            "metadata": self.store.metadatas[r],
            "score": float(s),
            "rank_score": float(rank_s),
        }

    # -- fused single-sync path ----------------------------------------------
    def _ensure_presence(self) -> None:
        """Per-chunk token ids for the on-device lexical rerank: the host
        rerank's regex tokens, FNV-hashed into a 2³⁰ space, up to 128 sorted
        ids per chunk ([padded rows, 128] int32, -1 sentinel). Each distinct
        word is hashed once (a per-call cache); the ids are the JAX package's."""
        if self._presence_n == self.store.n:
            return
        t = self._PRESENCE_TOKENS
        toks = np.full((self.store._padded_rows(), t), -1, np.int32)
        cache: Dict[str, int] = {}
        for i, doc in enumerate(self.store.documents):
            words = _tokenize(doc)
            ids = []
            for w in words:
                tid = cache.get(w)
                if tid is None:
                    tid = cache[w] = self._token_id(w)
                ids.append(tid)
            ids = sorted(set(ids))[:t]
            toks[i, : len(ids)] = ids
        self._doc_token_ids = torch.from_numpy(toks).to(self.store.device)
        self._presence_n = self.store.n

    @classmethod
    def _token_id(cls, word: str) -> int:
        return _fnv1a(word.encode("utf-8")) % cls._TOKEN_SPACE

    def _query_token_ids(self, queries: Sequence[str]):
        """(ids [B, Q] int32 with sentinel -2, inv_count [B] f32)."""
        q = self._QUERY_TOKENS
        ids = np.full((len(queries), q), -2, np.int32)
        inv = np.zeros((len(queries),), np.float32)
        for qi, query in enumerate(queries):
            words = sorted({self._token_id(w) for w in _tokenize(query)})
            if not words:
                continue
            ids[qi, : min(len(words), q)] = words[:q]
            inv[qi] = 1.0 / len(words)
        return ids, inv

    def retrieve_batch_fused(self, queries: Sequence[str], top_k: Optional[int] = None,
                             where: Optional[Dict[str, Any]] = None
                             ) -> List[List[Dict[str, Any]]]:
        """scan → rerank → threshold → MMR on the device, one host sync.
        ``where`` filters stay on this path as a row mask on the scan."""
        k = top_k or self.top_k
        if self.store.n == 0 or not queries:
            return [[] for _ in queries]
        store = self.store
        if store.format == "pq" and store._rpq is None:  # as crs_tpu: unfused
            fused_flag, self.fused = self.fused, False  # no recursion back here
            try:
                return self.retrieve_batch(queries, top_k, where=where)
            finally:
                self.fused = fused_flag
        if store.format == "pq" and store._codes is None:
            raise ValueError("the fused path rescores pq candidates against the device int8 "
                             "mirror: it needs pq_rescore='int8'")
        dev = store.device
        self._ensure_presence()
        fetch_k = min(
            self.rerank_fetch_mult * k if (self.rerank or self.diversity_penalty > 0) else k,
            store.n,
        )
        q_emb = self.embedder.embed(list(queries), is_query=True).to(dev)
        q_tok_np, q_inv_np = self._query_token_ids(queries)
        q_tok, q_inv = torch.from_numpy(q_tok_np).to(dev), torch.from_numpy(q_inv_np).to(dev)
        if where:
            mask_np, _ = store._row_mask(where)
            row_mask = torch.from_numpy(mask_np).to(dev)
        else:
            row_mask = torch.ones((store._padded_rows(),), dtype=torch.bool, device=dev)
        pq_args = None
        if store.format == "pq":
            # residual-ADC candidates + int8 rescore inside the fused path
            args = (store._codes, store._scales)
            pq_args = (store._rpq, store._pq_coarse_ids, store._pq_codes)
        elif store.format == "int8":
            args = (store._codes, store._scales)
        else:
            args = (store._vectors.float(), None)
        out = _fused_retrieve(
            args[0], args[1], self._doc_token_ids, row_mask, pq_args,
            q_emb, q_tok, q_inv, store.n,
            k=k, fetch_k=fetch_k,
            w=self.rerank_semantic_weight if self.rerank else 1.0,
            threshold=self.similarity_threshold,
            lam=1.0 - self.diversity_penalty,
            use_mmr=self.diversity_penalty > 0 and fetch_k > k,
            rescore_k=max(store.rescore_k, fetch_k),
        )
        sim, rows, ranked, picks_valid = (t.cpu().numpy() for t in out)
        results: List[List[Dict[str, Any]]] = []
        for qi in range(len(queries)):
            hits = []
            for s, rank_s, r, ok in zip(sim[qi], ranked[qi], rows[qi], picks_valid[qi]):
                if not ok or not (0 <= r < store.n) or len(hits) >= k:
                    continue
                hits.append(self._hit(r, s, rank_s))
            results.append(hits)
        return results

    # -- context assembly -----------------------------------------------------
    def get_context_string(self, query: str, top_k: Optional[int] = None,
                           separator: str = "\n\n") -> str:
        return separator.join(c["text"] for c in self.retrieve(query, top_k))

    @staticmethod
    def context_from_results(results: List[Dict[str, Any]], separator: str = "\n\n") -> str:
        return separator.join(c["text"] for c in results)

    def _overlap_matrix(self, queries: Sequence[str], rows: np.ndarray) -> np.ndarray:
        if self._doc_tokens_n != self.store.n:
            self._doc_tokens = [_tokenize(d) for d in self.store.documents]
            self._doc_tokens_n = self.store.n
        out = np.zeros(rows.shape, np.float32)
        for qi, query in enumerate(queries):
            q_tokens = _tokenize(query)
            if not q_tokens:
                continue
            for ci, r in enumerate(rows[qi]):
                if 0 <= r < len(self._doc_tokens):
                    out[qi, ci] = len(q_tokens & self._doc_tokens[r]) / len(q_tokens)
        return out


def _fused_retrieve(vec_or_codes, scales, doc_token_ids, row_mask, pq_args, q_emb, q_tok,
                    q_inv, valid_n, *, k: int, fetch_k: int, w: float, threshold: float,
                    lam: float, use_mmr: bool, rescore_k: int):
    """The post-embedding retrieval on the device: the format's scan (with
    the metadata row mask) → candidate gather → hashed-presence rerank →
    threshold → MMR → final top-k. ``pq_args`` = (rpq, coarse ids, codes)
    switches the scan to residual-ADC candidates + int8 rescore; ``scales``
    None means float vectors (exact top-k)."""
    if pq_args is not None:
        rpq, coarse_ids, pq_codes = pq_args
        _, cand_rows = residual_pq_adc_topk(rpq, coarse_ids, pq_codes, q_emb,
                                            max(rescore_k, fetch_k), valid_n, row_mask=row_mask)
        cand_vecs = vec_or_codes[cand_rows].float() * scales[cand_rows][..., None]
        exact = torch.bmm(cand_vecs, q_emb.float()[:, :, None])[..., 0]
        # filtered rows may sit among the candidates when few rows pass
        exact = torch.where((cand_rows < valid_n) & row_mask[cand_rows], exact, NEG_INF)
        sim, sel = topk_stable(exact, min(fetch_k, exact.shape[1]))
        rows = torch.gather(cand_rows, 1, sel)
        cand = torch.gather(cand_vecs, 1, sel[:, :, None].expand(-1, -1, cand_vecs.shape[2]))
    elif scales is None:
        sim, rows = exact_topk(vec_or_codes, q_emb, fetch_k, valid_n, row_mask=row_mask)
        cand = vec_or_codes[rows].float()
    else:
        sim, rows = int8_topk(vec_or_codes, scales, q_emb, fetch_k, valid_n,
                              rescore_k=rescore_k, row_mask=row_mask)
        cand = vec_or_codes[rows].float() * scales[rows][..., None]

    # overlap(q, d) = |tokens(d) ∩ tokens(q)| / |q|: exact equality count of
    # candidate token ids [B, F, T] against the query's padded ids [B, Q]
    # (sentinels -1 / -2 never match)
    cand_tokens = doc_token_ids[rows]
    matches = cand_tokens[:, :, :, None] == q_tok[:, None, None, :]
    overlap = matches.sum(dim=(2, 3)).float() * q_inv[:, None]
    ranked = w * sim + (1.0 - w) * overlap
    valid = sim >= threshold
    ranked = torch.where(valid, ranked, NEG_INF)
    order = _sort_desc(ranked)
    sim = torch.gather(sim, 1, order)
    rows = torch.gather(rows, 1, order)
    ranked = torch.gather(ranked, 1, order)
    valid = torch.gather(valid, 1, order)
    cand = torch.gather(cand, 1, order[:, :, None].expand(-1, -1, cand.shape[2]))

    if use_mmr:
        picks = mmr_select_batch(cand, ranked, k, lam)  # [B, k] distinct
        return (torch.gather(sim, 1, picks), torch.gather(rows, 1, picks),
                torch.gather(ranked, 1, picks), torch.gather(valid, 1, picks))
    return sim[:, :k], rows[:, :k], ranked[:, :k], valid[:, :k]


def _apply_picks(scores, rows, ranked, valid, picks):
    """Reorder each query's candidates by its (deduped) MMR picks."""
    b, f = scores.shape
    k = picks.shape[1]
    new_s = np.full((b, k), 0.0, scores.dtype)
    new_r = np.full((b, k), -1, rows.dtype)
    new_rank = np.full((b, k), NEG_INF, ranked.dtype)
    new_v = np.zeros((b, k), bool)
    for qi in range(b):
        seen = set()
        j = 0
        for p in picks[qi]:
            p = int(p)
            if p in seen or p >= f:
                continue
            seen.add(p)
            new_s[qi, j] = scores[qi, p]
            new_r[qi, j] = rows[qi, p]
            new_rank[qi, j] = ranked[qi, p]
            new_v[qi, j] = valid[qi, p]
            j += 1
            if j == k:
                break
    return new_s, new_r, new_rank, new_v
