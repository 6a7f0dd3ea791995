"""Batched text embedding (port of ``crs_tpu.rag.embedding``).

Three backends behind one ``EmbeddingModel``:

- ``hashed``: word uni/bi-gram feature hashing (``hashed_features``),
  sublinear tf weights, then a fixed Gaussian random projection to ``dim``,
  L2-normalized. The projection is ``default_rng(seed)`` numpy, so it is
  bit-identical to the JAX package's.
- ``lexical`` (``config.json``'s default): word uni/bi-grams + char
  3/4-grams, BM25×IDF weights fitted on the indexed corpus (with the
  bigram-IDF cap), and an LSA projection: the top right-singular vectors of
  the weighted corpus matrix through the Gram trick (G = D·Dᵀ and
  P = Dᵀ·U·Λ^−½ as f32 products on the encoder's device, ``eigh`` of G on
  the host in f64), plus the PPMI query expansion. Its state saves to and
  loads from ``crs_tpu``'s ``lexical_state.npz`` layout.
- ``minilm``: the 6-layer BERT encoder of ``models.minilm`` with length
  bucketing; converted Hugging Face weights and a WordPiece vocab from a
  local directory when one is given, else a deterministic random init and
  the hash tokenizer.

All return L2-normalized float32 tensors [N, dim] on the model's device.
``eigh`` leaves each eigenvector's sign free, so two fits agree in their
doc·query scores and rankings, not in the projection's columns.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.minilm import MiniLMConfig, MiniLMEncoder, load_hf_bert_params
from ..models.tokenizer import HashTokenizer, WordPieceTokenizer

logger = logging.getLogger(__name__)

__all__ = ["EmbeddingModel", "HashedEncoder", "LexicalLSAEncoder"]

# upper bound on the [rows, K, dim] float32 gather of one projection step
_GATHER_MAX_ELEMS = 1 << 25

_BUCKETS = (16, 32, 64, 128, 256, 512)


def _bucket_len(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _csr_to_padded(indices, weights, offsets, rows: int, k: int):
    """Vectorized CSR → padded [rows, k] (idx, w); features beyond k are
    dropped per row, in CSR order."""
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


def _concat_csr_rows(a, b):
    """Row-wise concatenation of two CSR triples over the same rows."""
    ai, aw, ao = a
    bi, bw, bo = b
    lens_a = ao[1:] - ao[:-1]
    lens_b = bo[1:] - bo[:-1]
    out_off = np.zeros(len(ao), np.int64)
    np.cumsum(lens_a + lens_b, out=out_off[1:])
    total = int(out_off[-1])
    idx = np.empty(total, ai.dtype if len(ai) else np.int64)
    w = np.empty(total, np.float32)
    if len(ai):
        dest_a = np.repeat(out_off[:-1], lens_a) + (np.arange(len(ai)) - np.repeat(ao[:-1], lens_a))
        idx[dest_a] = ai
        w[dest_a] = aw
    if len(bi):
        dest_b = (
            np.repeat(out_off[:-1] + lens_a, lens_b)
            + (np.arange(len(bi)) - np.repeat(bo[:-1], lens_b))
        )
        idx[dest_b] = bi
        w[dest_b] = bw
    return idx, w, out_off


def hashed_projection(num_features: int, dim: int, seed: int) -> np.ndarray:
    """The fixed projection, computed exactly as the JAX package does (the
    float32 draws divided by a float64 √dim, then rounded to float32)."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((num_features, dim)).astype(np.float32) / np.sqrt(dim)
    return proj.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _projection_host(num_features: int, dim: int, seed: int) -> torch.Tensor:
    """:func:`hashed_projection` as a CPU tensor, kept for the next encoder
    of its shape: the draw takes ~1 s of host time at 131,072 × 384."""
    return torch.from_numpy(hashed_projection(num_features, dim, seed))


def _projection(num_features: int, dim: int, seed: int, device) -> torch.Tensor:
    """The projection on ``device``, a copy of the kept one: no two
    encoders share its storage."""
    return _projection_host(num_features, dim, seed).to(device, copy=True)


def _project(proj: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """emb[b] = normalize(Σ_k w[b,k] · proj[idx[b,k]]), in row chunks so
    that the [rows, K, dim] gather never exceeds ``_GATHER_MAX_ELEMS``."""
    rows, k = idx.shape
    dim = proj.shape[1]
    out = torch.empty((rows, dim), dtype=torch.float32, device=proj.device)
    step = max(1, _GATHER_MAX_ELEMS // max(k * dim, 1))
    for r0 in range(0, rows, step):
        gathered = proj[idx[r0 : r0 + step]]  # [c, K, dim]
        o = torch.bmm(w[r0 : r0 + step, None, :], gathered)[:, 0]
        norm = torch.linalg.vector_norm(o, dim=-1, keepdim=True)
        out[r0 : r0 + step] = o / torch.clamp_min(norm, 1e-12)
    return out


def _project_csr(proj: torch.Tensor, indices, weights, offsets, buckets) -> torch.Tensor:
    """A CSR batch padded to the smallest nnz bucket that holds its longest
    row (the largest bucket past it: longer rows are cut), then projected."""
    nnz = int(np.max(offsets[1:] - offsets[:-1]))
    k = next((bk for bk in buckets if nnz <= bk), buckets[-1])
    idx, w = _csr_to_padded(indices, weights, offsets, len(offsets) - 1, k)
    return _project(proj, torch.from_numpy(idx).to(proj.device),
                    torch.from_numpy(w).to(proj.device))


class HashedEncoder(nn.Module):
    """Feature-hashing + fixed random projection sentence encoder."""

    _NNZ_BUCKETS = (64, 128, 256, 512, 1024)

    def __init__(self, dim: int = 384, num_features: int = 32768, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.dim = dim
        self.num_features = num_features
        self.device = resolve_device(device)
        self.register_buffer("proj", _projection(num_features, dim, seed, self.device))

    def project(self, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _project(self.proj, idx, w)

    def encode_dev(self, texts: Sequence[str], is_query: bool = False) -> torch.Tensor:
        """Encode texts → [len(texts), dim] float32 on the encoder's device.
        ``is_query`` is the lexical encoder's interface: no query-side
        behaviour here."""
        from .hashed_features import featurize_batch

        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        return _project_csr(self.proj, *featurize_batch(texts, self.num_features),
                            self._NNZ_BUCKETS)


def _check_no_tf32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the LSA fit needs torch.backends.cuda.matmul.allow_tf32 = False")


class LexicalLSAEncoder(nn.Module):
    """Corpus-fitted lexical encoder: BM25×IDF weighting + LSA projection.

    Unfitted, it behaves like :class:`HashedEncoder` (plain tf weights,
    seeded random projection) so cold pipelines still work; :meth:`fit`
    replaces the projection with the top-``dim`` LSA basis of the weighted
    corpus matrix and activates BM25×IDF weighting for all later encodes.
    The projection [num_features, dim] is the buffer ``proj``; the IDF,
    ``avgdl`` and the expansion map live on the host.
    """

    _NNZ_BUCKETS = (64, 128, 256, 512, 1024, 2048)

    def __init__(
        self,
        dim: int = 384,
        num_features: int = 131072,
        seed: int = 0,
        char_ngrams: bool = True,
        bm25_k1: float = 1.2,
        bm25_b: float = 0.75,
        max_fit_docs: int = 2048,
        char_weight: float = 1.0,
        bigram_idf_cap: bool = True,
        expansion_terms: int = 0,
        expansion_weight: float = 0.3,
        expansion_sim_threshold: float = 0.35,
        expansion_dims: int = 128,
        expansion_window: int = 8,
        expansion_vocab: int = 2048,
        section_weight: float = 0.0,
        neighbor_weight: float = 0.0,
        doc_expansion_terms: int = 0,
        doc_expansion_weight: float = 0.15,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.dim = dim
        self.num_features = num_features
        self.seed = seed
        self.char_ngrams = char_ngrams
        self.bm25_k1 = float(bm25_k1)
        self.bm25_b = float(bm25_b)
        self.max_fit_docs = int(max_fit_docs)
        # query expansion: PPMI word vectors of the fit subsample; a query
        # word pulls its top-``expansion_terms`` neighbours (cosine ≥ the
        # threshold) in at ``expansion_weight``·sim·idf. Docs are expanded
        # only by the doc_expansion_* pair.
        self.expansion_terms = int(expansion_terms)
        self.expansion_weight = float(expansion_weight)
        self.expansion_sim_threshold = float(expansion_sim_threshold)
        self.expansion_dims = int(expansion_dims)
        self.expansion_window = int(expansion_window)
        self.expansion_vocab = int(expansion_vocab)
        self._exp_map: Dict[bytes, list] = {}
        # index-side channels, relative to the chunk's own features: its
        # section title, its neighbours' text, and doc-side expansion
        self.section_weight = float(section_weight)
        self.neighbor_weight = float(neighbor_weight)
        self.doc_expansion_terms = int(doc_expansion_terms)
        self.doc_expansion_weight = float(doc_expansion_weight)
        # < 1 down-weights char 3/4-grams against word uni/bigrams once fitted
        self.char_weight = float(char_weight)
        # idf(a|b) ≤ idf(a) + idf(b) for corpus bigrams: stopword pairs stay weak
        self.bigram_idf_cap = bool(bigram_idf_cap)
        self.fitted = False
        self._idf = np.ones(num_features, np.float32)
        self._avgdl = 1.0
        # the last fit's stage seconds and the device of its products
        self.fit_report: Dict[str, Any] = {}
        self.register_buffer("proj", _projection(num_features, dim, seed, self.device))

    def _set_projection(self, proj: np.ndarray) -> None:
        self.proj = torch.as_tensor(np.asarray(proj, np.float32)).to(self.device)

    # -- featurize + weight --------------------------------------------------
    def _doc_totals(self, counts: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        # per-doc token totals (cumsum segment sums handle empty texts)
        csum = np.concatenate([[0.0], np.cumsum(counts, dtype=np.float64)])
        return csum[offsets[1:]] - csum[offsets[:-1]]

    def _bm25_weights(self, indices, counts, offsets, totals) -> np.ndarray:
        lens_per_nz = np.repeat(totals, offsets[1:] - offsets[:-1])
        k1, b = self.bm25_k1, self.bm25_b
        tf = counts.astype(np.float64)
        denom = tf + k1 * (1.0 - b + b * lens_per_nz / max(self._avgdl, 1e-9))
        return (self._idf[indices] * (tf * (k1 + 1.0) / np.maximum(denom, 1e-9))).astype(np.float32)

    def _weighted_csr(self, texts: Sequence[str]):
        from .hashed_features import featurize_batch_counts

        split = self.fitted and self.char_ngrams and self.char_weight != 1.0
        if not split:
            indices, counts, offsets = featurize_batch_counts(
                texts, self.num_features, self.char_ngrams
            )
            if not self.fitted:
                # unfitted fallback: sublinear tf, like HashedEncoder
                weights = (1.0 + np.log(np.maximum(counts, 1.0))).astype(np.float32)
                return indices, weights, offsets
            totals = self._doc_totals(counts, offsets)
            return indices, self._bm25_weights(indices, counts, offsets, totals), offsets

        # split: word uni/bigrams at full weight, char 3/4-grams scaled by
        # char_weight; BM25 length normalization over the combined totals
        wi, wc, wo = featurize_batch_counts(texts, self.num_features, parts="word")
        ci, cc, co = featurize_batch_counts(texts, self.num_features, parts="char")
        totals = self._doc_totals(wc, wo) + self._doc_totals(cc, co)
        w_weights = self._bm25_weights(wi, wc, wo, totals)
        c_weights = self._bm25_weights(ci, cc, co, totals) * self.char_weight
        return _concat_csr_rows((wi, w_weights, wo), (ci, c_weights, co))

    # -- fit ------------------------------------------------------------------
    def fit(self, corpus_texts: Sequence[str]) -> None:
        """Fit IDF + BM25 stats + the LSA projection on the corpus.

        The Gram-trick SVD over a ≤ ``max_fit_docs`` subsample: G = D·Dᵀ on
        the encoder's device (f32), ``eigh`` of G on the host in f64, then
        P = Dᵀ·U·Λ^−½ on the device: the top right-singular vectors of the
        weighted corpus matrix. The matrix D is densified and row-normalized
        on the host (a bucket written twice in a row keeps its last weight,
        as numpy's assignment does) and moved once.
        """
        from .hashed_features import featurize_batch_counts

        texts = [t for t in corpus_texts if t]
        if not texts:
            return
        t0 = time.perf_counter()
        indices, counts, offsets = featurize_batch_counts(
            texts, self.num_features, self.char_ngrams
        )
        n = len(texts)
        # document frequency → BM25 idf
        df = np.zeros(self.num_features, np.float64)
        np.add.at(df, indices, 1.0)  # features are unique per doc in CSR
        self._idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5)).astype(np.float32)
        doc_token_counts = np.add.reduceat(counts, offsets[:-1]) if len(counts) else np.ones(n)
        self._avgdl = float(np.mean(doc_token_counts)) if n else 1.0
        # the fit subsample, shared by the bigram-IDF cap and the LSA basis
        sub = np.linspace(0, n - 1, min(n, self.max_fit_docs)).astype(int)
        sub = np.unique(sub)
        sub_texts = [texts[i] for i in sub]
        t1 = time.perf_counter()
        if self.bigram_idf_cap:
            self._cap_bigram_idf(sub_texts)
        self.fitted = True
        t2 = time.perf_counter()

        # weighted, row-normalized doc matrix on the fit subsample
        w_indices, w_weights, w_offsets = self._weighted_csr(sub_texts)
        s = len(sub)
        dense = np.zeros((s, self.num_features), np.float32)
        for row in range(s):
            lo, hi = int(w_offsets[row]), int(w_offsets[row + 1])
            dense[row, w_indices[lo:hi]] = w_weights[lo:hi]
        norms = np.maximum(np.linalg.norm(dense, axis=1, keepdims=True), 1e-12)
        dense /= norms

        d_dev = torch.from_numpy(dense).to(self.device)
        _check_no_tf32(d_dev)
        gram_dev = d_dev @ d_dev.T
        gram = gram_dev.cpu().numpy()
        vals, vecs = np.linalg.eigh(gram.astype(np.float64))
        order = np.argsort(vals)[::-1][: self.dim]
        vals = np.maximum(vals[order], 1e-10)
        vecs = vecs[:, order]
        u_scaled = torch.from_numpy((vecs / np.sqrt(vals)[None, :]).astype(np.float32))
        proj_dev = d_dev.T @ u_scaled.to(self.device)
        if proj_dev.shape[1] < self.dim:  # rank-deficient tiny corpora: zero-pad
            proj_dev = torch.nn.functional.pad(proj_dev, (0, self.dim - proj_dev.shape[1]))
        self.proj = proj_dev.contiguous()
        del d_dev
        t3 = time.perf_counter()
        if max(self.expansion_terms, self.doc_expansion_terms) > 0:
            self._fit_expansion(sub_texts)
        t4 = time.perf_counter()
        self.fit_report = {
            "docs": n, "basis_docs": s, "device": str(gram_dev.device),
            "projection_device": str(proj_dev.device),
            "seconds": {"featurize_idf": t1 - t0, "bigram_cap": t2 - t1,
                        "gram_eigh_projection": t3 - t2, "expansion": t4 - t3},
        }
        logger.info(
            "LexicalLSAEncoder fitted: %d docs (%d in basis), avgdl=%.1f",
            n, s, self._avgdl,
        )

    def _fit_expansion(self, texts: Sequence[str]) -> None:
        """PPMI + eigendecomposition word vectors → per-word expansion lists.

        Distance-weighted co-occurrence in a ±window over the fit subsample's
        token streams, PPMI, then the top-``expansion_dims`` eigenbasis of
        the symmetric PPMI matrix gives word vectors whose cosine ranks the
        expansion candidates (vocab: count ≥ 3, top ``expansion_vocab``).
        ``eigh`` runs on the host in f64 up to 512 words, in f32 on the
        encoder's device above.
        """
        from collections import Counter

        from .hashed_features import _fnv1a, _tokenize_bytes

        docs = [_tokenize_bytes(t) for t in texts]
        cnt = Counter(w for d in docs for w in d)
        vocab = [w for w, c in cnt.most_common(self.expansion_vocab) if c >= 3]
        v = len(vocab)
        if v < 16:
            return
        w2i = {w: i for i, w in enumerate(vocab)}
        cooc = np.zeros((v, v), np.float32)
        win = self.expansion_window
        for d in docs:
            idxs = [w2i.get(w, -1) for w in d]
            for i, a in enumerate(idxs):
                if a < 0:
                    continue
                for j in range(i + 1, min(i + 1 + win, len(idxs))):
                    b = idxs[j]
                    if b < 0:
                        continue
                    wgt = 1.0 / (j - i)
                    cooc[a, b] += wgt
                    cooc[b, a] += wgt
        total = max(float(cooc.sum()), 1e-9)
        marg = np.maximum(cooc.sum(axis=1), 1e-9)
        ppmi = np.maximum(
            np.log(np.maximum(cooc * total, 1e-12) / np.outer(marg, marg)), 0.0
        ).astype(np.float32)
        if v <= 512:
            vals, vecs = np.linalg.eigh(ppmi.astype(np.float64))
        else:
            dv, dc = torch.linalg.eigh(torch.from_numpy(ppmi).to(self.device))
            vals, vecs = dv.cpu().numpy().astype(np.float64), dc.cpu().numpy().astype(np.float64)
        order = np.argsort(vals)[::-1][: self.expansion_dims]
        emb = vecs[:, order] * np.sqrt(np.maximum(vals[order], 1e-9))[None, :]
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
        sim = (emb @ emb.T).astype(np.float32)
        np.fill_diagonal(sim, -1.0)  # never expand a word to itself
        m = max(self.expansion_terms, self.doc_expansion_terms)
        top = np.argpartition(-sim, min(m, v - 1), axis=1)[:, :m]
        self._exp_map = {}
        f = self.num_features
        for i, w in enumerate(vocab):
            pairs = []
            for j in top[i]:
                s_ij = float(sim[i, j])
                if s_ij < self.expansion_sim_threshold:
                    continue
                pairs.append((_fnv1a(vocab[j]) % f, s_ij))
            if pairs:
                # sim-descending so a per-call terms limit takes the best
                pairs.sort(key=lambda p: -p[1])
                self._exp_map[w] = pairs
        logger.info(
            "Expansion fitted: vocab=%d, %d words with neighbors", v, len(self._exp_map)
        )

    def _expand_csr(self, texts, indices, weights, offsets, terms, weight):
        """Append each row word's top-``terms`` PPMI-neighbour features to its
        CSR row at ``weight``·sim·idf (the map's pair lists are sim-sorted)."""
        from .hashed_features import _tokenize_bytes

        out_i, out_w, out_off = [], [], [0]
        for row, t in enumerate(texts):
            lo, hi = int(offsets[row]), int(offsets[row + 1])
            row_i = list(indices[lo:hi])
            row_w = list(weights[lo:hi])
            present = set(row_i)
            for word in dict.fromkeys(_tokenize_bytes(t)):  # unique, ordered
                for bucket, s_ij in self._exp_map.get(word, ())[:terms]:
                    if bucket in present:
                        continue
                    present.add(bucket)
                    row_i.append(bucket)
                    row_w.append(weight * s_ij * float(self._idf[bucket]))
            out_i.extend(row_i)
            out_w.extend(row_w)
            out_off.append(len(out_i))
        return (
            np.asarray(out_i, indices.dtype),
            np.asarray(out_w, np.float32),
            np.asarray(out_off, offsets.dtype),
        )

    def _cap_bigram_idf(self, texts: Sequence[str]) -> None:
        """idf(a|b) ← min(idf(a|b), idf(a) + idf(b)) for every bigram of the
        texts (query-only bigrams never match, so corpus bigrams suffice)."""
        from .hashed_features import _fnv1a, _tokenize_bytes

        f = self.num_features
        seen = set()
        for t in texts:
            words = _tokenize_bytes(t)
            for a, b in zip(words, words[1:]):
                key = a + b"\x1f" + b
                if key in seen:
                    continue
                seen.add(key)
                bucket = _fnv1a(key) % f
                cap = self._idf[_fnv1a(a) % f] + self._idf[_fnv1a(b) % f]
                if self._idf[bucket] > cap:
                    self._idf[bucket] = cap

    # -- encode ----------------------------------------------------------------
    def encode_dev(
        self,
        texts: Sequence[str],
        pad_to: int = 0,
        is_query: bool = False,
        aux_channels: Optional[Sequence[Tuple[Sequence[str], float]]] = None,
    ) -> torch.Tensor:
        """Encode texts → [len(texts), dim] float32 on the encoder's device.

        ``is_query`` applies the query expansion (documents take the
        doc-side expansion and ``aux_channels`` instead). ``aux_channels``:
        per-row auxiliary texts merged into the row's features at a relative
        weight — (section titles, w), (neighbour context, w); each aligns
        with ``texts`` row for row. ``pad_to`` is ``crs_tpu``'s batch
        padding for its compiles; the padded rows are zeros that it slices
        off, so the port projects the real rows only.
        """
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        indices, weights, offsets = self._weighted_csr(texts)
        if is_query and self._exp_map and self.expansion_terms > 0:
            indices, weights, offsets = self._expand_csr(
                texts, indices, weights, offsets,
                self.expansion_terms, self.expansion_weight,
            )
        if not is_query:
            if self._exp_map and self.doc_expansion_terms > 0:
                indices, weights, offsets = self._expand_csr(
                    texts, indices, weights, offsets,
                    self.doc_expansion_terms, self.doc_expansion_weight,
                )
            for aux_texts, w in aux_channels or ():
                if w <= 0 or not self.fitted:
                    continue
                ai, aw, ao = self._weighted_csr(list(aux_texts))
                indices, weights, offsets = _concat_csr_rows(
                    (indices, weights, offsets),
                    (ai, aw * np.float32(w), ao),
                )
        return _project_csr(self.proj, indices, weights, offsets, self._NNZ_BUCKETS)

    # -- persistence (crs_tpu's lexical_state.npz) --------------------------------
    def save_state(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        extra = {}
        if self._exp_map:
            # flat arrays: word (utf-8 surrogate-escaped), bucket, sim
            words, buckets, sims = [], [], []
            for w, pairs in self._exp_map.items():
                for bucket, s_ij in pairs:
                    words.append(w.decode("utf-8", "surrogateescape"))
                    buckets.append(bucket)
                    sims.append(s_ij)
            extra = {
                "exp_words": np.array(words),
                "exp_buckets": np.asarray(buckets, np.int64),
                "exp_sims": np.asarray(sims, np.float32),
                "exp_weight": np.float32(self.expansion_weight),
                "exp_terms": np.int64(self.expansion_terms),
                "doc_exp_terms": np.int64(self.doc_expansion_terms),
                "doc_exp_weight": np.float32(self.doc_expansion_weight),
            }
        np.savez_compressed(
            os.path.join(directory, "lexical_state.npz"),
            proj=self.proj.cpu().numpy(),
            idf=self._idf,
            avgdl=np.float32(self._avgdl),
            fitted=np.bool_(self.fitted),
            char_ngrams=np.bool_(self.char_ngrams),
            char_weight=np.float32(self.char_weight),
            dim=np.int64(self.dim),
            num_features=np.int64(self.num_features),
            **extra,
        )

    def load_state(self, directory: str) -> bool:
        """Load ``lexical_state.npz`` (also the legacy archive without
        ``char_weight`` and the ``exp_*`` counts); False when absent."""
        path = os.path.join(directory, "lexical_state.npz")
        if not os.path.exists(path):
            return False
        with np.load(path) as data:
            self.dim = int(data["dim"])
            self.num_features = int(data["num_features"])
            self.char_ngrams = bool(data["char_ngrams"])
            if "char_weight" in data:
                self.char_weight = float(data["char_weight"])
            self.fitted = bool(data["fitted"])
            self._idf = data["idf"].astype(np.float32)
            self._avgdl = float(data["avgdl"])
            self._exp_map = {}
            if "exp_words" in data:
                self.expansion_weight = float(data["exp_weight"])
                for word, bucket, s_ij in zip(
                    data["exp_words"], data["exp_buckets"], data["exp_sims"]
                ):
                    key = str(word).encode("utf-8", "surrogateescape")
                    self._exp_map.setdefault(key, []).append((int(bucket), float(s_ij)))
                for pairs in self._exp_map.values():
                    pairs.sort(key=lambda p: -p[1])
                if "exp_terms" in data:
                    self.expansion_terms = int(data["exp_terms"])
                    self.doc_expansion_terms = int(data["doc_exp_terms"])
                    self.doc_expansion_weight = float(data["doc_exp_weight"])
                else:  # legacy archive: the map's existence implied query expansion
                    self.expansion_terms = max(len(p) for p in self._exp_map.values())
            self._set_projection(data["proj"])
        return True


class EmbeddingModel:
    """Config-driven embedding front end: ``hashed``, ``lexical`` or
    ``minilm``, on the card unless ``device="cpu"``."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        config = config or {}
        self.backend = config.get("backend", "minilm")
        self.batch_size = int(config.get("batch_size", 32))
        self.normalize = bool(config.get("normalize", True))
        self.max_length = int(config.get("max_length", 256))
        self.embedding_dim = int(config.get("embedding_dim", 384))
        self.device = resolve_device(device)
        seed = int(config.get("seed", 0))
        weights_path = config.get("weights_path") or os.environ.get("CRS_TPU_MINILM_WEIGHTS")
        self.tokenizer: Any = None
        self.encoder: nn.Module
        if self.backend == "hashed":
            self.encoder = HashedEncoder(dim=self.embedding_dim, seed=seed, device=self.device)
        elif self.backend == "lexical":
            self.encoder = LexicalLSAEncoder(
                dim=self.embedding_dim,
                num_features=int(config.get("num_features", 131072)),
                seed=seed,
                char_ngrams=bool(config.get("char_ngrams", True)),
                bm25_k1=float(config.get("bm25_k1", 1.2)),
                bm25_b=float(config.get("bm25_b", 0.75)),
                max_fit_docs=int(config.get("max_fit_docs", 2048)),
                char_weight=float(config.get("char_weight", 1.0)),
                bigram_idf_cap=bool(config.get("bigram_idf_cap", True)),
                expansion_terms=int(config.get("expansion_terms", 0)),
                expansion_weight=float(config.get("expansion_weight", 0.3)),
                expansion_sim_threshold=float(config.get("expansion_sim_threshold", 0.35)),
                expansion_dims=int(config.get("expansion_dims", 128)),
                expansion_window=int(config.get("expansion_window", 8)),
                expansion_vocab=int(config.get("expansion_vocab", 2048)),
                section_weight=float(config.get("section_weight", 0.0)),
                neighbor_weight=float(config.get("neighbor_weight", 0.0)),
                doc_expansion_terms=int(config.get("doc_expansion_terms", 0)),
                doc_expansion_weight=float(config.get("doc_expansion_weight", 0.15)),
                device=self.device,
            )
        elif self.backend == "minilm":
            cfg = (MiniLMConfig(hidden_size=self.embedding_dim) if self.embedding_dim != 384
                   else MiniLMConfig())
            params = None
            if weights_path and os.path.isdir(weights_path):
                params, self.tokenizer = _load_local_checkpoint(weights_path, cfg)
            if self.tokenizer is None:
                self.tokenizer = HashTokenizer(vocab_size=cfg.vocab_size)
            self.encoder = MiniLMEncoder(cfg, params=params, seed=seed, device=self.device)
        else:
            raise ValueError(f"unknown embedding backend: {self.backend}")
        logger.info("EmbeddingModel backend=%s dim=%d device=%s", self.backend,
                    self.embedding_dim, self.device)

    # -- public API ----------------------------------------------------------
    def embed(self, texts: Union[str, Sequence[str]], is_query: bool = False) -> torch.Tensor:
        """Embed texts → [N, dim] L2-normalized float32 on the model's device:
        hashed / lexical one projection per ≤ 512 texts (``is_query``: the
        lexical query expansion), MiniLM in length-sorted batches."""
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            return torch.zeros((0, self.embedding_dim), dtype=torch.float32, device=self.device)
        if self.backend == "minilm":
            return self._embed_minilm(texts)
        outs = [self.encoder.encode_dev(texts[i : i + 512], is_query=is_query)
                for i in range(0, len(texts), 512)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, 0)

    def embed_chunks(self, chunks: Sequence[Any]) -> torch.Tensor:
        texts = [c.text if hasattr(c, "text") else str(c) for c in chunks]
        enc = self.encoder
        use_aux = self.backend == "lexical" and (enc.section_weight > 0
                                                 or enc.neighbor_weight > 0)
        if not use_aux:
            return self.embed(texts)
        # index-side context channels: section title and adjacent-chunk text,
        # merged into each chunk's features at a reduced weight
        sections = [getattr(c, "section", None) or "" for c in chunks]
        pages = [getattr(c, "page_number", None) for c in chunks]

        def _adjacent(i: int, j: int) -> bool:
            # never stitch unrelated documents: neighbours sit on the same or
            # an adjacent page when pages are known
            pi, pj = pages[i], pages[j]
            return pi is None or pj is None or abs(int(pi) - int(pj)) <= 1

        neighbors = []
        for i in range(len(texts)):
            parts = []
            if i > 0 and _adjacent(i, i - 1):
                parts.append(texts[i - 1])
            if i + 1 < len(texts) and _adjacent(i, i + 1):
                parts.append(texts[i + 1])
            neighbors.append(" ".join(parts))

        outs = []
        for i in range(0, len(texts), 512):
            aux = []
            if enc.section_weight > 0:
                aux.append((sections[i : i + 512], enc.section_weight))
            if enc.neighbor_weight > 0:
                aux.append((neighbors[i : i + 512], enc.neighbor_weight))
            outs.append(enc.encode_dev(texts[i : i + 512], aux_channels=aux))
        return outs[0] if len(outs) == 1 else torch.cat(outs, 0)

    # -- corpus fitting (lexical backend) ------------------------------------
    @property
    def supports_fit(self) -> bool:
        return self.backend == "lexical"

    def fit(self, corpus_texts: Sequence[str]) -> None:
        """Fit corpus statistics (IDF/BM25/LSA basis): lexical backend only,
        a no-op elsewhere so pipelines can call it unconditionally."""
        if self.supports_fit:
            self.encoder.fit(corpus_texts)

    def save_state(self, directory: str) -> None:
        if self.supports_fit:
            self.encoder.save_state(directory)

    def load_state(self, directory: str) -> bool:
        if self.supports_fit:
            return self.encoder.load_state(directory)
        return False

    # -- minilm batching ----------------------------------------------------
    def _embed_minilm(self, texts: Sequence[str]) -> torch.Tensor:
        """Length-sorted batches of ``batch_size`` rows (the last one padded
        with empty rows), each padded to its length bucket, as ``crs_tpu``
        batches them; rows come back in the texts' order."""
        encoded = [self.tokenizer.encode(t, max_length=self.max_length) for t in texts]
        out = torch.zeros((len(texts), self.embedding_dim), dtype=torch.float32,
                          device=self.device)
        order = sorted(range(len(texts)), key=lambda i: len(encoded[i]))
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            blen = _bucket_len(max(len(encoded[i]) for i in idx))
            ids = np.zeros((self.batch_size, blen), np.int64)
            mask = np.zeros((self.batch_size, blen), np.bool_)
            for row, i in enumerate(idx):
                seq = encoded[i][:blen]
                ids[row, : len(seq)] = seq
                mask[row, : len(seq)] = True
            emb = self.encoder.encode_ids(ids, mask)
            out[torch.tensor(idx, device=self.device)] = emb[: len(idx)]
        return out

    def get_stats(self) -> Dict[str, Any]:
        return {"backend": self.backend, "embedding_dim": self.embedding_dim,
                "batch_size": self.batch_size, "normalize": self.normalize}


def _load_local_checkpoint(path: str, cfg: MiniLMConfig):
    """(params, tokenizer) from a local Hugging Face checkpoint directory:
    ``model.safetensors`` or ``pytorch_model.bin``, and ``vocab.txt``."""
    state = None
    st_path = os.path.join(path, "model.safetensors")
    bin_path = os.path.join(path, "pytorch_model.bin")
    try:
        if os.path.exists(st_path):
            from safetensors.numpy import load_file

            state = load_file(st_path)
        elif os.path.exists(bin_path):
            sd = torch.load(bin_path, map_location="cpu", weights_only=True)
            state = {k: v.numpy() for k, v in sd.items()}
    except (OSError, RuntimeError, ValueError, ImportError) as e:
        logger.warning("failed to load checkpoint %s: %s", path, e)
    params = None
    if state is not None:
        try:
            params = load_hf_bert_params(state, cfg)
        except KeyError as e:
            logger.warning(
                "checkpoint at %s does not match the MiniLM config (missing %s); "
                "falling back to deterministic init", path, e,
            )
    tokenizer = None
    vocab_path = os.path.join(path, "vocab.txt")
    if os.path.exists(vocab_path):
        tokenizer = WordPieceTokenizer.from_vocab_file(vocab_path)
    return params, tokenizer
