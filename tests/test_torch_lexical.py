"""The port's lexical LSA encoder against ``crs_tpu``'s, on the CPU.

Corpora are made from a seed with numpy (synthetic words with topic
structure, one chunk long enough to pass the 2,048-feature bucket), at
``num_features`` ≤ 8,192. Each result goes through ``crs_tpu``'s
``LexicalLSAEncoder`` / ``EmbeddingModel`` and the port's.

Tolerances:
- fit statistics (IDF after the bigram cap, ``avgdl``): bit for bit (the
  same host numpy);
- doc·query scores within 1e-5 with equal top-k ids: the two fits share
  the Gram's host f64 ``eigh`` only up to the f32 Gram (torch's product
  against XLA's) and each eigenvector's sign, which the scores do not see,
  and they project in another f32 sum order;
- the expansion map equal at a vocabulary ≤ 512 (host f64 ``eigh`` on the
  same PPMI); above 512 (f32 ``eigh``, torch's against XLA's) equal except
  for pairs within 1e-4 of the threshold or of the last kept neighbour;
- a state loaded from the other package: embeddings within 1e-5 (the same
  projection, another f32 sum order).
"""

import json
import shutil
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

SCORE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _words(rng, n):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, rng.integers(3, 10))) for _ in range(n)]


def _corpus(seed, n_docs=150, vocab=600, topics=12, long_doc=True):
    """Topic-structured synthetic chunks (Zipf word draws within a topic's
    words plus shared function words), and short queries from the same
    topics. One chunk of 700 distinct words passes 2,048 features."""
    rng = np.random.default_rng(seed)
    words = _words(rng, vocab)
    common = ["the", "of", "and", "to", "in", "is", "for", "with", "on", "by"]
    per_topic = np.array_split(rng.permutation(vocab), topics)
    zipf = 1.0 / np.arange(1, 200)
    docs = []
    for i in range(n_docs):
        t = per_topic[i % topics]
        p = zipf[: len(t)] / zipf[: len(t)].sum()
        n = int(rng.integers(20, 70))
        body = [words[j] for j in rng.choice(t, n, p=p)]
        for pos in rng.integers(0, n, n // 3):
            body.insert(int(pos), common[int(rng.integers(len(common)))])
        docs.append(" ".join(body).capitalize() + ".")
    if long_doc:
        docs[7] = " ".join(words[:700])
    queries = []
    for i in range(12):
        t = per_topic[i % topics]
        queries.append("what is " + " ".join(words[j] for j in rng.choice(t[:15], 3)) + "?")
    queries.append("the and of")  # function words only
    return docs, queries


def _pair(cfg_over=None, dim=64, features=8192):
    """The two packages' EmbeddingModels on one lexical config."""
    from crs_tpu.rag.embedding import EmbeddingModel as JModel
    from crs_tpu_torch.rag.embedding import EmbeddingModel

    cfg = {"backend": "lexical", "embedding_dim": dim, "num_features": features,
           "max_fit_docs": 100, "bm25_k1": 0.6}
    cfg.update(cfg_over or {})
    return JModel(cfg), EmbeddingModel(cfg, device="cpu")


def _scores(doc, q):
    return np.asarray(doc, np.float64) @ np.asarray(q, np.float64).T


def _assert_scores_and_topk(got_doc, got_q, ref_doc, ref_q, k=5):
    got, ref = _scores(got_doc, got_q), _scores(ref_doc, ref_q)
    assert np.abs(got - ref).max() <= SCORE_TOL, np.abs(got - ref).max()
    for qi in range(ref.shape[1]):
        order = np.argsort(-ref[:, qi], kind="stable")
        gaps = -np.diff(ref[order, qi])
        # ranks separated from the next by more than the score tolerance
        close = gaps[:k] <= 2 * SCORE_TOL
        sure = int(np.argmax(close)) if close.any() else k
        got_order = np.argsort(-got[:, qi], kind="stable")
        np.testing.assert_array_equal(got_order[:sure], order[:sure])


FIT_CASES = {
    "config_json": {"expansion_terms": 4, "expansion_weight": 0.3},
    "char_weight_split": {"char_weight": 0.5, "bm25_b": 0.6},
    "no_char_ngrams": {"char_ngrams": False, "bigram_idf_cap": False},
    "doc_expansion": {"doc_expansion_terms": 2, "expansion_terms": 3},
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_statistics_equal_bit_for_bit(case):
    docs, _ = _corpus(1)
    jm, tm = _pair(FIT_CASES[case])
    jm.fit(docs)
    tm.fit(docs)
    jenc, tenc = jm._hashed, tm.encoder
    assert tenc.fitted and jenc.fitted
    np.testing.assert_array_equal(tenc._idf, jenc._idf)
    assert tenc._avgdl == jenc._avgdl
    assert tenc.fit_report["device"] == "cpu" and tenc.fit_report["docs"] == len(docs)
    if FIT_CASES[case].get("bigram_idf_cap", True):
        # the cap moved some bigram's IDF below its raw document-frequency value
        from crs_tpu_torch.rag.hashed_features import featurize_batch_counts

        idx, _, _ = featurize_batch_counts(docs, 8192, tenc.char_ngrams)
        df = np.bincount(idx, minlength=8192).astype(np.float64)
        raw = np.log(1.0 + (len(docs) - df + 0.5) / (df + 0.5)).astype(np.float32)
        assert (tenc._idf < raw).any()


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_doc_query_scores_and_topk_match(case):
    docs, queries = _corpus(2)
    jm, tm = _pair(FIT_CASES[case])
    jm.fit(docs)
    tm.fit(docs)
    ref_doc, ref_q = jm.embed(docs), jm.embed(queries, is_query=True)
    got_doc, got_q = tm.embed(docs), tm.embed(queries, is_query=True)
    assert got_doc.shape == ref_doc.shape and got_doc.dtype == torch.float32
    _assert_scores_and_topk(got_doc.numpy(), got_q.numpy(), ref_doc, ref_q)
    # query expansion changes the query side only where a map exists
    plain = tm.embed(queries)
    assert torch.equal(plain, got_q) == (not tm.encoder._exp_map
                                         or tm.encoder.expansion_terms == 0)


def test_unfitted_encoder_matches():
    """Before a fit: sublinear tf weights on the seeded random projection,
    bit-identical to ``crs_tpu``'s."""
    docs, queries = _corpus(3, n_docs=20)
    jm, tm = _pair()
    np.testing.assert_array_equal(tm.encoder.proj.numpy(), np.asarray(jm._hashed._proj))
    np.testing.assert_allclose(tm.embed(queries).numpy(), jm.embed(queries), atol=SCORE_TOL)
    np.testing.assert_allclose(tm.embed(docs).numpy(), jm.embed(docs), atol=SCORE_TOL)


def _exp_pairs(enc):
    return {w: sorted(p) for w, p in enc._exp_map.items()}


def test_expansion_map_equal_at_small_vocab():
    docs, _ = _corpus(4, vocab=300)
    jm, tm = _pair({"expansion_terms": 4, "expansion_vocab": 512})
    jm.fit(docs)
    tm.fit(docs)
    ref, got = _exp_pairs(jm._hashed), _exp_pairs(tm.encoder)
    assert 16 <= len(ref) and got == ref


def test_expansion_map_above_512_words():
    """f32 ``eigh`` on each package's device (torch's LAPACK call against
    XLA's): the same neighbours, up to pairs within 1e-4 of the threshold or
    of the last neighbour a word keeps."""
    docs, _ = _corpus(5, n_docs=400, vocab=900)
    over = {"expansion_terms": 4, "expansion_vocab": 2048, "max_fit_docs": 400}
    jm, tm = _pair(over)
    jm.fit(docs)
    tm.fit(docs)
    jenc, tenc = jm._hashed, tm.encoder
    from crs_tpu_torch.rag.hashed_features import _tokenize_bytes

    cnt = Counter(w for d in docs for w in _tokenize_bytes(d))
    assert sum(c >= 3 for c in cnt.values()) > 512  # the f32 route
    thr, m = tenc.expansion_sim_threshold, tenc.expansion_terms
    near = 1e-4
    differing = 0
    for w in set(jenc._exp_map) | set(tenc._exp_map):
        ref = dict(jenc._exp_map.get(w, []))
        got = dict(tenc._exp_map.get(w, []))
        for b in set(ref) & set(got):
            assert abs(ref[b] - got[b]) <= near
        for mine, other in ((ref, got), (got, ref)):
            for b in set(mine) - set(other):
                differing += 1
                s = mine[b]
                last = min(other.values()) if len(other) == m else None
                assert abs(s - thr) <= near or (last is not None and abs(s - last) <= near), \
                    (w, b, s, other)
    assert differing <= len(jenc._exp_map) // 10
    assert len(tenc._exp_map) >= 16


def _chunks(docs):
    from crs_tpu_torch.rag.chunking import Chunk

    out = []
    for i, d in enumerate(docs):
        page = i // 4 + (3 if i >= 20 else 0)  # a jump of pages: no neighbour across it
        out.append(Chunk(text=d, chunk_id=f"c{i}", start_char=0, end_char=len(d),
                         page_number=page, section=f"Section {i // 6}" if i % 5 else None))
    return out


def test_embed_chunks_with_section_and_neighbor_channels():
    docs, queries = _corpus(6, n_docs=40)
    over = {"section_weight": 0.3, "neighbor_weight": 0.2, "expansion_terms": 2}
    jm, tm = _pair(over)
    jm.fit(docs)
    tm.fit(docs)
    chunks = _chunks(docs)
    ref = jm.embed_chunks(chunks)
    got = tm.embed_chunks(chunks)
    np.testing.assert_allclose(got.numpy(), ref, atol=SCORE_TOL)
    # the channels change the chunks' vectors
    assert not torch.allclose(got, tm.embed(docs), atol=1e-3)
    _assert_scores_and_topk(got.numpy(), tm.embed(queries, is_query=True).numpy(), ref,
                            jm.embed(queries, is_query=True))


@pytest.mark.parametrize("fitted_by", ["crs_tpu", "port"])
def test_state_round_trip_across_packages(tmp_path, fitted_by):
    docs, queries = _corpus(7)
    over = {"expansion_terms": 3, "char_weight": 0.7}
    jm, tm = _pair(over)
    src, dst = (jm, tm) if fitted_by == "crs_tpu" else (tm, jm)
    src.fit(docs)
    src.save_state(str(tmp_path))
    assert dst.load_state(str(tmp_path))
    jenc, tenc = jm._hashed, tm.encoder
    np.testing.assert_array_equal(tenc.proj.numpy(), np.asarray(jenc._proj))
    np.testing.assert_array_equal(tenc._idf, jenc._idf)
    # the archive keeps weights in float32: the side that fitted holds the config's float
    assert (tenc._avgdl, tenc.fitted, np.float32(tenc.char_weight), tenc.expansion_terms) == \
        (jenc._avgdl, jenc.fitted, np.float32(jenc.char_weight), jenc.expansion_terms)
    assert tenc._exp_map == jenc._exp_map and tenc._exp_map
    np.testing.assert_allclose(tm.embed(queries, is_query=True).numpy(),
                               jm.embed(queries, is_query=True), atol=SCORE_TOL)
    np.testing.assert_allclose(tm.embed(docs).numpy(), jm.embed(docs), atol=SCORE_TOL)


def test_legacy_archive_loads_in_both(tmp_path):
    """An archive without ``char_weight`` and without the ``exp_*`` counts
    (the map's presence implied query expansion): both packages restore the
    same encoder."""
    docs, queries = _corpus(8)
    jm, tm = _pair({"expansion_terms": 3, "char_weight": 0.5})
    jm.fit(docs)
    jm.save_state(str(tmp_path / "full"))
    with np.load(tmp_path / "full" / "lexical_state.npz") as data:
        legacy = {k: data[k] for k in data.files
                  if k not in ("char_weight", "exp_terms", "doc_exp_terms", "doc_exp_weight")}
    (tmp_path / "legacy").mkdir()
    np.savez_compressed(tmp_path / "legacy" / "lexical_state.npz", **legacy)
    jl, tl = _pair()
    assert jl.load_state(str(tmp_path / "legacy")) and tl.load_state(str(tmp_path / "legacy"))
    jenc, tenc = jl._hashed, tl.encoder
    assert tenc.char_weight == jenc.char_weight == 1.0
    assert tenc.expansion_terms == jenc.expansion_terms == 3
    np.testing.assert_allclose(tl.embed(queries, is_query=True).numpy(),
                               jl.embed(queries, is_query=True), atol=SCORE_TOL)


VDB_QUERIES = ["What is GPTQ?", "How does pruning work?", "knowledge distillation",
               "What is the KV cache?", "Explain low-rank factorization",
               "Which methods quantize activations?", "compression of large language models"]


def test_vector_db_state_loads_in_both():
    """The repository's ``vector_db/lexical_state.npz`` (a legacy archive:
    32,768 features, 384 dims) gives the same query embeddings in both."""
    from crs_tpu.rag.embedding import EmbeddingModel as JModel
    from crs_tpu_torch.rag.embedding import EmbeddingModel

    cfg = json.loads((REPO / "config.json").read_text())["rag"]["embedding"]
    jm, tm = JModel(cfg), EmbeddingModel(cfg, device="cpu")
    assert jm.load_state(str(REPO / "vector_db")) and tm.load_state(str(REPO / "vector_db"))
    assert tm.encoder.num_features == 32768 and tm.encoder.proj.shape == (32768, 384)
    np.testing.assert_allclose(tm.embed(VDB_QUERIES, is_query=True).numpy(),
                               jm.embed(VDB_QUERIES, is_query=True), atol=SCORE_TOL)


def test_vector_db_retrieval_ids_match(tmp_path):
    """``config.json``'s retrieve path on a copy of ``vector_db/``: the
    port's ``ContextRetriever`` returns ``crs_tpu``'s chunks."""
    from crs_tpu.rag.pipeline import RAGPipeline as JPipeline
    from crs_tpu_torch.rag.pipeline import RAGPipeline

    shutil.copytree(REPO / "vector_db", tmp_path / "vdb")
    rag = json.loads((REPO / "config.json").read_text())["rag"]
    rag["vector_store"]["persist_directory"] = str(tmp_path / "vdb")
    jp, tp = JPipeline(rag).setup(), RAGPipeline(rag, device="cpu").setup()
    assert tp.store.n == jp.store.n == 37
    ref = jp.retrieve_batch(VDB_QUERIES)
    got = tp.retrieve_batch(VDB_QUERIES)
    assert [[c["id"] for c in r] for r in got] == [[c["id"] for c in r] for r in ref]
    for g, r in zip(got, ref):
        assert np.allclose([c["score"] for c in g], [c["score"] for c in r], atol=SCORE_TOL)
    assert sum(len(r) for r in got) > 0


def test_native_featurizer_pieces_equal_one_call(monkeypatch):
    """The native batch featurizer counts its output in C ints, so a batch
    whose buffer would pass 2³¹ entries (262,144 chunks of 240 words with
    char n-grams: 8 a byte) goes in pieces of ``_NATIVE_PIECE_BYTES``
    bytes. Cut to 2,048 bytes here: the pieces' CSR equals ``crs_tpu``'s
    one call and the port's Python path, and no call's capacity exceeds
    its piece's."""
    from crs_tpu.rag import hashed_features as jf
    from crs_tpu_torch.rag import hashed_features as hf

    docs, queries = _corpus(3)
    texts = docs + queries + [""]
    ref = jf.featurize_batch_counts(texts, 8192, True)
    for got, want in zip(hf._count_batch_py(texts, 8192, True, True), ref):
        np.testing.assert_array_equal(got, want)
    lib = hf._load()
    if lib is None:  # no compiler: the port featurizes on the Python path checked above
        return
    caps = []

    class Recorder:
        def featurize_batch_ex(self, *args):
            caps.append((args[2], args[-1]))
            return lib.featurize_batch_ex(*args)

    monkeypatch.setattr(hf, "_NATIVE_PIECE_BYTES", 2048)
    for got, want in zip(hf._native_batch(Recorder(), texts, 8192, mode=3, per_char=8), ref):
        np.testing.assert_array_equal(got, want)
    long_doc = len(docs[7].encode())  # one text past the piece: a call of its own
    assert len(caps) > 10 and sum(n for n, _ in caps) == len(texts)
    assert all(cap <= 8 * max(2048, long_doc) + 16 * n + 256 for n, cap in caps)
