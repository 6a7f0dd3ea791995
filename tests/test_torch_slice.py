"""The port's batched int8 RAG retrieve against ``crs_tpu``'s, as a whole.

Both packages run on one state, carried across by ``crs_tpu_torch.convert``.
Tolerances: embeddings ≤ 1e-5 absolute (float32 sums of ≤ 1024 terms in
another order); retrieval ids and their order identical; similarity and rank
scores ≤ 1e-5 absolute (float32 rescore dots in another order).
"""

import json
import pathlib

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = REPO / "results" / "selftrained" / "heldout_corpus.txt"
QA = REPO / "results" / "selftrained" / "heldout_qa.json"
VECTOR_DB = REPO / "vector_db"

BENCH_CHUNKER = {"strategy": "semantic", "chunk_size": 160, "chunk_overlap": 30, "min_chunk_size": 10}
BENCH_RETRIEVER = {"top_k": 3, "similarity_threshold": 0.05, "rerank": True, "diversity_penalty": 0.1}
BENCH_STORE = {"format": "int8", "block_size": 256, "rescore_k": 64}


def _questions():
    qs = [x["question"] for x in json.loads(QA.read_text())]
    return qs + ["what is pruning?", "quantization int8 weights", "zzz qqq", ""]


@pytest.fixture(scope="module")
def jax_slice():
    """crs_tpu's bench slice on the held-out corpus."""
    from crs_tpu.rag.chunking import TextChunker
    from crs_tpu.rag.document_processing import DocumentProcessor
    from crs_tpu.rag.embedding import EmbeddingModel
    from crs_tpu.rag.index import VectorStore
    from crs_tpu.rag.retrieval import ContextRetriever

    pages = DocumentProcessor({}).process_file(str(CORPUS))
    ck = TextChunker(BENCH_CHUNKER)
    chunks = [c for t, p in pages for c in ck.chunk(t, page_number=p)]
    em = EmbeddingModel({"backend": "hashed", "embedding_dim": 384})
    store = VectorStore(BENCH_STORE)
    store.create_index(chunks, em.embed_chunks(chunks))
    retr = ContextRetriever(store, em, BENCH_RETRIEVER)
    return chunks, em, store, retr


def _port_from(jax_em, jax_store, jax_retr, config=BENCH_RETRIEVER):
    from crs_tpu_torch.convert import (
        embedding_model_from_numpy, int8_store_from_numpy, retriever_from_numpy,
    )

    jax_retr._ensure_presence()
    em = embedding_model_from_numpy(np.asarray(jax_em._hashed._proj), device="cpu")
    store = int8_store_from_numpy(
        np.asarray(jax_store._codes), np.asarray(jax_store._scales), jax_store.n,
        jax_store.ids, jax_store.documents, jax_store.metadatas,
        config={"block_size": jax_store.block_size, "rescore_k": jax_store.rescore_k},
        device="cpu")
    retr = retriever_from_numpy(store, em, np.asarray(jax_retr._doc_token_ids), config)
    return em, store, retr


def _assert_results_equal(got, ref, atol=1e-5):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert [c["id"] for c in g] == [c["id"] for c in r]
        for cg, cr in zip(g, r):
            assert cg["text"] == cr["text"] and cg["metadata"] == cr["metadata"]
            assert abs(cg["score"] - cr["score"]) <= atol
            assert abs(cg["rank_score"] - cr["rank_score"]) <= atol


def test_hashed_encoder_matches(jax_slice):
    from crs_tpu_torch.rag.embedding import EmbeddingModel, HashedEncoder

    chunks, jem, _, _ = jax_slice
    enc = HashedEncoder(dim=384, seed=0, device="cpu")
    np.testing.assert_array_equal(enc.proj.numpy(), np.asarray(jem._hashed._proj))
    texts = [c.text for c in chunks] + _questions()
    ref = np.asarray(jem.embed(texts))
    np.testing.assert_allclose(enc.encode_dev(texts).numpy(), ref, atol=1e-5, rtol=0)
    em = EmbeddingModel({"backend": "hashed", "embedding_dim": 384}, device="cpu")
    np.testing.assert_allclose(em.embed(texts).numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(em.embed_chunks(chunks).numpy(), np.asarray(jem.embed_chunks(chunks)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [1, 7])
def test_hashed_encoder_small_projection(seed):
    """Chunked projection steps (many rows, narrow width) change nothing."""
    from crs_tpu.rag.embedding import HashedEncoder as JEnc
    from crs_tpu_torch.rag import embedding as temb

    texts = [f"doc {i} about topic {i % 13} and term{i % 29}" for i in range(700)]
    jenc = JEnc(dim=32, num_features=4096, seed=seed)
    enc = temb.HashedEncoder(dim=32, num_features=4096, seed=seed, device="cpu")
    old = temb._GATHER_MAX_ELEMS
    temb._GATHER_MAX_ELEMS = 64 * 32 * 10  # 10 rows per step
    try:
        got = enc.encode_dev(texts).numpy()
    finally:
        temb._GATHER_MAX_ELEMS = old
    np.testing.assert_allclose(got, np.asarray(jenc.encode(texts)), atol=1e-5, rtol=0)


def test_store_codes_match(jax_slice):
    from crs_tpu_torch.rag.index import VectorStore

    chunks, jem, jstore, _ = jax_slice
    emb = np.asarray(jem.embed_chunks(chunks))
    store = VectorStore(BENCH_STORE, device="cpu")
    store.create_index(chunks, emb)
    np.testing.assert_array_equal(store._codes.numpy(), np.asarray(jstore._codes))
    np.testing.assert_array_equal(store._scales.numpy(), np.asarray(jstore._scales))
    assert (store.ids, store.documents, store.metadatas) == (jstore.ids, jstore.documents, jstore.metadatas)
    assert store._padded_rows() == jstore._padded_rows() == 256


def test_retrieve_batch_fused_matches(jax_slice):
    """The whole bench path: embed → int8 scan + rescore → presence rerank →
    threshold → MMR, on crs_tpu's state."""
    _, jem, jstore, jretr = jax_slice
    _, _, retr = _port_from(jem, jstore, jretr)
    batch = (_questions() * 24)[:328]
    ref = jretr.retrieve_batch_fused(batch)
    got = retr.retrieve_batch_fused(batch)
    _assert_results_equal(got, ref)
    assert sum(1 for r in got if r) >= 10


@pytest.mark.parametrize("config", [
    BENCH_RETRIEVER,
    dict(BENCH_RETRIEVER, diversity_penalty=0.0),
    dict(BENCH_RETRIEVER, rerank=False, similarity_threshold=-1.0),
    dict(BENCH_RETRIEVER, top_k=2, rerank_fetch_mult=1, diversity_penalty=0.3),
], ids=["bench", "no_mmr", "no_rerank", "top2"])
@pytest.mark.parametrize("fused", [True, False])
def test_retrieve_configs_match(jax_slice, config, fused):
    from crs_tpu.rag.retrieval import ContextRetriever as JCR

    _, jem, jstore, jretr = jax_slice
    jr = JCR(jstore, jem, config)
    jr._ensure_presence()
    _, _, retr = _port_from(jem, jstore, jr, config)
    batch = _questions()
    run = "retrieve_batch_fused" if fused else "retrieve_batch"
    _assert_results_equal(getattr(retr, run)(batch), getattr(jr, run)(batch))


def test_retrieve_with_where_filter(jax_slice):
    chunks, jem, jstore, jretr = jax_slice
    _, store, retr = _port_from(jem, jstore, jretr)
    where = {"page_number": 1}
    batch = _questions()
    _assert_results_equal(retr.retrieve_batch_fused(batch, where=where),
                          jretr.retrieve_batch_fused(batch, where=where))
    _assert_results_equal(retr.retrieve_batch(batch, where=where),
                          jretr.retrieve_batch(batch, where=where))
    assert retr.retrieve("what is pruning?", where={"page_number": 99}) == []


def test_port_builds_the_same_presence_ids(jax_slice):
    from crs_tpu_torch.rag.retrieval import ContextRetriever

    _, jem, jstore, jretr = jax_slice
    em, store, _ = _port_from(jem, jstore, jretr)
    retr = ContextRetriever(store, em, BENCH_RETRIEVER)
    retr._ensure_presence()
    np.testing.assert_array_equal(retr._doc_token_ids.numpy(), np.asarray(jretr._doc_token_ids))
    q_ids, q_inv = retr._query_token_ids(_questions())
    j_ids, j_inv = jretr._query_token_ids(_questions())
    np.testing.assert_array_equal(q_ids, j_ids)
    np.testing.assert_array_equal(q_inv, j_inv)


def _topic_corpus(rng, rows, n_topics=256, topic_words=24, doc_words=12):
    vocab = np.array([f"t{t}w{j}" for t in range(n_topics) for j in range(topic_words)])
    topic = rng.integers(0, n_topics, rows)
    words = topic[:, None] * topic_words + rng.integers(0, topic_words, (rows, doc_words))
    texts = [" ".join(r) for r in vocab[words].tolist()]
    q_topic = rng.integers(0, n_topics, 8)
    q_words = q_topic[:, None] * topic_words + rng.integers(0, topic_words, (8, 6))
    return texts, [" ".join(r) for r in vocab[q_words].tolist()]


def test_retrieve_fused_through_routed_scan():
    """16384 rows: the candidate scan routes through the scan kernel in both
    packages (Pallas interpret / the plain torch version) inside the fused
    serving path."""
    from crs_tpu.rag.embedding import EmbeddingModel
    from crs_tpu.rag.index import VectorStore
    from crs_tpu.rag.retrieval import ContextRetriever
    from crs_tpu_torch.ops import scan

    texts, queries = _topic_corpus(np.random.default_rng(21), 16384)
    jem = EmbeddingModel({"backend": "hashed", "embedding_dim": 64})
    jstore = VectorStore({"format": "int8", "block_size": 4096, "rescore_k": 64})
    jstore.create_index(texts, jem.embed(texts))
    jretr = ContextRetriever(jstore, jem, BENCH_RETRIEVER)
    ref = jretr.retrieve_batch_fused(queries)
    _, _, retr = _port_from(jem, jstore, jretr)
    calls = []
    wrapper = scan.block_topk_int8
    scan.block_topk_int8 = lambda *a, **k: calls.append(1) or wrapper(*a, **k)
    try:
        got = retr.retrieve_batch_fused(queries)
    finally:
        scan.block_topk_int8 = wrapper
    assert calls == [1]
    _assert_results_equal(got, ref)
    assert all(got)


def _random_queries(seed, b=6, d=384):
    q = np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("where", [None, {"page_number": 1}, {"section": "Introduction"}],
                         ids=["all", "page1", "section"])
def test_vector_db_loads_and_searches_alike(where):
    """The vector_db/ crs_tpu wrote (lexical backend) loads in the port;
    scans on its arrays give crs_tpu's ids."""
    from crs_tpu.rag.index import VectorStore as JStore
    from crs_tpu_torch.rag.index import VectorStore

    jstore = JStore({"format": "int8"})
    jstore.load(str(VECTOR_DB))
    store = VectorStore({"format": "int8"}, device="cpu")
    store.load(str(VECTOR_DB))
    assert store.n == jstore.n == 37 and store.block_size == 1024
    q = _random_queries(3)
    ref_s, ref_i = jstore.search_batch(q, top_k=5, where=where)
    s, i = store.search_batch(q, top_k=5, where=where)
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_allclose(s.numpy(), ref_s, atol=1e-5, rtol=0)
    got = store.search(q[0], top_k=4, where=where, where_document="the")
    ref = jstore.search(q[0], top_k=4, where=where, where_document="the")
    assert got["ids"] == ref["ids"] and got["documents"] == ref["documents"]
    np.testing.assert_allclose(got["similarities"], ref["similarities"], atol=1e-5)


def test_save_load_roundtrip_across_packages(tmp_path, jax_slice):
    from crs_tpu.rag.index import VectorStore as JStore
    from crs_tpu_torch.rag.index import VectorStore

    chunks, jem, jstore, _ = jax_slice
    store = VectorStore(dict(BENCH_STORE, persist_directory=str(tmp_path / "port")), device="cpu")
    store.create_index(chunks, np.asarray(jem.embed_chunks(chunks)))
    back = JStore({"format": "int8"})
    back.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back._codes), store._codes.numpy())
    assert back.ids == store.ids and back.metadatas == store.metadatas
    jstore.save(str(tmp_path / "jax"))
    again = VectorStore(dict(BENCH_STORE, persist_directory=str(tmp_path / "jax")), device="cpu")
    np.testing.assert_array_equal(again._codes.numpy(), np.asarray(jstore._codes))
    assert again.n == jstore.n and again.documents == jstore.documents
    q = torch.from_numpy(_random_queries(5))
    np.testing.assert_array_equal(again.search_batch(q, 3)[1].numpy(),
                                  np.asarray(jstore.search_batch(q.numpy(), 3)[1]))
