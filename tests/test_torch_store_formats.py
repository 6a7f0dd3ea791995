"""The port's fp32, bf16 and pq stores against ``crs_tpu``'s, end to end.

Each store is built and trained by ``crs_tpu``, saved with its ``save`` and
loaded by the port's ``VectorStore.load`` (or carried across by
``crs_tpu_torch.convert``), so both packages serve one state. Queries come
from one fixed embedding on both sides. On the CPU both stores take the
non-kernel route (``crs_tpu`` off the TPU); the kernel route is held
separately, with ``crs_tpu``'s Pallas kernels in interpret mode against the
port's plain versions.

Tolerances: retrieval ids and their order identical; similarity and rank
scores within 1e-5 absolute (float32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

N, D, NQ = 3000, 64, 12
BASE = {"block_size": 256, "rescore_k": 32, "pq_subspaces": 8, "pq_clusters": 64,
        "pq_iters": 4, "pq_opq_iters": 1, "pq_coarse_clusters": 256}
FORMATS = {
    "fp32": {"format": "fp32"},
    "bf16": {"format": "bf16"},
    "pq_int8": {"format": "pq", "pq_rescore": "int8"},
    "pq_host": {"format": "pq", "pq_rescore": "host"},
    "pq_none": {"format": "pq", "pq_rescore": "none"},
    "pq_plain": {"format": "pq", "pq_residual": False, "pq_rescore": "int8"},
}
RETRIEVER = {"top_k": 4, "similarity_threshold": -1.0, "rerank": True,
             "diversity_penalty": 0.1}
WHERE = {"page_number": 2}


def _data():
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((30, D)).astype(np.float32)
    x = centers[rng.integers(0, 30, N)] + 0.5 * rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    qi = rng.choice(N, NQ, replace=False)
    q = x[qi] + 0.05 * rng.standard_normal((NQ, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    texts = [f"doc {i} topic{i % 7} word{i % 13} page{i % 4}" for i in range(N)]
    mds = [{"page_number": i % 4, "section": "ab"[i % 2]} for i in range(N)]
    queries = [f"query {j} topic{j % 7} word{j % 5}" for j in range(NQ)]
    return x, q.astype(np.float32), texts, mds, queries


class _JaxFixedEmbed:
    def __init__(self, q):
        self.q = q

    def embed(self, queries, as_numpy=True, is_query=False):
        return jnp.asarray(self.q[[int(s.split()[1]) for s in queries]])


class _PortFixedEmbed:
    def __init__(self, q):
        self.q = q

    def embed(self, queries, is_query=False):
        return torch.from_numpy(self.q[[int(s.split()[1]) for s in queries]].copy())


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{format: (crs_tpu store, its save directory)} on one corpus."""
    from crs_tpu.rag.index import VectorStore

    x, q, texts, mds, queries = _data()
    out = {}
    for name, cfg in FORMATS.items():
        store = VectorStore(dict(BASE, **cfg))
        store.create_index(texts, x)
        store.metadatas = [dict(m) for m in mds]
        path = tmp_path_factory.mktemp(name)
        store.save(str(path))
        out[name] = (store, str(path))
    return out


def _port_load(path, cfg=None):
    from crs_tpu_torch.rag.index import VectorStore

    store = VectorStore(dict(BASE, **(cfg or {})), device="cpu")
    store.load(path)
    return store


def _assert_results_equal(got, ref, atol=1e-5):
    assert [[h["id"] for h in row] for row in got] == [[h["id"] for h in row] for row in ref]
    for g, r in zip(got, ref):
        for hg, hr in zip(g, r):
            assert hg["metadata"] == hr["metadata"]
            assert abs(hg["score"] - hr["score"]) <= atol
            assert abs(hg["rank_score"] - hr["rank_score"]) <= atol
    assert sum(len(r) for r in ref) > 0


def _retrievers(jstore, pstore, q, config):
    from crs_tpu.rag.retrieval import ContextRetriever as JRetriever
    from crs_tpu_torch.rag.retrieval import ContextRetriever

    return (JRetriever(jstore, _JaxFixedEmbed(q), config),
            ContextRetriever(pstore, _PortFixedEmbed(q), config))


@pytest.mark.parametrize("variant", ["plain", "prf", "where", "prf_where"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_retrieve_batch_matches_crs_tpu(stores, fmt, variant):
    _, q, _, _, queries = _data()
    jstore, path = stores[fmt]
    pstore = _port_load(path, FORMATS[fmt])
    config = dict(RETRIEVER, prf_beta=0.3 if "prf" in variant else 0.0)
    where = WHERE if "where" in variant else None
    jr, pr = _retrievers(jstore, pstore, q, config)
    got = pr.retrieve_batch(queries, where=where)
    _assert_results_equal(got, jr.retrieve_batch(queries, where=where))
    if where:
        assert all(h["metadata"]["page_number"] == 2 for row in got for h in row)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_search_batch_and_search_match(stores, fmt):
    """The store API itself: batched search (the pq host mode's host
    rescore included) and the single-query envelope with `where`."""
    _, q, _, _, _ = _data()
    jstore, path = stores[fmt]
    pstore = _port_load(path, FORMATS[fmt])
    js, ji = jstore.search_batch(q, top_k=6)
    ps, pi = pstore.search_batch(q, top_k=6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    jres = jstore.search(q[0], top_k=5, where={"section": "b"})
    pres = pstore.search(q[0], top_k=5, where={"section": "b"})
    assert pres["ids"] == jres["ids"]
    np.testing.assert_allclose(pres["similarities"], jres["similarities"], atol=1e-5)
    assert pstore.memory_bytes() == jstore.memory_bytes()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_kernel_route_matches_pallas(stores, fmt, monkeypatch):
    """The card's route (the scan kernels above 4·block_size rows), run
    through the kernels' plain versions, against ``crs_tpu``'s Pallas route
    (its kernels in interpret mode): same ids, scores within 1e-5."""
    from crs_tpu.rag.index import VectorStore as JStore
    from crs_tpu_torch.rag.index import VectorStore

    _, q, _, _, _ = _data()
    jstore, path = stores[fmt]
    pstore = _port_load(path, FORMATS[fmt])
    monkeypatch.setattr(JStore, "_use_pallas", lambda self: True)
    monkeypatch.setattr(VectorStore, "_scan_here", lambda self, rows: rows >= 4 * self.block_size)
    js, ji = jstore.search_batch_dev(jnp.asarray(q), 8)
    ps, pi = pstore.search_batch_dev(torch.from_numpy(q), 8)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    mask_np, _ = pstore._row_mask(WHERE)
    if FORMATS[fmt]["format"] == "pq":  # the mask reaches the ADC kernels' bias row
        js, ji = jstore._pq_adc_candidates(jnp.asarray(q), 8, row_mask=jnp.asarray(mask_np))
        ps, pi = pstore._pq_adc_candidates(torch.from_numpy(q), 8,
                                           row_mask=torch.from_numpy(mask_np))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
        assert mask_np[pi.numpy()].all()


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "pq_int8"])
def test_fused_path_matches_crs_tpu(stores, fmt):
    _, q, _, _, queries = _data()
    jstore, path = stores[fmt]
    pstore = _port_load(path, FORMATS[fmt])
    jr, pr = _retrievers(jstore, pstore, q, dict(RETRIEVER, fused=True))
    _assert_results_equal(pr.retrieve_batch_fused(queries, where=WHERE),
                          jr.retrieve_batch_fused(queries, where=WHERE))
    _assert_results_equal(pr.retrieve_batch_fused(queries), jr.retrieve_batch_fused(queries))


def test_convert_carries_float_and_pq_state(stores):
    """``convert.py`` builds the same stores from numpy state as ``load``."""
    from crs_tpu_torch.convert import float_store_from_numpy, pq_store_from_numpy

    _, q, _, _, queries = _data()
    for fmt in ("fp32", "bf16", "pq_int8", "pq_host", "pq_plain"):
        j, _ = stores[fmt]
        cfg = dict(BASE, **FORMATS[fmt])
        common = dict(ids=j.ids, documents=j.documents, metadatas=j.metadatas, config=cfg,
                      device="cpu")
        if j.format in ("fp32", "bf16"):
            p = float_store_from_numpy(np.asarray(j._vectors.astype(jnp.float32)), j.n, **common)
        else:
            rpq = j._rpq
            p = pq_store_from_numpy(
                j.n, j.dim, centroids=np.asarray(j._pq_codebook.centroids),
                pq_codes=np.asarray(j._pq_codes),
                rotation=None if rpq is None else np.asarray(rpq.rotation),
                coarse=None if rpq is None else np.asarray(rpq.coarse),
                coarse_ids=None if rpq is None else np.asarray(j._pq_coarse_ids),
                codes=None if j._codes is None else np.asarray(j._codes),
                scales=None if j._scales is None else np.asarray(j._scales),
                codes_host=j._codes_host, scales_host=j._scales_host, **common)
        jr, pr = _retrievers(j, p, q, dict(RETRIEVER, prf_beta=0.3))
        _assert_results_equal(pr.retrieve_batch(queries), jr.retrieve_batch(queries))


@pytest.mark.parametrize("fmt", ["bf16", "pq_host"])
def test_port_save_loads_in_crs_tpu(stores, fmt, tmp_path):
    from crs_tpu.rag.index import VectorStore as JStore

    _, q, _, _, _ = _data()
    _, path = stores[fmt]
    pstore = _port_load(path, FORMATS[fmt])
    pstore.save(str(tmp_path))
    back = JStore(dict(BASE, **FORMATS[fmt]))  # rescore_k is config, not saved state
    back.load(str(tmp_path))
    js, ji = back.search_batch(q, top_k=5)
    ps, pi = pstore.search_batch(q, top_k=5)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("fmt", ["fp32", "pq_int8", "pq_plain"])
def test_port_builds_and_retrieves(fmt):
    """The port's own create_index: finite scores, self-retrieval, and the
    PQ stores' layout (uint8 codes; int32 coarse ids; device bytes)."""
    from crs_tpu_torch.rag.index import VectorStore

    x, q, texts, _, _ = _data()
    store = VectorStore(dict(BASE, **FORMATS[fmt]), device="cpu")
    store.create_index(texts, x)
    s, i = store.search_batch(x[:20], top_k=3)
    assert torch.isfinite(s).all()
    assert (i[:, 0].numpy() == np.arange(20)).mean() >= 0.9
    if store.format == "pq":
        assert store._pq_codes.dtype == torch.uint8 and "pq_train" in store.build_seconds
        assert store.memory_bytes() < x.nbytes
        if store._rpq is not None:
            assert store._pq_coarse_ids.dtype == torch.int32
            assert store._residual_ext().shape == (store._padded_rows(), BASE["pq_subspaces"] + 2)


def test_pq_sorted_and_add_raise(stores):
    """Once raised; now ported: a ``pq_sorted`` store loads ``crs_tpu``'s
    residual state and serves the same search, and ``add`` grows a store
    as ``crs_tpu``'s grows."""
    from crs_tpu_torch.rag.index import VectorStore

    x, q, _, _, _ = _data()
    jstore, path = stores["pq_int8"]
    pstore = _port_load(path, dict(FORMATS["pq_int8"], pq_sorted=True))
    assert pstore.pq_sorted
    js, ji = jstore.search_batch(q, top_k=6)
    ps, pi = pstore.search_batch(q, top_k=6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    store = VectorStore(dict(BASE, format="fp32"), device="cpu")
    store.create_index([f"d{i}" for i in range(200)], x[:200])
    store.add([f"d{i}" for i in range(200, 300)], x[200:300])
    assert store.n == 300 and store._padded_rows() == 512  # max(2·256, 200 + 128)
    assert store.search_batch(x[250:253], top_k=1)[1][:, 0].tolist() == [250, 251, 252]
