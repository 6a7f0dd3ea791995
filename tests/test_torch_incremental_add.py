"""``VectorStore.add`` and the store's management calls, the port against
``crs_tpu`` (the cases of ``tests/test_incremental_add.py``, run through
both packages).

PQ codebooks come from ``crs_tpu`` (trained with ``jax.random``, which torch
cannot reproduce): the store is built and saved by ``crs_tpu`` and loaded
into the port, then both take the same adds. Tolerances: ids, capacities,
codes and coarse ids identical; scores within 1e-5 absolute (float32 sums
taken in another order); the host mirror's int8 rows identical.
"""

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


def _mk(n, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _jax_store(fmt, block=64, **kw):
    from crs_tpu.rag.index import VectorStore

    return VectorStore({"format": fmt, "block_size": block, **kw})


def _port_store(fmt, block=64, **kw):
    from crs_tpu_torch.rag.index import VectorStore

    return VectorStore({"format": fmt, "block_size": block, **kw}, device="cpu")


def _search(store, q, k=5):
    s, i = store.search_batch(q, top_k=k)
    return np.asarray(i), np.asarray(s, np.float32)


def _assert_same_search(a, b, q, k=5):
    ai, as_ = _search(a, q, k)
    bi, bs = _search(b, q, k)
    np.testing.assert_array_equal(ai, bi)
    np.testing.assert_allclose(as_, bs, atol=1e-5)


ADDS = ((0, 50), (50, 90), (90, 150), (150, 151), (151, 290))


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8"])
def test_add_equals_rebuild_and_crs_tpu(fmt):
    emb = _mk(290)
    texts = [f"doc {i}" for i in range(290)]
    q = _mk(4, seed=7)
    port, jax_ = _port_store(fmt), _jax_store(fmt)
    for lo, hi in ADDS:
        for store in (port, jax_):
            if lo == 0:
                store.create_index(texts[lo:hi], emb[lo:hi])
            else:
                store.add(texts[lo:hi], emb[lo:hi])
        assert port._padded_rows() == jax_._padded_rows(), (lo, hi)
        assert port.n == jax_.n == hi
        _assert_same_search(port, jax_, q)
    scratch = _port_store(fmt)
    scratch.create_index(texts, emb)
    _assert_same_search(port, scratch, q)
    assert port.ids == scratch.ids == jax_.ids
    if fmt == "int8":  # the appended rows quantize exactly as a build does
        assert torch.equal(port._codes[:290], scratch._codes[:290])
        assert torch.equal(port._scales[:290], scratch._scales[:290])


def test_add_grows_capacity():
    emb = _mk(200)
    texts = [f"d{i}" for i in range(200)]
    store = _port_store("fp32", block=64)
    store.create_index(texts[:40], emb[:40])
    assert store._padded_rows() == 64
    store.add(texts[40:200], emb[40:200])  # past 64 rows: the arrays grow
    assert store.n == 200
    assert store._padded_rows() == 256  # max(2·64, 40 + 160) rounded up to the block
    ids, _ = _search(store, emb[195:200], k=1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(195, 200))


def test_add_padding_never_leaks():
    """Rows in the padding region (zeros, the added block's own padding)
    never surface."""
    emb = _mk(70)
    port, jax_ = _port_store("int8"), _jax_store("int8")
    for store in (port, jax_):
        store.create_index([f"d{i}" for i in range(70)], emb)
        store.add([f"d{i}" for i in range(70, 75)], _mk(5, seed=3))
    ids, scores = _search(port, _mk(6, seed=9), k=75)
    assert (ids[scores > -1e29] < port.n).all()
    _assert_same_search(port, jax_, _mk(6, seed=9), k=75)


PQ_CFG = {"pq_subspaces": 8, "pq_iters": 5}


@pytest.mark.parametrize("residual", [True, False])
def test_pq_add_matches_crs_tpu_until_retrain(residual, tmp_path):
    """Codebooks trained by ``crs_tpu``: the added rows' codes, coarse ids
    and int8 mirror equal its own, and so do the searches; the retrain
    fires at the same n (the corpus doubled since training), after which
    the new codebooks (torch's k-means draws) still find the added rows."""
    emb = _mk(256)
    texts = [f"d{i}" for i in range(256)]
    cfg = dict(PQ_CFG, pq_residual=residual)
    jax_ = _jax_store("pq", **cfg)
    jax_.create_index(texts[:128], emb[:128])
    jax_.save(str(tmp_path))
    port = _port_store("pq", **cfg)
    port.load(str(tmp_path))
    assert port._pq_trained_n == jax_._pq_trained_n == 128
    for lo, hi in ((128, 160), (160, 192)):  # 1.5× — no retrain
        for store in (port, jax_):
            store.add(texts[lo:hi], emb[lo:hi])
        assert port._pq_trained_n == jax_._pq_trained_n == 128
        assert port._padded_rows() == jax_._padded_rows()
        np.testing.assert_array_equal(port._pq_codes.numpy(), np.asarray(jax_._pq_codes))
        if residual:
            np.testing.assert_array_equal(port._pq_coarse_ids.numpy(),
                                          np.asarray(jax_._pq_coarse_ids))
        np.testing.assert_array_equal(port._codes.numpy(), np.asarray(jax_._codes))
        _assert_same_search(port, jax_, emb[120:136])
    ids, _ = _search(port, emb[128:136], k=1)
    assert (ids[:, 0] == np.arange(128, 136)).mean() >= 0.75
    for store in (port, jax_):
        store.add(texts[192:256], emb[192:256])  # 2× since training → retrain
    assert port._pq_trained_n == jax_._pq_trained_n == 256
    assert port.n == 256 and port._padded_rows() == jax_._padded_rows()
    ids, _ = _search(port, emb[192:200], k=1)
    assert (ids[:, 0] == np.arange(192, 200)).mean() >= 0.75
    assert port.ids == jax_.ids


def test_add_into_empty_store_delegates_to_create():
    store = _port_store("fp32")
    store.add([f"d{i}" for i in range(10)], _mk(10))
    assert store.n == 10 and store.ids == [f"chunk_{i}" for i in range(10)]
    store.add(["x", "y"], _mk(2, seed=1))
    assert store.ids[-2:] == ["chunk_10", "chunk_11"]


@pytest.mark.parametrize("mmap", [False, True])
def test_pq_host_mirror_add(mmap, tmp_path):
    """pq_rescore="host": the mirror grows on its own length (RAM or a
    memmap under ``pq_host_mmap``), its new rows are numpy's true division
    by 127, and the host-rescored searches equal ``crs_tpu``'s."""
    emb = _mk(300)
    texts = [f"d{i}" for i in range(300)]
    cfg = dict(PQ_CFG, pq_rescore="host")
    jcfg, pcfg = dict(cfg), dict(cfg)
    if mmap:
        jcfg["pq_host_mmap"] = str(tmp_path / "jax_mirror")
        pcfg["pq_host_mmap"] = str(tmp_path / "port_mirror")
    jax_ = _jax_store("pq", **jcfg)
    jax_.create_index(texts[:100], emb[:100])
    jax_.save(str(tmp_path / "saved"))
    port = _port_store("pq", **pcfg)
    port.create_index(texts[:100], emb[:100])  # the port's own mirror files, then…
    port.load(str(tmp_path / "saved"))  # …crs_tpu's codebooks and mirror
    if mmap:
        port.pq_host_mmap = pcfg["pq_host_mmap"]
        port._mirror_set(np.asarray(jax_._codes_host), np.asarray(jax_._scales_host))
    for lo, hi in ((100, 140), (140, 190)):
        for store in (port, jax_):
            store.add(texts[lo:hi], emb[lo:hi])
        assert port._codes_host.shape == jax_._codes_host.shape
        np.testing.assert_array_equal(np.asarray(port._codes_host), np.asarray(jax_._codes_host))
        np.testing.assert_array_equal(np.asarray(port._scales_host),
                                      np.asarray(jax_._scales_host))
        assert isinstance(port._codes_host, np.memmap) == mmap
        assert port.get_stats()["host_mirror_mmap"] == mmap
        _assert_same_search(port, jax_, emb[95:105])
    if mmap:
        assert sorted(p.name for p in (tmp_path / "port_mirror").iterdir()) == [
            "mirror_codes.i8", "mirror_scales.f32"]
    np.testing.assert_array_equal(port.get_vectors([3, 150, 189]), jax_.get_vectors([3, 150, 189]))


def test_add_persists(tmp_path):
    """With ``persist_directory`` set, every add is saved; a fresh store
    (either package) loads the grown index."""
    from crs_tpu.rag.index import VectorStore as JStore
    from crs_tpu_torch.rag.index import VectorStore

    emb = _mk(120)
    cfg = {"format": "bf16", "block_size": 64, "persist_directory": str(tmp_path)}
    store = VectorStore(cfg, device="cpu")
    store.create_index([f"d{i}" for i in range(80)], emb[:80])
    store.add([f"d{i}" for i in range(80, 120)], emb[80:])
    again = VectorStore(cfg, device="cpu")
    assert again.n == 120 and again._padded_rows() == store._padded_rows()
    _assert_same_search(again, store, _mk(3, seed=5))
    _assert_same_search(JStore(cfg), store, _mk(3, seed=5))


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8", "pq"])
def test_get_vectors_and_management(fmt):
    """``get_vectors`` dequantizes or decodes as ``crs_tpu`` does (on one
    saved state for pq); ``delete_collection`` and ``reset`` empty the store,
    which then takes a fresh build through ``add``."""
    import tempfile

    emb = _mk(100)
    texts = [f"d{i}" for i in range(100)]
    jax_ = _jax_store(fmt, **PQ_CFG)
    jax_.create_index(texts, emb)
    port = _port_store(fmt, **PQ_CFG)
    with tempfile.TemporaryDirectory() as d:
        jax_.save(d)
        port.load(d)
    rows = [0, 5, 99, 42]
    got, ref = port.get_vectors(rows), np.asarray(jax_.get_vectors(np.array(rows)))
    assert got.shape == (4, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6)
    if fmt != "pq":
        np.testing.assert_allclose(got, emb[rows], atol=2e-2)
    for call in ("delete_collection", "reset"):
        getattr(port, call)()
        assert port.n == 0 and port._padded_rows() == 0 and port.ids == []
        s, i = port.search_batch(emb[:2], top_k=3)
        assert s.shape == (2, 0) and i.shape == (2, 0)
        port.add(texts[:10], emb[:10])
        assert port.n == 10
