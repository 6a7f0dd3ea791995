"""The port's sharded corpus (``crs_tpu_torch.parallel`` and the mesh
``VectorStore``) against ``crs_tpu``'s on the CPU, at world sizes 1, 2 and 4.

The parent trains residual PQ with ``crs_tpu`` (its codebooks come from
``jax.random``) and saves ``crs_tpu`` mesh stores; one
``torch.multiprocessing`` spawn per world size over a ``FileStore`` (gloo)
runs every check of the port, its workers importing nothing of JAX, and
rank 0 pickles the results. The parent holds them against ``crs_tpu``'s
mesh path on ``corpus_mesh(world)`` of the 8-device CPU mesh that
``tests/conftest.py`` sets up: ids identical except where scores tie, scores
within 1e-5·(1+|s|).

- the scans: ``sharded_topk`` (fp32, bf16), ``sharded_topk_int8`` and
  ``sharded_topk_residual_pq`` (with and without the int8 mirror), on the
  dense per-shard body and on the kernel route (small ``block_size``; the
  wrappers take their plain versions on the CPU), with a row mask, an ``n``
  that leaves ranks partly or wholly padding, and k larger than a shard;
- the store: fp32, bf16 and int8 built on the mesh, pq loaded from a
  ``crs_tpu`` mesh store, each searched with and without ``where``; adds
  across a regrow that moves rows between ranks; an index saved by either
  package's mesh store loaded by the other, sharded and not; and
  ``retrieve_batch`` with rerank and MMR.
"""

import itertools
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

WORLDS = [1, 2, 4]
D, NQ = 32, 6
SCAN_ROWS, SCAN_VALID, SCAN_BLOCK = 700, 380, 32  # rank 3 of 4 holds padding only
STORE_N, STORE_ADD, STORE_BLOCK = 600, (150, 150), 64
SCANS = ["fp32", "bf16", "int8", "rpq_int8", "rpq_none"]
ROUTES = [("dense", False), ("dense", True), ("kernel", True)]  # (route, row mask)
STORE_FORMATS = {
    "fp32": {"format": "fp32"},
    "bf16": {"format": "bf16"},
    "int8": {"format": "int8"},
    "pq_int8": {"format": "pq", "pq_rescore": "int8"},
    "pq_host": {"format": "pq", "pq_rescore": "host"},
}
STORE_BASE = {"block_size": STORE_BLOCK, "rescore_k": 16, "pq_subspaces": 8, "pq_iters": 4,
              "pq_opq_iters": 1}
RETRIEVER = {"top_k": 4, "similarity_threshold": -1.0, "rerank": True, "diversity_penalty": 0.1}
WHERE = {"page_number": 2}
K = 5
# the kernel route of rpq_none is rpq_int8's scan without the rescore
SCAN_CASES = [(name, route, masked) for name in SCANS for route, masked in ROUTES
              if (name, route) != ("rpq_none", "kernel")] + [("fp32_k_past_shard", "dense", False)]
RETRIEVE_FORMATS = ("fp32", "int8", "pq_host")  # MMR gathers vectors, codes and PQ decodes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _unit(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _store_data():
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((20, D)).astype(np.float32)
    n = STORE_N + sum(STORE_ADD)
    x = centers[rng.integers(0, 20, n)] + 0.5 * rng.standard_normal((n, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(n, NQ, replace=False)] + 0.05 * rng.standard_normal((NQ, D)).astype(
        np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    texts = [f"doc {i} topic{i % 7} word{i % 13}" for i in range(n)]
    mds = [{"page_number": i % 4, "section": "ab"[i % 2]} for i in range(n)]
    queries = [f"query {j} topic{j % 7} word{j % 5}" for j in range(NQ)]
    return x, q.astype(np.float32), texts, mds, queries


class _FixedEmbed:
    """Query i's embedding is row i of q (the same in both packages)."""

    def __init__(self, q, as_jax=False):
        self.q, self.as_jax = q, as_jax

    def embed(self, queries, as_numpy=True, is_query=False):
        rows = self.q[[int(s.split()[1]) for s in queries]]
        if self.as_jax:
            import jax.numpy as jnp

            return jnp.asarray(rows)
        return torch.from_numpy(rows.copy())


def _hits(results):
    return [[(h["id"], h["metadata"], h["score"], h["rank_score"]) for h in row]
            for row in results]


def _port_scans(mesh, prepared):
    """Every scan case of the port on this mesh → {case: (scores, ids)}."""
    from crs_tpu_torch.ops.pq import PQCodebook, ResidualPQ
    from crs_tpu_torch.parallel.sharded_index import (
        shard_corpus, sharded_topk, sharded_topk_int8, sharded_topk_residual_pq,
    )

    q = torch.from_numpy(prepared["scan_queries"])
    rpq = ResidualPQ(*(torch.from_numpy(prepared[k]) for k in ("rot", "coarse")),
                     codebook=PQCodebook(torch.from_numpy(prepared["centroids"])))
    vec = shard_corpus(prepared["scan_vectors"], mesh)[0]
    codes = shard_corpus(prepared["scan_codes"], mesh)[0]
    scales = shard_corpus(prepared["scan_scales"], mesh)[0]
    ext = shard_corpus(prepared["scan_ext"], mesh)[0]
    out = {}
    for route, masked in ROUTES:
        block = SCAN_BLOCK if route == "kernel" else 4096
        mask = torch.from_numpy(prepared["scan_mask"]) if masked else None
        kw = dict(row_mask=mask, block_size=block)
        for name in SCANS:
            if name in ("fp32", "bf16"):
                v = vec if name == "fp32" else vec.to(torch.bfloat16)
                res = sharded_topk(v, q, K, SCAN_VALID, mesh, **kw)
            elif name == "int8":
                res = sharded_topk_int8(codes, scales, q, K, SCAN_VALID, mesh, rescore_k=16, **kw)
            else:
                mirror = (codes, scales) if name == "rpq_int8" else (None, None)
                res = sharded_topk_residual_pq(rpq, ext, *mirror, q, K, SCAN_VALID, mesh,
                                               rescore_k=16, **kw)
            out[(name, route, masked)] = tuple(t.numpy() for t in res)
    small = shard_corpus(prepared["scan_vectors"][:64], mesh)[0]  # 16 rows a shard at 4
    out[("fp32_k_past_shard", "dense", False)] = tuple(
        t.numpy() for t in sharded_topk(small, q, 20, 64, mesh))
    return out


def _port_stores(mesh, world, prepared, out_dir):
    """Every store check of the port on this mesh → {check: result}."""
    from crs_tpu_torch.rag.index import VectorStore
    from crs_tpu_torch.rag.retrieval import ContextRetriever

    x, q, texts, mds, queries = _store_data()
    out = {}
    for name, cfg in STORE_FORMATS.items():
        store = VectorStore(dict(STORE_BASE, **cfg), device="cpu", mesh=mesh)
        n0 = STORE_N if name.startswith("pq") else 300
        if name.startswith("pq"):  # crs_tpu's codebooks: its saved mesh store
            store.load(prepared["pq_dirs"][(world, name)])
        else:
            store.create_index(texts[:n0], x[:n0])
        store.metadatas = [dict(m) for m in mds[:n0]]
        res = {}
        for where in (None, WHERE):
            s, i = store.search_batch(q, top_k=K, where=where)
            res[("search", bool(where))] = (s.numpy(), i.numpy())
        if name in RETRIEVE_FORMATS:
            retr = ContextRetriever(store, _FixedEmbed(q), dict(RETRIEVER))
            res["retrieve"] = _hits(retr.retrieve_batch(queries))
            res["retrieve_fused"] = _hits(retr.retrieve_batch_fused(queries))
        res["vectors"] = store.get_vectors(np.array([0, 7, n0 - 1]))
        res["stats"] = store.get_stats()
        adds = STORE_ADD if not name.startswith("pq") else (50,)
        lo = n0
        res["padded_before"] = store._padded_rows()
        for m in adds:
            store.add(texts[lo:lo + m], x[lo:lo + m])
            store.metadatas[lo:lo + m] = [dict(md) for md in mds[lo:lo + m]]
            lo += m
        res["padded_after"] = store._padded_rows()
        res["added"] = tuple(t.numpy() for t in store.search_batch(q, top_k=K))
        res["added_vectors"] = store.get_vectors(np.array([n0, lo - 1]))
        path = os.path.join(out_dir, f"port_{name}")
        store.save(path)
        res["saved"] = path
        out[name] = res
    return out


def _worker(rank, world, prepared_path, store_path, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from crs_tpu_torch.parallel.mesh import corpus_mesh, initialize_multihost
    from crs_tpu_torch.parallel.sharded_index import shard_corpus

    with open(prepared_path, "rb") as f:
        prepared = pickle.load(f)
    initialize_multihost(f"file://{store_path}", world, rank, device="cpu")
    mesh = corpus_mesh(device="cpu")
    local, n = shard_corpus(prepared["scan_vectors"], mesh)
    out = {"layout": (tuple(local.shape), n, local.numpy()),
           "scans": _port_scans(mesh, prepared),
           "stores": _port_stores(mesh, world, prepared, out_dir)}
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The scan arrays, crs_tpu's residual PQ over them, and crs_tpu mesh pq
    stores saved for every world size."""
    import jax
    import jax.numpy as jnp

    from crs_tpu.ops.pq import residual_codes_ext, residual_pq_encode, train_residual_pq
    from crs_tpu.parallel.mesh import corpus_mesh
    from crs_tpu.rag.index import VectorStore

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(5)
    vectors = _unit(rng, SCAN_ROWS)
    vectors[SCAN_VALID:] = 0.0  # the store's padding rows
    amax = np.max(np.abs(vectors), axis=-1)
    scales = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    codes = np.clip(np.round(vectors / scales[:, None]), -127, 127).astype(np.int8)
    rpq = train_residual_pq(jax.random.PRNGKey(0), jnp.asarray(vectors[:SCAN_VALID]),
                            num_subspaces=8, coarse_clusters=256, num_iters=4, opq_iters=1,
                            coarse_iters=3)
    cids, pq_codes = residual_pq_encode(rpq, jnp.asarray(vectors))
    out = {"scan_vectors": vectors, "scan_codes": codes, "scan_scales": scales,
           "scan_ext": np.asarray(residual_codes_ext(cids, pq_codes)),
           "scan_mask": np.arange(SCAN_ROWS) % 3 != 1,
           "scan_queries": _unit(rng, NQ), "rot": np.asarray(rpq.rotation),
           "coarse": np.asarray(rpq.coarse), "centroids": np.asarray(rpq.codebook.centroids),
           "pq_dirs": {}}
    x, _, texts, mds, _ = _store_data()
    jstores = {}
    for world in WORLDS:
        for name, cfg in STORE_FORMATS.items():
            if not name.startswith("pq"):
                continue
            store = VectorStore(dict(STORE_BASE, **cfg), mesh=corpus_mesh(world))
            store.create_index(texts[:STORE_N], x[:STORE_N])
            store.metadatas = [dict(m) for m in mds[:STORE_N]]
            path = tmp_path_factory.mktemp(f"jax_{name}_{world}")
            store.save(str(path))
            out["pq_dirs"][(world, name)] = str(path)
            jstores[(world, name)] = store
    path = tmp_path_factory.mktemp("prepared") / "prepared.pkl"
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return out, str(path), jstores


@pytest.fixture(scope="module")
def runs(prepared, tmp_path_factory):
    """The port's workers (every world size at once) run while the parent
    computes crs_tpu's results → (port, crs_tpu scans, crs_tpu stores)."""
    import torch.multiprocessing as mp

    outs, procs = {}, []
    for world in WORLDS:
        outs[world] = tmp_path_factory.mktemp(f"port_w{world}")
        procs.append(mp.spawn(_worker, args=(world, prepared[1], str(outs[world] / "store"),
                                             str(outs[world])), nprocs=world, join=False))
    # crs_tpu's side is mostly XLA compiles, which run in parallel in threads
    with ThreadPoolExecutor(4) as pool:
        scans = {key: pool.submit(lambda w, c: tuple(np.asarray(a) for a in _jax_scan(
            w, c, prepared[0])), *key) for key in itertools.product(WORLDS, SCAN_CASES)}
        stores = [pool.submit(_jax_store_results, prepared, world) for world in WORLDS]
        scans = {key: f.result() for key, f in scans.items()}
        stores = {key: res for f in stores for key, res in f.result().items()}
    for ctx in procs:
        while not ctx.join():
            pass
    port = {}
    for world, out in outs.items():
        with open(out / "port.pkl", "rb") as f:
            port[world] = pickle.load(f)
    return port, scans, stores


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_stores(runs):
    return runs[2]


def _jax_scan(world, case, prepared):
    import jax.numpy as jnp

    from crs_tpu.ops.pq import PQCodebook, ResidualPQ
    from crs_tpu.parallel.mesh import corpus_mesh
    from crs_tpu.parallel.sharded_index import (
        shard_corpus, sharded_topk, sharded_topk_int8, sharded_topk_residual_pq,
    )

    name, route, masked = case
    mesh = corpus_mesh(world)
    q = jnp.asarray(prepared["scan_queries"])
    if name == "fp32_k_past_shard":
        vec, n = shard_corpus(prepared["scan_vectors"][:64], mesh)
        return sharded_topk(vec, q, 20, n, mesh)
    kw = {"block_size": SCAN_BLOCK if route == "kernel" else 4096}
    if masked:
        mask = np.zeros((-(-SCAN_ROWS // world) * world,), bool)
        mask[:SCAN_ROWS] = prepared["scan_mask"]
        kw["row_mask"] = jnp.asarray(mask)
    if name in ("fp32", "bf16"):
        vec, _ = shard_corpus(prepared["scan_vectors"], mesh)
        if name == "bf16":
            vec = vec.astype(jnp.bfloat16)
        return sharded_topk(vec, q, K, SCAN_VALID, mesh, **kw)
    codes, _ = shard_corpus(prepared["scan_codes"], mesh)
    scales, _ = shard_corpus(prepared["scan_scales"], mesh)
    if name == "int8":
        return sharded_topk_int8(codes, scales, q, K, SCAN_VALID, mesh, rescore_k=16, **kw)
    rpq = ResidualPQ(rotation=jnp.asarray(prepared["rot"]), coarse=jnp.asarray(prepared["coarse"]),
                     codebook=PQCodebook(jnp.asarray(prepared["centroids"])))
    ext, _ = shard_corpus(prepared["scan_ext"], mesh)
    mirror = (codes, scales) if name == "rpq_int8" else (None, None)
    return sharded_topk_residual_pq(rpq, ext, *mirror, q, K, SCAN_VALID, mesh, rescore_k=16,
                                    **kw)


def _assert_topk(got, ref):
    """Scores within 1e-5·(1+|s|); an id may differ only where its score
    ties (within that tolerance) another entry of the reference's row."""
    (gs, gi), (rs, ri) = got, (np.asarray(ref[0], np.float32), np.asarray(ref[1]))
    assert gs.shape == rs.shape and gi.shape == ri.shape
    tol = 1e-5 * (1 + np.abs(rs))
    np.testing.assert_array_less(np.abs(gs - rs), tol + 1e-12)
    for b, j in zip(*np.nonzero(gi != ri)):
        tied = np.abs(rs[b] - rs[b, j]) <= tol[b, j]
        assert gi[b, j] in ri[b][tied] or rs[b, j] <= -1e29, (b, j, gi[b], ri[b], rs[b])


@pytest.mark.parametrize("world", WORLDS)
def test_shard_corpus_layout(port_runs, prepared, world):
    from crs_tpu.parallel.mesh import corpus_mesh
    from crs_tpu.parallel.sharded_index import shard_corpus

    shape, n, local = port_runs[world]["layout"]
    arr, jn = shard_corpus(prepared[0]["scan_vectors"], corpus_mesh(world))
    per = -(-SCAN_ROWS // world)
    assert n == jn == SCAN_ROWS and shape == (per, D) and arr.shape == (per * world, D)
    np.testing.assert_array_equal(local, np.asarray(arr)[:per])  # rank 0's rows


@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{'mask' if c[2] else 'all'}")
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_scans_match_crs_tpu(runs, world, case):
    _assert_topk(runs[0][world]["scans"][case], runs[1][(world, case)])


def _jax_store_results(prepared, world):
    """crs_tpu's mesh stores on ``world`` devices and their results, in the
    workers' order of operations."""
    from crs_tpu.parallel.mesh import corpus_mesh
    from crs_tpu.rag.index import VectorStore
    from crs_tpu.rag.retrieval import ContextRetriever

    x, q, texts, mds, queries = _store_data()
    out = {}
    for name, cfg in STORE_FORMATS.items():
        if name.startswith("pq"):
            store = prepared[2][(world, name)]
            n0 = STORE_N
        else:
            n0 = 300
            store = VectorStore(dict(STORE_BASE, **cfg), mesh=corpus_mesh(world))
            store.create_index(texts[:n0], x[:n0])
            store.metadatas = [dict(m) for m in mds[:n0]]
        res = {("search", bool(w)): store.search_batch(q, top_k=K, where=w)
               for w in (None, WHERE)}
        if name in RETRIEVE_FORMATS:
            retr = ContextRetriever(store, _FixedEmbed(q, as_jax=True), dict(RETRIEVER))
            res["retrieve"] = _hits(retr.retrieve_batch(queries))
        res["vectors"] = store.get_vectors(np.array([0, 7, n0 - 1]))
        res["stats"] = store.get_stats()
        res["padded_before"] = store._padded_rows()
        lo = n0
        for m in (STORE_ADD if not name.startswith("pq") else (50,)):
            store.add(texts[lo:lo + m], x[lo:lo + m])
            store.metadatas[lo:lo + m] = [dict(md) for md in mds[lo:lo + m]]
            lo += m
        res["padded_after"] = store._padded_rows()
        res["added"] = store.search_batch(q, top_k=K)
        res["added_vectors"] = store.get_vectors(np.array([n0, lo - 1]))
        out[(world, name)] = res
    return out


def _assert_hits(got, ref, atol=1e-5):
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in ref]
    for g, r in zip(got, ref):
        for hg, hr in zip(g, r):
            assert hg[1] == hr[1]
            assert abs(hg[2] - hr[2]) <= atol and abs(hg[3] - hr[3]) <= atol
    assert sum(len(r) for r in ref) > 0


@pytest.mark.parametrize("fmt", sorted(STORE_FORMATS))
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_store_search_matches_crs_tpu(port_runs, jax_stores, world, fmt):
    got, ref = port_runs[world]["stores"][fmt], jax_stores[(world, fmt)]
    for where in (False, True):
        _assert_topk(got[("search", where)], ref[("search", where)])
    mds = _store_data()[3]
    assert all(mds[i]["page_number"] == 2 for i in got[("search", True)][1].ravel())
    np.testing.assert_allclose(got["vectors"], ref["vectors"], atol=1e-6)
    assert got["stats"] == ref["stats"]


@pytest.mark.parametrize("fmt", sorted(STORE_FORMATS))
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_store_add_across_a_regrow(port_runs, jax_stores, world, fmt):
    got, ref = port_runs[world]["stores"][fmt], jax_stores[(world, fmt)]
    assert (got["padded_before"], got["padded_after"]) == (ref["padded_before"],
                                                            ref["padded_after"])
    assert got["padded_after"] > got["padded_before"]  # per grew: rows moved between ranks
    _assert_topk(got["added"], ref["added"])
    np.testing.assert_allclose(got["added_vectors"], ref["added_vectors"], atol=1e-6)


@pytest.mark.parametrize("fmt", RETRIEVE_FORMATS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_store_retrieve_matches_crs_tpu(port_runs, jax_stores, world, fmt):
    got, ref = port_runs[world]["stores"][fmt], jax_stores[(world, fmt)]
    _assert_hits(got["retrieve"], ref["retrieve"])
    _assert_hits(got["retrieve_fused"], ref["retrieve"])  # a mesh store is served unfused


@pytest.mark.parametrize("fmt", sorted(STORE_FORMATS))
@pytest.mark.parametrize("world", WORLDS)
def test_saved_mesh_index_loads_in_either_package(port_runs, prepared, world, fmt):
    """The port's mesh store's index loads into crs_tpu's mesh store
    (answering as the port's did) and into both packages' single-device
    stores (answering alike); crs_tpu's mesh pq index (loaded sharded by the
    workers) loads into both single-device stores too."""
    from crs_tpu.parallel.mesh import corpus_mesh
    from crs_tpu.rag.index import VectorStore as JStore
    from crs_tpu_torch.rag.index import VectorStore

    q = _store_data()[1]
    got = port_runs[world]["stores"][fmt]
    cfg = dict(STORE_BASE, **STORE_FORMATS[fmt])
    store = JStore(cfg, mesh=corpus_mesh(world))
    store.load(got["saved"])
    _assert_topk(got["added"], store.search_batch(q, top_k=K))
    paths = [got["saved"]] + ([prepared[0]["pq_dirs"][(world, fmt)]] if fmt.startswith("pq")
                              else [])
    for path in paths:
        jstore, port = JStore(cfg), VectorStore(cfg, device="cpu")
        jstore.load(path)
        port.load(path)
        assert port._padded_rows() == jstore._padded_rows()
        _assert_topk(tuple(t.numpy() for t in port.search_batch(q, top_k=K)),
                     jstore.search_batch(q, top_k=K))
