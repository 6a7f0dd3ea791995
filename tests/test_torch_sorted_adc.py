"""The port's sorted residual-ADC route against ``crs_tpu``'s.

``crs_tpu`` runs as ``tests/test_sorted_adc.py`` runs it: residual PQ
trained by JAX at 6,000 × 64 (M = 8, K = 16, C = 256) and
``pallas_topk_residual_pq_adc_sorted`` in Pallas interpret mode. The port
runs its plain torch versions (the CUDA kernel's CPU counterpart) through
the same host side.

Tolerances:
- the layout helpers (``sort_codes_by_coarse``, ``adc_auto_group``,
  ``plan_sorted_coarse_windows``): equal arrays, the same None;
- the sorted scan given JAX's LUTs (``_luts`` entry point): scores bit for
  bit and ids identical, as for kernel 3;
- the sorted scan against the unsorted one: scores bit for bit; ids, mapped
  back through the sort permutation, equal as sets within each group of
  exactly tied scores (the sorted scan breaks ties by the lowest SORTED
  position);
- the store, each package computing its own LUTs: ids identical, scores
  within 1e-5 absolute (the f32 LUT products run in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


N, D, NQ, M, KC = 6000, 64, 5, 8, 16


def _t(x):
    return torch.from_numpy(np.array(x))


@jax.jit
def _jax_luts(q, rot, coarse, cents):
    """The LUT products exactly as the JAX wrappers compute them."""
    qr = jnp.dot(q, rot, preferred_element_type=jnp.float32)
    cl = jnp.dot(qr, coarse.T, preferred_element_type=jnp.float32)
    sub = qr.reshape(q.shape[0], cents.shape[0], q.shape[1] // cents.shape[0])
    return cl, jnp.einsum("bmd,mkd->bmk", sub, cents, preferred_element_type=jnp.float32)


@pytest.fixture(scope="module")
def rpq_setup():
    """``tests/test_sorted_adc.py``'s state: a clustered corpus, residual PQ
    trained by JAX, its codes sorted by coarse id, and JAX's LUTs."""
    from crs_tpu.ops.pq import (
        residual_codes_ext, residual_pq_encode, sort_codes_by_coarse, train_residual_pq,
    )

    rng = np.random.default_rng(11)
    centers = rng.standard_normal((40, D)).astype(np.float32) * 2.0
    v = centers[rng.integers(40, size=N)] + rng.standard_normal((N, D)).astype(np.float32) * 0.3
    rpq = train_residual_pq(jax.random.PRNGKey(2), jnp.asarray(v), coarse_clusters=256,
                            num_subspaces=M, num_clusters=KC, num_iters=3, opq_iters=1,
                            coarse_iters=3)
    cids, codes = residual_pq_encode(rpq, jnp.asarray(v))
    ext = np.asarray(residual_codes_ext(cids, codes))
    sorted_ext, perm, counts = sort_codes_by_coarse(ext, 256)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    cl, lut = (np.asarray(a) for a in _jax_luts(jnp.asarray(q), rpq.rotation, rpq.coarse,
                                                rpq.codebook.centroids))
    return dict(rpq=rpq, ext=ext, sorted_ext=sorted_ext, perm=perm, counts=counts, q=q, cl=cl,
                lut=lut, mask=rng.random(N) < 0.7)


# -- the layout helpers ---------------------------------------------------------

def test_sort_codes_by_coarse_matches_crs_tpu():
    from crs_tpu.ops.pq import sort_codes_by_coarse as jax_sort
    from crs_tpu_torch.ops.pq import sort_codes_by_coarse

    rng = np.random.default_rng(0)
    ext = rng.integers(0, 256, size=(500, 6)).astype(np.uint8)
    ext[:, 0] = rng.integers(0, 2, size=500)  # coarse ids < 512
    for arg in (ext, torch.from_numpy(ext)):
        got = sort_codes_by_coarse(arg, 512)
        for g, r in zip(got, jax_sort(ext, 512)):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    assert got[1].dtype == np.int32 and got[2].dtype == np.int64
    with pytest.raises(ValueError, match="num_coarse"):
        sort_codes_by_coarse(ext, 300)
    with pytest.raises(ValueError, match="num_coarse"):
        jax_sort(ext, 300)


PLAN_CASES = {  # name: (counts, n, block_size, group)
    "clustered_g1": ("setup", N, 512, 1),
    "clustered_g2": ("setup", N, 512, 2),
    "clustered_g4": ("setup", N, 256, 4),
    "fragmented_refused": (np.ones(4096, np.int64), 4096, 2048, 1),
    "padding_tile": ("one_cluster", 100, 2048, 1),
    "padding_tail_tiles": ("one_cluster", 100, 32, 2),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_planner_matches_crs_tpu(rpq_setup, case):
    from crs_tpu.ops.pallas_scan import plan_sorted_coarse_windows as jax_plan
    from crs_tpu_torch.ops.scan import plan_sorted_coarse_windows

    counts, n, bs, group = PLAN_CASES[case]
    if isinstance(counts, str):
        if counts == "setup":
            counts = rpq_setup["counts"]
        else:
            counts = np.zeros(256, np.int64)
            counts[0] = 100
    got, ref = plan_sorted_coarse_windows(counts, n, bs, group), jax_plan(counts, n, bs, group)
    if ref is None:
        assert got is None and case == "fragmented_refused"
        return
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="sum to n"):
        plan_sorted_coarse_windows(counts, n + 1, bs, group)


@pytest.mark.parametrize("geometry", [(6000, 5, 512, 10), (100_000, 328, 1024, 50),
                                      (1 << 20, 328, 1024, 50), (40_000, 3, 256, 18),
                                      (1 << 20, 200, 2048, 14)])
def test_adc_auto_group_matches_crs_tpu(geometry):
    from crs_tpu.ops.pallas_scan import adc_auto_group as jax_group
    from crs_tpu_torch.ops.scan import adc_auto_group

    assert adc_auto_group(*geometry) == jax_group(*geometry)


# -- the sorted scan (kernel 4's plain version and its host side) ---------------

BF16_LUT_ATOL, BF16_LUT_RTOL = 2e-3, 1e-3  # kernel (bf16 LUT) against f32 ADC scores


def _ids_agree_beyond(ref_s, ref_i, got_s, got_i, atol=BF16_LUT_ATOL, rtol=BF16_LUT_RTOL):
    """Per row, each side's ids scoring more than twice the tolerance above
    that side's k-th score are in the other side's top-k: two rankings of
    one top-k whose scores differ by at most the tolerance may swap only
    near the boundary."""
    for rs, ri, gs, gi in zip(ref_s, ref_i, got_s, got_i):
        tol = 2 * (atol + rtol * abs(rs[-1]))
        assert set(ri[rs > rs[-1] + tol]) <= set(gi)
        assert set(gi[gs > gs[-1] + tol]) <= set(ri)


SCAN_CASES = {  # name: (k, block_size, group, repair, masked, valid_n cut)
    "small_k_g1": (8, 512, 1, 256, False, 0),
    "small_k_g2": (8, 512, 2, 256, False, 0),
    "repair_g1": (48, 512, 1, 256, False, 0),
    "repair_g2_masked": (48, 256, 2, 256, True, 123),
    "fallback_over_budget": (48, 512, 1, 2, False, 0),
    "no_repair": (48, 512, 1, 0, True, 0),
    "mask_valid_n": (8, 512, 1, 256, True, 123),
}


def _jax_sorted(st, wbase, k, valid, bs, group, repair, mask):
    from crs_tpu.ops.pallas_scan import pallas_topk_residual_pq_adc_sorted

    rpq = st["rpq"]
    return pallas_topk_residual_pq_adc_sorted(
        rpq.rotation, rpq.coarse, rpq.codebook.centroids, jnp.asarray(st["sorted_ext"]),
        jnp.asarray(wbase), jnp.asarray(st["q"]), k, valid, block_size=bs,
        row_mask=None if mask is None else jnp.asarray(mask), repair=repair, group=group)


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_sorted_scan_matches_pallas(rpq_setup, case):
    from crs_tpu_torch.ops.scan import (
        STATS, plan_sorted_coarse_windows, scan_topk_residual_pq_adc_sorted_luts,
    )

    st = rpq_setup
    k, bs, group, repair, masked, cut = SCAN_CASES[case]
    valid = N - cut
    mask = st["mask"][st["perm"]] if masked else None  # the mask in sorted row order
    wbase = plan_sorted_coarse_windows(st["counts"], N, bs, group)
    assert wbase is not None
    ref_s, ref_i = _jax_sorted(st, wbase, k, valid, bs, group, repair, mask)
    STATS.reset()
    got_s, got_i = scan_topk_residual_pq_adc_sorted_luts(
        _t(st["cl"]), _t(st["lut"]), _t(st["sorted_ext"]), wbase, k, valid, block_size=bs,
        row_mask=None if mask is None else _t(mask), repair=repair, group=group)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert np.array_equal(got_s.numpy(), np.asarray(ref_s)), \
        np.abs(got_s.numpy() - np.asarray(ref_s)).max()
    if case.startswith("repair"):
        assert STATS.repairs == 1, vars(STATS)
    if case in ("fallback_over_budget", "no_repair"):
        assert STATS.fallbacks == 1, vars(STATS)
    if cut or masked:
        ok = got_i.numpy()[got_s.numpy() > -1e29]
        assert (ok < valid).all() and (mask is None or mask[ok].all())


def test_layout_budget_repairs_past_crs_tpu_budget(rpq_setup):
    """``layout_budget``: with ``kb`` from a 2-pair budget, ``crs_tpu``
    falls back; the port repairs within ``B·(k // kb)`` pairs. The repaired
    top-k ranks by the kernel's scores (bf16 LUT), the fallback by f32."""
    from crs_tpu_torch.ops.scan import (
        STATS, plan_sorted_coarse_windows, scan_topk_residual_pq_adc_sorted_luts,
    )

    st = rpq_setup
    k, bs = 48, 512
    wbase = plan_sorted_coarse_windows(st["counts"], N, bs, 1)
    ref_s, ref_i = (np.asarray(a) for a in _jax_sorted(st, wbase, k, N, bs, 1, 2, None))
    STATS.reset()
    got_s, got_i = scan_topk_residual_pq_adc_sorted_luts(
        _t(st["cl"]), _t(st["lut"]), _t(st["sorted_ext"]), wbase, k, N, block_size=bs,
        repair=2, group=1, layout_budget=True)
    assert (STATS.repairs, STATS.fallbacks) == (1, 0), vars(STATS)
    np.testing.assert_allclose(got_s.numpy(), ref_s, rtol=BF16_LUT_RTOL, atol=BF16_LUT_ATOL)
    _ids_agree_beyond(ref_s, ref_i, got_s.numpy(), got_i.numpy())


def test_hand_built_plan_gives_a_zero_coarse_term():
    """A plan that leaves ids outside their tile's 512-id window: those rows
    get a coarse term of exactly 0 in the Pallas kernel (their one-hot row is
    zero) and in the port. Random LUTs at C = 1024, one tile per block."""
    from crs_tpu.ops.pallas_scan import pallas_topk_residual_pq_adc_sorted
    from crs_tpu_torch.ops.scan import (
        ADC_QUERY_TILE, _pad_rows, adc_tables, block_topk_adc_sorted_plain,
        scan_topk_residual_pq_adc_sorted_luts,
    )

    rng = np.random.default_rng(5)
    c, n, bs, k = 1024, 2048, 256, 6
    rot = np.linalg.qr(rng.standard_normal((D, D)))[0].astype(np.float32)
    coarse = (rng.standard_normal((c, D)) * 0.3).astype(np.float32)
    cents = (rng.standard_normal((M, KC, D // M)) * 0.1).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    cid = rng.integers(0, c, n)
    ext = np.concatenate([(cid // 256)[:, None], (cid % 256)[:, None],
                          rng.integers(0, KC, (n, M))], 1).astype(np.uint8)
    wbase = np.array([0, 1, 2, 3, 1, 0, 2, 1], np.int32)  # windows that miss most ids
    ref = pallas_topk_residual_pq_adc_sorted(
        jnp.asarray(rot), jnp.asarray(coarse), jnp.asarray(cents), jnp.asarray(ext),
        jnp.asarray(wbase), jnp.asarray(q), k, n, block_size=bs, group=1)
    cl, lut = (np.asarray(a) for a in _jax_luts(jnp.asarray(q), jnp.asarray(rot),
                                                jnp.asarray(coarse), jnp.asarray(cents)))
    got = scan_topk_residual_pq_adc_sorted_luts(_t(cl), _t(lut), _t(ext), wbase, k, n,
                                                block_size=bs, group=1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    # the partials: a row outside its window scores exactly Σ lut + bias
    lut_bf, hi, lo = adc_tables(_pad_rows(_t(lut), ADC_QUERY_TILE),
                                torch.nn.functional.pad(_pad_rows(_t(cl), ADC_QUERY_TILE),
                                                        (0, 256)))
    outside = (cid - 256 * np.repeat(wbase, bs) < 0) | (cid - 256 * np.repeat(wbase, bs) >= 512)
    assert outside.mean() > 0.3
    bias = torch.full((n,), -1e30)
    row = int(np.flatnonzero(outside)[0])
    bias[row] = 0.0  # one allowed row: block row // bs emits it first
    out_s, out_i = block_topk_adc_sorted_plain(lut_bf, _t(ext), bias, 1, bs, hi, lo,
                                               _t(wbase), 1)
    want = torch.zeros(ADC_QUERY_TILE)
    for mi in range(M):
        want = want + lut_bf[:, mi, int(ext[row, 2 + mi])].float()
    assert int(out_i[0, row // bs, 0, 0]) == row
    assert torch.equal(out_s[0, row // bs, 0], want)


@pytest.mark.parametrize("k", [8, 16])
def test_sorted_kernel_equals_unsorted_kernel(rpq_setup, k):
    """Kernel 4 against kernel 3 on the same rows (their plain versions):
    with kb = k every block emits its own top-k, so the merged top-k is
    exact under the kernels' scores in both layouts. Scores bit for bit,
    ids equal through the permutation up to exact ties. (The scans' repairs
    rescore the coarse term in full f32 in whichever blocks they flag, and
    the two layouts flag different blocks.)"""
    from crs_tpu_torch.ops.scan import (
        ADC_QUERY_TILE, _bias_row, _finalize, _pad_rows, adc_auto_group, adc_tables,
        block_topk_adc, block_topk_adc_sorted, plan_sorted_coarse_windows,
    )

    st = rpq_setup
    bs = 512
    group = adc_auto_group(N, NQ, bs, M + 2)
    wbase = _t(plan_sorted_coarse_windows(st["counts"], N, bs, group))
    cl = torch.nn.functional.pad(_pad_rows(_t(st["cl"]), ADC_QUERY_TILE), (0, 256))
    lut_bf, hi, lo = adc_tables(_pad_rows(_t(st["lut"]), ADC_QUERY_TILE), cl)
    ext_u = _pad_rows(_t(st["ext"]), group * bs)
    ext_s = _pad_rows(_t(st["sorted_ext"]), group * bs)
    bias = _bias_row(ext_u.shape[0], N, None, "cpu")
    su, iu = _finalize(*block_topk_adc(lut_bf, ext_u, bias, k, bs, hi, lo), NQ, k)
    ss, is_ = _finalize(*block_topk_adc_sorted(lut_bf, ext_s, bias, k, bs, hi, lo, wbase, group),
                        NQ, k)
    assert torch.equal(ss, su)
    mapped = st["perm"][is_.numpy()]
    for row_s, row_u, row_m in zip(su.numpy(), iu.numpy(), mapped):
        for v in np.unique(row_s):
            tied = row_s == v
            assert set(row_u[tied]) == set(row_m[tied])


# -- the store ------------------------------------------------------------------

STORE_N, STORE_D = 4096, 64
STORE_CFG = {"format": "pq", "block_size": 512, "pq_subspaces": 8, "pq_coarse_clusters": 256,
             "pq_iters": 8, "pq_opq_iters": 1, "rescore_k": 32}


def _store_data():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((30, STORE_D)).astype(np.float32)
    x = centers[rng.integers(30, size=STORE_N)] + 0.2 * rng.standard_normal(
        (STORE_N, STORE_D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:6] + 0.01 * rng.standard_normal((6, STORE_D)).astype(np.float32)
    extra = rng.standard_normal((200, STORE_D)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    return x, q, extra, rng.random(STORE_N) < 0.6


@pytest.fixture(scope="module")
def saved_store(tmp_path_factory):
    """A residual pq store built and saved by ``crs_tpu``."""
    from crs_tpu.rag.index import VectorStore

    x, _, _, _ = _store_data()
    store = VectorStore(dict(STORE_CFG))
    store.create_index([f"t{i}" for i in range(STORE_N)], x)
    path = tmp_path_factory.mktemp("pq_sorted")
    store.save(str(path))
    return str(path)


def _kernel_route(monkeypatch):
    """Both stores on their kernel route at ≥ 4·block_size rows (the port's
    kernels through their plain versions, ``crs_tpu``'s in interpret mode)."""
    from crs_tpu.rag.index import VectorStore as JStore
    from crs_tpu_torch.rag.index import VectorStore

    monkeypatch.setattr(JStore, "_use_pallas", lambda self: True)
    monkeypatch.setattr(VectorStore, "_scan_here", lambda self, rows: rows >= 4 * self.block_size)


def _pair(path, sorted_flag=True):
    from crs_tpu.rag.index import VectorStore as JStore
    from crs_tpu_torch.rag.index import VectorStore

    cfg = dict(STORE_CFG, pq_sorted=sorted_flag)
    j = JStore(cfg)
    j.load(path)
    p = VectorStore(cfg, device="cpu")
    p.load(path)
    return j, p


@pytest.mark.parametrize("masked", [False, True])
def test_store_pq_sorted_matches_crs_tpu(saved_store, monkeypatch, masked):
    """Both packages' ``pq_sorted`` stores on one saved state: the sorted
    candidates (ids through the permutation, the mask permuted with them)
    and the int8-rescored search."""
    _kernel_route(monkeypatch)
    x, q, _, mask_n = _store_data()
    j, p = _pair(saved_store)
    mask = np.zeros(j._padded_rows(), bool)
    mask[:STORE_N] = mask_n
    jm = jnp.asarray(mask) if masked else None
    pm = _t(mask) if masked else None
    js, ji = j._pq_adc_candidates(jnp.asarray(q), 10, row_mask=jm)
    ps, pi = p._pq_adc_candidates(_t(q), 10, row_mask=pm)
    assert j._pq_sorted_cache is not None and p._pq_sorted_cache is not None
    np.testing.assert_array_equal(p._pq_sorted_cache[1].numpy(), np.asarray(j._pq_sorted_cache[1]))
    group = next(iter(p._pq_wbase))
    np.testing.assert_array_equal(p._pq_wbase[group].numpy(), j._pq_wbase[group])
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    if masked:
        assert mask[pi.numpy()].all()
    js, ji = j.search_batch_dev(jnp.asarray(q), 5)
    ps, pi = p.search_batch_dev(_t(q), 5)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    assert (pi[:, 0].numpy() == np.arange(6)).all()


def test_store_sorted_route_equals_unsorted_and_refusal_falls_back(saved_store, monkeypatch):
    """The port's sorted route ranks as the unsorted route: candidate scores
    within 1e-5 (each route's repair rescores the coarse term in full f32 in
    the blocks it flags, and the layouts flag different blocks), the
    rescored search identical; a refused plan takes the unsorted scan and is
    remembered per group."""
    from crs_tpu_torch.rag import index as port_index

    _kernel_route(monkeypatch)
    _, q, _, _ = _store_data()
    _, p_sorted = _pair(saved_store, True)
    _, p_plain = _pair(saved_store, False)
    ss, _ = p_sorted._pq_adc_candidates(_t(q), 10)
    us, ui = p_plain._pq_adc_candidates(_t(q), 10)
    np.testing.assert_allclose(ss.numpy(), us.numpy(), atol=1e-5)
    fs, fi = p_sorted.search_batch_dev(_t(q), 5)
    gs, gi = p_plain.search_batch_dev(_t(q), 5)
    assert torch.equal(fs, gs) and torch.equal(fi, gi)
    _, p_refused = _pair(saved_store, True)
    monkeypatch.setattr(port_index, "plan_sorted_coarse_windows", lambda *a: None)

    def must_not_run(*args, **kwargs):
        raise AssertionError("a refused plan must not reach the sorted scan")

    monkeypatch.setattr(port_index, "scan_topk_residual_pq_adc_sorted", must_not_run)
    rs, ri = p_refused._pq_adc_candidates(_t(q), 10)
    assert torch.equal(rs, us) and torch.equal(ri, ui)
    assert list(p_refused._pq_wbase.values()) == [None]


def test_store_pq_sorted_cache_cleared_on_add(saved_store, monkeypatch):
    """``add`` drops the sorted layout (a stale permutation would return
    wrong ids); the next search rebuilds it, and both packages agree."""
    _kernel_route(monkeypatch)
    x, q, extra, _ = _store_data()
    j, p = _pair(saved_store)
    for store, qq in ((j, jnp.asarray(q)), (p, _t(q))):
        store._pq_adc_candidates(qq, 5)
        assert store._pq_sorted_cache is not None
        store.add([f"n{i}" for i in range(64)], extra[:64])
        assert store._pq_sorted_cache is None and store._pq_wbase == {}
    qe = np.concatenate([q[:2], extra[:3]])
    js, ji = j._pq_adc_candidates(jnp.asarray(qe), 5)
    ps, pi = p._pq_adc_candidates(_t(qe), 5)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    assert p._pq_sorted_cache[0].shape[0] == STORE_N + 64
    assert (pi[2:, 0].numpy() == STORE_N + np.arange(3)).all()


def _clustered_store_data():
    """16,384 rows around 200 centres and 64 queries near rows 0..63: each
    query's top 64 crowd into the few sorted blocks of its coarse ids."""
    rng = np.random.default_rng(7)
    n, d = 16384, 32
    centers = rng.standard_normal((200, d)).astype(np.float32)
    x = centers[rng.integers(200, size=n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:64] + 0.05 * rng.standard_normal((64, d)).astype(np.float32)
    return x, q


CLUSTERED_CFG = {"format": "pq", "block_size": 512, "pq_subspaces": 4,
                 "pq_coarse_clusters": 256, "pq_iters": 4, "pq_opq_iters": 1}


def test_sorted_layout_repairs_where_crs_tpu_falls_back(tmp_path, monkeypatch):
    """Why the sorted route sizes its own repair budget: sorting puts a
    query's neighbours, which share coarse ids, into a few consecutive
    blocks, so more (query, block) pairs flag their ceilings than
    ``crs_tpu``'s 256-pair budget takes and its exact fallback rescans the
    corpus, where the unsorted layout repairs. With ``crs_tpu``'s budget the
    port falls back too, to the same candidates; the port's store repairs
    within ``B·(k // kb)`` pairs instead (``kb`` still ``crs_tpu``'s). Its
    candidates rank by the kernel's scores, not the fallback's f32 ones, so
    they agree within the bf16 LUT's rounding, and the int8-rescored search
    equals ``crs_tpu``'s."""
    from crs_tpu.rag.index import VectorStore as JStore
    from crs_tpu_torch.ops.scan import STATS
    from crs_tpu_torch.rag import index as port_index
    from crs_tpu_torch.rag.index import VectorStore

    _kernel_route(monkeypatch)
    x, q = _clustered_store_data()
    cfg = dict(CLUSTERED_CFG, pq_sorted=True)
    j = JStore(cfg)
    j.create_index([f"t{i}" for i in range(x.shape[0])], x)
    j.save(str(tmp_path))
    p = VectorStore(cfg, device="cpu")
    p.load(str(tmp_path))
    js, ji = (np.asarray(a) for a in j._pq_adc_candidates(jnp.asarray(q), 64))

    def candidates(store, sorted_flag):
        store.pq_sorted = sorted_flag
        STATS.reset()
        s, i = store._pq_adc_candidates(_t(q), 64)
        return s.numpy(), i.numpy(), (STATS.repairs, STATS.fallbacks)

    assert candidates(p, False)[2] == (1, 0)  # insertion order: the budget holds
    s, i, counts = candidates(p, True)
    assert counts == (1, 0), counts  # the layout's budget: repaired, no fallback
    # the kernels' bf16 LUT against f32
    np.testing.assert_allclose(s, js, rtol=BF16_LUT_RTOL, atol=BF16_LUT_ATOL)
    _ids_agree_beyond(js, ji, s, i)
    orig = port_index.scan_topk_residual_pq_adc_sorted
    monkeypatch.setattr(port_index, "scan_topk_residual_pq_adc_sorted",
                        lambda *a, **kw: orig(*a, **{**kw, "layout_budget": False}))
    s_fb, i_fb, counts = candidates(p, True)
    assert counts == (0, 1), counts  # crs_tpu's budget: the dense f32 fallback, as crs_tpu
    np.testing.assert_allclose(s_fb, js, atol=1e-5)  # each package's own f32 LUTs
    _ids_agree_beyond(js, ji, s_fb, i_fb, atol=1e-5, rtol=0.0)
    monkeypatch.setattr(port_index, "scan_topk_residual_pq_adc_sorted", orig)
    js, ji = j.search_batch_dev(jnp.asarray(q), 5)
    ps, pi = p.search_batch_dev(_t(q), 5)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
