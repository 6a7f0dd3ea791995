"""ROADMAP §3's card-only refusals, repaired in the kernels: every shape
``crs_tpu`` sends to a Pallas kernel launches the port's CUDA kernel, and
the port routes exactly as ``crs_tpu`` does.

- Store scans: kernel 1 takes any D (it streams the queries in slices and
  zero-fills a ragged D itself), kernel 2 any D (bf16 zero-padded to a
  multiple of 8 by ``scan_topk``), the ADC kernels any M ≤ 256-cluster
  table (fewer queries per CUDA block, or the LUTs staged in slices of
  subspaces, when a tile's tables do not fit in shared memory).
- q4 / NF4 groups off the kernel's 16-row step are taken by the kernel
  itself (``tests/test_torch_qgemm.py`` and ``test_torch_guard.py``).
- Decode attention: every head dim a multiple of 128 (past 512 the kernel
  reads a row in 512-byte segments), any number of query heads per kv-head
  (zero heads padded to a built count, ``launch_groups``), any S.

The wrappers are held with the guard's patched launchers (meta tensors, no
card). The stores run on the CPU with the kernel route forced (``_scan_here``
patched: the CPU plays the card, so each scan runs its kernel's plain
version) against ``crs_tpu``'s store on the same numpy inputs. Tolerances:
ids identical; scores within 1e-5 absolute (fp32, int8, pq; float32 sums in
another order) and 1e-2·(1 + |s|) (bf16); decode attention as
``tests/test_torch_decode_attention.py`` states it.
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


class _FakeKernels:
    """Stands in for a loaded kernel library: records each launcher's calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return 0

        return launch


@pytest.fixture
def fake_scans(monkeypatch):
    """Non-CPU (meta) tensors reach the scan kernels' launchers."""
    from crs_tpu_torch.ops import scan

    lib = _FakeKernels()
    monkeypatch.setattr(scan, "_load_kernel_lib", lambda source: lib)
    monkeypatch.setattr(scan, "_load_lib", lambda: lib)
    monkeypatch.setattr(scan, "_stream_handle", lambda device: 0)
    monkeypatch.setattr(scan, "_adc_grid_x", lambda nblocks, nq, dev: 4)
    return scan, lib


def _accepts(fn, *args) -> bool:
    try:
        fn(*args)
    except ValueError:
        return False
    return True


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- the wrappers launch every shape ---------------------------------------------

@pytest.mark.parametrize("d", [1, 15, 16, 100, 1040, 2047, 2048, 2049, 3072])
def test_kernel_1_takes_every_width(fake_scans, d):
    """Kernel 1 launches at any D, the corpus as it is (no padded copy)."""
    scan, lib = fake_scans
    scan.block_topk_int8(_meta((64, d), torch.int8), _meta((512, d), torch.int8),
                         _meta((512,)), _meta((512,)), 3)
    assert len(lib.calls) == 1 and lib.calls[0][1][8] == d


@pytest.mark.parametrize("d", [1, 33, 100, 104, 384, 3072, 4096, 16384, 16385, 20000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_2_takes_every_width(fake_scans, dtype, d):
    """Kernel 2 launches at any fp32 D and at any bf16 D once ``scan_topk``
    has zero-padded it to a multiple of 8."""
    scan, lib = fake_scans
    dp = -(-d // 8) * 8 if dtype == torch.bfloat16 else d  # scan_topk's padding
    scan.block_topk_float(_meta((64, dp), dtype), _meta((1024, dp), dtype), _meta((1024,)), 3, 512)
    assert len(lib.calls) == 1 and lib.calls[0][1][9] == dp
    if dp != d:
        with pytest.raises(ValueError):
            scan.block_topk_float(_meta((64, d), dtype), _meta((1024, d), dtype),
                                  _meta((1024,)), 3, 512)


@pytest.mark.parametrize("m", [8, 48, 51, 52, 64, 96])
@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("coarse", [None, 256, 2048, 65536, 65792, 300])
def test_adc_kernels_take_every_table(fake_scans, m, k, coarse):
    """Kernels 3 and 5 launch at any M and K ≤ 256 (past shared memory the
    kernel takes fewer queries per CUDA block); the only refusal left is a
    coarse table past two-byte ids, which ``crs_tpu``'s gate (C a multiple
    of 256 up to 65,536) keeps from the kernel in both packages."""
    scan, lib = fake_scans
    residual = coarse is not None
    args = [_meta((8, m, k), torch.bfloat16), _meta((1024, m + (2 if residual else 0)),
                                                    torch.uint8), _meta((1024,)), 3, 512]
    if residual:
        args += [_meta((8, coarse), torch.bfloat16)] * 2
    ok = _accepts(scan.block_topk_adc, *args)
    assert ok == (not residual or coarse <= 65536)
    assert len(lib.calls) == int(ok)
    if ok:
        plan = scan.adc_layout(m, k, residual)
        assert lib.calls[0][1][10:12] == (m, k)
        assert lib.calls[0][1][14:17] == (plan.queries, plan.subspaces, int(plan.skewed))


@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("residual", [True, False])
def test_adc_plan_takes_the_skewed_main_path_where_it_fits(fake_scans, k, residual):
    """``adc_layout`` is the one plan of the ADC kernels, and the launchers
    get it as it is (qt, ms, skew; the launcher checks that it fits): the
    skewed main path (8 queries, all M) wherever it fits in a CUDA block's
    shared memory, M ≤ 48 at K = 256; then 8 queries unskewed (M 49–51),
    fewer queries, or LUT slices. Every M gets a plan that fits; the
    sorted launcher gets the residual plan."""
    from crs_tpu_torch.ops.scan import ADC_QUERY_TILE, ADC_SMEM_LIMIT, adc_layout

    scan, lib = fake_scans
    for m in range(1, 400):
        p = adc_layout(m, k, residual)
        assert 0 < p.smem <= ADC_SMEM_LIMIT and p.queries in (1, 2, 4, 8)
        assert 1 <= p.subspaces <= m and (p.subspaces == m or p.queries == ADC_QUERY_TILE)
        assert not p.skewed or (p.queries, p.subspaces) == (ADC_QUERY_TILE, m)
    if k == 256:
        assert all(adc_layout(m, k, residual).skewed for m in range(1, 49))
        assert [adc_layout(m, k, residual)[:2] for m in (49, 50, 51, 52)] == \
            [(8, 49), (8, 50), (8, 51), (4, 52)]
        assert adc_layout(320, k, residual)[:2] == (8, 51)
    else:
        assert adc_layout(256, k, residual).skewed and not adc_layout(399, k, residual).skewed
    for m in (8, 48, 49, 52, 320):
        p = adc_layout(m, k, residual)
        want = (p.queries, p.subspaces, int(p.skewed))
        cols = m + (2 if residual else 0)
        extra = [_meta((8, 512), torch.bfloat16)] * 2 if residual else []
        scan.block_topk_adc(_meta((8, m, k), torch.bfloat16), _meta((1024, cols), torch.uint8),
                            _meta((1024,)), 3, 512, *extra)
        assert lib.calls[-1][0] == ("adc_scan_topk_residual_launch" if residual
                                    else "adc_scan_topk_plain_launch")
        assert lib.calls[-1][1][14:17] == want
        if residual:
            scan.block_topk_adc_sorted(_meta((8, m, k), torch.bfloat16),
                                       _meta((1024, cols), torch.uint8), _meta((1024,)), 3, 512,
                                       _meta((8, 768), torch.bfloat16),
                                       _meta((8, 768), torch.bfloat16),
                                       _meta((2,), torch.int32), 1)
            assert lib.calls[-1][0] == "adc_scan_topk_sorted_launch"
            assert lib.calls[-1][1][16:19] == want


@pytest.mark.parametrize("nq", [1, 2, 5, 16, 41, 64])
@pytest.mark.parametrize("nblocks", [1, 4, 8, 1024, 1088])
def test_adc_grid_fills_the_waves(nq, nblocks):
    """``adc_grid_x``: a count of CUDA blocks along the corpus within [1,
    nblocks], near 8 per SM over the query tiles, whose waves on 132 SMs
    are at least as full as the old rule's (⌈8·132 / nq⌉), and 99 % full at
    the main shape (41 tiles × 1,024 blocks)."""
    from crs_tpu_torch.ops.scan import adc_grid_x

    def fill(gx):
        per = -(-nblocks // gx)
        return nblocks * nq / (-(-(-(-nblocks // per)) * nq // 132) * 132 * per)

    base = max(1, min(nblocks, -(-8 * 132 // nq)))
    gx = adc_grid_x(nblocks, nq, 132)
    assert 1 <= gx <= nblocks and base // 2 <= gx <= 2 * base
    assert fill(gx) >= fill(base)
    if (nq, nblocks) == (41, 1024):
        assert gx == 32 and fill(gx) > 0.99


@pytest.mark.parametrize("hd", [64, 128, 256, 512, 640, 1024])
@pytest.mark.parametrize("g", [1, 2, 3, 5, 6, 7, 8, 9, 16])
@pytest.mark.parametrize("s", [128, 2176, 131072, 131200])
def test_kernel_10_takes_every_gated_shape(monkeypatch, hd, g, s):
    """The wrapper launches wherever ``crs_tpu``'s gate sends a step to its
    kernel (hd and S multiples of 128, hd past 512 included), with G's heads
    padded to ``launch_groups(G)``, and returns G heads; the launch carries
    the head dim."""
    from crs_tpu_torch.ops import decode_attention as da

    lib = _FakeKernels()
    monkeypatch.setattr(da, "load_library", lambda source, launchers: lib)
    monkeypatch.setattr(da, "stream_handle", lambda device: 0)
    monkeypatch.setattr(da, "sm_count", lambda dev: 132)
    b, hkv = 1, 2
    ops = (_meta((b, hkv, g, hd)), _meta((b, hkv, s, hd), torch.int8), _meta((b, hkv, s)),
           _meta((b, hkv, s, hd), torch.int8), _meta((b, hkv, s)), _meta((b, s), torch.bool))
    try:
        out = da.decode_attention_int8(*ops)
    except ValueError:
        out = None
    assert (out is not None) == da.decode_attention_supported(hd, s) == (hd != 64)
    if out is not None:
        assert out.shape == (b, hkv, g, hd)
        args = lib.calls[0][1]
        launched_g, rows, nchunk, launched_hd = args[13], args[15], args[16], args[17]
        assert launched_g == da.launch_groups(g) and launched_hd == hd
        assert launched_g >= g and (launched_g in da.KERNEL_GROUPS or launched_g % 8 == 0)
        assert rows <= da.MAX_CHUNK_ROWS and (nchunk - 1) * rows < s <= nchunk * rows


# -- the store: off-multiple and past-the-limit D, past-the-LUT M -------------

N, NQ, K = 2048, 8, 4
BLOCK = 256  # 8 blocks: past the 4-block kernel threshold


def _data(d, seed=5):
    rng = np.random.default_rng(seed + d)
    centers = rng.standard_normal((24, d)).astype(np.float32)
    x = centers[rng.integers(0, 24, N)] + 0.5 * rng.standard_normal((N, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(N, NQ, replace=False)] + 0.05 * rng.standard_normal((NQ, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q.astype(np.float32)


def _card_store(cfg, monkeypatch):
    """A port store on the CPU that routes as the card does."""
    from crs_tpu_torch.rag.index import VectorStore

    store = VectorStore(dict(cfg), device="cpu")
    monkeypatch.setattr(store, "_scan_here", lambda rows: rows >= 4 * store.block_size)
    return store


@pytest.mark.parametrize("d", [100, 3072])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8"])
def test_store_scans_off_multiple_and_wide_d_like_crs_tpu(monkeypatch, fmt, d):
    """The kernel's route at D 100 and 3,072 in every format: ids equal to
    ``crs_tpu``'s, scores within tolerance; only a bf16 corpus is padded
    (to TMA's multiple of 8), and the store keeps its own D."""
    from crs_tpu.rag.index import VectorStore as JStore

    from crs_tpu_torch.ops import scan

    seen = []
    for name in ("block_topk_float_plain", "block_topk_int8_plain"):
        plain = getattr(scan, name)
        monkeypatch.setattr(scan, name, lambda *a, _p=plain, **kw: seen.append(
            tuple(a[1].shape)) or _p(*a, **kw))
    x, q = _data(d)
    cfg = {"format": fmt, "block_size": BLOCK, "rescore_k": 32}
    jstore = JStore(cfg)
    jstore.create_index([f"doc {i}" for i in range(N)], x)
    store = _card_store(cfg, monkeypatch)
    store.create_index([f"doc {i}" for i in range(N)], x)
    s, i = store.search_batch(q, top_k=K)
    ref_s, ref_i = (np.asarray(a) for a in jstore.search_batch(q, top_k=K))
    assert np.array_equal(i.numpy(), ref_i)
    rtol = 1e-2 if fmt == "bf16" else 0.0
    assert np.all(np.abs(s.numpy() - ref_s) <= 1e-5 + rtol * (1 + np.abs(ref_s)))
    multiple = 8 if fmt == "bf16" else 1
    assert seen and seen[0][1] == -(-d // multiple) * multiple
    assert store.dim == d and store.get_vectors([0, 5]).shape == (2, d)


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "plain"])
def test_pq_store_past_one_tiles_luts_scans_like_crs_tpu(monkeypatch, tmp_path, residual):
    """M = 64 subspaces of 256 clusters (a query tile's LUTs, 256 KB, do not
    fit in shared memory beside a chunk: the kernel takes fewer queries per
    CUDA block): the store takes the ADC kernel's route, as ``crs_tpu``
    does, and gives its ids and scores; the state is ``crs_tpu``'s (trained
    there, loaded here)."""
    from crs_tpu.rag.index import VectorStore as JStore

    from crs_tpu_torch.ops import scan

    seen = []
    plain = scan.block_topk_adc_plain
    monkeypatch.setattr(scan, "block_topk_adc_plain", lambda *a, **kw: seen.append(
        tuple(a[0].shape)) or plain(*a, **kw))
    x, q = _data(128, seed=9)
    cfg = {"format": "pq", "block_size": BLOCK, "pq_subspaces": 64, "pq_clusters": 256,
           "pq_iters": 2, "pq_opq_iters": 1, "pq_coarse_clusters": 256, "rescore_k": 32,
           "pq_residual": residual}
    jstore = JStore(cfg)
    jstore.create_index([f"doc {i}" for i in range(N)], x)
    jstore.save(str(tmp_path))
    store = _card_store(cfg, monkeypatch)
    store.load(str(tmp_path))
    s, i = store.search_batch(q, top_k=K)
    ref_s, ref_i = (np.asarray(a) for a in jstore.search_batch(q, top_k=K))
    assert np.array_equal(i.numpy(), ref_i)
    assert np.allclose(s.numpy(), ref_s, atol=1e-5, rtol=0)
    assert seen and seen[0][1:] == (64, 256)


# -- decode attention: G padded to the next built kernel ---------------------------

@pytest.mark.parametrize("g", [3, 5, 6, 7, 9, 12])
def test_padded_query_heads_leave_the_real_ones_exact(g):
    """Zero query heads padded up to ``launch_groups(G)`` (the next built G,
    or past 8 the next multiple of 8): each head's attention is its own, so
    the real heads are bit for bit the unpadded ones, and they match
    ``crs_tpu``'s kernel (Pallas, interpret mode) at G."""
    from crs_tpu.ops import decode_attention as jd

    from crs_tpu_torch.ops import decode_attention as td

    rng = np.random.default_rng(g)
    b, hkv, s, hd = 2, 2, 256, 128
    q = rng.standard_normal((b, hkv, g, hd)).astype(np.float32)
    kc, ks = jax.jit(jd.quantize_kv_rows)(jnp.asarray(rng.standard_normal((b, hkv, s, hd)),
                                                      jnp.float32))
    vc, vs = jax.jit(jd.quantize_kv_rows)(jnp.asarray(rng.standard_normal((b, hkv, s, hd)),
                                                      jnp.float32))
    valid = np.zeros((b, s), bool)
    valid[0, 40:200] = valid[1, 5:30] = True
    ops = [torch.from_numpy(np.array(a)) for a in (q, kc, ks, vc, vs, valid)]
    g_run = td.launch_groups(g)
    padded = torch.nn.functional.pad(ops[0], (0, 0, 0, g_run - g))
    got = td.emulate_decode_attention_int8(padded, *ops[1:])[:, :, :g]
    assert torch.equal(got, td.emulate_decode_attention_int8(*ops))
    ref = np.asarray(jd.decode_attention_int8(jnp.asarray(q), kc, ks, vc, vs, jnp.asarray(valid)))
    qb = ops[0].bfloat16().float()
    sc = torch.einsum("bhgd,bhsd->bhgs", qb, ops[1].float()) * ops[2][:, :, None, :] / hd ** 0.5
    sc = torch.where(ops[5][:, None, None, :], sc, -1e30)
    terms = (torch.softmax(sc, -1) * ops[4][:, :, None, :]).abs()[..., None] \
        * ops[3].float().abs()[:, :, None]
    tol = 1e-5 * terms.sum(3) + 2 ** -8 * terms.amax(3) + 1e-6
    assert np.all(np.abs(got.numpy() - ref) <= tol.numpy())


@pytest.mark.parametrize("heads,kv_heads,hd", [(3, 1, 128), (6, 2, 128), (9, 1, 128),
                                               (16, 1, 128), (4, 2, 256), (4, 2, 640)])
def test_transformer_takes_the_kernel_where_crs_tpu_does(monkeypatch, heads, kv_heads, hd):
    """The int8-KV decode step calls the kernel's wrapper wherever
    ``crs_tpu``'s gate holds (hd and S 128-aligned), at any G and at hd 256
    and 640."""
    from crs_tpu_torch.models import transformer as tr

    calls = []
    real = tr.decode_attention_int8
    monkeypatch.setattr(tr, "decode_attention_int8",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    cfg = tr.TransformerConfig(vocab_size=64, hidden_size=hd * heads, num_layers=1,
                               num_heads=heads, num_kv_heads=kv_heads, intermediate_size=256,
                               max_seq_len=256, kv_bits=8)
    assert cfg.head_dim == hd
    params = tr.init_params(0, cfg)
    cache = tr.init_cache(cfg, 1, 128)
    _, cache = tr.prefill(params, cfg, torch.arange(5)[None, :], cache)
    logits, _ = tr.decode_step(params, cfg, torch.tensor([3]), cache)
    assert bool(torch.isfinite(logits).all())
    assert [tuple(c) for c in calls] == [(1, kv_heads, heads // kv_heads, hd)]
