"""Shapes ``crs_tpu`` sends to its Pallas kernels that the port's CUDA
kernels once refused, the port against ``crs_tpu`` on the CPU.

The Pallas kernels run in interpret mode; the port runs its wrappers, which
take the kernels' plain torch versions for CPU tensors (the card runs the
kernels on the same shapes: ``chip_smoke.py``'s faults phase):

- the segment-max scans (kernels 6 and 7) at D 24, 40, 100 and 4,104 and at
  blocks of 384, 640 and 8,192 rows (any whole 128-row segments);
- the fused MLP (kernel 11) at chunks 32, 40, 64, 96 and one chunk of
  24,576 rows at H 128 (past what shared memory holds);
- the int8 scan (kernel 1) on the default 4,096-row blocks, on
  config.json's 1,024 and on blocks off its 256-row chunk (1,000, 640,
  128), with a `where` mask and a ragged D, against ``pallas_topk_int8``
  and the dense int8 top-k.

Tolerances: the segment maxima as ``tests/test_torch_segmax.py`` holds them
(int8 bit for bit; f32 / bf16 scores within rtol·(1 + |s|), rtol 1e-5 /
1e-2, ids equal at every rank farther than 1e-5·(1 + |s|) from both
neighbours); the fused MLP within 1e-5·max|out| (``tests/test_torch_fused_mlp.py``:
XLA's rsqrt and exp differ in the last ulps); the int8 scan's ids identical
to ``pallas_topk_int8``'s and scores within 1e-6 relative (the same f32
operations in the same order), against the dense int8 top-k the same rows
and scores within 1e-6 relative (it rounds (q·c)·scale in another order,
so its exact ties may rank the other way round).
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


ID_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_ranked_close(got, ref, rtol):
    ref_s, ref_i = (np.asarray(a, np.float64) for a in ref)
    got_s, got_i = got[0].double().numpy(), got[1].numpy()
    assert np.all(np.abs(got_s - ref_s) <= rtol * (1.0 + np.abs(ref_s))), \
        np.abs(got_s - ref_s).max()
    tol = ID_RTOL * (1.0 + np.abs(ref_s))
    gap_prev = np.full(ref_s.shape, np.inf)
    gap_next = np.full(ref_s.shape, np.inf)
    gap_prev[:, 1:] = ref_s[:, :-1] - ref_s[:, 1:]
    gap_next[:, :-1] = ref_s[:, :-1] - ref_s[:, 1:]
    need = ((gap_prev > tol) & (gap_next > tol)) | (ref_s <= -1e29)
    assert need.any()
    np.testing.assert_array_equal(got_i[need], ref_i[need].astype(np.int64))


# -- kernels 6 and 7: any D, any block of whole segments -------------------------

# name → (rows, D, queries, block_size, k, valid_n): blocks of 3 and 5
# segments (a half chunk at each block's end), of 64 segments, D off every
# old multiple and past the old cap of 4,096
SEGMAX_CASES = {
    "d24_block384": (1536, 24, 5, 384, 8, 1500),
    "d40_block640": (2560, 40, 70, 640, 10, 2000),
    "d100_block8192": (16384, 100, 5, 8192, 12, 16000),
    "d4104_block384": (768, 4104, 3, 384, 5, 700),
}


def _segmax_inputs(case, seed):
    rows, d, b, _, _, _ = SEGMAX_CASES[case]
    rng = np.random.default_rng(seed)
    return _unit(rng, rows, d), rng.standard_normal((b, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(SEGMAX_CASES))
def test_segmax_takes_any_width_and_block(dtype, case):
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax
    from crs_tpu_torch.ops import scan_topk_segmax

    _, _, b, bs, k, valid = SEGMAX_CASES[case]
    v, q = _segmax_inputs(case, 21)
    jdt, tdt, rtol = ((jnp.float32, torch.float32, 1e-5) if dtype == "fp32"
                      else (jnp.bfloat16, torch.bfloat16, 1e-2))
    ref = pallas_topk_segmax(jnp.asarray(v, jdt), jnp.asarray(q), k, valid, block_size=bs)
    got = scan_topk_segmax(_t(v).to(tdt), _t(q), k, valid, block_size=bs)
    assert got[0].shape == (b, k)
    _assert_ranked_close(got, ref, rtol)
    assert (got[1].numpy()[got[0].numpy() > -1e29] < valid).all()


@pytest.mark.parametrize("case", sorted(SEGMAX_CASES))
def test_segmax_int8_takes_any_width_and_block_bit_for_bit(case):
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax_int8
    from crs_tpu.ops.quant import scalar_quantize as jax_quantize
    from crs_tpu_torch.ops import scalar_quantize, scan_topk_segmax_int8

    _, _, _, bs, k, valid = SEGMAX_CASES[case]
    v, q = _segmax_inputs(case, 22)
    codes, scales = jax_quantize(jnp.asarray(v))
    ref_s, ref_i = pallas_topk_segmax_int8(codes, scales, jnp.asarray(q), k, valid,
                                           block_size=bs)
    pc, ps = scalar_quantize(_t(v))
    got_s, got_i = scan_topk_segmax_int8(pc, ps, _t(q), k, valid, block_size=bs)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert np.array_equal(got_s.numpy(), np.asarray(ref_s))


def test_segmax_block_partials_never_hold_the_next_block_s_rows():
    """Blocks of 384 rows: each block's winners lie in its own rows (the
    kernel's last half chunk scores the next block's rows and drops them)."""
    from crs_tpu_torch.ops.scan import SEGMAX_QUERY_TILE, block_topk_segmax_plain

    rng = np.random.default_rng(23)
    v = _unit(rng, 1152, 32)
    v[384:512] *= 10  # loud rows at the start of block 1
    q = torch.zeros((SEGMAX_QUERY_TILE, 32))
    q[:4] = _t(rng.standard_normal((4, 32)).astype(np.float32))
    out_s, out_i = block_topk_segmax_plain(q, _t(v), 1152, 3, 384)
    blocks = torch.arange(3)[None, :, None, None]
    assert torch.all(out_i // 384 == blocks)


# -- kernel 11: any chunk that divides I -----------------------------------------

def _mlp_inputs(seed, h, inter, b):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h)) * 0.3).astype(np.float32)
    ns = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)

    def qw(k, n):
        w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
        s = (np.abs(w).max(axis=0) / 127.0).astype(np.float32)
        return np.clip(np.round(w / s[None, :]), -127, 127).astype(np.int8), s

    return x, ns, (*qw(h, inter), *qw(h, inter), *qw(inter, h))


# (H, I, chunk, B): chunks off 128 and below it, and one past 16,384 rows
MLP_CHUNKS = {"chunk32": (128, 96, 32, 3), "chunk40": (128, 200, 40, 2),
              "chunk64": (128, 256, 64, 8), "chunk96": (128, 288, 96, 1),
              "chunk24576": (128, 24576, 24576, 2)}


@pytest.mark.parametrize("case", sorted(MLP_CHUNKS))
def test_fused_mlp_takes_every_gated_chunk(case):
    from crs_tpu.ops import fused_mlp as jf

    from crs_tpu_torch.ops import fused_mlp as tf

    h, inter, chunk, b = MLP_CHUNKS[case]
    assert jf.fused_mlp_supported(b, h, inter, chunk) and tf.fused_mlp_supported(b, h, inter,
                                                                                 chunk)
    x, ns, weights = _mlp_inputs(chunk + b, h, inter, b)
    lay_j = jf.fused_mlp_layout(*[jnp.asarray(a) for a in weights], chunk=chunk)
    ref = np.asarray(jf.fused_mlp_int8(jnp.asarray(x), jnp.asarray(ns), *lay_j, chunk=chunk))
    lay_t = tf.fused_mlp_layout(*[torch.from_numpy(a) for a in weights], chunk=chunk)
    got, codes = tf.fused_mlp_int8(torch.from_numpy(x), torch.from_numpy(ns), *lay_t,
                                   chunk=chunk, return_codes=True)
    assert got.shape == (b, h)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert codes.hq.shape == (b, inter) and codes.hs.shape == (b, inter // chunk)


# -- kernel 1: crs_tpu's blocks, any size ------------------------------------------

@pytest.mark.parametrize("block_size", [4096, 1024, 1000, 640, 128])
@pytest.mark.parametrize("d", [64, 100])
def test_scan_topk_int8_on_crs_tpu_s_blocks(block_size, d):
    from crs_tpu.ops.pallas_scan import pallas_topk_int8
    from crs_tpu.ops.quant import scalar_quantize as jax_quantize
    from crs_tpu_torch.ops.quant import _int8_topk_dense
    from crs_tpu_torch.ops.scan import scan_topk_int8

    rng = np.random.default_rng(24 + d)
    n, b, k = 20000, 7, 16  # whole blocks: 5 of 4,096 (padded), 20 of 1,024, ...
    x = _unit(rng, n, d)
    x[9000:9030] = x[0:30]  # exact ties
    q = x[:b].copy()
    mask = rng.random(n) < 0.6
    mask[:b] = True
    valid_n = n - 77
    codes, scales = jax_quantize(jnp.asarray(x))
    ref_s, ref_i = pallas_topk_int8(codes, scales, jnp.asarray(q), k, valid_n,
                                    block_size=block_size, row_mask=jnp.asarray(mask))
    args = (_t(codes), _t(scales), _t(q), k, valid_n)
    got_s, got_i = scan_topk_int8(*args, block_size=block_size, row_mask=_t(mask))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-6, atol=0)
    # the dense route rounds (q·c)·scale in another order: its exact ties
    # (the duplicated rows) may rank the other way round, so the same rows
    # and scores within 1e-6 relative
    dense_s, dense_i = _int8_topk_dense(*args, rescore_k=0, row_mask=_t(mask))
    assert [set(r) for r in got_i.tolist()] == [set(r) for r in dense_i.tolist()]
    np.testing.assert_allclose(got_s.numpy(), dense_s.numpy(), rtol=1e-6, atol=0)
    assert got_i.max() < valid_n and mask[got_i.numpy()].all()


# -- kernels 2 to 5: crs_tpu's blocks off the 256-row chunk ----------------------

OFF_CHUNK_BLOCKS = [128, 384, 640]


@pytest.mark.parametrize("block_size", OFF_CHUNK_BLOCKS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_float_scan_on_blocks_off_the_chunk(dtype, block_size):
    """Kernel 2's route at blocks that are not whole 256-row chunks, with a
    `where` mask, exact ties and padding rows: ``pallas_topk``'s ids and
    scores (the float tolerances above)."""
    from crs_tpu.ops.pallas_scan import pallas_topk
    from crs_tpu_torch.ops.scan import scan_topk

    rng = np.random.default_rng(block_size + (dtype == "bf16"))
    n, d, b, k = 2600, 48, 9, 12
    x = _unit(rng, n, d)
    x[1500:1520] = x[0:20]  # exact ties across blocks
    q = x[:b] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(n) < 0.7
    valid_n = n - 31
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    ref = pallas_topk(jnp.asarray(x, jdt), jnp.asarray(q), k, valid_n, block_size=block_size,
                      row_mask=jnp.asarray(mask))
    got = scan_topk(_t(x).to(tdt), _t(q), k, valid_n, block_size=block_size, row_mask=_t(mask))
    _assert_ranked_close(got, ref, 1e-5 if dtype == "fp32" else 1e-2)
    assert got[1].max() < valid_n and mask[got[1].numpy()].all()


def _adc_tables(rng, d, m, kc, c):
    rot = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    coarse = (rng.standard_normal((c, d)) * 0.3).astype(np.float32)
    cents = (rng.standard_normal((m, kc, d // m)) * 0.1).astype(np.float32)
    return rot, coarse, cents


def _jax_luts(q, rot, coarse, cents):
    """The LUT products exactly as the JAX wrappers compute them."""
    qr = jnp.dot(jnp.asarray(q), jnp.asarray(rot), preferred_element_type=jnp.float32)
    cl = jnp.dot(qr, jnp.asarray(coarse).T, preferred_element_type=jnp.float32)
    m = cents.shape[0]
    sub = qr.reshape(q.shape[0], m, q.shape[1] // m)
    lut = jnp.einsum("bmd,mkd->bmk", sub, jnp.asarray(cents), preferred_element_type=jnp.float32)
    plain = jnp.einsum("bmd,mkd->bmk", jnp.asarray(q).reshape(sub.shape), jnp.asarray(cents),
                       preferred_element_type=jnp.float32)
    return np.asarray(cl), np.asarray(lut), np.asarray(plain)


@pytest.mark.parametrize("block_size", OFF_CHUNK_BLOCKS)
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "plain"])
def test_adc_scans_on_blocks_off_the_chunk_bit_for_bit(residual, block_size):
    """Kernels 3 and 5's route at blocks off the 256-row chunk, given JAX's
    LUTs: ``pallas_topk_residual_pq_adc`` / ``pallas_topk_pq_adc``'s ids and
    scores bit for bit, a repair included (k past kb)."""
    from crs_tpu.ops.pallas_scan import pallas_topk_pq_adc, pallas_topk_residual_pq_adc
    from crs_tpu_torch.ops.scan import scan_topk_pq_adc_luts, scan_topk_residual_pq_adc_luts

    rng = np.random.default_rng(40 + block_size)
    n, d, b, m, kc, c, k = 2600, 32, 9, 8, 16, 256, 24
    rot, coarse, cents = _adc_tables(rng, d, m, kc, c)
    ext = np.concatenate([np.zeros((n, 1)), rng.integers(0, c, (n, 1)),
                          rng.integers(0, kc, (n, m))], 1).astype(np.uint8)
    ext[1800:1900] = ext[0:100]  # exactly tied scores
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(n) < 0.7
    valid_n = n - 17
    cl, lut, plut = _jax_luts(q, rot, coarse, cents)
    if residual:
        ref = pallas_topk_residual_pq_adc(
            *(jnp.asarray(a) for a in (rot, coarse, cents, ext, q)), k, valid_n,
            block_size=block_size, row_mask=jnp.asarray(mask))
        got = scan_topk_residual_pq_adc_luts(_t(cl), _t(lut), _t(ext), k, valid_n,
                                             block_size=block_size, row_mask=_t(mask))
    else:
        codes = ext[:, 2:].copy()
        ref = pallas_topk_pq_adc(jnp.asarray(cents), jnp.asarray(codes), jnp.asarray(q), k,
                                 valid_n, block_size=block_size, row_mask=jnp.asarray(mask))
        got = scan_topk_pq_adc_luts(_t(plut), _t(codes), k, valid_n, block_size=block_size,
                                    row_mask=_t(mask))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("block_size", OFF_CHUNK_BLOCKS)
def test_sorted_adc_on_blocks_off_the_chunk_bit_for_bit(block_size):
    """Kernel 4's route at blocks off the 256-row chunk: the plan, the
    group and ``pallas_topk_residual_pq_adc_sorted``'s ids and scores bit
    for bit, given JAX's LUTs."""
    from crs_tpu.ops.pallas_scan import (
        adc_auto_group as jax_group, pallas_topk_residual_pq_adc_sorted,
        plan_sorted_coarse_windows as jax_plan,
    )
    from crs_tpu.ops.pq import sort_codes_by_coarse
    from crs_tpu_torch.ops.scan import (
        adc_auto_group, plan_sorted_coarse_windows, scan_topk_residual_pq_adc_sorted_luts,
    )

    rng = np.random.default_rng(60 + block_size)
    n, d, b, m, kc, c, k = 2600, 32, 5, 8, 16, 256, 8
    rot, coarse, cents = _adc_tables(rng, d, m, kc, c)
    ext = np.concatenate([np.zeros((n, 1)), rng.integers(0, c, (n, 1)),
                          rng.integers(0, kc, (n, m))], 1).astype(np.uint8)
    sorted_ext, _, counts = sort_codes_by_coarse(ext, c)
    q = rng.standard_normal((b, d)).astype(np.float32)
    group = adc_auto_group(n, b, block_size, m + 2)
    assert group == jax_group(n, b, block_size, m + 2)
    wbase = plan_sorted_coarse_windows(counts, n, block_size, group)
    np.testing.assert_array_equal(wbase, jax_plan(counts, n, block_size, group))
    cl, lut, _ = _jax_luts(q, rot, coarse, cents)
    ref = pallas_topk_residual_pq_adc_sorted(
        *(jnp.asarray(a) for a in (rot, coarse, cents, sorted_ext)), jnp.asarray(wbase),
        jnp.asarray(q), k, n, block_size=block_size, group=group)
    got = scan_topk_residual_pq_adc_sorted_luts(_t(cl), _t(lut), _t(sorted_ext), wbase, k, n,
                                                block_size=block_size, group=group)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("block_size", [128, 640])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "pq"])
def test_stores_on_blocks_off_the_chunk_like_crs_tpu(monkeypatch, tmp_path, fmt, block_size):
    """fp32, bf16 and pq stores of 128- and 640-row blocks take the kernels'
    route, as on the card (at ≥ 4 blocks), at their own block_size, and give
    ``crs_tpu``'s ids (the pq state trained by ``crs_tpu``, loaded here)."""
    from crs_tpu.rag.index import VectorStore as JStore
    from crs_tpu_torch.ops import scan
    from crs_tpu_torch.rag.index import VectorStore

    seen = []
    for name in ("block_topk_float_plain", "block_topk_adc_plain"):
        plain = getattr(scan, name)
        monkeypatch.setattr(scan, name, lambda *a, _p=plain, **kw: seen.append(a[4]) or _p(*a, **kw))
    rng = np.random.default_rng(block_size)
    n, d = 2600, 32
    centers = rng.standard_normal((20, d)).astype(np.float32)
    x = centers[rng.integers(0, 20, n)] + 0.5 * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(n, 6, replace=False)] + 0.05 * rng.standard_normal((6, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cfg = {"format": fmt, "block_size": block_size, "rescore_k": 32, "pq_subspaces": 8,
           "pq_clusters": 16, "pq_iters": 2, "pq_opq_iters": 1, "pq_coarse_clusters": 256}
    texts = [f"doc {i}" for i in range(n)]
    jstore = JStore(cfg)
    jstore.create_index(texts, x)
    store = VectorStore(dict(cfg), device="cpu")
    monkeypatch.setattr(store, "_scan_here", lambda rows: rows >= 4 * store.block_size)
    if fmt == "pq":
        jstore.save(str(tmp_path))
        store.load(str(tmp_path))
    else:
        store.create_index(texts, torch.from_numpy(x))
    s, i = store.search_batch(torch.from_numpy(q.astype(np.float32)), top_k=5)
    ref_s, ref_i = (np.asarray(a) for a in jstore.search_batch(q, top_k=5))
    assert seen and set(seen) == {block_size}
    np.testing.assert_array_equal(i.numpy(), ref_i)
    rtol = 1e-2 if fmt == "bf16" else 0.0
    assert np.all(np.abs(s.numpy() - ref_s) <= 1e-5 + rtol * (1 + np.abs(ref_s)))
