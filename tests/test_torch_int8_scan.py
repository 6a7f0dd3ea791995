"""The port's search primitives against ``crs_tpu``'s on the CPU.

The JAX side runs as its own tests run it: ``pallas_topk_int8`` in Pallas
interpret mode. The port's int8 scan runs its plain torch version (the CUDA
kernel's CPU counterpart). Tolerances: ids identical everywhere; int8-scan
scores identical to 1e-6 relative (they are computed with the same float32
operations in the same order); fp32 products that sum in another order
(rescore, exact_topk, MMR similarities) to 1e-5 absolute on unit vectors.
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


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _assert_scan_equal(ref, got, rel=1e-6):
    ref_s, ref_i = (np.asarray(a) for a in ref)
    got_s, got_i = (a.numpy() for a in got)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_allclose(got_s, ref_s, rtol=rel, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scalar_quantize_identical(seed):
    from crs_tpu.ops.quant import scalar_quantize as jq
    from crs_tpu_torch.ops.quant import scalar_quantize as tq

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3000, 96)).astype(np.float32) * rng.uniform(0.01, 10, (3000, 1))
    x[5] = 0.0  # all-zero row: the 1e-12 floor
    x[7, :4] = [127.5, -127.5, 0.5, 1.5]  # round-half-to-even cases
    codes, scales = jq(jnp.asarray(x))
    t_codes, t_scales = tq(_t(x))
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(t_scales.numpy(), np.asarray(scales))


def test_topk_stable_breaks_ties_like_lax():
    import jax

    from crs_tpu_torch.ops.topk import topk_stable

    rng = np.random.default_rng(3)
    x = rng.integers(0, 5, (7, 300)).astype(np.float32)  # many exact ties
    ref_s, ref_i = jax.lax.top_k(jnp.asarray(x), 40)
    s, i = topk_stable(_t(x), 40)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_exact_topk(dtype, masked):
    from crs_tpu.ops.topk import exact_topk as jtopk
    from crs_tpu_torch.ops.topk import exact_topk

    rng = np.random.default_rng(4)
    v, q = _unit(rng, 900, 64), _unit(rng, 6, 64)
    mask = rng.random(900) < 0.6 if masked else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    ref = jtopk(jnp.asarray(v, jdt), jnp.asarray(q), 12, 850,
                row_mask=None if mask is None else jnp.asarray(mask))
    got = exact_topk(_t(v).to(tdt), _t(q), 12, 850, row_mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)


def test_exact_topk_pads_past_n():
    from crs_tpu_torch.ops.topk import exact_topk

    s, i = exact_topk(torch.eye(4), torch.eye(4)[:2], 6)
    assert i[:, 4:].eq(-1).all() and s[:, 4:].eq(-1e30).all()


def test_blockwise_and_merge_topk():
    from crs_tpu.ops.topk import blockwise_topk as jblock
    from crs_tpu.ops.topk import merge_topk as jmerge
    from crs_tpu_torch.ops.topk import blockwise_topk, merge_topk

    rng = np.random.default_rng(5)
    v, q = _unit(rng, 1000, 32), _unit(rng, 5, 32)
    mask = rng.random(1000) < 0.7
    ref = jblock(jnp.asarray(v), jnp.asarray(q), 9, 950, block_size=256, row_mask=jnp.asarray(mask))
    got = blockwise_topk(_t(v), _t(q), 9, 950, block_size=256, row_mask=_t(mask))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)

    scores = rng.integers(0, 6, (4, 3, 5)).astype(np.float32)
    ids = rng.integers(0, 1000, (4, 3, 5)).astype(np.int32)
    ref = jmerge(jnp.asarray(scores), jnp.asarray(ids), 7)
    got = merge_topk(_t(scores), _t(ids), 7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def _clustered(seed=11, n=4096, d=64, b=16):
    """tests/test_pallas_scan.py's construction: every query owns a hot
    block of ~50 near-copies, so kb=2 leaves hidden winners."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    for qi in range(b):
        st = (256 * qi) % (n - 60)
        base[st:st + 50] = q[qi][None] * 10 + 0.01 * rng.standard_normal((50, d))
    return base, q, rng


# name → (repair budget, masked, which exactness step must run)
_SCAN_CASES = {
    "targeted_repair": (256, False, "repairs"),
    "over_budget_fallback": (4, False, "fallbacks"),
    "no_repair_fallback": (0, False, "fallbacks"),
    "repair_with_row_mask": (256, True, "repairs"),
}


@pytest.mark.parametrize("case", sorted(_SCAN_CASES))
def test_scan_topk_int8_clustered(case):
    from crs_tpu.ops.pallas_scan import pallas_topk_int8
    from crs_tpu.ops.quant import scalar_quantize
    from crs_tpu_torch.ops.scan import STATS, scan_topk_int8

    repair, masked, step = _SCAN_CASES[case]
    base, q, rng = _clustered()
    n, k = base.shape[0], 40
    mask = rng.random(n) < 0.5 if masked else None
    codes, scales = scalar_quantize(jnp.asarray(base))
    ref = pallas_topk_int8(codes, scales, jnp.asarray(q), k, n, block_size=256, kb=2,
                           repair=repair, row_mask=None if mask is None else jnp.asarray(mask))
    STATS.reset()
    got = scan_topk_int8(_t(codes), _t(scales), _t(q), k, n, block_size=256, kb=2,
                         repair=repair, row_mask=None if mask is None else _t(mask))
    assert getattr(STATS, step) == 1, vars(STATS)
    assert STATS.launches == 0  # CPU tensors: the plain version, no kernel
    _assert_scan_equal(ref, got)


def test_scan_topk_int8_padding_mask_and_ties():
    from crs_tpu.ops.pallas_scan import pallas_topk_int8
    from crs_tpu.ops.quant import scalar_quantize
    from crs_tpu_torch.ops.scan import scan_topk_int8

    rng = np.random.default_rng(12)
    n, d = 5000, 64  # not a multiple of the block: padded rows
    x = _unit(rng, n, d)
    x[3000:3040] = x[0:40]  # exact duplicates → exactly tied scores
    q = x[:24].copy()
    mask = rng.random(n) < 0.7
    mask[:24] = True
    valid_n = n - 170
    codes, scales = scalar_quantize(jnp.asarray(x))
    ref = pallas_topk_int8(codes, scales, jnp.asarray(q), 10, valid_n, block_size=256,
                           row_mask=jnp.asarray(mask))
    got = scan_topk_int8(_t(codes), _t(scales), _t(q), 10, valid_n, block_size=256,
                         row_mask=_t(mask))
    _assert_scan_equal(ref, got)
    ids = got[1].numpy()
    assert ids.max() < valid_n and mask[ids].all()
    assert np.isin(ids, np.arange(3000, 3040)).any(), "no tied duplicate reached the top-k"


@pytest.mark.parametrize("kb", [2, 3, 8])
def test_scan_topk_int8_random(kb):
    from crs_tpu.ops.pallas_scan import pallas_topk_int8
    from crs_tpu.ops.quant import scalar_quantize
    from crs_tpu_torch.ops.scan import scan_topk_int8

    rng = np.random.default_rng(13 + kb)
    x, q = _unit(rng, 6144, 64), _unit(rng, 70, 64)  # two query tiles
    codes, scales = scalar_quantize(jnp.asarray(x))
    ref = pallas_topk_int8(codes, scales, jnp.asarray(q), 20, 6144, block_size=256, kb=kb)
    got = scan_topk_int8(_t(codes), _t(scales), _t(q), 20, 6144, block_size=256, kb=kb)
    _assert_scan_equal(ref, got)


def test_block_topk_plain_matches_iterative_extract():
    """The plain partials repeat _extract_block_topk literally, including its
    re-emission of the lowest id once a block has no allowed rows left."""
    from crs_tpu_torch.ops.scan import QUERY_TILE, block_topk_int8

    rng = np.random.default_rng(14)
    bs, d = 32, 16
    codes = torch.from_numpy(rng.integers(-3, 4, (2 * bs, d)).astype(np.int8))
    q = torch.from_numpy(rng.integers(-3, 4, (QUERY_TILE, d)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 2 * bs).astype(np.float32))
    bias = torch.zeros(2 * bs)
    bias[bs + 2:] = -1e30  # second block: two allowed rows only
    out_s, out_i = block_topk_int8(q, codes, scale, bias, 4, block_size=bs)
    s = (q.float() @ codes.float().T) * scale + bias
    for qi in range(QUERY_TILE):
        for blk in range(2):
            row = s[qi, blk * bs:(blk + 1) * bs].clone()
            col = torch.arange(blk * bs, (blk + 1) * bs)
            for j in range(4):
                m = row.max()
                idx = int(col[row >= m].min())
                assert out_s[0, blk, j, qi] == m and out_i[0, blk, j, qi] == idx
                row[col == idx] = -1e30
    assert (out_i[0, 1, 2:] == bs).all()  # exhausted block: lowest id again


@pytest.mark.parametrize("masked", [False, True])
def test_int8_topk_small_corpus(masked):
    from crs_tpu.ops.quant import int8_topk as jint8, scalar_quantize
    from crs_tpu_torch.ops.quant import int8_topk

    rng = np.random.default_rng(15)
    x, q = _unit(rng, 3000, 64), _unit(rng, 9, 64)
    mask = rng.random(3000) < 0.5 if masked else None
    codes, scales = scalar_quantize(jnp.asarray(x))
    ref = jint8(codes, scales, jnp.asarray(q), 6, 2900, rescore_k=48,
                row_mask=None if mask is None else jnp.asarray(mask))
    got = int8_topk(_t(codes), _t(scales), _t(q), 6, 2900, rescore_k=48,
                    row_mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)


def test_int8_topk_routed_at_16384_rows(monkeypatch):
    """At 16384 rows both packages route the candidate scan through their
    scan kernel (Pallas interpret / the plain torch version), then rescore."""
    from crs_tpu.ops.quant import int8_topk as jint8, scalar_quantize
    from crs_tpu_torch.ops import scan
    from crs_tpu_torch.ops.quant import SCAN_MIN_ROWS, int8_topk

    assert SCAN_MIN_ROWS == 16384
    calls = []
    wrapper = scan.block_topk_int8
    monkeypatch.setattr(scan, "block_topk_int8", lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    rng = np.random.default_rng(16)
    x, q = _unit(rng, 16384, 64), _unit(rng, 8, 64)
    codes, scales = scalar_quantize(jnp.asarray(x))
    ref = jint8(codes, scales, jnp.asarray(q), 6, 16384, rescore_k=64)
    got = int8_topk(_t(codes), _t(scales), _t(q), 6, 16384, rescore_k=64)
    assert calls == [1]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)


@pytest.mark.parametrize("lam", [0.9, 0.5])
def test_mmr_select_batch_identical(lam):
    from crs_tpu.ops.mmr import mmr_select, mmr_select_batch as jmmr
    from crs_tpu_torch.ops.mmr import mmr_select as tmmr_one
    from crs_tpu_torch.ops.mmr import mmr_select_batch

    rng = np.random.default_rng(17)
    emb = rng.standard_normal((12, 10, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    rel = rng.uniform(-0.2, 1.0, (12, 10)).astype(np.float32)
    rel[3, 4:] = -1e30  # invalid candidates
    ref = np.asarray(jmmr(jnp.asarray(emb), jnp.asarray(rel), 4, lam))
    got = mmr_select_batch(_t(emb), _t(rel), 4, lam).numpy()
    np.testing.assert_array_equal(got, ref)
    one = np.asarray(mmr_select(jnp.asarray(emb[0]), jnp.asarray(rel[0]), 4, lam))
    np.testing.assert_array_equal(tmmr_one(_t(emb[0]), _t(rel[0]), 4, lam).numpy(), one)
