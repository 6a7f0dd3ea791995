"""The port's segment-max scans against ``crs_tpu``'s Pallas kernels.

``pallas_topk_segmax`` / ``pallas_topk_segmax_int8`` run in Pallas interpret
mode; the port runs ``scan_topk_segmax`` / ``scan_topk_segmax_int8`` on the
kernels' plain torch versions, at 3,000 × 64, block 512, 5 queries, and on
the edges of the kernels' tiling (EDGE_CASES: valid_n inside a segment,
whole blocks past it, query counts off the tile, D = 32 and 96, blocks of
256 and 4096) and on exact ties across lanes, quads and segments.

Tolerances:
- int8 (kernel 7): scores and ids bit for bit. The int32 dot is exact, and
  s = (f32(acc) · q_scale) · row_scale rounds the same two products.
- f32 / bf16 (kernel 6): scores within rtol·(1 + |s|), rtol 1e-5 (f32) and
  1e-2 (bf16); ids equal at every rank whose score is farther than
  1e-5·(1 + |s|) from both neighbours' and at every -1e30 rank (in both
  dtypes the products are exact in f32 and only the order of the f32 sums
  differs), as for kernel 2.
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


N, D, B, BS = 3000, 64, 5, 512
ID_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_close(got, ref, rtol):
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


CASES = {  # name: (k, valid_n)
    "k10": (10, N),
    "padding": (8, N - 123),
    "k_past_candidates": (40, 600),  # kseg·nblocks = 24 < 40, most segments all -1e30
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_segmax_matches_pallas(dtype, case):
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax
    from crs_tpu_torch.ops import scan_topk_segmax

    k, valid = CASES[case]
    rng = np.random.default_rng(3)
    v, q = _unit(rng, N, D), rng.standard_normal((B, D)).astype(np.float32)
    jdt, tdt, rtol = ((jnp.float32, torch.float32, 1e-5) if dtype == "fp32"
                      else (jnp.bfloat16, torch.bfloat16, 1e-2))
    ref = pallas_topk_segmax(jnp.asarray(v, jdt), jnp.asarray(q), k, valid, block_size=BS)
    got = scan_topk_segmax(_t(v).to(tdt), _t(q), k, valid, block_size=BS)
    assert got[1].dtype == torch.int64 and got[0].shape == (B, k)
    _assert_close(got, ref, rtol)
    assert (got[1].numpy()[got[0].numpy() > -1e29] < valid).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_segmax_int8_matches_pallas_bit_for_bit(case):
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax_int8
    from crs_tpu.ops.quant import scalar_quantize as jax_quantize
    from crs_tpu_torch.ops import scalar_quantize, scan_topk_segmax_int8

    k, valid = CASES[case]
    rng = np.random.default_rng(4)
    v, q = _unit(rng, N, D), rng.standard_normal((B, D)).astype(np.float32)
    codes, scales = jax_quantize(jnp.asarray(v))
    ref_s, ref_i = pallas_topk_segmax_int8(codes, scales, jnp.asarray(q), k, valid,
                                           block_size=BS)
    pc, ps = scalar_quantize(_t(v))
    assert np.array_equal(pc.numpy(), np.asarray(codes))
    got_s, got_i = scan_topk_segmax_int8(pc, ps, _t(q), k, valid, block_size=BS)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert np.array_equal(got_s.numpy(), np.asarray(ref_s))


def test_segmax_int8_padding_masked():
    """``tests/test_pallas_scan.py``'s case: loud rows past valid_n (ten
    times the unit rows) never surface."""
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax_int8
    from crs_tpu_torch.ops import scalar_quantize, scan_topk_segmax_int8

    rng = np.random.default_rng(1)
    vectors = np.concatenate([_unit(rng, 3000, 128), 10 * np.ones((200, 128), np.float32)])
    queries = _unit(rng, 4, 128)
    codes, scales = scalar_quantize(_t(vectors))
    s, i = scan_topk_segmax_int8(codes, scales, _t(queries), 8, 3000, block_size=512)
    assert int(i.max()) < 3000
    ref_s, ref_i = pallas_topk_segmax_int8(jnp.asarray(codes.numpy()),
                                           jnp.asarray(scales.numpy()), jnp.asarray(queries), 8,
                                           3000, block_size=512)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def test_segmax_duplicate_ids_past_the_candidates():
    """Fewer real rows than k: once a block's live segments run out, its
    later picks land on the lowest segment at -1e30 and emit that segment's
    argmax id again — so the final top-k carries duplicate ids at -1e30, as
    the Pallas kernel's does."""
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax
    from crs_tpu_torch.ops import scan_topk_segmax
    from crs_tpu_torch.ops.scan import SEGMAX_QUERY_TILE, block_topk_segmax_plain

    rng = np.random.default_rng(6)
    v, q = _unit(rng, 1024, D), rng.standard_normal((B, D)).astype(np.float32)
    k, valid = 8, 200  # block 0: segment 0 full, segment 1 72 rows; block 1 empty
    ref_s, ref_i = (np.asarray(a) for a in pallas_topk_segmax(jnp.asarray(v), jnp.asarray(q),
                                                              k, valid, block_size=BS))
    got_s, got_i = scan_topk_segmax(_t(v), _t(q), k, valid, block_size=BS)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    np.testing.assert_allclose(got_s.numpy(), ref_s, rtol=1e-5)
    for row_s, row_i in zip(got_s.numpy(), got_i.numpy()):
        assert (row_s[:2] > -1e29).all() and (row_s[2:] == np.float32(-1e30)).all()
        dead = row_i[2:]
        assert len(set(dead.tolist())) < len(dead)  # duplicates
    # the partials: block 1 (no live row) emits its segment 0's first row kseg times
    qq = torch.zeros((SEGMAX_QUERY_TILE, D))
    qq[:B] = _t(q)
    out_s, out_i = block_topk_segmax_plain(qq, _t(v), valid, 4, BS)
    assert out_s.shape == (1, 2, 4, SEGMAX_QUERY_TILE)
    assert torch.all(out_s[:, 1] == np.float32(-1e30)) and torch.all(out_i[:, 1] == BS)
    # block 0: its two live segments, then segment 0 (the lowest) re-emitted
    first_two = out_i[0, 0, :2, :B]
    assert torch.all((first_two // 128).sort(0).values == torch.tensor([[0], [1]]))
    seg0_id = torch.where(first_two[0] // 128 == 0, first_two[0], first_two[1])
    assert torch.all(out_s[0, 0, 2:] == np.float32(-1e30))
    assert torch.all(out_i[0, 0, 2:, :B] == seg0_id[None])


def test_segmax_block_size_default_and_kseg():
    """The Python default block of 2048 gives kseg = min(k, 16); k beyond it
    is capped (the partials hold 16 per block)."""
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax
    from crs_tpu_torch.ops import scan_topk_segmax

    rng = np.random.default_rng(8)
    v, q = _unit(rng, 5000, 32), rng.standard_normal((3, 32)).astype(np.float32)
    for k in (10, 20):
        ref = pallas_topk_segmax(jnp.asarray(v), jnp.asarray(q), k, 5000)
        got = scan_topk_segmax(_t(v), _t(q), k, 5000)
        _assert_close(got, ref, 1e-5)


# The kernels' tiling edges (kernel 6: 128 queries and 256-row chunks per
# CUDA block, 64-dimension bf16 slices; kernel 7: 64 queries): name → (rows,
# dim, queries, block_size, k, valid_n). The port runs its plain versions
# here and its kernels on the card (chip_smoke.py's kernel_segmax phase).
EDGE_CASES = {
    "valid_n_inside_a_segment_and_chunk": (3000, 64, 5, 512, 8, 1337),
    "blocks_past_valid_n": (3000, 64, 5, 512, 8, 1100),  # blocks 3..5: no live row
    "queries_not_a_tile": (1500, 64, 70, 512, 8, 1500),  # 2 tiles, the second ragged
    "queries_odd_tiles": (1024, 32, 130, 512, 4, 1024),  # 3 tiles: a pair and a single
    "d32": (2000, 32, 5, 512, 8, 2000),
    "d_ragged_96": (2000, 96, 5, 512, 8, 2000),  # not a multiple of the 64-dim slice
    "block_256": (2000, 64, 5, 256, 4, 1999),  # kseg = 2
    "block_4096": (5000, 64, 3, 4096, 40, 4500),  # kseg = 32, the most segments
}


def _edge_inputs(case, seed):
    rows, d, b, _, _, _ = EDGE_CASES[case]
    rng = np.random.default_rng(seed)
    return _unit(rng, rows, d), rng.standard_normal((b, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_segmax_edge_cases_match_pallas(dtype, case):
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax
    from crs_tpu_torch.ops import scan_topk_segmax

    _, _, b, bs, k, valid = EDGE_CASES[case]
    v, q = _edge_inputs(case, 11)
    jdt, tdt, rtol = ((jnp.float32, torch.float32, 1e-5) if dtype == "fp32"
                      else (jnp.bfloat16, torch.bfloat16, 1e-2))
    ref = pallas_topk_segmax(jnp.asarray(v, jdt), jnp.asarray(q), k, valid, block_size=bs)
    got = scan_topk_segmax(_t(v).to(tdt), _t(q), k, valid, block_size=bs)
    assert got[0].shape == (b, k)
    _assert_close(got, ref, rtol)
    assert (got[1].numpy()[got[0].numpy() > -1e29] < valid).all()


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_segmax_int8_edge_cases_match_pallas_bit_for_bit(case):
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax_int8
    from crs_tpu.ops.quant import scalar_quantize as jax_quantize
    from crs_tpu_torch.ops import scalar_quantize, scan_topk_segmax_int8

    _, _, _, bs, k, valid = EDGE_CASES[case]
    v, q = _edge_inputs(case, 12)
    codes, scales = jax_quantize(jnp.asarray(v))
    ref_s, ref_i = pallas_topk_segmax_int8(codes, scales, jnp.asarray(q), k, valid,
                                           block_size=bs)
    pc, ps = scalar_quantize(_t(v))
    got_s, got_i = scan_topk_segmax_int8(pc, ps, _t(q), k, valid, block_size=bs)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert np.array_equal(got_s.numpy(), np.asarray(ref_s))


# one vector at rows 9 and 70 (segment 0: lanes 2 / 17 of the f32 kernel,
# quads 0 / 3 of the bf16 one), 424 and 484 (segment 3) and 1153 and 1279
# (block 1, segment 1): exact ties inside a segment and equal maxima across
# segments, for query 0
TIE_ROWS = (9, 70, 424, 484, 1153, 1279)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_segmax_exact_ties_pick_the_lowest_row_and_segment(dtype):
    """Query 0 scores its direction highest at six rows: each segment keeps
    its lowest such row, equal segment maxima are picked lowest segment
    first, and the final top-3 are rows 9, 424, 1153 — in the plain
    version's partials and in both packages' results."""
    from crs_tpu.ops.pallas_scan import pallas_topk_segmax, pallas_topk_segmax_int8
    from crs_tpu.ops.quant import scalar_quantize as jax_quantize
    from crs_tpu_torch.ops import scalar_quantize, scan_topk_segmax, scan_topk_segmax_int8
    from crs_tpu_torch.ops.scan import (
        SEGMAX_QUERY_TILE, _pad_rows, block_topk_segmax_int8_plain, block_topk_segmax_plain,
    )

    rng = np.random.default_rng(13)
    v, q = _unit(rng, 2048, D), rng.standard_normal((B, D)).astype(np.float32)
    v[list(TIE_ROWS)] = q[0] / np.linalg.norm(q[0])
    bs, k = 1024, 4
    if dtype == "int8":
        codes, scales = jax_quantize(jnp.asarray(v))
        ref = pallas_topk_segmax_int8(codes, scales, jnp.asarray(q), k, 2048, block_size=bs)
        pc, ps = scalar_quantize(_t(v))
        got = scan_topk_segmax_int8(pc, ps, _t(q), k, 2048, block_size=bs)
        qc, qs = scalar_quantize(_t(q))
        out_s, out_i = block_topk_segmax_int8_plain(
            _pad_rows(qc, SEGMAX_QUERY_TILE), _pad_rows(qs, SEGMAX_QUERY_TILE), pc, ps, 2048, k,
            bs)
    else:
        jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
        ref = pallas_topk_segmax(jnp.asarray(v, jdt), jnp.asarray(q), k, 2048, block_size=bs)
        got = scan_topk_segmax(_t(v).to(tdt), _t(q), k, 2048, block_size=bs)
        out_s, out_i = block_topk_segmax_plain(_pad_rows(_t(q).to(tdt), SEGMAX_QUERY_TILE),
                                               _t(v).to(tdt), 2048, k, bs)
    assert out_i[0, 0, :2, 0].tolist() == [9, 424] and int(out_i[0, 1, 0, 0]) == 1153
    assert out_s[0, 0, 0, 0] == out_s[0, 0, 1, 0] == out_s[0, 1, 0, 0]
    assert got[1][0, :3].tolist() == [9, 424, 1153]
    np.testing.assert_array_equal(np.asarray(ref[1])[0, :3], [9, 424, 1153])
    if dtype == "int8":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    else:
        _assert_close(got, ref, 1e-5 if dtype == "fp32" else 1e-2)
