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
