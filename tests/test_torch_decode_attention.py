"""The port's int8-KV decode attention (kernel 10) against ``crs_tpu``'s.

The JAX side runs ``decode_attention_int8`` as its own tests run it, in
Pallas interpret mode; the port runs the kernel's plain torch version
(``emulate_decode_attention_int8``), which the wrapper takes for CPU tensors.

Tolerances:
- ``quantize_kv_rows``: codes and scales bit for bit (the jitted JAX
  function: XLA's ``x / 127`` is a product with float32(1/127));
- the attention: |port − crs_tpu| ≤ 1e-5 · Σ_s |p_s·v_s,d| + 2⁻⁸ · max_s
  |p_s·v_s,d| + 1e-6: products are exact in f32, the sums run in another
  order and exp may differ in its last bit, which can move one bf16 rounding
  of p·v_scale by one step (2⁻⁸ of that term) — and exact zeros for a batch
  row with no valid slot. The same bound holds the chunked mirror of the CUDA
  kernel's arithmetic (``_chunked_mirror``), whose l is summed per chunk and
  then over chunks in chunk order.
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


SUM_RTOL = 1e-5


def _case(seed, b, hkv, g, s, hd=128):
    from crs_tpu.ops.decode_attention import quantize_kv_rows

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    v = (rng.standard_normal((b, hkv, s, hd)) * 0.5 + 0.2).astype(np.float32)
    kc, ks = jax.jit(quantize_kv_rows)(jnp.asarray(k))
    vc, vs = jax.jit(quantize_kv_rows)(jnp.asarray(v))
    start = rng.integers(0, s // 2, b)
    length = rng.integers(1, s // 2, b)
    pos = np.arange(s)[None, :]
    valid = (pos >= start[:, None]) & (pos < (start + length)[:, None])
    valid[:, -1] = True  # the decode token's own slot
    if b > 1:
        valid[1] = False  # a batch row with no valid slot
    return q, kc, ks, vc, vs, valid


@pytest.mark.parametrize("shape", [(2, 3, 5, 128), (1, 2, 2, 64), (4, 8, 7, 128)])
def test_quantize_kv_rows_bits(shape):
    from crs_tpu.ops.decode_attention import quantize_kv_rows as jq

    from crs_tpu_torch.ops.decode_attention import quantize_kv_rows as tq

    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # the 1e-12 scale floor
    jc, js = jax.jit(jq)(jnp.asarray(x))
    tc, ts = tq(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    # bf16 input, as the model hands it over
    jc, js = jax.jit(jq)(jnp.asarray(x, jnp.bfloat16))
    tc, ts = tq(torch.from_numpy(x).bfloat16())
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("b,hkv,g", [(3, 2, 2), (1, 1, 4), (2, 1, 1)])
def test_decode_attention_matches_pallas(s, b, hkv, g):
    from crs_tpu.ops import decode_attention as jd

    from crs_tpu_torch.ops import decode_attention as td

    q, kc, ks, vc, vs, valid = _case(s + b + g, b, hkv, g, s)
    assert jd.decode_attention_supported(128, s) and td.decode_attention_supported(128, s)
    ref = np.asarray(jd.decode_attention_int8(jnp.asarray(q), kc, ks, vc, vs, jnp.asarray(valid)))
    ops = [torch.from_numpy(np.array(a)) for a in (q, kc, ks, vc, vs, valid)]
    got = td.decode_attention_int8(*ops)
    assert got.dtype == torch.float32 and got.shape == (b, hkv, g, 128)
    assert torch.equal(got, td.emulate_decode_attention_int8(*ops))  # CPU: the plain version
    # the tolerance scale: Σ_s |p_s · v_s,d| with p from the plain softmax
    qb = ops[0].bfloat16().float()
    sc = torch.einsum("bhgd,bhsd->bhgs", qb, ops[1].float()) * ops[2][:, :, None, :] / 128 ** 0.5
    sc = torch.where(ops[5][:, None, None, :], sc, -1e30)
    p = torch.softmax(sc, -1) * ops[4][:, :, None, :]
    terms = p.abs()[..., None] * ops[3].float().abs()[:, :, None]  # [b, h, g, s, d]
    tol = SUM_RTOL * terms.sum(3) + 2 ** -8 * terms.amax(3) + 1e-6
    assert np.all(np.abs(got.numpy() - ref) <= tol.numpy())
    if b > 1:
        assert not got[1].any() and not np.asarray(ref)[1].any()  # exact zeros, no NaN


def test_emulation_matches_crs_tpu_emulation_on_unaligned_dims():
    """hd 64 and S 96: the shapes ``crs_tpu`` sends to its XLA emulation."""
    from crs_tpu.ops import decode_attention as jd

    from crs_tpu_torch.ops import decode_attention as td

    q, kc, ks, vc, vs, valid = _case(5, 2, 2, 2, 96, hd=64)
    assert not td.decode_attention_supported(64, 96)
    ref = np.asarray(jax.jit(jd.emulate_decode_attention_int8)(
        jnp.asarray(q), kc, ks, vc, vs, jnp.asarray(valid)))
    got = td.emulate_decode_attention_int8(
        *[torch.from_numpy(np.array(a)) for a in (q, kc, ks, vc, vs, valid)]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert not got[1].any()


def _chunked_mirror(q, kc, ks, vc, vs, valid, rows):
    """Kernel 10's arithmetic over chunks of ``rows`` slots, in plain torch:
    each chunk's scores (past hd 512 a row's q·k as the sum of its 512-wide
    segments' dots, in segment order), m_c and l_c = Σ exp(s − m_c); then
    m = max m_c, l = Σ_c l_c·exp(m_c − m) in chunk order, p = bf16((exp(s −
    m) / l)·v_scale) and the chunks' partial ctx added in chunk order; zero
    rows with no valid slot (the wrapper's gate)."""
    hd, s = q.shape[-1], kc.shape[2]
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    bias = torch.where(valid != 0, 0.0, -1e30).float()[:, None, None, :]
    seg = hd if hd <= 512 else 512
    dots = torch.zeros(q.shape[:3] + (s,), dtype=torch.float32)
    for c0 in range(0, hd, seg):
        dots = dots + torch.einsum("bhgd,bhsd->bhgs", q[..., c0:c0 + seg].bfloat16().float(),
                                   kc[..., c0:c0 + seg].float())
    sc = dots * (ks * scale)[:, :, None, :] + bias
    bounds = [(c, min(s, c + rows)) for c in range(0, s, rows)]
    m_c = torch.stack([sc[..., a:b].amax(-1) for a, b in bounds], -1)
    l_c = torch.stack([torch.exp(sc[..., a:b] - m_c[..., i, None]).sum(-1)
                       for i, (a, b) in enumerate(bounds)], -1)
    m = m_c.amax(-1)
    t = l_c * torch.exp(m_c - m[..., None])
    l = torch.zeros_like(m)
    for i in range(len(bounds)):
        l = l + t[..., i]
    p = (torch.exp(sc - m[..., None]) / torch.clamp_min(l, 1e-30)[..., None]
         * vs[:, :, None, :]).bfloat16().float()
    out = torch.zeros(q.shape, dtype=torch.float32)
    for a, b in bounds:
        out = out + torch.einsum("bhgs,bhsd->bhgd", p[..., a:b], vc[:, :, a:b].float())
    return out * (valid != 0).any(dim=1).float()[:, None, None, None]


def _masked_chunks_case(seed, g, s=256, hkv=2):
    """Three batch rows: valid only in a window inside one 96-row chunk (so
    the other chunks are fully masked), no valid slot, every slot valid."""
    from crs_tpu.ops.decode_attention import quantize_kv_rows

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, hkv, g, 128)).astype(np.float32)
    k = rng.standard_normal((3, hkv, s, 128)).astype(np.float32)
    v = (rng.standard_normal((3, hkv, s, 128)) * 0.5 + 0.2).astype(np.float32)
    kc, ks = jax.jit(quantize_kv_rows)(jnp.asarray(k))
    vc, vs = jax.jit(quantize_kv_rows)(jnp.asarray(v))
    valid = np.zeros((3, s), dtype=bool)
    valid[0, 100:150] = True
    valid[2] = True
    return q, kc, ks, vc, vs, valid


@pytest.mark.parametrize("rows", [32, 96, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_chunked_mirror_matches_pallas(g, rows):
    """The split over S keeps the function: the chunked arithmetic agrees
    with crs_tpu's Pallas kernel through fully masked chunks, a ragged last
    chunk and a row with no valid slot."""
    from crs_tpu.ops import decode_attention as jd

    q, kc, ks, vc, vs, valid = _masked_chunks_case(g * 10 + rows, g)
    ref = np.asarray(jd.decode_attention_int8(jnp.asarray(q), kc, ks, vc, vs, jnp.asarray(valid)))
    ops = [torch.from_numpy(np.array(a)) for a in (q, kc, ks, vc, vs, valid)]
    got = _chunked_mirror(*ops, rows)
    qb = ops[0].bfloat16().float()
    sc = torch.einsum("bhgd,bhsd->bhgs", qb, ops[1].float()) * ops[2][:, :, None, :] / 128 ** 0.5
    sc = torch.where(ops[5][:, None, None, :], sc, -1e30)
    p = torch.softmax(sc, -1) * ops[4][:, :, None, :]
    terms = p.abs()[..., None] * ops[3].float().abs()[:, :, None]
    tol = SUM_RTOL * terms.sum(3) + 2 ** -8 * terms.amax(3) + 1e-6
    assert np.all(np.abs(got.numpy() - ref) <= tol.numpy())
    assert not got[1].any() and not np.asarray(ref)[1].any()
    assert got[0].abs().sum() > 0 and got[2].abs().sum() > 0


@pytest.mark.parametrize("hd", [640, 1024])
def test_head_dims_past_512_match_pallas(hd):
    """Past hd 512 (the kernel reads a row in 512-byte segments): the port's
    decode attention on the CPU (the plain version) and the segmented,
    chunked mirror of the kernel's arithmetic agree with crs_tpu's Pallas
    kernel in interpret mode, a batch row with no valid slot included."""
    from crs_tpu.ops import decode_attention as jd

    from crs_tpu_torch.ops import decode_attention as td

    q, kc, ks, vc, vs, valid = _case(hd, 2, 2, 2, 256, hd=hd)
    assert jd.decode_attention_supported(hd, 256) and td.decode_attention_supported(hd, 256)
    ref = np.asarray(jd.decode_attention_int8(jnp.asarray(q), kc, ks, vc, vs, jnp.asarray(valid)))
    ops = [torch.from_numpy(np.array(a)) for a in (q, kc, ks, vc, vs, valid)]
    qb = ops[0].bfloat16().float()
    sc = torch.einsum("bhgd,bhsd->bhgs", qb, ops[1].float()) * ops[2][:, :, None, :] / hd ** 0.5
    sc = torch.where(ops[5][:, None, None, :], sc, -1e30)
    terms = (torch.softmax(sc, -1) * ops[4][:, :, None, :]).abs()[..., None] \
        * ops[3].float().abs()[:, :, None]
    tol = SUM_RTOL * terms.sum(3) + 2 ** -8 * terms.amax(3) + 1e-6
    for got in (td.decode_attention_int8(*ops), _chunked_mirror(*ops, 96)):
        assert got.shape == (2, 2, 2, hd)
        assert np.all(np.abs(got.numpy() - ref) <= tol.numpy())
        assert not got[1].any() and not np.asarray(ref)[1].any()


@pytest.mark.parametrize("bh", [1, 8, 16, 24, 64, 256])
@pytest.mark.parametrize("s", [128, 256, 2176, 4096, 32768])
def test_split_plan_fills_the_card(bh, s):
    """Chunks are whole steps of 32 rows within the kernel's limits, cover S
    with no empty chunk, and give 2 blocks per SM wherever S has the rows."""
    from crs_tpu_torch.ops import decode_attention as td

    rows, nchunk = td.split_plan(bh, s, 132)
    assert rows % td.ROWS_PER_STEP == 0 and td.ROWS_PER_STEP <= rows <= td.MAX_CHUNK_ROWS
    assert 1 <= nchunk <= td.MAX_CHUNKS and (nchunk - 1) * rows < s <= nchunk * rows
    assert bh * nchunk >= min(2 * 132, bh * (s // td.ROWS_PER_STEP), bh * td.MAX_CHUNKS)
    if bh >= 2 * 132:
        assert rows == min(td.MAX_CHUNK_ROWS, s) or nchunk == -(-s // td.MAX_CHUNK_ROWS)


def test_split_plan_main_shapes():
    """The 1b decode step's cache (Hkv 8, S 2176): 34 chunks of 64 rows at
    B = 1, 6 of 384 at B = 8 — 272 and 384 blocks on 132 SMs."""
    from crs_tpu_torch.ops import decode_attention as td

    assert td.split_plan(8, 2176, 132) == (64, 34)
    assert td.split_plan(64, 2176, 132) == (384, 6)
