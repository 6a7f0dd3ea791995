"""The port's int4 / NF4 weight-only matmuls (kernels 8 and 9) and weight
quantization against ``crs_tpu``'s.

The JAX side runs as its own tests run it: ``q4_matmul`` and
``nf4_matmul`` in Pallas interpret mode. The port runs the kernels' plain
torch versions (``emulate_q4_matmul`` / ``emulate_nf4_matmul``), which the
wrappers take for CPU tensors.

Tolerances:
- quantization: codes and scales bit for bit;
- the products: |port − crs_tpu| ≤ 1e-5 · Σ_k |x_k·w_k,n| + 1e-6. Every
  bf16 × bf16 product is exact in f32, so only the order of the f32 sums
  differs;
- the int8 route of ``qmatmul``: bit for bit (an exact int32 product);
- the kernel's whole-byte dequant tables (int4, NF4): bit for bit against the plain
  version's bf16 weights.
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


def _weights(rng, k, n):
    return (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)


def _abs_sum(x, codes, scales, nf4):
    """Σ_k |x_k·w_k,n| for the kernels' bf16 weights (the tolerance scale)."""
    from crs_tpu_torch.ops import qgemm

    vals = qgemm._unpack_nf4(codes) if nf4 else qgemm._unpack_int4(codes).float()
    w = (vals.to(torch.bfloat16)
         * torch.repeat_interleave(scales, vals.shape[0] // scales.shape[0], 0).to(torch.bfloat16))
    return x.to(torch.bfloat16).float().abs() @ w.float().abs()


@pytest.mark.parametrize("bits", [8, 4, "nf4", 2, 3])
@pytest.mark.parametrize("k,n,group", [(256, 128, 128), (512, 640, 128), (384, 256, 256)])
def test_quantize_tensor_bits(bits, k, n, group):
    from crs_tpu.models.quantized import quantize_tensor as jq

    from crs_tpu_torch.models.quantized import quantize_tensor as tq

    w = _weights(np.random.default_rng(k + n), k, n)
    w[3, 5] = 0.0
    w[:, 7] = 0.0  # an all-zero column: the 1e-12 scale floor
    ref, got = jq(w, bits=bits, group_size=group), tq(torch.from_numpy(w), bits=bits,
                                                     group_size=group)
    assert (got.bits, got.group_size, got.shape) == (ref.bits, ref.group_size, ref.shape)
    assert np.array_equal(got.codes.numpy(), np.asarray(ref.codes))
    assert got.codes.dtype == {"nf4": torch.uint8}.get(bits, torch.int8)
    assert np.array_equal(got.scales.numpy(), np.asarray(ref.scales))
    assert np.array_equal(got.dequantize().numpy(), np.asarray(ref.dequantize()))


def test_tensor_from_int_codes_packs_like_quantize():
    from crs_tpu.models.quantized import tensor_from_int_codes as jt

    from crs_tpu_torch.models.quantized import tensor_from_int_codes as tt

    rng = np.random.default_rng(3)
    vals = rng.integers(-7, 8, (256, 128)).astype(np.int8)
    scales = rng.random((2, 128)).astype(np.float32)
    for bits in (4, 3):
        ref, got = jt(vals, scales, bits, 128), tt(vals, scales, bits, 128)
        assert np.array_equal(got.codes.numpy(), np.asarray(ref.codes))


@pytest.mark.parametrize("nf4", [False, True], ids=["int4", "nf4"])
@pytest.mark.parametrize("r", [1, 5, 64])
@pytest.mark.parametrize("k,n", [(256, 128), (512, 256), (512, 640)])
def test_q4_matmul_matches_pallas_and_emulation(nf4, r, k, n):
    from crs_tpu.models.quantized import quantize_tensor
    from crs_tpu.ops import qgemm as jq

    from crs_tpu_torch.ops import qgemm as tq

    rng = np.random.default_rng(r * 7 + k + n)
    qt = quantize_tensor(_weights(rng, k, n), bits="nf4" if nf4 else 4, group_size=128)
    assert jq.q4_pallas_supported(r, k // 2, n, qt.scales.shape[0])
    assert tq.q4_pallas_supported(r, k // 2, n, qt.scales.shape[0])
    x = rng.standard_normal((r, k)).astype(np.float32)
    pallas = (jq.nf4_matmul if nf4 else jq.q4_matmul)(jnp.asarray(x), qt.codes, qt.scales)
    emul = (jq.emulate_nf4_matmul if nf4 else jq.emulate_q4_matmul)(jnp.asarray(x), qt.codes,
                                                                   qt.scales)
    codes, scales = torch.from_numpy(np.array(qt.codes)), torch.from_numpy(np.array(qt.scales))
    xt = torch.from_numpy(x)
    got = (tq.nf4_matmul if nf4 else tq.q4_matmul)(xt, codes, scales)
    assert got.dtype == torch.float32 and got.shape == (r, n)
    plain = (tq.emulate_nf4_matmul if nf4 else tq.emulate_q4_matmul)(xt, codes, scales)
    assert torch.equal(got, plain)  # a CPU tensor takes the plain version
    tol = SUM_RTOL * _abs_sum(xt, codes, scales, nf4).numpy() + 1e-6
    assert np.all(np.abs(got.numpy() - np.asarray(pallas)) <= tol)
    assert np.all(np.abs(got.numpy() - np.asarray(emul)) <= tol)


def test_tile_gate_matches_crs_tpu():
    from crs_tpu.ops import qgemm as jq

    from crs_tpu_torch.ops import qgemm as tq

    for rows in (1, 64, 65, 512):
        for k2, n, g in ((128, 512, 1), (256, 512, 2), (256, 100, 2), (64, 512, 1), (1024, 512, 8),
                         (2816, 2048, 44), (1024, 32000, 16)):
            assert tq.q4_pallas_supported(rows, k2, n, g) == jq.q4_pallas_supported(rows, k2, n, g)
    assert np.array_equal(tq.NF4_LEVELS, jq.NF4_LEVELS)


@pytest.mark.parametrize("bits", [8, 4, "nf4", 3])
@pytest.mark.parametrize("rows", [3, 96])
def test_qmatmul_routes_like_crs_tpu(bits, rows):
    """Decode-sized int4 / nf4 rows take the kernel's plain version, larger
    ones the dequantized bf16 product; int8 the exact int8 product."""
    from crs_tpu.models.quantized import qmatmul as jqm, quantize_tensor

    from crs_tpu_torch.convert import params_from_numpy
    from crs_tpu_torch.models.quantized import qmatmul as tqm

    rng = np.random.default_rng(rows)
    qt = quantize_tensor(_weights(rng, 256, 384), bits=bits, group_size=128)
    x = jnp.asarray(rng.standard_normal((rows, 256)).astype(np.float32), jnp.bfloat16)
    ref = np.asarray(jax.jit(jqm)(x, qt).astype(jnp.float32))
    got = tqm(params_from_numpy(np.asarray(x)), params_from_numpy(qt))
    assert got.dtype == torch.bfloat16 and got.shape == (rows, 384)
    if bits == 8:
        assert np.array_equal(got.float().numpy(), ref)
    else:  # bf16 outputs: one rounding apart where the f32 sums differ in order
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7, atol=1e-6)


def test_int8_product_is_exact_past_float32():
    """127²·K > 2²⁴: float32 sums would round; the port's product may not."""
    from crs_tpu_torch.models.quantized import _int8_product

    k = 4096
    a = torch.full((2, k), 127, dtype=torch.int8)
    b = torch.full((k, 8), 127, dtype=torch.int8)
    b[0, 0] = 126
    out = _int8_product(a, b)
    assert out.dtype == torch.int32
    assert int(out[0, 0]) == 127 * 127 * (k - 1) + 127 * 126
    assert int(out[0, 1]) == 127 * 127 * k


def test_params_num_bytes_counts_packed_width():
    from crs_tpu_torch.models.quantized import params_num_bytes, quantize_tensor

    w = torch.from_numpy(_weights(np.random.default_rng(0), 256, 128))
    assert params_num_bytes(quantize_tensor(w, bits=4)) == 128 * 128 + 2 * 128 * 4
    assert params_num_bytes({"a": [w.bfloat16()], "b": quantize_tensor(w, bits=8)}) == \
        256 * 128 * 2 + 256 * 128 + 128 * 4


# the chip smoke's shapes of kernel 9: 1b's linear layers, mistral-7b's MLP,
# and the edge shapes (N = 128, a deep K into N = 1024)
NF4_SHAPES = ((2048, 2048), (2048, 1024), (2048, 5632), (5632, 2048), (2048, 32000),
              (4096, 14336), (14336, 4096), (2048, 128), (5632, 1024))


@pytest.mark.parametrize("k,n", NF4_SHAPES)
def test_nf4_plan_covers_the_weight_once(k, n):
    """For R = 1..64: every row of x in one pass over the weight (no row
    tiles), the f32 sums within 64 registers, whole column slabs, K cut into
    non-empty group-aligned slices, at most one cluster's worth of them (the
    slices meet in distributed shared memory: no partial reaches device
    memory), and a grid within a factor 2 of the planner's target unless a
    cap (the cluster, the group count, one slice) stops it."""
    from crs_tpu_torch.ops import qgemm as tq

    k2, gs2, sms = k // 2, 64, 132
    groups = k2 // gs2
    target = tq.NF4_BLOCKS_PER_SM * sms
    for r in range(1, 65):
        plan = tq.nf4_plan(r, k2, n, gs2, sms)
        assert 8 * plan.n_tiles >= r > 8 * plan.n_tiles // 2 or plan.n_tiles == 1
        assert plan.width in (16, 8, 4) and 2 * plan.width * plan.n_tiles <= 64
        assert plan.warps_n == (8 if plan.n_tiles == 8 and n >= tq.NF4_WIDE_N else 1)
        assert n % plan.block_cols == 0
        assert plan.slice_rows % gs2 == 0 and plan.slice_rows > 0
        assert (plan.ksplit - 1) * plan.slice_rows < k2 <= plan.ksplit * plan.slice_rows
        assert 1 <= plan.ksplit <= tq.NF4_MAX_SPLIT
        blocks = plan.blocks(n)
        assert blocks >= target / 2 or plan.ksplit in (groups, tq.NF4_MAX_SPLIT)
        assert blocks <= 2 * target or plan.ksplit == 1


def test_nf4_plan_main_shapes():
    """The 1b decode step at R = 8 on 132 SMs: (n-tiles, width, K slices)."""
    from crs_tpu_torch.ops import qgemm as tq

    plans = {(k, n): tq.nf4_plan(8, k // 2, n, 64, 132) for k, n in NF4_SHAPES[:5]}
    assert {kn: (p.n_tiles, p.width, p.ksplit) for kn, p in plans.items()} == {
        (2048, 2048): (1, 16, 6), (2048, 1024): (1, 8, 6), (2048, 5632): (1, 16, 2),
        (5632, 2048): (1, 16, 6), (2048, 32000): (1, 16, 1)}


def _check_byte_table(kind):
    """The kernel dequantises a whole byte: the table's bf16 pair (low
    nibble, high nibble) times bf16(scale), the exact product rounded once
    (bf16x2 multiply), equals the plain version's bf16 weights bit for bit
    for all 256 bytes over a spread of scales."""
    from crs_tpu_torch.ops import qgemm as tq

    table = tq.nf4_byte_table() if kind == "nf4" else tq.int4_byte_table()
    assert table.dtype == np.uint32 and table.shape == (256,)
    # the kernel's copy: each entry once per lane, entry e of lane l at 32·e + l
    lanes = tq._lane_table(torch.device("cpu"), kind).numpy().view(np.uint32).reshape(256, 32)
    assert np.array_equal(lanes, np.repeat(table[:, None], 32, axis=1))
    rng = np.random.default_rng(0)
    spread = np.concatenate([10.0 ** np.arange(-12, 4), rng.random(48) * 0.05,
                             rng.standard_normal(16) * 3]).astype(np.float32)
    codes = torch.from_numpy(np.tile(np.arange(256, dtype=np.uint8), (64, len(spread))))
    scales = torch.from_numpy(np.repeat(spread, 256)[None, :].copy())  # one group
    # the plain version's weights, as _emulate forms them
    vals = tq._unpack_nf4(codes) if kind == "nf4" else tq._unpack_int4(codes.view(torch.int8))
    w = vals.to(torch.bfloat16) * torch.repeat_interleave(scales, 128, 0).to(torch.bfloat16)
    words = torch.from_numpy(table.view(np.int32)).long() & 0xFFFFFFFF
    lo = (words & 0xFFFF).to(torch.int16).view(torch.bfloat16)
    hi = (words >> 16).to(torch.int16).view(torch.bfloat16)
    s = scales[0].to(torch.bfloat16).double()
    byte = codes[0].long()
    got_lo = (lo[byte].double() * s).to(torch.bfloat16)  # the exact product, one rounding
    got_hi = (hi[byte].double() * s).to(torch.bfloat16)
    assert torch.equal(got_lo.view(torch.int16), w[0].view(torch.int16))
    assert torch.equal(got_hi.view(torch.int16), w[1].view(torch.int16))


def test_nf4_byte_table_reproduces_the_plain_weights():
    _check_byte_table("nf4")


def test_int4_byte_table_reproduces_the_plain_weights():
    """int4's table (sign-extended nibbles) against ``emulate_q4_matmul``'s
    weights: the twin of the NF4 test, since one kernel serves both."""
    _check_byte_table("int4")


# (packed rows per group, K, N): each K holds whole groups
PLAN_GROUP_CASES = [(gs2, k, n) for gs2 in (1, 4, 12, 24, 64)
                    for k, n in ((2048, 2048), (5632, 2048), (2048, 32000), (6144, 1024))
                    if (k // 2) % gs2 == 0]


@pytest.mark.parametrize("gs2,k,n", PLAN_GROUP_CASES)
def test_nf4_plan_takes_groups_off_the_step(gs2, k, n):
    """Groups of any even size: every K slice holds whole groups and whole
    8-row k steps, the slices cover K once, and the group count caps the
    split only in units of lcm(gs2, 8) packed rows."""
    import math

    from crs_tpu_torch.ops import qgemm as tq

    k2 = k // 2
    unit = math.lcm(gs2, 8)
    for r in (1, 3, 8, 17, 64):
        plan = tq.nf4_plan(r, k2, n, gs2, 132)
        assert plan.slice_rows % unit == 0 and plan.slice_rows > 0
        assert (plan.ksplit - 1) * plan.slice_rows < k2 <= plan.ksplit * plan.slice_rows
        assert 1 <= plan.ksplit <= min(tq.NF4_MAX_SPLIT, k2 // unit)


@pytest.mark.parametrize("nf4", [False, True], ids=["int4", "nf4"])
@pytest.mark.parametrize("gs2,k", [(1, 256), (4, 256), (12, 384)])
def test_q4_matmul_off_step_groups_match_crs_tpu(nf4, gs2, k):
    """Groups of 2, 8 and 24 rows (packed rows 1, 4, 12: off the kernel's
    8-row step): the port's plain version (the kernel's arithmetic) against
    ``crs_tpu``'s emulation on the same codes, and against its Pallas kernel
    where its gate takes the shape."""
    from crs_tpu.models.quantized import quantize_tensor
    from crs_tpu.ops import qgemm as jq

    from crs_tpu_torch.ops import qgemm as tq

    rng = np.random.default_rng(gs2 * 31 + k)
    n, r = 256, 5
    qt = quantize_tensor(_weights(rng, k, n), bits="nf4" if nf4 else 4, group_size=2 * gs2)
    assert np.asarray(qt.scales).shape == (k // (2 * gs2), n)
    x = rng.standard_normal((r, k)).astype(np.float32)
    codes, scales = torch.from_numpy(np.array(qt.codes)), torch.from_numpy(np.array(qt.scales))
    xt = torch.from_numpy(x)
    got = (tq.nf4_matmul if nf4 else tq.q4_matmul)(xt, codes, scales)
    tol = SUM_RTOL * _abs_sum(xt, codes, scales, nf4).numpy() + 1e-6
    emul = (jq.emulate_nf4_matmul if nf4 else jq.emulate_q4_matmul)(jnp.asarray(x), qt.codes,
                                                                   qt.scales)
    assert np.all(np.abs(got.numpy() - np.asarray(emul)) <= tol)
    g = k // (2 * gs2)
    assert tq.q4_pallas_supported(r, k // 2, n, g) == jq.q4_pallas_supported(r, k // 2, n, g)
    if jq.q4_pallas_supported(r, k // 2, n, g):
        pallas = (jq.nf4_matmul if nf4 else jq.q4_matmul)(jnp.asarray(x), qt.codes, qt.scales)
        assert np.all(np.abs(got.numpy() - np.asarray(pallas)) <= tol)
