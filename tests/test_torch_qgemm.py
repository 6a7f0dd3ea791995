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
- the int8 route of ``qmatmul``: bit for bit (an exact int32 product).
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
