"""The fused MLP (TPU kernel 11) and the fused projections of the port against
``crs_tpu``.

``crs_tpu``'s ``fused_mlp_int8`` runs its Pallas kernel in interpret mode on
the CPU; the port's wrapper runs its plain version there. Inputs are made
from numpy seeds and handed to both packages.

Tolerances:
- ``fused_mlp_int8``: |port − crs_tpu| ≤ 1e-5·max|crs_tpu|. XLA evaluates
  rsqrt and exp with its own approximations and sums the squares in its own
  order, so the f32 values differ in the last ulps (observed ≤ 2.1e-7
  relative); a hidden code moved by one step would show as ~1e-3;
- ``fused_mlp_layout`` / ``fused_mlp_supported``: exact;
- a decode step through ``fuse_mlp_params``: bf16 logits bit-identical (the
  rounding to bf16 absorbs the ulps), f32 logits within 1e-5·max|logit|;
- ``fuse_qkv_params``: the fused weights bit-identical to ``crs_tpu``'s;
  int8 fused logits identical to unfused in both packages; bf16 / int4 /
  nf4 fused logits within the generator tests' 0.05 of ``crs_tpu``'s.
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


MLP_RTOL = 1e-5
LOGIT_ATOL = 0.05
DIMS = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=256, max_seq_len=64)


def _mlp_inputs(seed, h, inter, b):
    """x, the norm scale and int8 gate / up / down with per-channel scales."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h)) * 0.3).astype(np.float32)
    ns = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)

    def qw(k, n):
        w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
        s = (np.abs(w).max(axis=0) / 127.0).astype(np.float32)
        return np.clip(np.round(w / s[None, :]), -127, 127).astype(np.int8), s

    return x, ns, (*qw(h, inter), *qw(h, inter), *qw(inter, h))


@pytest.mark.parametrize("h,inter,b", [(128, 256, 1), (128, 512, 3), (256, 256, 8),
                                       (256, 512, 1), (256, 512, 8)])
def test_fused_mlp_matches_crs_tpu(h, inter, b):
    from crs_tpu.ops import fused_mlp as jf

    from crs_tpu_torch.ops import fused_mlp as tf

    chunk = 128
    x, ns, weights = _mlp_inputs(h + inter + b, h, inter, b)
    lay_j = jf.fused_mlp_layout(*[jnp.asarray(a) for a in weights], chunk=chunk)
    ref = np.asarray(jf.fused_mlp_int8(jnp.asarray(x), jnp.asarray(ns), *lay_j, chunk=chunk))
    lay_t = tf.fused_mlp_layout(*[torch.from_numpy(a) for a in weights], chunk=chunk)
    got, codes = tf.fused_mlp_int8(torch.from_numpy(x), torch.from_numpy(ns), *lay_t,
                                   chunk=chunk, return_codes=True)
    assert got.shape == (b, h) and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= MLP_RTOL * np.abs(ref).max()
    assert codes.hq.shape == (b, inter) and codes.hs.shape == (b, inter // chunk)
    # the codes re-form the output: x + Σ_c (hq_c · down_c) · hs_c · s_down, in chunk order
    down = torch.from_numpy(weights[4]).double()
    y = torch.zeros((b, h), dtype=torch.float32)
    for c in range(inter // chunk):
        part = (codes.hq[:, c * chunk:(c + 1) * chunk].double() @ down[c * chunk:(c + 1) * chunk])
        y = y + part.float() * codes.hs[:, c:c + 1]
    assert torch.equal(torch.from_numpy(x) + y * torch.from_numpy(weights[5]), got)


def test_fused_mlp_layout_and_gate_exact():
    from crs_tpu.ops import fused_mlp as jf

    from crs_tpu_torch.ops import fused_mlp as tf

    _, _, weights = _mlp_inputs(7, 256, 512, 1)
    for chunk in (128, 256, 512):
        ref = jf.fused_mlp_layout(*[jnp.asarray(a) for a in weights], chunk=chunk)
        got = tf.fused_mlp_layout(*[torch.from_numpy(a) for a in weights], chunk=chunk)
        for r, g in zip(ref, got):
            assert g.shape == r.shape and np.array_equal(g.numpy(), np.asarray(r))
        assert got[0].is_contiguous() and got[2].is_contiguous()
    for batch in (1, 8, 9):
        for hidden in (128, 200, 4096):
            for inter in (1024, 1536, 5632, 14336):
                for chunk in (128, 1024):
                    args = (batch, hidden, inter, chunk)
                    assert tf.fused_mlp_supported(*args) == jf.fused_mlp_supported(*args)
    assert tf.fused_mlp_supported(8, 4096, 14336) and not tf.fused_mlp_supported(8, 2048, 5632)


def _cfgs(dtype_name, kv_bits):
    from crs_tpu.models.transformer import TransformerConfig as JC

    from crs_tpu_torch.models.transformer import TransformerConfig as TC

    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[
        dtype_name]
    return JC(**DIMS, dtype=jdt, kv_bits=kv_bits), TC(**DIMS, dtype=tdt, kv_bits=kv_bits)


def _int8_params(cj):
    from crs_tpu.models.quantized import quantize_params
    from crs_tpu.models.transformer import init_params

    from crs_tpu_torch.convert import params_from_numpy

    jp = quantize_params(init_params(0, cj), bits=8)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("kv_bits", [8, 16])
@pytest.mark.parametrize("dtype_name", ["bf16", "f32"])
def test_fused_mlp_decode_matches_crs_tpu(monkeypatch, dtype_name, kv_bits):
    """fuse_mlp_params, a prefill of 12 rows (the unfused route) and two
    decode steps of 2 rows (the fused MLP, once per layer and step)."""
    from crs_tpu.models import transformer as jt

    from crs_tpu_torch.models import transformer as tt

    cj, ct = _cfgs(dtype_name, kv_bits)
    jp, tp = _int8_params(cj)
    jf, tf = jt.fuse_mlp_params(jp, chunk=128), tt.fuse_mlp_params(tp, chunk=128)
    for lj, lt in zip(jf["layers"], tf["layers"]):
        for key, ref in lj["mlp"]["fused"].items():
            assert np.array_equal(lt["mlp"]["fused"][key].numpy(), np.asarray(ref))
    calls = []
    real = tt.fused_mlp_int8
    monkeypatch.setattr(tt, "fused_mlp_int8", lambda *a, **k: calls.append(1) or real(*a, **k))

    rng = np.random.default_rng(0)
    ids, mask = rng.integers(0, 256, (2, 6)), np.ones((2, 6), bool)
    mask[1, :2] = False
    lj, cache_j = jt.prefill(jf, cj, jnp.asarray(ids, jnp.int32), jt.init_cache(cj, 2, 32),
                             jnp.asarray(mask))
    lt, cache_t = tt.prefill(tf, ct, torch.from_numpy(ids), tt.init_cache(ct, 2, 32),
                             torch.from_numpy(mask))
    assert not calls  # 12 prefill rows: the unfused route
    outs = [(lt, lj)]
    for tok in ([3, 5], [100, 7]):
        lj, cache_j = jt.decode_step(jf, cj, jnp.asarray(tok, jnp.int32), cache_j)
        lt, cache_t = tt.decode_step(tf, ct, torch.tensor(tok), cache_t)
        outs.append((lt, lj))
    assert len(calls) == 2 * DIMS["num_layers"]
    for got, ref in outs:
        ref = np.asarray(ref)
        if dtype_name == "bf16":
            assert np.array_equal(got.numpy(), ref)
        else:
            assert np.abs(got.numpy() - ref).max() <= MLP_RTOL * np.abs(ref).max()


def test_fuse_mlp_params_skips_what_the_kernel_does_not_take():
    """Only int8 layers whose I divides by the chunk and H by 128 take the
    layout — at chunk 1024 only mistral-7b's I (14336) among the presets."""
    from crs_tpu_torch.models import transformer as tt

    cj, _ = _cfgs("bf16", 16)
    bf16, int8 = _both_quantized(cj, None)[1], _int8_params(cj)[1]
    assert "fused" not in tt.fuse_mlp_params(int8)["layers"][0]["mlp"]  # I 256 % 1024
    assert "fused" in tt.fuse_mlp_params(int8, chunk=256)["layers"][0]["mlp"]
    assert "fused" not in tt.fuse_mlp_params(bf16, chunk=128)["layers"][0]["mlp"]
    int4 = _both_quantized(cj, 4)[1]
    assert "fused" not in tt.fuse_mlp_params(int4, chunk=128)["layers"][0]["mlp"]
    for name, cfg in tt.CONFIGS.items():
        ok = cfg.intermediate_size % 1024 == 0 and cfg.hidden_size % 128 == 0
        assert ok == (name == "mistral-7b"), name


def _both_quantized(cj, bits):
    """(crs_tpu params, the port's) from one init, each package quantizing its own."""
    from crs_tpu.models.quantized import quantize_params as jq
    from crs_tpu.models.transformer import init_params

    from crs_tpu_torch.convert import params_from_numpy
    from crs_tpu_torch.models.quantized import quantize_params as tq

    jp = init_params(0, cj)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    if bits is None:
        return jp, tp
    return jq(jp, bits=bits, group_size=64), tq(tp, bits=bits, group_size=64)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "codes"):
        return [tree.codes, tree.scales]
    return [tree]


def _as_numpy(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("bits", [None, 8, 4, "nf4"], ids=["bf16", "int8", "int4", "nf4"])
def test_fuse_qkv_params_matches_crs_tpu(bits):
    from crs_tpu.models import transformer as jt

    from crs_tpu_torch.models import transformer as tt

    cj, ct = _cfgs("bf16", 16)
    jp, tp = _both_quantized(cj, bits)
    jf, tf = jt.fuse_qkv_params(jp), tt.fuse_qkv_params(tp)
    layer = tf["layers"][0]
    assert set(layer["attn"]) == {"qkv", "o"} and set(layer["mlp"]) == {"gateup", "down"}
    lj, lt = _leaves(jf), _leaves(tf)
    assert len(lj) == len(lt)
    for r, g in zip(lj, lt):
        assert np.array_equal(_as_numpy(g), _as_numpy(r))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (2, 8))
    ref = np.asarray(jt.forward(jf, cj, jnp.asarray(ids, jnp.int32)))
    got = tt.forward(tf, ct, torch.from_numpy(ids)).numpy()
    assert np.abs(got - ref).max() <= LOGIT_ATOL
    if bits == 8:  # exact: one activation scale per row, per-column weight scales
        ref_unfused = np.asarray(jt.forward(jp, cj, jnp.asarray(ids, jnp.int32)))
        assert np.array_equal(ref, ref_unfused)
        assert np.array_equal(got, tt.forward(tp, ct, torch.from_numpy(ids)).numpy())


def test_fuse_qkv_params_rejects_mixed_widths():
    from crs_tpu_torch.models.quantized import quantize_tensor
    from crs_tpu_torch.models.transformer import _concat_out

    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        _concat_out([quantize_tensor(w, bits=8), quantize_tensor(w, bits=4, group_size=32)])
    assert torch.equal(_concat_out([w, w]), torch.cat([w, w], 1))
