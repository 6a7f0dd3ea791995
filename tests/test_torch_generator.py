"""The port's causal LM against ``crs_tpu``: weights, quantization, logits,
greedy decoding and the sampling filters (checkpoints, answer generation and
the RAG pipeline are in ``tests/test_torch_rag_generation.py``).

The model config has head_dim 128 and 128-aligned widths, so ``crs_tpu``
itself takes its Pallas kernels (q4 / NF4 matmul at ≤ 64 rows, int8 decode
attention), in interpret mode, and the port takes their plain versions.

Tolerances:
- ``init_params``: bits;
- logits (forward, prefill, decode; bf16 activations): |port − crs_tpu| ≤
  0.05, and the same argmax wherever the top logit leads by more than 0.1
  (bf16 logits tie often). Both packages round every bf16 op
  alike (XLA's fusions mirrored in ``models/transformer.py``), so what is
  left is the order of f32 sums under a bf16 rounding: one or two bf16
  steps (2⁻⁶ at the logits' magnitude of 2–4);
- greedy tokens and the sampling filters: identical.
"""

import pathlib

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


REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = REPO / "results" / "selftrained" / "heldout_corpus.txt"
QA = REPO / "results" / "selftrained" / "heldout_qa.json"
DIMS = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
            intermediate_size=512, max_seq_len=4096)
LOGIT_ATOL = 0.05
CFG_NAME = "kernel_shapes_test"


def _cfgs(kv_bits=16):
    from crs_tpu.models.transformer import TransformerConfig as JC

    from crs_tpu_torch.models.transformer import TransformerConfig as TC

    return JC(**DIMS, kv_bits=kv_bits), TC(**DIMS, kv_bits=kv_bits)


@pytest.fixture(scope="module")
def jax_params():
    from crs_tpu.models.transformer import init_params

    return init_params(3, _cfgs()[0])


@pytest.fixture(scope="module")
def both_params(jax_params):
    """{bits: (crs_tpu params, the port's params)}, quantized by each package."""
    from crs_tpu.models.quantized import quantize_params as jq

    from crs_tpu_torch.convert import params_from_numpy
    from crs_tpu_torch.models.quantized import quantize_params as tq

    port = params_from_numpy(jax.tree.map(np.asarray, jax_params))
    out = {None: (jax_params, port)}
    for bits in (8, 4, "nf4"):
        out[bits] = (jq(jax_params, bits=bits), tq(port, bits=bits))
    return out


def test_init_params_bits(jax_params):
    from crs_tpu_torch.models.transformer import init_params

    port = init_params(3, _cfgs()[1])
    flat_j = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    assert len(flat_j) == 2 + 9 * DIMS["num_layers"] + 1
    for path, leaf in flat_j:
        node = port
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert node.dtype == torch.bfloat16
        assert np.array_equal(node.view(torch.int16).numpy(),
                              np.asarray(leaf).view(np.int16)), path


def test_port_quantizes_like_crs_tpu(both_params):
    for bits in (8, 4, "nf4"):
        jp, tp = both_params[bits]
        for name in ("q", "o"):
            ref, got = jp["layers"][1]["attn"][name], tp["layers"][1]["attn"][name]
            assert np.array_equal(got.codes.numpy(), np.asarray(ref.codes))
            assert np.array_equal(got.scales.numpy(), np.asarray(ref.scales))


def _prompt_batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 259, (2, 32))
    mask = np.ones((2, 32), bool)
    mask[1, :7] = False  # left padding
    return ids, mask


def _close(got: torch.Tensor, ref) -> None:
    """Logits within LOGIT_ATOL, and the same argmax wherever the reference's
    top logit leads the runner-up by more than 2·LOGIT_ATOL."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= LOGIT_ATOL
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * LOGIT_ATOL
    assert np.array_equal(got.numpy().argmax(-1)[clear], ref.argmax(-1)[clear])


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("bits", [None, 8, 4, "nf4"], ids=["bf16", "int8", "int4", "nf4"])
def test_logits_match(both_params, bits, kv_bits):
    """forward, then prefill (B·S = 64 rows: the q4 / NF4 kernels) and two
    decode steps (the int8 attention kernel with kv_bits 8)."""
    from crs_tpu.models import transformer as jt

    from crs_tpu_torch.models import transformer as tt

    jp, tp = both_params[bits]
    cj, ct = _cfgs(kv_bits)
    ids, mask = _prompt_batch()
    if kv_bits == 16:  # forward takes no cache: once per weight type
        _close(tt.forward(tp, ct, torch.from_numpy(ids), torch.from_numpy(mask)),
               jt.forward(jp, cj, jnp.asarray(ids), jnp.asarray(mask)))
    cache_j = jt.init_cache(cj, 2, 40)
    lj, cache_j = jt.prefill(jp, cj, jnp.asarray(ids), cache_j, jnp.asarray(mask))
    cache_t = tt.init_cache(ct, 2, 40)
    lt, cache_t = tt.prefill(tp, ct, torch.from_numpy(ids), cache_t, torch.from_numpy(mask))
    _close(lt, lj)
    assert cache_t.length == int(cache_j.length) == 32
    for tok in ([5, 77], [300, 2]):
        lj, cache_j = jt.decode_step(jp, cj, jnp.asarray(tok), cache_j)
        lt, cache_t = tt.decode_step(tp, ct, torch.tensor(tok), cache_t)
        _close(lt, lj)
    assert np.array_equal(cache_t.mask.numpy(), np.asarray(cache_j.mask))
    if kv_bits == 8:  # the int8 cache holds the same codes (S rounded up to 128)
        assert cache_t.k_codes.shape == cache_j.k_codes.shape == (2, 2, 1, 128, 128)
        same = (cache_t.k_codes.numpy() == np.asarray(cache_j.k_codes)).mean()
        assert same > 0.99


@pytest.fixture
def kernel_config(monkeypatch):
    """The test dims registered as a named config in both packages."""
    from crs_tpu.models import model_interface as jmi

    from crs_tpu_torch.models import model_interface as tmi

    cj, ct = _cfgs()
    monkeypatch.setitem(jmi.CONFIGS, CFG_NAME, cj)
    monkeypatch.setitem(tmi.CONFIGS, CFG_NAME, ct)
    return CFG_NAME


PROMPTS = ["Model compression", "What does the scaling law say about compressed models?"]


@pytest.mark.parametrize("kind", ["int4", "nf4"])
def test_greedy_generate_batch_identical(kernel_config, kind):
    """Greedy tokens through create_model_interface, kv_bits 8: a batch of
    two left-padded prompts and a batch of one (prompt bucket 32, so the
    prefill itself takes the q4 / NF4 kernel)."""
    from crs_tpu.models.model_interface import create_model_interface as jcmi

    from crs_tpu_torch.models.model_interface import create_model_interface as tcmi

    conf = {"config": kernel_config, "kv_bits": 8, "seed": 3}
    jm, tm = jcmi(kind, conf), tcmi(kind, conf, device="cpu")
    for batch in (PROMPTS, PROMPTS[:1]):
        ref = jm.generate_batch(batch, max_new_tokens=8)
        got = tm.generate_batch(batch, max_new_tokens=8)
        assert got == ref
    info = tm.get_model_info()
    assert info["kv_bits"] == 8 and info["quantization"] == kind
    assert info["model_size_gb"] == pytest.approx(jm.get_model_info()["model_size_gb"])


def test_generate_tokens_contract_and_eos():
    """tokens after a row's EOS are pad; lengths count the EOS."""
    from crs_tpu.models import sampling as js
    from crs_tpu.models.transformer import TransformerConfig, init_params

    from crs_tpu_torch.convert import params_from_numpy
    from crs_tpu_torch.models import sampling as ts
    from crs_tpu_torch.models.transformer import TransformerConfig as TC

    dims = dict(vocab_size=300, hidden_size=64, num_layers=1, num_heads=2, num_kv_heads=1,
                intermediate_size=128, max_seq_len=256)
    jp = init_params(1, TransformerConfig(**dims))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    ids, mask = _prompt_batch()
    ids = ids % 256
    first = np.asarray(js.generate_tokens(jp, TransformerConfig(**dims), jnp.asarray(ids),
                                          jnp.asarray(mask), jax.random.PRNGKey(0),
                                          js.SamplingParams(max_new_tokens=6))[0])
    eos = int(first[0, 2])  # make row 0 stop at its third token
    spj = js.SamplingParams(max_new_tokens=6, eos_id=eos, pad_id=258)
    spt = ts.SamplingParams(max_new_tokens=6, eos_id=eos, pad_id=258)
    tj, lj = js.generate_tokens(jp, TransformerConfig(**dims), jnp.asarray(ids), jnp.asarray(mask),
                                jax.random.PRNGKey(0), spj)
    tt_, lt = ts.generate_tokens(tp, TC(**dims), torch.from_numpy(ids), torch.from_numpy(mask),
                                 torch.Generator(), spt)
    assert np.array_equal(tt_.numpy(), np.asarray(tj)) and np.array_equal(lt.numpy(), np.asarray(lj))
    assert int(lt[0]) <= 3 and (tt_[0, int(lt[0]):] == 258).all()


# -- sampling filters -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampling_filters_match(seed):
    from crs_tpu.models import sampling as js

    from crs_tpu_torch.models import sampling as ts

    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((4, 300)) * 3).astype(np.float32)
    seen = rng.random((4, 300)) < 0.2
    lj, lt = jnp.asarray(logits), torch.from_numpy(logits)
    pen = jax.jit(js._apply_repetition_penalty, static_argnums=2)(lj, jnp.asarray(seen), 1.15)
    assert np.array_equal(ts._apply_repetition_penalty(lt, torch.from_numpy(seen), 1.15).numpy(),
                          np.asarray(pen))
    for k in (0, 1, 5, 300):
        assert np.array_equal(ts._top_k_filter(lt, k).numpy(), np.asarray(js._top_k_filter(lj, k)))
    for p in (0.5, 0.9, 1.0):
        assert np.array_equal(ts._top_p_filter(lt, p).numpy(), np.asarray(js._top_p_filter(lj, p)))
    greedy = ts._sample(lt, torch.Generator(), ts.SamplingParams(temperature=0.0))
    assert np.array_equal(greedy.numpy(), np.asarray(js._sample(lj, None, js.SamplingParams())))
    # a sampled draw keeps to the filtered support
    sp = ts.SamplingParams(temperature=0.3, top_p=0.5, top_k=5)
    g = torch.Generator()
    g.manual_seed(seed)
    draws = torch.stack([ts._sample(lt, g, sp) for _ in range(20)], 1)
    allowed = ts._top_p_filter(ts._top_k_filter(lt * (1 / 0.3), 5), 0.5) > -1e29
    assert torch.gather(allowed, 1, draws).all()
