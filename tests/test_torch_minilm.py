"""The port's MiniLM encoder and tokenizers against ``crs_tpu``'s, on the CPU.

- The seeded random init equals ``crs_tpu``'s bit for bit (both draw from
  ``np.random.default_rng`` with the seed ``crs_tpu`` takes from its key).
- ``minilm_encode`` at 2 layers, hidden 64, with padded and masked rows,
  and the full-width ``EmbeddingModel`` (6 layers, hidden 384, vocab 30,522)
  in length-sorted batches: embeddings within 1e-5 absolute. Both run f32;
  XLA and torch sum the products, the softmax and the layer norms in other
  orders (XLA also multiplies by 1/√hd where torch divides).
- ``HashTokenizer`` ids, ``WordPieceTokenizer`` on a vocab the test writes,
  and ``load_hf_bert_params`` / the local-checkpoint loader on a state dict
  the test writes: equal ids and equal arrays.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _small_cfgs(vocab=500):
    from crs_tpu.models.minilm import MiniLMConfig as JConfig
    from crs_tpu_torch.models.minilm import MiniLMConfig

    kw = dict(vocab_size=vocab, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128, max_position_embeddings=64)
    return JConfig(**kw), MiniLMConfig(**kw)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(got, ref):
    got_l, ref_l = dict(_leaves(got)), dict(_leaves(ref))
    assert got_l.keys() == ref_l.keys()
    for name in ref_l:
        assert got_l[name].dtype == np.float32, name
        np.testing.assert_array_equal(got_l[name], ref_l[name], err_msg=name)


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 3])
def test_random_init_equals_crs_tpu_bit_for_bit(seed):
    from crs_tpu.models.minilm import init_minilm_params as jax_init
    from crs_tpu_torch.models.minilm import init_minilm_params

    jcfg, cfg = _small_cfgs()
    ref = jax_init(jax.random.PRNGKey(seed), jcfg)
    _assert_trees_equal(init_minilm_params(seed, cfg), ref)


def test_full_width_encoder_init_equals_crs_tpu():
    """The EmbeddingModel's MiniLM-L6 (384 wide, 12 heads, 1,536, vocab
    30,522) holds ``crs_tpu``'s weights."""
    from crs_tpu.rag.embedding import EmbeddingModel as JModel
    from crs_tpu_torch.rag.embedding import EmbeddingModel

    cfg = {"backend": "minilm", "seed": 3}
    jm, tm = JModel(cfg), EmbeddingModel(cfg, device="cpu")
    _assert_trees_equal(_to_numpy(tm.encoder.params), jm.encoder.params)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.cpu().numpy()


def _ids_and_mask(rng, cfg, b=6, s=24):
    ids = rng.integers(4, cfg.vocab_size, (b, s))
    lens = [s, 1, 9, 17, 0, 24]  # full, one token, ragged, an all-padding row
    mask = np.zeros((b, s), bool)
    for r, n in enumerate(lens[:b]):
        mask[r, :n] = True
    ids = np.where(mask, ids, 0)
    return ids.astype(np.int32), mask


def test_minilm_encode_matches_crs_tpu():
    from crs_tpu.models.minilm import init_minilm_params as jax_init, minilm_encode as jax_encode
    from crs_tpu_torch.models.minilm import minilm_encode, params_to_torch

    jcfg, cfg = _small_cfgs()
    params = jax_init(jax.random.PRNGKey(1), jcfg)
    # LayerNorm scales and biases away from 1 / 0, so every parameter shows
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    ids, mask = _ids_and_mask(rng, cfg)
    ref = np.asarray(jax_encode(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                jnp.asarray(ids), jnp.asarray(mask)))
    got = minilm_encode(params_to_torch(params), cfg, torch.from_numpy(ids.astype(np.int64)),
                        torch.from_numpy(mask))
    assert got.shape == (6, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    assert np.all(ref[4] == 0) and torch.all(got[4] == 0)  # a row with no tokens pools to 0
    norms = np.linalg.norm(ref[[0, 1, 2, 3, 5]], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


TEXTS = [
    "What is GPTQ?",
    "Post-training quantization maps the weights of a large language model to 4-bit "
    "integers with a small calibration set, layer by layer, keeping accuracy close.",
    "", "KV cache", "Ünïcödé àccents and CJK 量化 mixed-in, with punctuation!?",
    " ".join(f"word{i}" for i in range(300)),  # past max_length
    "pruning", "distillation of a teacher into a student",
]


def test_embedding_model_minilm_matches_crs_tpu():
    """Full width, random init, batch 4: three length-sorted batches, the
    last padded with empty rows, buckets 16 to 256; rows back in order."""
    from crs_tpu.rag.embedding import EmbeddingModel as JModel
    from crs_tpu_torch.rag.embedding import EmbeddingModel

    cfg = {"backend": "minilm", "batch_size": 4, "max_length": 256}
    jm, tm = JModel(cfg), EmbeddingModel(cfg, device="cpu")
    ref = jm.embed(TEXTS)
    got = tm.embed(TEXTS)
    assert got.shape == (len(TEXTS), 384) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tm.embed_chunks(TEXTS[:3]).numpy(), ref[:3], atol=ATOL, rtol=0)
    assert not tm.supports_fit and tm.load_state("/nonexistent") is False


def test_hash_tokenizer_ids_equal():
    from crs_tpu.models.tokenizer import HashTokenizer as JTok, basic_tokenize as jbasic
    from crs_tpu_torch.models.tokenizer import HashTokenizer, basic_tokenize

    for vocab in (30522, 1000):
        jt, tt = JTok(vocab_size=vocab), HashTokenizer(vocab_size=vocab)
        for t in TEXTS:
            for ml in (None, 8, 256):
                got = tt.encode(t, max_length=ml)
                assert got == jt.encode(t, max_length=ml)
                assert got[0] == 1 and got[-1] == 2 and all(3 < i < vocab for i in got[1:-1])
    for t in TEXTS:
        assert basic_tokenize(t) == jbasic(t)
        assert basic_tokenize(t, lowercase=False) == jbasic(t, lowercase=False)


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "what", "is", "gp", "##t", "##q", "?", "quant",
         "##ization", "##ize", "the", "model", "##s", "a", "!", ",", "und", "##er", "ac",
         "##cent", "##s", "量"]


def test_wordpiece_tokenizer_on_a_written_vocab(tmp_path):
    from crs_tpu.models.tokenizer import WordPieceTokenizer as JWP
    from crs_tpu_torch.models.tokenizer import WordPieceTokenizer

    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    jt, tt = JWP.from_vocab_file(str(path)), WordPieceTokenizer.from_vocab_file(str(path))
    texts = TEXTS + ["What is GPTQ? Quantization, quantize the models!", "Àccents under",
                     "x" * 150]
    for t in texts:
        for ml in (None, 5):
            assert tt.encode(t, max_length=ml) == jt.encode(t, max_length=ml)
    assert tt.encode("What is GPTQ?") == [2, 4, 5, 6, 7, 8, 9, 3]
    assert tt.encode("x" * 150) == [2, 1, 3]  # past max_input_chars_per_word: [UNK]


def _hf_state(cfg, seed=4, prefix="bert."):
    """A Hugging Face BERT state dict for ``cfg`` (torch's [out, in] kernels)."""
    rng = np.random.default_rng(seed)
    h, f = cfg.hidden_size, cfg.intermediate_size

    def arr(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    sd = {
        "embeddings.word_embeddings.weight": arr(cfg.vocab_size, h),
        "embeddings.position_embeddings.weight": arr(cfg.max_position_embeddings, h),
        "embeddings.token_type_embeddings.weight": arr(cfg.type_vocab_size, h),
        "embeddings.LayerNorm.weight": 1 + arr(h), "embeddings.LayerNorm.bias": arr(h),
    }
    for i in range(cfg.num_layers):
        b = f"encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (h, h), "attention.self.key": (h, h),
                             "attention.self.value": (h, h), "attention.output.dense": (h, h),
                             "intermediate.dense": (f, h), "output.dense": (h, f)}.items():
            sd[b + name + ".weight"], sd[b + name + ".bias"] = arr(o, n), arr(o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[b + ln + ".weight"], sd[b + ln + ".bias"] = 1 + arr(h), arr(h)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["", "bert.", "0.auto_model."])
def test_load_hf_bert_params_on_a_written_state_dict(prefix):
    from crs_tpu.models.minilm import load_hf_bert_params as jax_load, minilm_encode as jax_encode
    from crs_tpu_torch.models.minilm import load_hf_bert_params, minilm_encode, params_to_torch

    jcfg, cfg = _small_cfgs()
    sd = _hf_state(cfg, prefix=prefix)
    ref = jax_load(sd, jcfg)
    got = load_hf_bert_params(sd, cfg)
    _assert_trees_equal(got, ref)
    ids, mask = _ids_and_mask(np.random.default_rng(5), cfg)
    np.testing.assert_allclose(
        minilm_encode(params_to_torch(got), cfg, torch.from_numpy(ids.astype(np.int64)),
                      torch.from_numpy(mask)).numpy(),
        np.asarray(jax_encode(ref, jcfg, jnp.asarray(ids), jnp.asarray(mask))), atol=ATOL, rtol=0)
    del sd[prefix + "encoder.layer.1.output.dense.bias"]
    with pytest.raises(KeyError):
        load_hf_bert_params(sd, cfg)


def test_local_checkpoint_directory_loads_like_crs_tpu(tmp_path):
    """A directory with ``pytorch_model.bin`` and ``vocab.txt``: the same
    params and tokenizer in both packages."""
    from crs_tpu.rag.embedding import _load_local_checkpoint as jax_load_dir
    from crs_tpu_torch.rag.embedding import _load_local_checkpoint

    jcfg, cfg = _small_cfgs(vocab=len(VOCAB))
    torch.save({k: torch.from_numpy(v) for k, v in _hf_state(cfg).items()},
               tmp_path / "pytorch_model.bin")
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    ref_p, ref_t = jax_load_dir(str(tmp_path), jcfg)
    got_p, got_t = _load_local_checkpoint(str(tmp_path), cfg)
    _assert_trees_equal(got_p, ref_p)
    assert got_t.encode("What is GPTQ?") == ref_t.encode("What is GPTQ?")
