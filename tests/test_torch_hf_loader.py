"""The port's Hugging Face loader (``crs_tpu_torch/models/hf_loader.py``) and
``model_path`` through the factory, against ``crs_tpu``.

A tiny Mistral checkpoint is written by ``transformers`` (skipped where it
is not installed), as safetensors and as a torch ``.bin``. Tolerances:
params bit-identical to ``crs_tpu``'s (f32 and bf16); f32 logits within
1e-5 of ``crs_tpu``'s and within ``tests/test_hf_loading.py``'s 2e-3 / 2e-2
of ``transformers``'; bf16 logits within the generator tests' 0.05.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def mistral_ckpts(tmp_path_factory):
    """{"safetensors": dir, "bin": dir} of one tiny random Mistral, and the model."""
    cfg = transformers.MistralConfig(
        vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        sliding_window=None, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = transformers.MistralForCausalLM(cfg).eval()
    dirs = {}
    for kind, safe in (("safetensors", True), ("bin", False)):
        d = tmp_path_factory.mktemp(f"mistral_{kind}")
        model.save_pretrained(str(d), safe_serialization=safe)
        dirs[kind] = str(d)
    return dirs, model


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["safetensors", "bin"])
def test_params_and_logits_match_crs_tpu(mistral_ckpts, kind, dtype):
    from crs_tpu.models.hf_loader import load_hf_causal_lm as jload
    from crs_tpu.models.transformer import forward as jforward

    from crs_tpu_torch.models.hf_loader import load_hf_causal_lm
    from crs_tpu_torch.models.transformer import forward

    dirs, model = mistral_ckpts
    cj, pj = jload(dirs[kind], dtype=getattr(jnp, dtype))
    ct, pt = load_hf_causal_lm(dirs[kind], dtype=getattr(torch, dtype), device="cpu")
    assert {f: getattr(ct, f) for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                                        "num_kv_heads", "intermediate_size", "max_seq_len",
                                        "rope_theta", "rms_eps", "tie_embeddings")} == \
        {f: getattr(cj, f) for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                                     "num_kv_heads", "intermediate_size", "max_seq_len",
                                     "rope_theta", "rms_eps", "tie_embeddings")}
    lj, lt = _leaves(pj), _leaves(pt)
    assert len(lj) == len(lt) == 2 + 9 * 2 + 1
    for r, g in zip(lj, lt):
        r = np.asarray(r)
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == r.shape
        assert g.is_contiguous()
        got = g.view(torch.int16).numpy() if dtype == "bfloat16" else g.numpy()
        assert np.array_equal(got, r.view(np.int16) if dtype == "bfloat16" else r)
    ids = np.random.default_rng(0).integers(0, 97, (2, 9))
    ref = np.asarray(jforward(pj, cj, jnp.asarray(ids)))
    got = forward(pt, ct, torch.from_numpy(ids)).numpy()
    if dtype == "float32":
        assert np.abs(got - ref).max() <= 1e-5
        with torch.no_grad():
            hf = model(input_ids=torch.from_numpy(ids)).logits.numpy()
        np.testing.assert_allclose(got, hf, atol=2e-3, rtol=2e-2)
    else:
        assert np.abs(got - ref).max() <= 0.05


def test_loader_without_safetensors(mistral_ckpts, monkeypatch):
    """Without ``safetensors`` a safetensors directory loads nothing (the
    factory then refuses random init); a ``.bin`` directory still loads."""
    import builtins

    from crs_tpu_torch.models.hf_loader import load_hf_causal_lm

    real_import = builtins.__import__

    def no_safetensors(name, *args, **kwargs):
        if name.startswith("safetensors"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    dirs, _ = mistral_ckpts
    monkeypatch.setattr(builtins, "__import__", no_safetensors)
    assert load_hf_causal_lm(dirs["safetensors"]) is None
    assert load_hf_causal_lm(dirs["bin"]) is not None


def test_model_path_through_the_factory(mistral_ckpts):
    from crs_tpu.models.model_interface import create_model_interface as jcmi

    from crs_tpu_torch.models.model_interface import create_model_interface

    dirs, _ = mistral_ckpts
    m = create_model_interface("hf", {"model_path": dirs["safetensors"], "dtype": "float32"},
                               device="cpu")
    m.load()
    assert m.cfg.vocab_size == 97 and m.weights_source == "checkpoint"
    ids = np.array([[1, 2, 3, 4]])
    out = m.forward(ids)
    assert out.shape == (1, 4, 97)
    jm = jcmi("hf", {"model_path": dirs["safetensors"], "dtype": "float32"})
    assert np.abs(out - jm.forward(ids.astype(np.int32))).max() <= 1e-5
    info = m.get_model_info()
    assert info["model_name"] == dirs["safetensors"] and info["quantization"] == "bf16"
    q = create_model_interface("int8", {"model_path": dirs["bin"]}, device="cpu")
    q.load()
    assert q.quantization == "int8" and q.params["layers"][0]["mlp"]["up"].bits == 8
    assert np.corrcoef(m.forward(ids).ravel(), q.forward(ids).ravel())[0, 1] > 0.98


def test_model_path_without_weights_refuses_random_init(tmp_path):
    from crs_tpu_torch.models.model_interface import TorchModel

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 97, "hidden_size": 64, "num_hidden_layers": 1,
        "num_attention_heads": 4, "intermediate_size": 128}))
    with pytest.raises(RuntimeError, match="no weights could be loaded"):
        TorchModel({"model_path": str(tmp_path)}, device="cpu").load()
    with pytest.raises(RuntimeError, match="no weights could be loaded"):
        TorchModel({"model_path": str(tmp_path / "absent")}, device="cpu").load()


def test_fused_flags_on_a_checkpoint(mistral_ckpts):
    """fuse_projections on an int8 checkpoint: logits equal the unfused ones."""
    from crs_tpu_torch.models.model_interface import create_model_interface

    dirs, _ = mistral_ckpts
    ids = np.array([[5, 6, 7, 8, 9]])
    plain = create_model_interface("int8", {"model_path": dirs["bin"]}, device="cpu")
    fused = create_model_interface("int8", {"model_path": dirs["bin"], "fuse_projections": True},
                                   device="cpu")
    assert np.array_equal(plain.forward(ids), fused.forward(ids))
