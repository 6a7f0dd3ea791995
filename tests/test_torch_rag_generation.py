"""The port's checkpoints, answer generation and RAG pipeline against
``crs_tpu``'s.

Tolerances:
- ``selftrained_small`` (f32 weights, f32 activations): rtol 1e-4 and atol
  1e-4 (f32 sums of ≤ 1,536 terms in another order, through 8 layers);
- a cross-loaded nf4 checkpoint: the logits rule of
  ``tests/test_torch_generator.py`` (within 0.05, the same argmax where the
  top logit leads by more than 0.1);
- prompts, cleaned answers, retrieved chunks, scores (1e-5) and greedy
  pipeline answers: identical.
"""

import json

import numpy as np
import pytest
import torch

# kernel_config is a fixture: importing it makes it this module's too
from tests.test_torch_generator import CORPUS, QA, REPO, _close, kernel_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SELFTRAINED = REPO / "checkpoints" / "selftrained_small"


def test_selftrained_small_logits():
    """The repo's trained checkpoint (f32) through both load_pretrained."""
    from crs_tpu.models.bytes_tokenizer import ByteTokenizer
    from crs_tpu.models.model_interface import JaxModel

    from crs_tpu_torch.models.model_interface import TorchModel

    jm = JaxModel({"model_path": str(SELFTRAINED)})
    tm = TorchModel({"model_path": str(SELFTRAINED)}, device="cpu")
    jm.load()
    tm.load()
    assert tm.weights_source == "checkpoint" and tm.cfg.vocab_size == 384
    lines = [ln for ln in CORPUS.read_text(encoding="utf-8").splitlines() if ln.strip()][:3]
    tok = ByteTokenizer()
    ids = np.full((3, 48), tok.pad_id, np.int64)
    for i, ln in enumerate(lines):
        enc = tok.encode(ln)[:48]
        ids[i, : len(enc)] = enc
    ref, got = jm.forward(ids), tm.forward(ids)
    assert got.dtype == np.float32 and got.shape == ref.shape == (3, 48, 384)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_checkpoints_cross_load(tmp_path, kernel_config):
    """A port nf4 checkpoint loads in crs_tpu and the other way round."""
    from crs_tpu.models.model_interface import JaxModel, create_model_interface as jcmi

    from crs_tpu_torch.models.model_interface import TorchModel
    from crs_tpu_torch.models.quantized import QuantizedTensor

    conf = {"config": kernel_config, "seed": 3}
    jm = jcmi("nf4", conf)
    jm.save_pretrained(str(tmp_path / "jax"))
    tm = TorchModel({"model_path": str(tmp_path / "jax")}, device="cpu")
    tm.load()
    q = tm.params["layers"][0]["attn"]["q"]
    assert isinstance(q, QuantizedTensor) and q.bits == "nf4" and q.codes.dtype == torch.uint8
    ids = np.random.default_rng(1).integers(0, 259, (1, 32))
    _close(torch.from_numpy(tm.forward(ids)), jm.forward(ids))
    tm.save_pretrained(str(tmp_path / "port"))
    back = JaxModel({"model_path": str(tmp_path / "port")})
    back.load()
    assert back.quantization == "nf4"
    np.testing.assert_array_equal(np.asarray(back.params["layers"][1]["mlp"]["down"].codes),
                                  np.asarray(jm.params["layers"][1]["mlp"]["down"].codes))


def test_lora_checkpoints_raise(tmp_path):
    """LoRA nodes (an int4 and a bf16 base, A, B, alpha, rank) no longer
    raise: a tree saved by either package loads in the other bit for bit,
    A and B as leaf tensors that require a gradient."""
    import jax

    from crs_tpu.finetuning.lora import LoRAWeight as JL, add_lora
    from crs_tpu.models.quantized import quantize_params
    from crs_tpu.models.transformer import CONFIGS, init_params
    from crs_tpu.utils.checkpoint import load_pytree as jload, save_pytree as jsave

    from crs_tpu_torch.finetuning.lora import LoRAWeight as TL, adapter_tensors
    from crs_tpu_torch.models.quantized import QuantizedTensor
    from crs_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    params = init_params(0, CONFIGS["tiny"])
    params["layers"][1] = quantize_params({"l": params["layers"][1]}, bits=4)["l"]
    tree = add_lora(params, jax.random.PRNGKey(2), rank=4, alpha=8.0)
    rng = np.random.default_rng(5)  # B as if trained: bf16 draws
    tree = jax.tree.map(lambda n: JL(n.base, n.lora_a, jax.numpy.asarray(
        rng.standard_normal(n.lora_b.shape) * 0.01, n.lora_b.dtype), n.alpha, n.rank)
        if isinstance(n, JL) else n, tree, is_leaf=lambda n: isinstance(n, JL))
    jsave(str(tmp_path / "j"), tree)
    got = load_pytree(str(tmp_path / "j"))
    q1, q0 = got["layers"][1]["attn"]["q"], got["layers"][0]["mlp"]["down"]
    assert isinstance(q1, TL) and isinstance(q1.base, QuantizedTensor) and q1.base.bits == 4
    assert isinstance(q0, TL) and q0.base.dtype == torch.bfloat16
    assert (q1.alpha, q1.rank) == (8.0, 4) and len(adapter_tensors(got)) == 28
    assert all(p.requires_grad and p.is_leaf and p.dtype == torch.bfloat16
               for p in adapter_tensors(got))
    save_pytree(str(tmp_path / "t"), got)
    back = jload(str(tmp_path / "t"))
    flat_ref = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b)), path
    assert back["layers"][1]["attn"]["q"].alpha == 8.0


# -- answer generation and the pipeline --------------------------------------

def test_rag_generator_prompts_and_cleaning():
    from crs_tpu.rag.generation import RAGGenerator as JG

    from crs_tpu_torch.rag.generation import RAGGenerator as TG

    cfg = {"max_context_chars": 120, "max_answer_sentences": 2}
    jg, tg = JG(None, cfg), TG(None, cfg)
    ctx = ("Quantization maps weights to fewer bits. Pruning removes weights! "
           "Distillation trains a small student? " * 3)
    for q, c in (("What is pruning?", ctx), ("Why?", ""), ("Short", "One. Two.")):
        assert tg._truncate_context(c) == jg._truncate_context(c)
        assert tg._format_instruct_prompt(q, c) == jg._format_instruct_prompt(q, c)
        assert tg._format_simple_prompt(q, c) == jg._format_simple_prompt(q, c)
    answers = ["Answer: Based on the context, pruning removes weights. It helps. A lot. Yes.",
               "response - the context does not specify this at all",
               "pruning removes weights pruning removes weights pruning removes weights",
               " ".join(f"word{i}" for i in range(20)), "", ctx[:90]]
    for a in answers:
        assert tg._clean_answer(a) == jg._clean_answer(a)
        assert tg._is_problematic(a, ctx) == jg._is_problematic(a, ctx)


PIPE_CFG = {
    "chunking": {"strategy": "semantic", "chunk_size": 160, "chunk_overlap": 30,
                 "min_chunk_size": 10},
    "embedding": {"backend": "hashed", "embedding_dim": 384},
    "vector_store": {"format": "int8", "block_size": 256, "rescore_k": 64},
    "retrieval": {"top_k": 2, "similarity_threshold": 0.05, "rerank": True,
                  "diversity_penalty": 0.1},
    "generation": {"max_new_tokens": 6, "temperature": 0.0, "max_context_chars": 600},
}


def test_rag_pipeline_query_matches(kernel_config):
    """Same chunks, same prompt and, greedy, the same answer (retry
    included) from the nf4 model with an int8 cache."""
    from crs_tpu.models.model_interface import create_model_interface as jcmi
    from crs_tpu.rag.pipeline import RAGPipeline as JP

    from crs_tpu_torch.models.model_interface import create_model_interface as tcmi
    from crs_tpu_torch.rag.pipeline import RAGPipeline as TP

    conf = {"config": kernel_config, "kv_bits": 8, "seed": 3}
    jp = JP(PIPE_CFG).setup(jcmi("nf4", conf))
    tp = TP(PIPE_CFG, device="cpu").setup(tcmi("nf4", conf, device="cpu"))
    jp.index_documents(str(CORPUS))
    tp.index_documents(str(CORPUS))
    assert tp.store.n == jp.store.n and tp.store.ids == jp.store.ids
    question = json.loads(QA.read_text())[0]["question"]
    ref = jp.query(question, return_context=True, return_chunks=True)
    got = tp.query(question, return_context=True, return_chunks=True)
    assert [c["id"] for c in got["chunks"]] == [c["id"] for c in ref["chunks"]]
    assert got["chunks"] and got["context"] == ref["context"]
    gen = tp.generator
    assert gen._format_instruct_prompt(question, gen._truncate_context(got["context"])) == \
        jp.generator._format_instruct_prompt(question, jp.generator._truncate_context(ref["context"]))
    assert got["answer"] == ref["answer"]
    assert tp.validate_retrieval(question, ["compression", "zzz"]) == \
        jp.validate_retrieval(question, ["compression", "zzz"])
    stats = tp.get_stats()
    assert stats["vector_store"]["num_vectors"] == tp.store.n
    assert stats["model"]["quantization"] == "nf4"


def test_fused_flag_routes_retrieve_batch(monkeypatch):
    """``retrieval.fused``: retrieve_batch takes the fused path and gives
    crs_tpu's ids and scores; a store the fused path does not take (plain
    PQ) falls back to the unfused path without recursing."""
    from crs_tpu.rag.pipeline import RAGPipeline as JP

    from crs_tpu_torch.rag import retrieval
    from crs_tpu_torch.rag.pipeline import RAGPipeline as TP

    cfg = dict(PIPE_CFG, retrieval=dict(PIPE_CFG["retrieval"], fused=True, top_k=3))
    jp, tp = JP(cfg).setup(), TP(cfg, device="cpu").setup()
    jp.index_documents(str(CORPUS))
    tp.index_documents(str(CORPUS))
    calls = []
    fused = retrieval.ContextRetriever.retrieve_batch_fused
    monkeypatch.setattr(retrieval.ContextRetriever, "retrieve_batch_fused",
                        lambda self, *a, **k: calls.append(1) or fused(self, *a, **k))
    questions = [x["question"] for x in json.loads(QA.read_text())]
    got, ref = tp.retrieve_batch(questions), jp.retrieve_batch(questions)
    assert calls and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert [c["id"] for c in g] == [c["id"] for c in r]
        assert all(abs(a["score"] - b["score"]) <= 1e-5 for a, b in zip(g, r))

    pq = dict(cfg, vector_store={"format": "pq", "pq_residual": False, "pq_subspaces": 8,
                                 "pq_clusters": 4, "block_size": 256})
    tpq = TP(pq, device="cpu").setup()
    tpq.index_documents(str(CORPUS))
    fused_res = tpq.retrieve_batch(questions[:3])
    assert tpq.retriever.fused  # the flag is restored after the fallback
    tpq.retriever.fused = False
    assert [[c["id"] for c in r] for r in fused_res] == \
        [[c["id"] for c in r] for r in tpq.retrieve_batch(questions[:3])]


def test_context_helpers():
    from crs_tpu.rag.retrieval import distance_to_similarity as jd

    from crs_tpu_torch.rag.retrieval import ContextRetriever, distance_to_similarity as td

    for metric in ("cosine", "l2", "ip"):
        for d in (0.0, 0.3, 1.7):
            assert td(d, metric) == jd(d, metric)
    with pytest.raises(ValueError):
        td(0.1, "hamming")
    hits = [{"text": "a"}, {"text": "b"}]
    assert ContextRetriever.context_from_results(hits) == "a\n\nb"
    assert ContextRetriever.context_from_results(hits, " | ") == "a | b"
