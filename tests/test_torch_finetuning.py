"""The port's finetuning (``crs_tpu_torch.finetuning``) against
``crs_tpu``'s, on the CPU: datasets, LoRA and the gradients through the
quantized routes here; the optimizer, the trainer and its checkpoints in
``tests/test_torch_finetuning_trainer.py`` (with these helpers and
tolerances).

Inputs are made from seeds (numpy and the models' seeded init); the LoRA
A's are ``crs_tpu``'s own (``jax.random``), carried across by
``convert.params_from_numpy``. The q4 / NF4 products run ``crs_tpu``'s
Pallas kernels in interpret mode and the port's plain versions.

Tolerances:
- datasets, prompts, stats, paths, masks, checkpoint files, the trainer's
  JSON: equal;
- LoRA at init (B = 0): logits bit-identical to ``crs_tpu``'s where the
  base model's are (``tiny`` bf16 and int8) and to the port's own base
  model always; ``small`` int8's base logits differ from ``crs_tpu``'s by
  f32 sum orders that move an int8 activation code now and then (0.13
  measured at 24 tokens), so they are held to LOGIT_ATOL;
- the autograd Functions' dx against ``jax.vjp`` of ``crs_tpu``'s custom
  VJPs: f32 products of the same terms in another order,
  |Δ| ≤ 1e-5·Σ|g·w| (bf16 inputs: one bf16 step);
- the first step's loss within LOSS_ATOL (3.0e-5 measured) and each adapter
  gradient within GRAD_RTOL of its largest entry (2.2e-2 measured: bf16
  products summed in another order, a bf16 step or two);
- the optimizer (optax's clip and AdamW in bf16, the port's written out):
  bit-identical on the same gradients, the schedule within 1e-6 relative
  and equal once rounded to bf16;
- three trainer steps from the same A's and batches: losses within
  STEP_LOSS_ATOL (2.5e-3 measured at the third step, after one update
  whose signs differ where a gradient is near 0); adapters within RATE_FACTOR times the sum of the rates:
  an Adam step moves an entry by at most |m̂ / √v̂| ≤ 1.004 times the rate
  at these counts (Cauchy-Schwarz over the bf16 moments), and a gradient
  near 0 may take either sign in the two packages, so twice the sum, and
  5 % for the bf16 roundings of the rate and of the update; most entries
  equal.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parent.parent
LOGIT_ATOL = 0.25
LOSS_ATOL = 1e-4
GRAD_RTOL = 4e-2
STEP_LOSS_ATOL = 1e-2
RATE_FACTOR = 2.1
FT_CFG = {"lora_rank": 4, "lora_alpha": 8.0, "num_epochs": 1, "batch_size": 2,
          "max_seq_len": 64, "learning_rate": 2e-4, "warmup_steps": 10}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(quant, config="tiny"):
    """(crs_tpu's model, the port's), loaded from one seed."""
    from crs_tpu.models.model_interface import JaxModel

    from crs_tpu_torch.models.model_interface import TorchModel

    conf = {"config": config, "seed": 0, "quantization": quant}
    j, t = JaxModel(conf), TorchModel(conf, device="cpu")
    j.load()
    t.load()
    return j, t


# -- datasets ---------------------------------------------------------------------

def _dump(samples):
    import dataclasses

    return [dataclasses.asdict(s) for s in samples]


@pytest.mark.parametrize("conf", [{"num_samples": 20, "seed": 1}, {"num_samples": 64},
                                  {"num_samples": 1, "seed": 5}])
def test_synthetic_samples_prompts_and_stats_equal(conf):
    from crs_tpu.finetuning.base import BaseDatasetLoader as JB
    from crs_tpu.finetuning.code_generation import SyntheticCodeLoader as JS

    from crs_tpu_torch.finetuning.base import BaseDatasetLoader as TB
    from crs_tpu_torch.finetuning.code_generation import SyntheticCodeLoader as TS

    (jt, je), (tt, te) = JS(conf).load(), TS(conf).load()
    assert _dump(tt) == _dump(jt) and _dump(te) == _dump(je)
    for s_j, s_t in zip(jt + je, tt + te):
        for out in (True, False):
            assert TB.format_prompt(s_t, out) == JB.format_prompt(s_j, out)
    assert TB.stats(tt) == JB.stats(jt) and TB.stats([]) == JB.stats([])
    info_j, info_t = JS(conf).get_info(jt, je), TS(conf).get_info(tt, te)
    assert vars(info_t) == vars(info_j)


def test_local_json_and_category_dispatch(tmp_path):
    from crs_tpu.finetuning import code_generation as jcg
    from crs_tpu.finetuning.base import BaseDatasetLoader as JB
    from crs_tpu.finetuning.load_dataset import load_dataset as jload

    from crs_tpu_torch.finetuning import code_generation as tcg
    from crs_tpu_torch.finetuning.base import BaseDatasetLoader as TB, DatasetSample
    from crs_tpu_torch.finetuning.load_dataset import load_dataset as tload

    rows = [{"instruction": f"q{i}", "input": "ctx" if i % 2 else "", "output": f"a{i}",
             "difficulty": i} for i in range(10)]
    path = tmp_path / "data.json"
    path.write_text(json.dumps(rows))
    for name in ("local_json", "mbpp", "code_alpaca", "code_contests", "humaneval"):
        conf = {"data_path": str(path), "eval_split": 0.3}
        got = tcg.create_code_dataset_loader(name, conf).load()
        ref = jcg.create_code_dataset_loader(name, conf).load()
        assert [_dump(x) for x in got] == [_dump(x) for x in ref], name
    sample = DatasetSample("Do X", "with Y", "done")
    assert TB.format_prompt(sample) == JB.format_prompt(sample)
    got = tload("code_generation", "synthetic", {"num_samples": 8})
    assert [_dump(x) for x in got] == [_dump(x) for x in jload("code_generation", "synthetic",
                                                              {"num_samples": 8})]
    for category in ("math_reasoning", "world_knowledge", "domain_expertise", "summarization",
                     "instruction_following"):
        with pytest.raises(NotImplementedError, match=category):
            tload(category)
    for bad in (lambda: tload("nonsense"), lambda: tcg.create_code_dataset_loader("nope")):
        with pytest.raises(ValueError):
            bad()


def test_stub_categories_and_hub_loaders_offline(monkeypatch):
    """The five stub modules declare crs_tpu's datasets and raise; the hub
    loaders, their hub unreachable, return no samples in both packages."""
    import importlib

    from crs_tpu.finetuning import code_generation as jcg

    from crs_tpu_torch.finetuning import code_generation as tcg

    for name, cls in (("math_reasoning", "MathReasoningLoader"),
                      ("world_knowledge", "WorldKnowledgeLoader"),
                      ("domain_expertise", "DomainExpertiseLoader"),
                      ("summarization", "SummarizationLoader"),
                      ("instruction_following", "InstructionFollowingLoader")):
        j = importlib.import_module(f"crs_tpu.finetuning.{name}")
        t = importlib.import_module(f"crs_tpu_torch.finetuning.{name}")
        assert t.PLANNED_DATASETS == j.PLANNED_DATASETS and t.__all__ == j.__all__
        with pytest.raises(NotImplementedError) as got:
            getattr(t, cls)().load()
        with pytest.raises(NotImplementedError) as ref:
            getattr(j, cls)().load()
        assert str(got.value) == str(ref.value)

    def offline(*a, **k):
        raise ConnectionError("no hub")

    for mod in (jcg, tcg):
        monkeypatch.setattr(mod, "_hf", offline)
    for name in ("humaneval", "mbpp", "code_alpaca", "code_contests"):
        assert tcg.create_code_dataset_loader(name).load() == \
            jcg.create_code_dataset_loader(name).load() == ([], [])


# -- LoRA ---------------------------------------------------------------------------

def _lora_pair(quant, config="tiny", rank=4, bump=None):
    """(crs_tpu's model with LoRA params, the port's with the same A's, and
    B's: zeros, or ``bump``-scaled normal draws)."""
    from crs_tpu.finetuning.lora import LoRAWeight as JL, add_lora

    from crs_tpu_torch.convert import params_from_numpy

    j, t = _models(quant, config)
    lp = add_lora(j.params, jax.random.PRNGKey(1), rank=rank)
    if bump:
        keys = iter(jax.random.split(jax.random.PRNGKey(3), 64))
        lp = jax.tree.map(lambda n: JL(n.base, n.lora_a, (jax.random.normal(
            next(keys), n.lora_b.shape) * bump).astype(n.lora_b.dtype), n.alpha, n.rank)
            if isinstance(n, JL) else n, lp, is_leaf=lambda n: isinstance(n, JL))
    j.params = lp
    t.params = params_from_numpy(_np_tree(lp))
    return j, t


def _batch(vocab=259, b=2, s=24, seed=0):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, s - 5:] = False
    return ids, mask


def _logits(j, t, ids, mask):
    from crs_tpu.models.transformer import forward as jf

    from crs_tpu_torch.models.transformer import forward as tf

    ref = np.asarray(jax.jit(jf, static_argnums=1)(j.params, j.cfg, jnp.asarray(ids),
                                                   jnp.asarray(mask)))
    with torch.no_grad():
        got = tf(t.params, t.cfg, torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    return got, ref


@pytest.mark.parametrize("quant,config,exact", [(None, "tiny", True), ("int8", "tiny", True),
                                                ("int8", "small", False)])
def test_lora_at_init_logits(quant, config, exact):
    j, t = _lora_pair(quant, config)
    ids, mask = _batch()
    got, ref = _logits(j, t, ids, mask)
    _, base = _models(quant, config)
    with torch.no_grad():
        from crs_tpu_torch.models.transformer import forward as tf

        base_logits = tf(base.params, base.cfg, torch.from_numpy(ids).long(),
                         torch.from_numpy(mask)).numpy()
    assert np.array_equal(got, base_logits)  # the adapters start as the identity
    if exact:
        assert np.array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= LOGIT_ATOL


def test_lora_logits_with_trained_b():
    """B ≠ 0 on a bf16 base: the port's rounding order is crs_tpu's."""
    j, t = _lora_pair(None, bump=0.05)
    got, ref = _logits(j, t, *_batch())
    assert np.array_equal(got, ref)


def _leaves(node) -> list:
    """The tree's leaves in crs_tpu's order: a LoRA node's base, A, B; a
    quantized tensor's codes, scales."""
    from crs_tpu_torch.finetuning.lora import LoRAWeight

    if isinstance(node, LoRAWeight):
        return _leaves(node.base) + [node.lora_a, node.lora_b]
    if hasattr(node, "codes"):
        return [node.codes, node.scales]
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in _leaves(node[k])]
    if isinstance(node, list):
        return [x for v in node for x in _leaves(v)]
    return [node]


def test_add_lora_mask_extract_and_merge():
    from crs_tpu.finetuning.lora import extract_lora as jextract, merge_lora as jmerge

    from crs_tpu_torch.finetuning.lora import (
        DEFAULT_TARGETS, add_lora, adapter_tensors, extract_lora, lora_trainable_mask,
        merge_lora,
    )
    from crs_tpu_torch.models.transformer import forward as tf

    from crs_tpu.finetuning.lora import lora_trainable_mask as jmask

    for quant, rank in ((None, 2), ("int4", 4), ("nf4", 16)):
        j, t = _lora_pair(quant, rank=rank)
        mask = _leaves(lora_trainable_mask(t.params))
        assert mask == jax.tree.leaves(jmask(j.params))  # crs_tpu's structure
        assert sum(v is True for v in mask) == 28 and not all(v is True for v in mask)
        assert sum(bool(getattr(x, "requires_grad", False)) for x in _leaves(t.params)) == 28
        # the port's own draw: a host generator, so any device gets the same A's
        base = _models(quant)[1].params
        params = add_lora(base, torch.Generator().manual_seed(0), rank=rank)
        again = add_lora(base, torch.Generator().manual_seed(0), rank=rank)
        trainable = adapter_tensors(params)
        assert len(trainable) == 28 and all(p.requires_grad and p.is_leaf for p in trainable)
        assert all(torch.equal(a, b) for a, b in zip(trainable, adapter_tensors(again)))
        ad = extract_lora(params)
        assert len(ad) == 14 and {k.split(".")[-1] for k in ad} == set(DEFAULT_TARGETS)
        for v in ad.values():
            assert v["a"].dtype == v["b"].dtype == torch.bfloat16 and not v["b"].any()
            assert v["a"].shape[1] == v["b"].shape[0] == rank
    # paths, merge: against crs_tpu on the same A's and B's
    j, t = _lora_pair("int8", bump=0.01)
    assert sorted(extract_lora(t.params)) == sorted(jextract(j.params))
    got, ref = merge_lora(t.params), jmerge(j.params)
    for layer_t, layer_j in zip(got["layers"], ref["layers"]):
        for grp in ("attn", "mlp"):
            for name, w in layer_t[grp].items():
                r = np.asarray(layer_j[grp][name].astype(jnp.float32))
                # f32 A·B summed in another order: at most one bf16 step apart
                assert np.abs(w.float().numpy() - r).max() <= 2.0 ** -8 * np.abs(r).max()
                assert w.dtype == torch.bfloat16 and not w.requires_grad
    # crs_tpu's own check: one adapter's B moved, the merged bf16 model's
    # logits within its 6e-2 + 3e-2·|x| of the adapted model's
    _, t = _lora_pair(None)
    q = t.params["layers"][0]["attn"]["q"]
    with torch.no_grad():
        q.lora_b.add_(0.01)
    ids = torch.from_numpy(_batch()[0][:1, :3]).long()
    with torch.no_grad():
        lora_out = tf(t.params, t.cfg, ids).numpy()
        merged_out = tf(merge_lora(t.params), t.cfg, ids).numpy()
    np.testing.assert_allclose(merged_out, lora_out, atol=6e-2, rtol=3e-2)
    assert not any(isinstance(n, type(q)) for n in _leaves(merge_lora(t.params)))


# -- gradients through the quantized routes ------------------------------------------

def _q4_case(kind, r=6, k=256, n=128, seed=0):
    from crs_tpu.models.quantized import quantize_tensor

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    qt = quantize_tensor(w, bits=4 if kind == "int4" else "nf4", group_size=64)
    x = rng.standard_normal((r, k)).astype(np.float32)
    g = rng.standard_normal((r, n)).astype(np.float32)
    return qt, x, g


@pytest.mark.parametrize("kind", ["int4", "nf4"])
def test_q4_backward_matches_crs_tpu_vjp(kind):
    from crs_tpu.ops import qgemm as jq

    from crs_tpu_torch.ops import qgemm as tq

    qt, x, g = _q4_case(kind)
    jfn = jq.q4_matmul if kind == "int4" else jq.nf4_matmul
    tfn = tq.q4_matmul if kind == "int4" else tq.nf4_matmul
    codes, scales = torch.tensor(np.asarray(qt.codes)), torch.tensor(np.asarray(qt.scales))
    w = tq.dequantize_f32(kind, codes, scales)
    bound = 1e-5 * (np.abs(g) @ np.abs(w.numpy().T)) + 1e-30
    # f32 activations: crs_tpu's VJP through jax.vjp
    out, vjp = jax.vjp(lambda a: jfn(a, qt.codes, qt.scales), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt, codes, scales)
    got.backward(torch.from_numpy(g))
    assert np.abs(got.detach().numpy() - np.asarray(out)).max() <= 1e-4
    assert xt.grad.dtype == torch.float32
    assert (np.abs(xt.grad.numpy() - np.asarray(ref_dx)) <= bound).all()
    # bf16 activations (the model's): dx rounded to x's dtype
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tfn(xb, codes, scales).backward(torch.from_numpy(g))
    ref_b = torch.tensor(np.asarray(ref_dx)).to(torch.bfloat16).float().numpy()
    assert xb.grad.dtype == torch.bfloat16
    assert (np.abs(xb.grad.float().numpy() - ref_b) <= 2.0 ** -7 * np.abs(ref_b) + bound).all()
    assert not codes.requires_grad and not scales.requires_grad


def test_int8_route_backward_matches_crs_tpu_vjp():
    from crs_tpu.models.quantized import _int8_act_matmul as jfn, quantize_tensor

    from crs_tpu_torch.models.quantized import _int8_act_matmul as tfn

    rng = np.random.default_rng(1)
    qt = quantize_tensor(rng.standard_normal((96, 160)).astype(np.float32), bits=8)
    x = rng.standard_normal((7, 96)).astype(np.float32)
    g = rng.standard_normal((7, 160)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jfn(a, qt.codes, qt.scales), jnp.asarray(x))
    ref_dx = np.asarray(vjp(jnp.asarray(g))[0])
    codes, scales = torch.tensor(np.asarray(qt.codes)), torch.tensor(np.asarray(qt.scales))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt, codes, scales)
    assert np.array_equal(got.detach().numpy(), np.asarray(out))  # the exact int8 forward
    got.backward(torch.from_numpy(g))
    w = codes.float().numpy() * scales.numpy()[None, :]
    assert np.abs(ref_dx).max() > 0  # round() would have zeroed it
    assert (np.abs(xt.grad.numpy() - ref_dx) <= 1e-5 * (np.abs(g) @ np.abs(w.T))).all()
    with torch.no_grad():  # no autograd node where no gradient is wanted
        assert np.array_equal(tfn(xt, codes, scales).numpy(), got.detach().numpy())


def test_forward_only_kernels_refuse_gradients():
    from crs_tpu_torch.ops.decode_attention import decode_attention_int8
    from crs_tpu_torch.ops.fused_mlp import fused_mlp_int8, fused_mlp_layout

    b, hkv, g, s, hd = 1, 1, 2, 128, 128
    q = torch.randn(b, hkv, g, hd)
    kc = torch.randint(-127, 128, (b, hkv, s, hd), dtype=torch.int8)
    ks = torch.rand(b, hkv, s)
    valid = torch.ones(b, s, dtype=torch.bool)
    args = (kc, ks, kc, ks, valid)
    with pytest.raises(RuntimeError, match="forward-only"):
        decode_attention_int8(q.clone().requires_grad_(True), *args)
    with torch.no_grad():
        decode_attention_int8(q.clone().requires_grad_(True), *args)
    h, inter = 128, 256
    codes = torch.randint(-127, 128, (h, inter), dtype=torch.int8)
    sc = torch.rand(inter) + 0.5
    down = torch.randint(-127, 128, (inter, h), dtype=torch.int8)
    layout = fused_mlp_layout(codes, sc, codes, sc, down, torch.rand(h) + 0.5, 128)
    x, norm = torch.randn(2, h), torch.ones(h)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_mlp_int8(x.requires_grad_(True), norm, *layout, chunk=128)
    fused_mlp_int8(x.detach(), norm, *layout, chunk=128)


def _jax_loss(cfg, traced_anew: bool = False):
    """crs_tpu's trainer's loss_fn; ``traced_anew``: through the function
    under crs_tpu's jitted forward, so a patched route gate is traced."""
    import optax

    from crs_tpu.models.transformer import forward

    fwd = forward.__wrapped__ if traced_anew else forward

    def loss_fn(params, ids, mask):
        logits = fwd(params, cfg, ids, mask)
        losses = optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1, :], ids[:, 1:])
        valid = mask[:, 1:] & mask[:, :-1]
        return jnp.sum(losses * valid) / jnp.maximum(jnp.sum(valid), 1)

    return loss_fn


@pytest.mark.parametrize("quant", ["int4", "nf4"])
def test_step_at_kernel_rows_where_crs_tpu_refuses(quant, monkeypatch):
    """At ≤ 64 rows crs_tpu's int4 / NF4 VJP returns an f32 dx for the bf16
    activations and JAX refuses the step (an assertion); the port casts dx
    to x's dtype, as autograd does, and trains. Its gradients there lie
    within GRAD_RTOL of crs_tpu's through the dense route, whose weights
    are bf16(code·scale) where the kernel's are bf16(level)·bf16(scale)."""
    from crs_tpu.finetuning.lora import LoRAWeight as JL
    from crs_tpu.ops import qgemm as jq

    from crs_tpu_torch.finetuning.lora import adapter_tensors
    from crs_tpu_torch.finetuning.trainer import masked_loss
    from crs_tpu_torch.models.transformer import forward as tf

    j, t = _lora_pair(quant, bump=0.02)
    ids, mask = _batch(b=2, s=32)  # 64 rows: the kernels' route
    with pytest.raises(AssertionError):
        jax.value_and_grad(_jax_loss(j.cfg), allow_int=True)(
            j.params, jnp.asarray(ids), jnp.asarray(mask))
    monkeypatch.setattr(jq, "q4_pallas_supported", lambda *a, **k: False)
    _, grads = jax.jit(jax.value_and_grad(_jax_loss(j.cfg, traced_anew=True), allow_int=True))(
        j.params, jnp.asarray(ids), jnp.asarray(mask))
    ref = [np.asarray(x, np.float32) for n in jax.tree.leaves(grads, is_leaf=lambda n: isinstance(
        n, JL)) if isinstance(n, JL) for x in (n.lora_a, n.lora_b)]
    it, im = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    masked_loss(tf(t.params, t.cfg, it, im), it, im).backward()
    for g_t, g_j in zip((p.grad.float().numpy() for p in adapter_tensors(t.params)), ref):
        assert np.isfinite(g_t).all()
        assert np.abs(g_t - g_j).max() <= GRAD_RTOL * np.abs(g_j).max()
