"""The port's finetuning trainer (``crs_tpu_torch.finetuning.trainer``)
against ``crs_tpu``'s, on the CPU: the loss and its gradients, the
schedule, the optimizer, three trainer steps, ``train()`` with the
per-epoch evaluation, the checkpoints across the packages, resume, pruning,
``save_model`` and the estimate. Helpers and tolerances are
``tests/test_torch_finetuning.py``'s (its docstring states them).
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# _one_torch_thread is an autouse fixture: importing it makes it this module's too
from tests.test_torch_finetuning import (
    FT_CFG, GRAD_RTOL, LOSS_ATOL, RATE_FACTOR, REPO, STEP_LOSS_ATOL, _jax_loss, _lora_pair,
    _models, _one_torch_thread,  # noqa: F401
)


@pytest.mark.parametrize("quant", [None, "int8", "int4", "nf4"])
def test_first_step_loss_and_gradients_match_crs_tpu(quant):
    from crs_tpu.finetuning.lora import LoRAWeight as JL

    from crs_tpu_torch.finetuning.code_generation import SyntheticCodeLoader
    from crs_tpu_torch.finetuning.lora import adapter_tensors
    from crs_tpu_torch.finetuning.trainer import QuantizedModelFinetuner

    j, t = _lora_pair(quant, bump=0.02)  # B ≠ 0: A gets a gradient too
    train, _ = SyntheticCodeLoader({"num_samples": 12}).load()
    batch = QuantizedModelFinetuner(t, FT_CFG).prepare_batches(train)[0]
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss(j.cfg), allow_int=True))(
        j.params, jnp.asarray(batch["ids"]), jnp.asarray(batch["mask"]))
    nodes = [n for n in jax.tree.leaves(grads, is_leaf=lambda n: isinstance(n, JL))
             if isinstance(n, JL)]
    ref = [np.asarray(x, np.float32) for n in nodes for x in (n.lora_a, n.lora_b)]
    ft = QuantizedModelFinetuner(t, FT_CFG)
    ids, mask = ft._device_batch(batch)
    got_loss = ft.loss(ids, mask)
    got_loss.backward()
    got = [p.grad.float().numpy() for p in adapter_tensors(t.params)]
    assert abs(float(got_loss.detach()) - float(loss)) <= LOSS_ATOL
    assert len(got) == len(ref) == 28
    for g_t, g_j in zip(got, ref):
        assert np.abs(g_j).max() > 0
        assert np.abs(g_t - g_j).max() <= GRAD_RTOL * np.abs(g_j).max()


@pytest.mark.parametrize("warmup,total", [(10, 2), (10, 30), (3, 30), (10, 150), (1, 7)])
def test_schedule_is_optax(warmup, total):
    import optax

    from crs_tpu_torch.finetuning.trainer import warmup_cosine_lr

    w = min(warmup, max(total // 10, 1))
    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-4, w, total)
    for count in range(total + 3):
        ref, got = float(sched(count)), warmup_cosine_lr(count, 2e-4, w, total)
        assert abs(got - ref) <= 1e-6 * ref
        assert torch.tensor(got).bfloat16() == torch.tensor(ref).bfloat16()
    assert warmup_cosine_lr(0, 2e-4, w, total) == 0.0


def test_schedule_values_and_refusal():
    from crs_tpu_torch.finetuning.trainer import warmup_cosine_lr

    got = [warmup_cosine_lr(c, 2e-4, 3, 30) for c in (0, 1, 3, 29)]
    np.testing.assert_allclose(got, [0.0, 6.6667e-5, 2e-4, 6.7616e-7], rtol=1e-4)
    with pytest.raises(ValueError):  # optax refuses a cosine decay of no steps too
        warmup_cosine_lr(0, 2e-4, 1, 1)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_optimizer_is_crs_tpus_chain_bit_for_bit(quant):
    """crs_tpu's optimizer (zero the frozen, clip, AdamW under the schedule)
    and the port's on the same bf16 gradients, clipping on alternate steps."""
    import optax

    from crs_tpu.finetuning.lora import LoRAWeight as JL
    from crs_tpu.finetuning.trainer import QuantizedModelFinetuner as JF

    from crs_tpu_torch.finetuning.lora import adapter_tensors
    from crs_tpu_torch.finetuning.trainer import QuantizedModelFinetuner as TF

    j, t = _lora_pair(quant, bump=0.02)
    steps = 6
    jf, tf = JF(j, FT_CFG), TF(t, FT_CFG)
    tx = jf._build_optimizer(steps)
    state = tx.init(j.params)
    update = jax.jit(tx.update)  # as it runs inside crs_tpu's jitted step
    tf._opt = tf._build_optimizer(steps)
    rng = np.random.default_rng(0)
    is_lora = lambda n: isinstance(n, JL)  # noqa: E731
    for step in range(steps):
        scale = 3.0 if step % 2 == 0 else 0.02
        draws = [(rng.standard_normal(p.shape) * scale / 8).astype(np.float32)
                 for p in adapter_tensors(t.params)]
        it = iter(draws)

        def grad_of(node):
            if isinstance(node, JL):
                zero_base = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32)
                                         if not jnp.issubdtype(p.dtype, jnp.floating)
                                         else jnp.zeros_like(p), node.base)
                return JL(zero_base, jnp.asarray(next(it), jnp.bfloat16),
                          jnp.asarray(next(it), jnp.bfloat16), node.alpha, node.rank)
            return jnp.zeros(node.shape, jnp.float32) if not jnp.issubdtype(
                node.dtype, jnp.floating) else jnp.zeros_like(node)

        # the port's adapter order is crs_tpu's flattened order (sorted keys)
        grads = jax.tree.map(grad_of, j.params, is_leaf=is_lora)
        updates, state = update(grads, state, j.params)
        j.params = optax.apply_updates(j.params, updates)
        for p, d in zip(adapter_tensors(t.params), draws):
            p.grad = torch.from_numpy(d).to(torch.bfloat16)
        tf._opt.step()
        ref = [np.asarray(x.astype(jnp.float32)) for n in jax.tree.leaves(j.params, is_leaf=is_lora)
               if isinstance(n, JL) for x in (n.lora_a, n.lora_b)]
        got = [p.detach().float().numpy() for p in adapter_tensors(t.params)]
        assert all(np.array_equal(a, b) for a, b in zip(got, ref)), step


# -- the trainer ------------------------------------------------------------------------

def _trainers(quant, tmp_path, bump=None, **cfg):
    from crs_tpu.finetuning.trainer import QuantizedModelFinetuner as JF

    from crs_tpu_torch.finetuning.trainer import QuantizedModelFinetuner as TF

    j, t = _lora_pair(quant, bump=bump)
    conf = dict(FT_CFG, **cfg)
    return (JF(j, dict(conf, output_dir=str(tmp_path / "j"))),
            TF(t, dict(conf, output_dir=str(tmp_path / "t"))))


def _adapters(params, jax_side: bool):
    if jax_side:
        from crs_tpu.finetuning.lora import extract_lora

        return {k: (np.asarray(v["a"], np.float32), np.asarray(v["b"], np.float32))
                for k, v in extract_lora(params).items()}
    from crs_tpu_torch.finetuning.lora import extract_lora

    return {k: (v["a"].detach().float().numpy(), v["b"].detach().float().numpy())
            for k, v in extract_lora(params).items()}


@pytest.mark.parametrize("quant", [None, "int8"])
def test_three_trainer_steps_match_crs_tpu(quant, tmp_path):
    from crs_tpu.finetuning.code_generation import SyntheticCodeLoader

    jf, tf = _trainers(quant, tmp_path)
    train, _ = SyntheticCodeLoader({"num_samples": 12}).load()
    batches = jf.prepare_batches(train)[:3]
    assert all(np.array_equal(a["ids"], b["ids"]) and np.array_equal(a["mask"], b["mask"])
               for a, b in zip(batches, tf.prepare_batches(train)))
    jf._tx = jf._build_optimizer(3)
    state = jf._tx.init(jf.model.params)
    jstep = jf._make_train_step(jf.model.cfg)
    tf._opt = tf._build_optimizer(3)
    rates = 0.0
    for i, batch in enumerate(batches):
        rates += tf._opt.schedule(i)
        jf.model.params, state, jl = jstep(jf.model.params, state, jnp.asarray(batch["ids"]),
                                           jnp.asarray(batch["mask"]))
        tl = tf.train_step(batch)
        assert abs(tl - float(jl)) <= STEP_LOSS_ATOL
        ref, got = _adapters(jf.model.params, True), _adapters(tf.model.params, False)
        equal = total = 0
        for name, (ra, rb) in ref.items():
            for g, r in zip(got[name], (ra, rb)):
                assert np.abs(g - r).max() <= RATE_FACTOR * rates, (i, name)
                equal, total = equal + int((g == r).sum()), total + r.size
        if i == 0:  # the first update's rate is 0: nothing moved
            assert equal == total
    assert equal >= 0.5 * total


def test_train_checkpoints_resume_prune_and_save(tmp_path):
    """train() end to end with the per-epoch evaluation; files as crs_tpu
    lays them out; pruning; resume; save_model; the estimate."""
    from crs_tpu.finetuning.code_generation import SyntheticCodeLoader
    from crs_tpu.finetuning.trainer import QuantizedModelFinetuner as JF

    from crs_tpu_torch.finetuning.trainer import QuantizedModelFinetuner as TF

    jf, tf = _trainers("int8", tmp_path, num_epochs=2, checkpoint_every=2, save_total_limit=2,
                       learning_rate=5e-3, warmup_steps=1)
    train, held = SyntheticCodeLoader({"num_samples": 10}).load()
    out = tmp_path / "t"
    cb = tf.setup_evaluation(
        eval_config={"performance": {"perplexity": {"dataset_path": str(
            REPO / "results" / "selftrained" / "heldout_corpus.txt"), "max_samples": 1,
            "max_length": 32}}}, output_dir=str(tmp_path / "eval"))
    result = tf.train(train, held)
    assert [h["epoch"] for h in result["history"]] == [0, 1]
    assert result["total_steps"] == 10 and result["final_loss"] < result["history"][0]["loss"]
    assert all(np.isfinite(h["eval_loss"]) for h in result["history"])
    ckpts = sorted(p.name for p in out.iterdir() if p.name.startswith("checkpoint-"))
    assert ckpts == ["checkpoint-10", "checkpoint-8"]  # save_total_limit 2
    assert json.loads((out / "train_result.json").read_text())["total_steps"] == 10
    manifest = json.loads((out / "checkpoint-10" / "manifest.json").read_text())
    assert manifest["step"] == 10 and manifest["epoch"] == 1 and len(manifest["adapters"]) == 14
    arrays = np.load(out / "checkpoint-10" / "adapters.npz")
    assert sorted(arrays.files) == sorted(f"{x}_{i}" for i in range(14) for x in "ab")
    assert all(arrays[k].dtype == np.float32 for k in arrays.files)
    hist = json.loads((tmp_path / "eval" / "evaluation_history.json").read_text())
    assert set(hist) == {"history", "best_metric", "best_value", "best_epoch"}
    assert [h["epoch"] for h in hist["history"]] == [0, 1] and cb.best_epoch in (0, 1)
    assert (tmp_path / "eval" / "epoch_1" / "performance_results.json").exists()
    # crs_tpu resumes from the port's checkpoints, and the port from crs_tpu's
    jm, tm = _models("int8")
    jf2, tf2 = JF(jm, dict(FT_CFG, output_dir=str(out))), TF(tm, dict(FT_CFG, output_dir=str(out)))
    jf2.prepare_model()
    assert jf2._try_resume() == 2 and jf2.global_step == 10
    tf2.prepare_model()
    assert tf2._try_resume() == 2 and tf2.global_step == 10
    want = _adapters(tf.model.params, False)
    for side, params in ((True, jf2.model.params), (False, tf2.model.params)):
        got = _adapters(params, side)
        assert all(np.array_equal(got[k][i], want[k][i]) for k in want for i in (0, 1))
    jdir = tmp_path / "jsaved"
    jf2.output_dir = str(jdir)
    jf2.global_step = 3
    jf2._save_checkpoint(epoch=0)
    tf3 = TF(_models("int8")[1], dict(FT_CFG, output_dir=str(jdir)))
    tf3.prepare_model()
    assert tf3._try_resume() == 1 and tf3.global_step == 3
    got = _adapters(tf3.model.params, False)
    assert all(np.array_equal(got[k][i], want[k][i]) for k in want for i in (0, 1))
    assert all(p.requires_grad and p.is_leaf for k in ("lora_a", "lora_b")
               for p in [getattr(tf3.model.params["layers"][0]["attn"]["q"], k)])
    # save_model's snapshot has crs_tpu's keys
    final = tf.save_model()
    snap = json.loads((pathlib.Path(final) / "training_config.json").read_text())
    jfinal = jf2.save_model(str(tmp_path / "jfinal"))
    jsnap = json.loads((pathlib.Path(jfinal) / "training_config.json").read_text())
    assert set(snap) == set(jsnap) and set(snap["model"]) == set(jsnap["model"])
    assert snap["lora_rank"] == 4 and os.path.exists(os.path.join(final, "adapters.npz"))
    for n, step_s in ((100, 0.1), (7, None), (0, 2.0)):
        assert tf.estimate_training_time(n, step_s) == jf.estimate_training_time(n, step_s)


def test_no_checkpoint_or_a_bad_one_starts_fresh(tmp_path):
    from crs_tpu_torch.finetuning.trainer import QuantizedModelFinetuner as TF

    _, t = _models(None)
    ft = TF(t, dict(FT_CFG, output_dir=str(tmp_path)))
    ft.prepare_model()
    assert ft._try_resume() == 0
    (tmp_path / "checkpoint-4").mkdir()
    assert ft._try_resume() == 0 and ft.global_step == 0
    with pytest.raises(ValueError, match="no training batches"):
        ft.train([])


def test_adapted_model_generates_without_gradients():
    """Generation over LoRA params (whose A and B require a gradient) runs
    under no_grad, so the forward-only kernels' refusal never fires, and
    the greedy tokens are crs_tpu's."""
    j, t = _lora_pair(None, bump=0.05)
    assert t.generate("def add_3(x):", max_new_tokens=6) == j.generate("def add_3(x):",
                                                                      max_new_tokens=6)
    assert t.get_model_info()["model_size_gb"] == pytest.approx(
        j.get_model_info()["model_size_gb"])
