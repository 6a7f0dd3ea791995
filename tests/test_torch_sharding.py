"""The port's dp × tp causal LM (``crs_tpu_torch.models.sharding``) against
``crs_tpu.models.sharding`` on the CPU.

One ``torch.multiprocessing`` spawn per mesh shape — (dp, tp) = (2, 2) on
four gloo processes and (1, 2) on two, over a ``FileStore`` — runs every
check of the port and writes rank 0's results to an ``.npz``; the workers
import nothing of JAX. The parent computes ``crs_tpu``'s results on the
same mesh shape of the 8-device CPU mesh that ``tests/conftest.py`` sets up
and compares: the f32 ``tiny`` forward at ``tests/test_sharding.py``'s
tolerances, one SGD step against the single-device step, five AdamW steps,
and greedy tokens (exactly equal) at ``tiny`` and at the hd-128 ``kv_bits=8``
config, whose decode goes through kernel 10's wrapper on the local cache;
at (2, 2) a batch of 3 that ``decode_attention_shardable`` refuses takes the
emulation, as in ``crs_tpu``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

MESHES = [(2, 2), (1, 2)]
KV8_DIMS = dict(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=256, max_seq_len=512, kv_bits=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs():
    """The token batches, as in ``tests/test_sharding.py``."""
    fwd_ids = np.random.default_rng(0).integers(0, 512, (4, 12)).astype(np.int64)
    step_ids = np.random.default_rng(0).integers(0, 512, (8, 12)).astype(np.int64)
    adam_ids = np.random.default_rng(0).integers(0, 512, (8, 16)).astype(np.int64)
    gen_ids = np.random.default_rng(1).integers(0, 512, (4, 10)).astype(np.int64)
    gen_mask = np.ones((4, 10), bool)
    gen_mask[2, :3] = False  # a left-padded row
    kv_ids = np.random.default_rng(2).integers(0, 512, (4, 10)).astype(np.int64)
    kv_mask = np.ones((4, 10), bool)
    kv_mask[1, :2] = False
    return dict(fwd_ids=fwd_ids, step_ids=step_ids, adam_ids=adam_ids, gen_ids=gen_ids,
                gen_mask=gen_mask, kv_ids=kv_ids, kv_mask=kv_mask)


def _by_path(tree, path="", is_leaf=lambda _: False):
    """{path: leaf} of a params-shaped tree (dicts by key, lists by index)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, f"{path}.{k}" if path else k, is_leaf))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_by_path(v, f"{path}[{i}]", is_leaf))
        return out
    return {path: tree}


def _full(shard, spec, group):
    """A parameter reassembled from every tp rank's shard."""
    import torch.distributed as dist

    if spec == ():
        return shard
    dim = spec.index("tp")
    parts = [torch.empty_like(shard) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, shard.contiguous(), group=group)
    return torch.cat(parts, dim)


def _worker(rank, world, tp, store, out_dir):
    """One rank: every check of the port on a (world / tp, tp) gloo mesh."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    import crs_tpu_torch.models.transformer as tr
    from crs_tpu_torch.models.sampling import SamplingParams, generate_tokens
    from crs_tpu_torch.models.sharding import (
        make_model_mesh, make_sharded_train_step, param_leaves, param_pspecs, shard_batch,
        shard_params, sharded_generate_tokens,
    )
    from crs_tpu_torch.parallel.mesh import initialize_multihost

    initialize_multihost(f"file://{store}", world, rank, device="cpu")
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    out = {}
    mesh = make_model_mesh(tp=tp, device="cpu")
    out["mesh_shape"] = np.array([mesh.size(0), mesh.size(1)])
    default = make_model_mesh(device="cpu")
    out["default_mesh_shape"] = np.array([default.size(0), default.size(1)])
    tp_group = mesh.get_group("tp")

    cfg = dataclasses.replace(tr.CONFIGS["tiny"], dtype=torch.float32)
    params = tr.init_params(0, cfg)
    shard = shard_params(params, mesh, cfg)
    out["forward"] = tr.forward(shard, cfg, x["fwd_ids"], mesh=mesh).numpy()
    fused = shard_params(tr.fuse_qkv_params(params), mesh, cfg)  # q|k|v, gate|up split by part
    out["forward_fused"] = tr.forward(fused, cfg, x["fwd_ids"], mesh=mesh).numpy()

    # one SGD(1e-2) step on a fresh shard, the updated params reassembled
    step_shard = shard_params(params, mesh, cfg)
    opt = torch.optim.SGD(param_leaves(step_shard), lr=1e-2)
    step = make_sharded_train_step(cfg, mesh, opt)
    ids, mask = shard_batch(x["step_ids"], torch.ones((8, 12), dtype=torch.bool), mesh)
    out["sgd_loss"] = np.array(float(step(step_shard, ids, mask)))
    specs = _by_path(param_pspecs(params))
    with torch.no_grad():
        for path, w in _by_path(step_shard).items():
            out[f"sgd_param_{path}"] = _full(w, specs[path], tp_group).numpy()

    # five AdamW steps on the bf16 tiny model
    bcfg = tr.CONFIGS["tiny"]
    adam_shard = shard_params(tr.init_params(0, bcfg), mesh, bcfg)
    opt = torch.optim.AdamW(param_leaves(adam_shard), lr=5e-3)
    step = make_sharded_train_step(bcfg, mesh, opt)
    ids, mask = shard_batch(x["adam_ids"], torch.ones((8, 16), dtype=torch.bool), mesh)
    out["adam_losses"] = np.array([float(step(adam_shard, ids, mask)) for _ in range(5)])

    gen = torch.Generator().manual_seed(7)
    toks, lens = sharded_generate_tokens(
        shard, cfg, x["gen_ids"], x["gen_mask"], gen,
        SamplingParams(max_new_tokens=6, temperature=0.0, eos_id=-1), mesh)
    out["gen_tokens"], out["gen_lengths"] = toks.numpy(), lens.numpy()

    # hd 128, kv_bits 8: kernel 10's wrapper on the local cache, counted
    calls = {"kernel": 0, "emulation": 0}
    kernel, emulation = tr.decode_attention_int8, tr.emulate_decode_attention_int8

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    tr.decode_attention_int8 = counted("kernel", kernel)
    tr.emulate_decode_attention_int8 = counted("emulation", emulation)
    kcfg = tr.TransformerConfig(**KV8_DIMS, dtype=torch.float32)
    kshard = shard_params(tr.init_params(0, kcfg), mesh, kcfg)
    sp = SamplingParams(max_new_tokens=5, temperature=0.0, eos_id=-1)
    toks, lens = sharded_generate_tokens(kshard, kcfg, x["kv_ids"], x["kv_mask"], gen, sp, mesh)
    out["kv8_tokens"], out["kv8_lengths"] = toks.numpy(), lens.numpy()
    out["kv8_calls"] = np.array([calls["kernel"], calls["emulation"]])
    calls.update(kernel=0, emulation=0)
    toks, lens = generate_tokens(kshard, kcfg, x["kv_ids"][:3], x["kv_mask"][:3], gen, sp,
                                 mesh=mesh)
    out["kv8_b3_tokens"], out["kv8_b3_lengths"] = toks.numpy(), lens.numpy()
    out["kv8_b3_calls"] = np.array([calls["kernel"], calls["emulation"]])
    tr.decode_attention_int8, tr.emulate_decode_attention_int8 = kernel, emulation
    if rank == 0:
        np.savez(os.path.join(out_dir, "port.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    import torch.multiprocessing as mp

    runs = {}
    for dp, tp in MESHES:
        out = tmp_path_factory.mktemp(f"port_{dp}x{tp}")
        mp.spawn(_worker, args=(dp * tp, tp, str(out / "store"), str(out)), nprocs=dp * tp)
        with np.load(out / "port.npz") as f:
            runs[(dp, tp)] = dict(f)
    return runs


@pytest.fixture(scope="module")
def jax_runs():
    """crs_tpu's results on each mesh shape of the 8-device CPU mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from crs_tpu.models.sampling import SamplingParams, generate_tokens
    from crs_tpu.models.sharding import make_model_mesh, shard_params, sharded_generate_tokens
    from crs_tpu.models.transformer import CONFIGS, TransformerConfig, forward, init_params

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    x = _inputs()
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=jnp.float32)
    params = init_params(0, cfg)
    ids, mask = jnp.asarray(x["step_ids"], jnp.int32), jnp.ones((8, 12), bool)

    def loss_local(p):  # tests/test_sharding.py's single-device step
        logits = forward(p, cfg, ids, mask)
        valid = mask[:, 1:] & mask[:, :-1]
        losses = optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1, :], ids[:, 1:])
        return jnp.sum(losses * valid) / jnp.maximum(jnp.sum(valid), 1)

    loss, grads = jax.value_and_grad(loss_local)(params)
    tx = optax.sgd(1e-2)
    upd, _ = tx.update(grads, tx.init(params), params)
    new = _by_path(optax.apply_updates(params, upd))
    single = {"sgd_loss": float(loss), "sgd_params": {k: np.asarray(v) for k, v in new.items()}}
    kcfg = TransformerConfig(**KV8_DIMS, dtype=jnp.float32)
    kparams = init_params(0, kcfg)
    key = jax.random.PRNGKey(7)
    runs = {}
    for dp, tp in MESHES:
        mesh = make_model_mesh(dp * tp, tp=tp)
        res = {"mesh_shape": (mesh.shape["dp"], mesh.shape["tp"]),
               "default_mesh_shape": tuple(make_model_mesh(dp * tp).shape.values())}
        sharded = shard_params(params, mesh)
        res["forward"] = np.asarray(forward(sharded, cfg, jnp.asarray(x["fwd_ids"], jnp.int32)))
        toks, lens = sharded_generate_tokens(
            sharded, cfg, x["gen_ids"].astype(np.int32), x["gen_mask"], key,
            SamplingParams(max_new_tokens=6, temperature=0.0, eos_id=-1), mesh)
        res["gen_tokens"], res["gen_lengths"] = np.asarray(toks), np.asarray(lens)
        sp = SamplingParams(max_new_tokens=5, temperature=0.0, eos_id=-1)
        ksharded = shard_params(kparams, mesh)
        toks, lens = sharded_generate_tokens(ksharded, kcfg, x["kv_ids"].astype(np.int32),
                                             x["kv_mask"], key, sp, mesh)
        res["kv8_tokens"], res["kv8_lengths"] = np.asarray(toks), np.asarray(lens)
        toks, lens = generate_tokens(ksharded, kcfg, jnp.asarray(x["kv_ids"][:3], jnp.int32),
                                     jnp.asarray(x["kv_mask"][:3]), key, sp, mesh=mesh)
        res["kv8_b3_tokens"], res["kv8_b3_lengths"] = np.asarray(toks), np.asarray(lens)
        runs[(dp, tp)] = res
    return single, runs


def test_param_pspecs_match_crs_tpu():
    import jax
    import jax.numpy as jnp

    from crs_tpu.models import sharding as jsh
    from crs_tpu.models import transformer as jtr
    from crs_tpu_torch.models import sharding
    from crs_tpu_torch.models import transformer as tr

    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
    trees = [(jtr.init_params(0, jtr.CONFIGS[n]), tr.init_params(0, tr.CONFIGS[n]))
             for n in ("tiny", "small")]
    cfg = dataclasses.replace(jtr.CONFIGS["tiny"], dtype=jnp.float32)
    trees.append((jtr.fuse_qkv_params(jtr.init_params(0, cfg)),
                  tr.fuse_qkv_params(tr.init_params(0, tr.CONFIGS["tiny"]))))
    for jparams, params in trees:
        jspecs = _by_path(jsh.param_pspecs(jparams), is_leaf=is_spec)
        specs = _by_path(sharding.param_pspecs(params))
        assert {k: tuple(v) for k, v in jspecs.items()} == specs
        assert set(specs.values()) == {(None, "tp"), ("tp", None), ()}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}_tp{s[1]}")
def test_mesh_shapes(port_runs, jax_runs, shape):
    port, ref = port_runs[shape], jax_runs[1][shape]
    assert tuple(port["mesh_shape"]) == ref["mesh_shape"] == shape
    assert tuple(port["default_mesh_shape"]) == ref["default_mesh_shape"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}_tp{s[1]}")
@pytest.mark.parametrize("which", ["forward", "forward_fused"])
def test_sharded_forward_matches_crs_tpu(port_runs, jax_runs, shape, which):
    np.testing.assert_allclose(port_runs[shape][which], jax_runs[1][shape]["forward"],
                               atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}_tp{s[1]}")
def test_sgd_step_matches_single_device(port_runs, jax_runs, shape):
    port, single = port_runs[shape], jax_runs[0]
    assert abs(float(port["sgd_loss"]) - single["sgd_loss"]) < 1e-4
    assert len(single["sgd_params"]) == 3 + 2 * 9 and all(
        f"sgd_param_{path}" in port for path in single["sgd_params"])
    for path, ref in single["sgd_params"].items():
        np.testing.assert_allclose(port[f"sgd_param_{path}"], ref, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}_tp{s[1]}")
def test_adamw_steps_lower_the_loss(port_runs, shape):
    losses = port_runs[shape]["adam_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}_tp{s[1]}")
@pytest.mark.parametrize("run", ["gen", "kv8"])
def test_greedy_tokens_equal_crs_tpu(port_runs, jax_runs, shape, run):
    port, ref = port_runs[shape], jax_runs[1][shape]
    np.testing.assert_array_equal(port[f"{run}_tokens"], ref[f"{run}_tokens"])
    np.testing.assert_array_equal(port[f"{run}_lengths"], ref[f"{run}_lengths"])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}_tp{s[1]}")
def test_kv8_decode_takes_kernel_10_on_the_local_cache(port_runs, shape):
    kernel, emulation = port_runs[shape]["kv8_calls"]
    assert kernel == 2 * 4 and emulation == 0  # two layers × four decode steps


def test_refused_batch_takes_the_emulation(port_runs, jax_runs):
    """B = 3 over dp = 2: ``decode_attention_shardable`` refuses, every dp
    rank decodes the three rows, and the attention is the emulation."""
    from crs_tpu.models.sharding import make_model_mesh
    from crs_tpu.ops.decode_attention import decode_attention_shardable as jgate
    from crs_tpu_torch.ops.decode_attention import decode_attention_shardable

    class _Mesh:  # the port's gate reads only the axis names and sizes
        mesh_dim_names = ("dp", "tp")

        def size(self, dim):
            return (2, 2)[dim]

    assert not jgate(3, 2, make_model_mesh(4)) and not decode_attention_shardable(3, 2, _Mesh())
    assert decode_attention_shardable(4, 2, _Mesh())
    port, ref = port_runs[(2, 2)], jax_runs[1][(2, 2)]
    kernel, emulation = port["kv8_b3_calls"]
    assert kernel == 0 and emulation == 2 * 4
    np.testing.assert_array_equal(port["kv8_b3_tokens"], ref["kv8_b3_tokens"])
    np.testing.assert_array_equal(port["kv8_b3_lengths"], ref["kv8_b3_lengths"])


def test_shard_params_refuses_quantized_weights():
    """crs_tpu's shard_params does not take quantized weights (its tree of
    PartitionSpecs does not match a QuantizedTensor node); the port's
    raises for them."""
    import torch.distributed as dist

    from crs_tpu_torch.models import quantize_params
    from crs_tpu_torch.models.sharding import make_model_mesh, shard_params
    from crs_tpu_torch.models.transformer import CONFIGS, init_params

    params = quantize_params(init_params(0, CONFIGS["tiny"]), bits=8)
    mesh = make_model_mesh(device="cpu")  # a one-rank group of its own
    try:
        with pytest.raises(TypeError, match="quantized"):
            shard_params(params, mesh, CONFIGS["tiny"])
    finally:
        dist.destroy_process_group()
