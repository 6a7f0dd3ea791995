"""The port's multi-host dry run (``crs_tpu_torch/tools/dryrun_multihost.py``)
against the JAX tool ``tools/dryrun_multihost.py`` and ``crs_tpu``, on the CPU.

- End to end: the tool's default CPU run (2 hosts × 4 gloo workers) in a
  child prints two ``MULTIHOST OK … devices=8`` lines, with the overlaps and
  the loss that ``crs_tpu`` gives on the same inputs, and ``PASS``.
- Scans and the training step: the tool's :func:`scans` and
  :func:`train_step` in gloo worlds of 8 and 1 (one ``torch.multiprocessing``
  spawn each, over a ``FileStore``) against ``crs_tpu``'s ``sharded_topk`` /
  ``sharded_topk_int8`` and the JAX tool's jitted ``value_and_grad`` SGD
  step on an 8- and a 1-device CPU mesh, computed in a child process with
  ``--xla_force_host_platform_device_count=8``. Ids equal but for fp32 ties
  within 1e-6, scores within 1e-5; the loss within 1e-5 relative, the
  updated params within 1e-6. At world 8 both packages scan 525-row shards
  with the dense body; at world 1 ``crs_tpu`` takes its Pallas route
  (interpret mode) and the port its kernels' plain versions.
- Refusals: a failing, a hanging or a silent worker fails the run, and too
  few cards raise.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLDS = [8, 1]
SCORE_ATOL, TIE_ATOL = 1e-5, 1e-6
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6

JAX_SIDE = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from crs_tpu.models.transformer import TransformerConfig, forward, init_params
from crs_tpu.ops.quant import scalar_quantize
from crs_tpu.parallel.sharded_index import shard_corpus, sharded_topk, sharded_topk_int8

worlds, model, out_path = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
# the JAX tool's inputs, in its draw order
rng = np.random.default_rng(0)
n, d, b, k = 4096 + 100, 128, 8, 10
vecs = rng.standard_normal((n, d)).astype(np.float32)
vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
queries = vecs[:b] + 0.01 * rng.standard_normal((b, d)).astype(np.float32)
ids = rng.integers(1, 384, (8, 32)).astype(np.int32)
out = {"vecs": vecs, "queries": queries, "ids": ids}
cfg = TransformerConfig(**model, dtype=jnp.float32)
params = init_params(jax.random.PRNGKey(0), cfg)


def loss_fn(p, x):
    logits = forward(p, cfg, x)
    return optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1, :], x[:, 1:]).mean()


@jax.jit
def train_step(p, x):
    loss, grads = jax.value_and_grad(loss_fn)(p, x)
    return jax.tree.map(lambda a, g: a - 1e-3 * g, p, grads), loss


def flat(tree, path=""):
    if isinstance(tree, dict):
        return {kk: vv for key, v in tree.items()
                for kk, vv in flat(v, f"{path}.{key}" if path else key).items()}
    if isinstance(tree, list):
        return {kk: vv for i, v in enumerate(tree) for kk, vv in flat(v, f"{path}.{i}").items()}
    return {path: np.asarray(tree)}


for w in worlds:
    mesh = Mesh(np.array(jax.devices()[:w]), ("corpus",))
    vs, valid_n = shard_corpus(vecs, mesh)
    q = jax.device_put(jnp.asarray(queries), NamedSharding(mesh, P()))
    s, i = sharded_topk(vs, q, k, valid_n, mesh, block_size=512)
    codes, scales = scalar_quantize(jnp.asarray(vecs))
    cs, _ = shard_corpus(np.asarray(codes), mesh)
    ss, _ = shard_corpus(np.asarray(scales).reshape(-1, 1), mesh)
    s8, i8 = sharded_topk_int8(cs, ss.reshape(-1), q, k, valid_n, mesh, rescore_k=32,
                               block_size=512)
    out.update({f"{w}_fp32_s": np.asarray(s), f"{w}_fp32_i": np.asarray(i),
                f"{w}_int8_s": np.asarray(s8), f"{w}_int8_i": np.asarray(i8)})
    dp = Mesh(np.array(jax.devices()[:w]), ("dp",))
    ids_sh = jax.device_put(jnp.asarray(ids), NamedSharding(dp, P("dp", None)))
    params2, loss = train_step(jax.device_put(params, NamedSharding(dp, P())), ids_sh)
    out[f"{w}_loss"] = np.asarray(loss)
    out.update({f"{w}_param_{key}": v for key, v in flat(params2).items()})
np.savez(out_path, **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, path=""):
    """{path: numpy leaf} of a params tree (dicts by key, lists by index)."""
    if isinstance(tree, dict):
        return {kk: vv for key, v in tree.items()
                for kk, vv in _flat(v, f"{path}.{key}" if path else key).items()}
    if isinstance(tree, list):
        return {kk: vv for i, v in enumerate(tree) for kk, vv in _flat(v, f"{path}.{i}").items()}
    return {path: tree.detach().cpu().numpy()}


def _worker(rank, world, store, out_dir):
    """One rank of a gloo world: the tool's scans and step; rank 0 saves them."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from crs_tpu_torch.models.sharding import make_model_mesh
    from crs_tpu_torch.parallel.mesh import corpus_mesh, initialize_multihost
    from crs_tpu_torch.tools import dryrun_multihost as dm

    initialize_multihost(f"file://{store}", world, rank, device="cpu")
    vecs, queries, ids = dm.inputs()
    found = dm.scans(corpus_mesh(device="cpu"), vecs, queries)
    loss, params = dm.train_step(make_model_mesh(tp=1, device="cpu"), ids)
    if rank == 0:
        out = {f"{kind}_{part}": t.numpy() for kind in ("fp32", "int8")
               for part, t in zip("si", found[kind])}
        out.update(loss=np.array(loss), fp32_overlap=np.array(found["fp32_overlap"]),
                   int8_overlap=np.array(found["int8_overlap"]))
        out.update({f"param_{key}": v for key, v in _flat(params).items()})
        np.savez(os.path.join(out_dir, "port.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _tool_child(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-m", "crs_tpu_torch.tools.dryrun_multihost",
                             *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tool's CPU run in a child, crs_tpu's side in a child and the port's
    gloo worlds, all at once → (tool (rc, stdout, stderr), jax npz, {world:
    port npz})."""
    import torch.multiprocessing as mp

    from crs_tpu_torch.tools import dryrun_multihost as dm

    tool = _tool_child("--device", "cpu", "--port", str(_free_port()))
    jax_out = tmp_path_factory.mktemp("jax") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, json.dumps(WORLDS),
                                 json.dumps(dm.MODEL), str(jax_out)], cwd=REPO, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        outs, ctxs = {}, []
        for world in WORLDS:
            outs[world] = tmp_path_factory.mktemp(f"port_w{world}")
            ctxs.append(mp.spawn(_worker, args=(world, str(outs[world] / "store"),
                                                str(outs[world])), nprocs=world, join=False))
        for ctx in ctxs:
            while not ctx.join():
                pass
        port = {}
        for world, out in outs.items():
            with np.load(out / "port.npz") as f:
                port[world] = dict(f)
        _, err = jax_proc.communicate(timeout=300)
        assert jax_proc.returncode == 0, err[-3000:]
        with np.load(jax_out) as f:
            jax_side = dict(f)
        stdout, stderr = tool.communicate(timeout=300)
    finally:
        for proc in (tool, jax_proc):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return (tool.returncode, stdout, stderr), jax_side, port


def _assert_topk(got, ref):
    """Scores within SCORE_ATOL; an id may differ only where its score ties
    (within TIE_ATOL) another entry of the reference's row, or the score at
    its rank."""
    (gs, gi), (rs, ri) = got, ref
    assert gs.shape == rs.shape and gi.shape == ri.shape
    np.testing.assert_allclose(gs, rs, rtol=0, atol=SCORE_ATOL)
    for b, j in zip(*np.nonzero(gi != ri)):
        tied = np.abs(rs[b] - rs[b, j]) <= TIE_ATOL
        assert gi[b, j] in ri[b][tied] or abs(gs[b, j] - rs[b, j]) <= TIE_ATOL, (b, j, gi[b],
                                                                               ri[b], rs[b])


def test_inputs_follow_the_jax_draw_order(runs):
    from crs_tpu_torch.tools import dryrun_multihost as dm

    jax_side = runs[1]
    for got, key in zip(dm.inputs(), ("vecs", "queries", "ids")):
        np.testing.assert_array_equal(got, jax_side[key])


def test_tool_runs_end_to_end_on_the_cpu(runs):
    """Two OK lines (one a host) over 8 devices, the overlaps and the loss
    as crs_tpu gives them, printed the JAX tool's way, then PASS."""
    from crs_tpu_torch.tools import dryrun_multihost as dm

    (rc, stdout, stderr), jax_side = runs[0], runs[1]
    assert rc == 0, stdout[-3000:] + stderr[-1000:]
    want = np.argsort(-(jax_side["queries"] @ jax_side["vecs"].T), axis=1)[:, :dm.K]
    tail = (f"devices=8 fp32_overlap={dm.overlap(jax_side['8_fp32_i'], want):.2f} "
            f"int8_overlap={dm.overlap(jax_side['8_int8_i'], want):.2f} "
            f"dp_loss={float(jax_side['8_loss']):.4f}")
    lines = [line for line in stdout.splitlines() if line.startswith("MULTIHOST OK")]
    assert lines == [f"MULTIHOST OK proc={h} {tail}" for h in range(2)], stdout
    assert stdout.strip().splitlines()[-1] == "MULTIHOST DRYRUN: PASS"


@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("world", WORLDS)
def test_scans_match_crs_tpu(runs, world, kind):
    port, jax_side = runs[2][world], runs[1]
    _assert_topk((port[f"{kind}_s"], port[f"{kind}_i"]),
                 (jax_side[f"{world}_{kind}_s"], jax_side[f"{world}_{kind}_i"]))
    assert (port["fp32_i"][:, 0] == np.arange(port["fp32_i"].shape[0])).all()


@pytest.mark.parametrize("world", WORLDS)
def test_train_step_matches_crs_tpu(runs, world):
    port, jax_side = runs[2][world], runs[1]
    want = float(jax_side[f"{world}_loss"])
    assert abs(float(port["loss"]) - want) <= LOSS_RTOL * abs(want)
    keys = sorted(k[len(f"{world}_param_"):] for k in jax_side
                  if k.startswith(f"{world}_param_"))
    assert keys == sorted(k[len("param_"):] for k in port if k.startswith("param_"))
    for key in keys:
        np.testing.assert_allclose(port[f"param_{key}"], jax_side[f"{world}_param_{key}"],
                                   rtol=0, atol=PARAM_ATOL, err_msg=key)


FAKE_WORKER = r"""
import os, sys, time
rank, mode = int(os.environ["RANK"]), sys.argv[1]
print("rank", rank, "local", os.environ["LOCAL_RANK"], "world", os.environ["WORLD_SIZE"],
      "cards", os.environ.get("CUDA_VISIBLE_DEVICES"), flush=True)
if rank == 1 and mode in ("fails", "hangs"):
    if mode == "fails":
        time.sleep(2)  # rank 0 ends first: nothing is left to kill
    print("boom", flush=True)
    sys.exit(3)
if mode in ("hangs", "times_out"):
    time.sleep(600)
if os.environ["LOCAL_RANK"] == "0" and mode != "silent":
    print("MULTIHOST OK proc=0 devices=2 fp32_overlap=1.00 int8_overlap=0.99 dp_loss=6.4976")
"""


@pytest.fixture
def fake_workers(monkeypatch):
    """Workers replaced by a script that behaves as ``mode`` says."""
    from crs_tpu_torch.tools import dryrun_multihost as dm

    def use(mode):
        monkeypatch.setattr(dm, "worker_command",
                            lambda host, port, device: [sys.executable, "-c", FAKE_WORKER, mode])
        return dm

    return use


@pytest.mark.parametrize("mode,failed,note", [
    ("fails", [1], "boom"),
    ("hangs", [0, 1], "stopped after proc 1 failed"),  # the waiting rank is killed
    ("times_out", [0, 1], "TIMEOUT"),
    ("silent", [0], "rank 0"),  # local rank 0 exited 0 without its OK line
])
def test_a_failing_worker_fails_the_run(fake_workers, monkeypatch, capsys, mode, failed, note):
    dm = fake_workers(mode)
    monkeypatch.setattr(dm, "WORKER_TIMEOUT_S", 3)
    rc = dm.main(["--device", "cpu", "--hosts", "1", "--devices-per-host", "2",
                  "--port", str(_free_port())])
    out = capsys.readouterr().out
    assert rc == 1 and out.strip().splitlines()[-1] == "MULTIHOST DRYRUN: FAIL", out
    assert [r for r in (0, 1) if f"proc {r} FAILED:" in out] == failed, out
    assert note in out
    assert ("MULTIHOST OK" in out) == (0 not in failed)


def test_parent_passes_when_every_host_reports(fake_workers, capsys):
    """Every worker exits 0 and each host's local rank 0 prints its line."""
    dm = fake_workers("passes")
    assert dm.parent(2, 2, _free_port(), [["3", "2"], ["1", "0"]]) == 0
    out = capsys.readouterr().out
    assert out.count("MULTIHOST OK") == 2 and out.strip().endswith("PASS"), out


def test_workers_get_the_launch_environment(fake_workers, capsys):
    """On the card every worker sees only its host's cards, LOCAL_RANK its
    place there."""
    dm = fake_workers("silent")  # local rank 0 prints no OK line: every tail is shown
    dm.parent(2, 2, _free_port(), [["3", "2"], ["1", "0"]])
    out = capsys.readouterr().out
    for rank, local, cards in ((0, 0, "3,2"), (2, 0, "1,0")):
        assert f"rank {rank} local {local} world 4 cards {cards}" in out, out


@pytest.fixture
def cards(monkeypatch):
    """A machine that reports ``n`` cards."""
    def use(n, visible=None):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        if visible is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    return use


@pytest.mark.parametrize("n,argv", [
    (2, ["--hosts", "2", "--devices-per-host", "2"]),
    (1, []),  # the default: the visible cards ÷ 2 hosts, none each
    (3, ["--hosts", "1", "--devices-per-host", "4"]),
])
def test_too_few_cards_raise(cards, n, argv):
    from crs_tpu_torch.tools import dryrun_multihost as dm

    cards(n)
    with pytest.raises(RuntimeError, match=f"{n} visible"):
        dm.main(argv + ["--port", "1"])


def test_plan_splits_the_visible_cards(cards):
    from crs_tpu_torch.tools import dryrun_multihost as dm

    cards(4, visible="7,6,5,4")
    assert dm.plan(2, None, None) == (2, [["7", "6"], ["5", "4"]])
    assert dm.plan(1, 1, "cuda") == (1, [["7"]])
    cards(4)
    assert dm.plan(2, 2, None) == (2, [["0", "1"], ["2", "3"]])
    assert dm.plan(2, None, "cpu") == (dm.CPU_DEVICES_PER_HOST, None)
    with pytest.raises(ValueError):
        dm.plan(0, None, "cpu")
