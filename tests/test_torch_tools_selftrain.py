"""The port's self-training tool (``crs_tpu_torch/tools/selftrain_lm.py``)
against the JAX script ``tools/selftrain_lm.py``, on the CPU.

The JAX script reads its corpus and questions from module constants
(``CORPUS``, ``QA``) that name files outside the repository; here they are
pointed at a synthetic corpus and a 20-item QA file made from a seed. Both
tools train six steps at toy widths from the same pre-written
``train_contexts.json``. The JAX script runs whole in a child process, its
``jax.jit`` wrapped so that the batches its step receives are recorded; a
second child scores the repository's ``checkpoints/selftrained_small`` on
its held-out text (``results/selftrained/heldout_corpus.txt``) with the JAX
script's own loop.

Tolerances:
- the split, the samples, the printed data lines and the six steps'
  batches (ids, mask, loss mask): identical; the retrieval contexts:
  identical;
- the per-step losses: rtol 1e-3; the parameters after six steps: within
  2.1·Σ rate (Adam turns a gradient near 0 into a full ±rate step of either
  sign, ``tests/test_torch_finetuning.py``'s allowance);
- the held-out byte perplexity: rtol 1e-3 after training, rtol 1e-4 for
  the committed checkpoint (f32 sums in other orders);
- the logits of a checkpoint saved by one package and loaded by the other:
  within 1e-5 of the saving package's.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
COMMITTED = REPO / "checkpoints" / "selftrained_small"
HELDOUT = REPO / "results" / "selftrained" / "heldout_corpus.txt"
STEPS = 6
LR = 3e-4
TOY = ["--steps", str(STEPS), "--batch", "2", "--seq", "256", "--hidden", "32", "--layers", "1",
       "--heads", "2", "--kv-heads", "1", "--inter", "64", "--qa-every", "2", "--log-every", "1"]
LOSS_RTOL = 1e-3
PPL_RTOL = 1e-3
COMMITTED_PPL_RTOL = 1e-4
LOGITS_ATOL = 1e-5
ADAM_RATE_FACTOR = 2.1
N_QA = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_script():
    spec = importlib.util.spec_from_file_location("_jax_selftrain_lm", REPO / "tools" /
                                                  "selftrain_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic(base: pathlib.Path):
    """A corpus of sentences over 300 made-up words and 20 questions that
    quote it, from a seed."""
    rng = np.random.default_rng(7)
    vocab = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), size=rng.integers(3, 9)))
             for _ in range(300)]
    paras = []
    for _ in range(60):
        sents = [" ".join(rng.choice(vocab, size=rng.integers(6, 16))).capitalize() + "."
                 for _ in range(rng.integers(3, 7))]
        paras.append(" ".join(sents))
    corpus = base / "corpus.txt"
    corpus.write_text("\n\n".join(paras))
    words = " ".join(paras).split()
    qa = [{"question": f"What is meant by {' '.join(words[97 * i:97 * i + 8])}?",
           "answer": " ".join(rng.choice(vocab, size=6)), "section": "s"} for i in range(N_QA)]
    qa_path = base / "qa.json"
    qa_path.write_text(json.dumps(qa))
    return str(corpus), str(qa_path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    base = tmp_path_factory.mktemp("selftrain")
    corpus, qa = _synthetic(base)
    text = pathlib.Path(corpus).read_text()
    # short contexts: every QA sample's answer lies inside the toy window
    contexts = [text[300 * i:300 * i + 40] for i in range(N_QA - 10)]
    outs = {}
    for side in ("port", "jax"):
        outs[side] = base / side
        outs[side].mkdir()
        (outs[side] / "train_contexts.json").write_text(json.dumps(contexts))
    return {"base": base, "corpus": corpus, "qa": qa, "port": outs["port"], "jax": outs["jax"]}


@pytest.fixture(scope="module")
def port_run(files):
    from crs_tpu_torch.tools import selftrain_lm

    args = selftrain_lm.parse_args(["--corpus", files["corpus"], "--qa", files["qa"], *TOY,
                                    "--out", str(files["port"]), "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        params, cfg, result = selftrain_lm.run(args)
    return {"args": args, "params": params, "cfg": cfg, "result": result,
            "lines": buf.getvalue().splitlines()}


# the JAX side: "train" runs the JAX script whole (its step's batches recorded), then the
# retrieval contexts of its train split, then the logits of both packages' checkpoints;
# "committed" scores the committed checkpoint with the script's held-out loop
JAX_SIDE = """
import importlib.util, io, contextlib, json, sys
import numpy as np
job, arg = json.loads(sys.argv[1])
import jax, jax.numpy as jnp, optax
from crs_tpu.models.model_interface import create_model_interface
from crs_tpu.models.transformer import forward
def logits_of(path, ids):
    m = create_model_interface("jax", {"model_path": path})
    m.load()
    return np.asarray(forward(m.params, m.cfg, jnp.asarray(ids), jnp.ones(ids.shape, bool)))
if job == "train":
    spec = importlib.util.spec_from_file_location("jax_selftrain_lm", "tools/selftrain_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CORPUS, mod.QA = arg["corpus"], arg["qa"]
    batches, jit = [], jax.jit
    def recording_jit(fn, *a, **k):
        compiled = jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "step":
            return compiled
        def step(p, s, ids, mask, lmask):
            batches.append([np.asarray(x) for x in (ids, mask, lmask)])
            return compiled(p, s, ids, mask, lmask)
        return step
    jax.jit = recording_jit
    sys.argv = ["selftrain_lm.py", "--cpu", *arg["argv"], "--out", arg["out"]]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        mod.main()
    jax.jit = jit
    ctx = mod.retrieve_contexts([x["question"] for x in mod.qa_split()[0]])
    ids = np.load(arg["ids"])
    np.savez(arg["out"] + "/side.npz", ids=np.stack([b[0] for b in batches]),
             mask=np.stack([b[1] for b in batches]), lmask=np.stack([b[2] for b in batches]),
             own_logits=logits_of(arg["out"], ids), port_logits=logits_of(arg["port"], ids))
    print(json.dumps({"lines": buf.getvalue().splitlines(), "contexts": ctx}))
else:
    from crs_tpu.models.bytes_tokenizer import ByteTokenizer
    m = create_model_interface("jax", {"model_path": arg["ckpt"]})
    m.load()
    def loss_fn(p, ids, mask, lmask):
        logits = forward(p, m.cfg, ids, mask)
        losses = optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1, :], ids[:, 1:])
        valid = lmask[:, 1:] & mask[:, :-1]
        return jnp.sum(losses * valid) / jnp.maximum(jnp.sum(valid), 1)
    tok, seq = ByteTokenizer(), arg["seq"]
    held_ids = np.array(tok.encode(open(arg["text"]).read(), max_length=None), np.int32)
    nll, count = 0.0, 0
    eval_windows = [held_ids[s:s + seq] for s in range(0, max(len(held_ids) - 16, 1), seq)]
    eval_loss = jax.jit(loss_fn)
    for w in eval_windows:
        ids = np.full((1, seq), tok.pad_id, np.int32)
        mask = np.zeros((1, seq), np.bool_)
        ids[0, :len(w)] = w
        mask[0, :len(w)] = True
        lv = float(eval_loss(m.params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(mask)))
        n = max(len(w) - 1, 1)
        nll += lv * n
        count += n
    print(json.dumps({"ppl": float(np.exp(nll / max(count, 1))), "count": count}))
"""


@pytest.fixture(scope="module")
def jax_procs(files, port_run):
    """The JAX side's two children, started with the first test that needs them."""
    ids = np.random.default_rng(3).integers(0, 259, size=(2, 48))
    np.save(files["base"] / "ids.npy", ids)
    jobs = {"train": {"corpus": files["corpus"], "qa": files["qa"], "argv": TOY,
                      "out": str(files["jax"]), "port": str(files["port"]),
                      "ids": str(files["base"] / "ids.npy")},
            "committed": {"ckpt": str(COMMITTED), "text": str(HELDOUT), "seq": 1536}}
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    procs = {job: subprocess.Popen([sys.executable, "-c", JAX_SIDE, json.dumps([job, arg])],
                                   cwd=REPO, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for job, arg in jobs.items()}
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


def _jax(procs, job) -> dict:
    proc = procs[job]
    if not hasattr(proc, "result"):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (job, err[-3000:])
        proc.result = json.loads(out.strip().splitlines()[-1])
    return proc.result


# -- in this process: the data functions, the defaults, the refusals ------------------------

def test_split_and_samples_equal_the_jax_tools(files, jax_procs, monkeypatch):
    """(Starts the JAX side's children: the tests before theirs run meanwhile.)"""
    from crs_tpu_torch.tools import selftrain_lm

    jax_tool = _jax_script()
    monkeypatch.setattr(jax_tool, "QA", files["qa"])
    got, want = selftrain_lm.qa_split(files["qa"]), jax_tool.qa_split()
    assert got == want
    assert len(got[0]) == N_QA - 10 and len(got[2]) == 10
    for item in got[0] + got[1]:
        assert selftrain_lm.qa_sample_texts(item, "ctx\n\nmore") == \
            jax_tool.qa_sample_texts(item, "ctx\n\nmore")


def test_default_out_lies_outside_the_repository(files, monkeypatch, tmp_path):
    from crs_tpu_torch.tools import selftrain_lm

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = selftrain_lm.parse_args(["--corpus", files["corpus"], "--qa", files["qa"]])
    assert args.out == str(tmp_path / "crs_tpu_torch" / "selftrain_lm")
    assert REPO not in pathlib.Path(args.out).parents


def test_default_device_raises_without_a_card(files, monkeypatch, tmp_path):
    from crs_tpu_torch.tools import selftrain_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        selftrain_lm.main(["--corpus", files["corpus"], "--qa", files["qa"], *TOY,
                           "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_an_empty_train_split_raises(files, tmp_path):
    from crs_tpu_torch.tools import selftrain_lm

    qa = tmp_path / "ten.json"
    qa.write_text(json.dumps(json.loads(pathlib.Path(files["qa"]).read_text())[:10]))
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(ValueError, match="none is left to train"):
        selftrain_lm.main(["--corpus", files["corpus"], "--qa", str(qa), *TOY,
                           "--out", str(tmp_path / "out"), "--device", "cpu"])


def test_contexts_of_another_qa_file_are_refused(files, tmp_path):
    from crs_tpu_torch.tools import selftrain_lm

    out = tmp_path / "out"
    out.mkdir()
    (out / "train_contexts.json").write_text(json.dumps(["one", "two"]))
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(ValueError, match="another QA file"):
        selftrain_lm.main(["--corpus", files["corpus"], "--qa", files["qa"], *TOY,
                           "--out", str(out), "--device", "cpu"])


def test_committed_checkpoint_perplexity_equals_jax(jax_procs):
    from crs_tpu_torch.models import create_model_interface
    from crs_tpu_torch.tools.selftrain_lm import heldout_perplexity

    m = create_model_interface("jax", {"model_path": str(COMMITTED)}, device="cpu")
    m.load()
    ppl, count = heldout_perplexity(m.params, m.cfg, HELDOUT.read_text(), 1536)
    want = _jax(jax_procs, "committed")
    meta = json.loads((COMMITTED / "selftrain_result.json").read_text())
    assert count == want["count"] == meta["heldout_bytes"]
    assert abs(ppl / want["ppl"] - 1) <= COMMITTED_PPL_RTOL, (ppl, want["ppl"])


# -- against the JAX script's run ----------------------------------------------------------------

def test_printed_lines_and_batches_equal_the_jax_tools(files, port_run, jax_procs):
    from crs_tpu_torch.tools import selftrain_lm

    want = _jax(jax_procs, "train")
    # the data lines and the model line; the step lines carry the host's seconds
    assert port_run["lines"][:4] == want["lines"][:4]
    with contextlib.redirect_stdout(io.StringIO()):
        data = selftrain_lm.prepare(port_run["args"], torch.device("cpu"))
    args = port_run["args"]
    batches = selftrain_lm.Batches(data["windows"], data["qa_encoded"], args.batch, args.seq,
                                   data["pad_id"], args.qa_every)
    side = np.load(files["jax"] / "side.npz")
    assert side["ids"].shape == (STEPS, args.batch, args.seq)
    for i in range(STEPS):
        ids, mask, lmask = batches.for_step(i)
        assert np.array_equal(ids, side["ids"][i]), i
        assert np.array_equal(mask, side["mask"][i]), i
        assert np.array_equal(lmask, side["lmask"][i]), i
    assert side["lmask"][0].sum() < side["mask"][0].sum()  # step 0 is a QA batch


def test_contexts_equal_the_jax_tools(files, jax_procs, tmp_path):
    from crs_tpu_torch.tools import selftrain_lm

    path = tmp_path / "contexts.json"
    assert selftrain_lm.main(["--corpus", files["corpus"], "--qa", files["qa"],
                              "--make-contexts", str(path), "--device", "cpu"]) == 0
    got = json.loads(path.read_text())
    assert len(got) == N_QA - 10 and any(got)
    assert got == _jax(jax_procs, "train")["contexts"]


def test_six_steps_equal_the_jax_tool(files, port_run, jax_procs):
    from crs_tpu_torch.finetuning.trainer import warmup_cosine_lr
    from crs_tpu_torch.tools.selftrain_lm import param_leaves
    from crs_tpu_torch.utils.checkpoint import load_pytree

    _jax(jax_procs, "train")
    got = port_run["result"]
    want = json.loads((files["jax"] / "selftrain_result.json").read_text())
    assert set(got) == set(want) | {"device"}
    assert got["device"]["kind"] == "cpu" and got["device"]["peak_mb"] is None
    assert [e["step"] for e in got["log"]] == [e["step"] for e in want["log"]] == \
        list(range(STEPS))
    for g, w in zip(got["log"], want["log"]):
        assert g["loss"] > 0 and abs(g["loss"] / w["loss"] - 1) <= LOSS_RTOL, (g, w)
    for key in ("params_millions", "steps", "heldout_bytes", "qa_eval_indices"):
        assert got[key] == want[key], key
    assert abs(got["heldout_byte_perplexity"] / want["heldout_byte_perplexity"] - 1) <= PPL_RTOL
    warmup = min(max(STEPS // 50, 10), max(STEPS // 2, 1))
    rates = sum(warmup_cosine_lr(c, LR, warmup, STEPS + warmup) for c in range(STEPS))
    jax_params = param_leaves(load_pytree(str(files["jax"] / "model")))
    port_params = param_leaves(port_run["params"])
    assert len(jax_params) == len(port_params)
    for g, w in zip(port_params, jax_params):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert float((g - w).abs().max()) <= ADAM_RATE_FACTOR * rates


def test_checkpoints_load_in_both_packages(files, port_run, jax_procs):
    from crs_tpu_torch.models import create_model_interface
    from crs_tpu_torch.models.transformer import forward

    _jax(jax_procs, "train")
    side = np.load(files["jax"] / "side.npz")
    ids = torch.from_numpy(np.load(files["base"] / "ids.npy"))
    ones = torch.ones(ids.shape, dtype=torch.bool)
    with torch.no_grad():
        # the port's checkpoint in crs_tpu, against the port's own trained params
        own = forward(port_run["params"], port_run["cfg"], ids, ones).numpy()
        assert np.abs(side["port_logits"] - own).max() <= LOGITS_ATOL
        # the JAX tool's checkpoint in the port, against crs_tpu's logits of it
        m = create_model_interface("jax", {"model_path": str(files["jax"])}, device="cpu")
        m.load()
        got = forward(m.params, m.cfg, ids, ones).numpy()
    assert m.config_name == "selftrained_small"
    assert np.abs(got - side["own_logits"]).max() <= LOGITS_ATOL
    meta = json.loads((files["port"] / "model_meta.json").read_text())
    assert meta == json.loads((files["jax"] / "model_meta.json").read_text())
