"""The port's per-variant evaluation of the self-trained model
(``crs_tpu_torch/tools/eval_selftrained.py``) against the JAX script
``tools/eval_selftrained.py``, on the CPU.

- The per-variant configs: the JAX script's ``VARIANTS`` table (imported
  without JAX) and the configs it wrote for the committed run
  (``results/selftrained/config_<name>.json``), against the port's; they
  differ only in paths and the retrieval corpus.
- A run of the tool with ``--device cpu`` on a toy checkpoint saved by the
  port, three variants (bf16, int4, nf4) and a light base config (one
  efficiency run at batch 1, two retrieval questions): exit codes 0, the
  summary's rows with the JAX rows' keys plus ``device``, and each variant's
  perplexity within EVAL_PPL_RTOL of ``crs_tpu``'s ``PerplexityEvaluator``
  on the same checkpoint and held-out text (each variant in a child
  process, started with the file's first test).
- ``checkpoints/``, ``results/selftrained/`` and ``results/retrieval/`` are
  unchanged by the run (digests), its default output lies outside the
  repository, and without a card the default device raises.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
HELD = REPO / "results" / "selftrained"
EVAL_PPL_RTOL = 1e-2  # |port / crs_tpu − 1| of a variant's perplexity (chip_smoke.py's)
RUN_VARIANTS = ("bf16", "int4", "nf4")
PATH_KEYS = (("model", "model_path"), ("evaluation", "performance", "perplexity", "dataset_path"),
             ("evaluation", "retrieval", "test_questions_file"))
PORT_KEYS = (("rag", "vector_store", "persist_directory"),
             ("evaluation", "performance", "tasks", "corpus_qa_mc", "qa_path"),
             ("evaluation", "retrieval", "output_dir"), ("evaluation", "retrieval", "corpus_file"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_script():
    spec = importlib.util.spec_from_file_location("_jax_eval_selftrained",
                                                  REPO / "tools" / "eval_selftrained.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(*dirs) -> str:
    h = hashlib.sha256()
    for d in dirs:
        for p in sorted((REPO / d).rglob("*")):
            if p.is_file():
                h.update(str(p.relative_to(REPO)).encode())
                h.update(p.read_bytes())
    return h.hexdigest()


def _pop(cfg, path):
    node = cfg
    for key in path[:-1]:
        node = node[key]
    return node.pop(path[-1], None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A toy checkpoint saved by the port and a light copy of config.json."""
    from crs_tpu_torch.models.bytes_tokenizer import ByteTokenizer
    from crs_tpu_torch.models.model_interface import TorchModel
    from crs_tpu_torch.models.transformer import TransformerConfig, init_params

    base = tmp_path_factory.mktemp("selftrained_eval")
    cfg = TransformerConfig(vocab_size=384, hidden_size=128, num_layers=2, num_heads=4,
                            num_kv_heads=2, intermediate_size=256, max_seq_len=2048,
                            dtype=torch.float32)
    m = TorchModel({"config": "small"}, device="cpu")
    m.cfg, m.params, m.tokenizer, m._loaded = cfg, init_params(0, cfg), ByteTokenizer(), True
    m.config_name = "selftrained_small"
    m.save_pretrained(str(base / "ckpt"))
    light = json.loads((REPO / "config.json").read_text())
    light["evaluation"]["efficiency"].update(num_warmup=1, num_runs=1, max_new_tokens=8,
                                             batch_sizes=[1])
    light["evaluation"]["retrieval"]["max_questions"] = 2
    (base / "light.json").write_text(json.dumps(light))
    return {"base": base, "ckpt": str(base / "ckpt"), "light": str(base / "light.json")}


JAX_SIDE = """
import json, sys
ckpt, kind, quant, text = json.loads(sys.argv[1])
from crs_tpu.evaluation.performance.perplexity import PerplexityEvaluator
from crs_tpu.models.model_interface import create_model_interface
m = create_model_interface(kind, {"model_path": ckpt, "quantization": quant, "max_seq_len": 2048})
m.load()
out = PerplexityEvaluator(m, {"dataset_path": text, "max_samples": 24, "max_length": 1024})
print(json.dumps(out.calculate()))
"""


@pytest.fixture(scope="module")
def jax_procs(files):
    """crs_tpu's perplexity of each variant of the toy checkpoint, one child each."""
    variants = _jax_script().VARIANTS
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, json.dumps(
            [files["ckpt"], variants[name]["type"], variants[name]["quantization"],
             str(HELD / "heldout_corpus.txt")])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in RUN_VARIANTS}
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_run(files, jax_procs):
    """The tool on the toy checkpoint (after the JAX side's children start)."""
    from crs_tpu_torch.tools import eval_selftrained

    out = files["base"] / "out"
    before = _digest("checkpoints", "results/selftrained", "results/retrieval")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = eval_selftrained.main(["--ckpt", files["ckpt"], "--variants", ",".join(RUN_VARIANTS),
                                    "--base-config", files["light"], "--out", str(out),
                                    "--device", "cpu"])
    after = _digest("checkpoints", "results/selftrained", "results/retrieval")
    return {"rc": rc, "out": out, "lines": buf.getvalue(), "digests": (before, after),
            "summary": json.loads((out / "summary.json").read_text())}


# -- the configs -----------------------------------------------------------------------------------

def test_variants_and_configs_equal_the_jax_tools(tmp_path):
    """Each variant's config from config.json equals the one the JAX script
    wrote for the committed run, but for its paths and the port's keys."""
    from crs_tpu_torch.tools import eval_selftrained
    from crs_tpu_torch.utils.config import ConfigLoader

    jax_variants = _jax_script().VARIANTS
    assert eval_selftrained.VARIANTS == jax_variants
    base = ConfigLoader(str(REPO / "config.json")).config
    for name in jax_variants:
        got = eval_selftrained.variant_config(base, name, "ckpt", "held.txt", "qa.json",
                                              "mc.json", "corpus.txt", "index", "responses")
        want = json.loads((HELD / f"config_{name}.json").read_text())
        assert [_pop(got, k) for k in PATH_KEYS] == ["ckpt", "held.txt", "qa.json"]
        assert [_pop(got, k) for k in PORT_KEYS] == ["index", "mc.json", "responses",
                                                     "corpus.txt"]
        for key in PATH_KEYS:
            _pop(want, key)
        for key in PORT_KEYS:  # config.json's values where the JAX run kept them
            _pop(want, key)
        assert got == want, name
    assert base == ConfigLoader(str(REPO / "config.json")).config  # not modified


def test_held_out_inputs_from_the_full_files(files, tmp_path):
    """--qa picks the checkpoint's held-out indices from the full QA file;
    --corpus cuts the corpus at --holdout-frac; both go into the configs."""
    from crs_tpu_torch.tools import eval_selftrained
    from crs_tpu_torch.tools.selftrain_lm import build_text

    held_qa = json.loads((HELD / "heldout_qa.json").read_text())
    idx = json.loads((REPO / "checkpoints" / "selftrained_small" /
                      "selftrain_result.json").read_text())["qa_eval_indices"]
    full = [{"question": f"filler {i}?", "answer": "x", "section": "s"} for i in range(41)]
    for i, item in zip(idx, held_qa):
        full[i] = item
    (tmp_path / "full.json").write_text(json.dumps(full))
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("Alpha beta gamma delta. " * 200)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "selftrain_result.json").write_text(json.dumps({"qa_eval_indices": idx}))
    args = type("Args", (), {"qa": str(tmp_path / "full.json"), "corpus": str(corpus),
                             "ckpt": str(ckpt), "holdout_frac": 0.25})()
    out = tmp_path / "out"
    out.mkdir()
    qa_path, held_txt = eval_selftrained._held_out(args, out)
    assert json.loads(qa_path.read_text()) == held_qa
    whole = build_text(str(corpus))
    assert held_txt.read_text() == whole[int(len(whole) * 0.75):]
    args.qa = args.corpus = None
    qa_path, held_txt = eval_selftrained._held_out(args, out)
    assert qa_path.read_text() == json.dumps(held_qa, indent=2)
    assert held_txt.read_text() == (HELD / "heldout_corpus.txt").read_text()


def test_default_out_lies_outside_the_repository(monkeypatch, tmp_path):
    import argparse

    from crs_tpu_torch.tools import eval_selftrained

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    parsed = {}

    def capture(self, args=None, namespace=None):
        parsed.update(vars(argparse.ArgumentParser.parse_known_args(self, args, namespace)[0]))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        eval_selftrained.main([])
    assert parsed["out"] == str(tmp_path / "crs_tpu_torch" / "eval_selftrained")
    assert parsed["ckpt"] == str(REPO / "checkpoints" / "selftrained_small")
    assert parsed["qa"] is None and parsed["corpus"] is None


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    from crs_tpu_torch.tools import eval_selftrained

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_selftrained.main(["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# -- the run on the toy checkpoint ---------------------------------------------------------------

def test_the_tool_runs_each_variant(files, port_run):
    from crs_tpu_torch.tools import eval_selftrained
    from crs_tpu_torch.utils.config import ConfigLoader

    assert port_run["rc"] == 0
    summary, out = port_run["summary"], port_run["out"]
    jax_row_keys = set(json.loads((HELD / "summary.json").read_text())["int4"])
    assert list(summary) == list(RUN_VARIANTS)
    base = ConfigLoader(files["light"]).config
    for name, row in summary.items():
        assert row["rc"] == 0, name
        assert set(row) == jax_row_keys | {"device"} and row["device"] == "cpu"
        assert row["perplexity"] is not None and row["f1_score"] is not None, row
        assert sorted(p.name for p in (out / name).iterdir()) == [
            "comprehensive_results.json", "efficiency_results.json", "performance_results.json",
            "retrieval", "retrieval_results.json", "summary.json"]
        written = json.loads((out / f"config_{name}.json").read_text())
        assert written == eval_selftrained.variant_config(
            base, name, files["ckpt"], str(out / "heldout_corpus.txt"),
            str(out / "heldout_qa.json"), str(out / "heldout_qa.json"),
            str(out / "heldout_corpus.txt"), str(out / f"index_{name}"),
            str(out / name / "retrieval"))
    assert (out / "heldout_corpus.txt").read_text() == (HELD / "heldout_corpus.txt").read_text()
    assert json.loads((out / "heldout_qa.json").read_text()) == \
        json.loads((HELD / "heldout_qa.json").read_text())


def test_the_run_leaves_the_repository_unchanged(port_run):
    before, after = port_run["digests"]
    assert before == after


def test_perplexities_equal_crs_tpus(port_run, jax_procs):
    for name in RUN_VARIANTS:
        out, err = jax_procs[name].communicate(timeout=300)
        assert jax_procs[name].returncode == 0, (name, err[-3000:])
        want = json.loads(out.strip().splitlines()[-1])
        got = json.loads((port_run["out"] / name / "performance_results.json").read_text())
        got = got.get("metrics", got)
        assert got["num_tokens"] == want["num_tokens"] and got["num_samples"] == want["num_samples"]
        ppl = port_run["summary"][name]["perplexity"]
        assert abs(ppl / want["perplexity"] - 1) <= EVAL_PPL_RTOL, (name, ppl, want)


def test_summary_is_rewritten_after_each_variant(port_run):
    lines = port_run["lines"].splitlines()
    rows = [json.loads(x) for x in lines if x.startswith("{\"")]
    assert [list(r) for r in rows] == [[n] for n in RUN_VARIANTS]
    assert rows[-1][RUN_VARIANTS[-1]] == port_run["summary"][RUN_VARIANTS[-1]]
