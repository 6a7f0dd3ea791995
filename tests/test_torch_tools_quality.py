"""The port's retrieval-quality tools (``crs_tpu_torch/tools/ir_eval.py``,
``quality_eval.py``, ``oracle_bounds.py``, ``quality_diag.py``,
``quality_sweep.py``, ``quality_docside_sweep.py``,
``quality_geometry_sweep.py``) against the JAX scripts of ``tools/`` of the
same names, on the repository's held-out corpus and questions
(``results/selftrained/heldout_corpus.txt``, ``heldout_qa.json``).

The JAX scripts read a survey PDF and its questions from outside the
repository; here their reads are pointed at the held-out files: the module
constants ``CORPUS`` / ``QA`` of ``tools/ir_eval.py``, and for the others
``crs_tpu``'s ``RAGPipeline.index_documents`` / ``DocumentProcessor.process_file``
and the scripts' own ``open`` (the questions file by its name). They run
through their own ``main`` / ``run_config`` / ``run`` in three child
processes started together; each child indexes a (chunking, embedding,
store) configuration once and shares that pipeline's store and embedder
with the later pipelines of that configuration (a ``crs_tpu`` lexical
pipeline compiles its jitted encoder anew, ~10 s on the CPU, and its fit is
deterministic). ``oracle_bounds`` (no JAX program) runs in this process.
The held-out answers are paraphrases, so no chunk holds one (the
``answer`` judgments are empty in both packages and the benchmark
refuses them): ``ir_eval`` is held on the held-out questions with answers
cut from the corpus (8 words each), where both judgments have relevant
chunks. Each script also runs once as a child with ``--device cpu`` and its
outputs under a temporary ``TMPDIR``, and raises without CUDA unless the CPU
was asked for.

Tolerances:
- the judgments: equal; the IR metrics (precision / recall / F1 at k, MRR,
  MAP) of fp32 and int8: equal within 1e-9; of pq: within 0.05 (the
  codebooks train from other random streams; observed equal);
- the context metrics (sufficiency, precision, coverage, context chars,
  chunks retrieved, repeat consistency) of ``quality_eval``, one grid entry
  of each sweep and the ``quality_diag`` lines: equal within 1e-6 (the
  printed lines exactly);
- the mean and spread of the retrieval scores: within 1e-5 (int8 store
  scores, f32 sums in other orders; observed 1e-6);
- the oracle ceilings: equal.
"""

import builtins
import contextlib
import hashlib
import importlib
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
CORPUS = str(REPO / "results" / "selftrained" / "heldout_corpus.txt")
QA = str(REPO / "results" / "selftrained" / "heldout_qa.json")
CPU_ARGS = ["--device", "cpu"]
IR_TOL = 1e-9
PQ_TOL = 0.05
CONTEXT_TOL = 1e-6
SCORE_TOL = 1e-5
CONTEXT_KEYS = ("context_sufficiency", "context_precision", "context_coverage",
                "avg_context_length_chars", "avg_chunks_retrieved", "retrieval_repeat_consistency")
SCORE_KEYS = ("avg_retrieval_score", "retrieval_consistency")
IR_PREFIXES = ("precision_at", "recall_at", "f1_at", "mrr", "map")
# one grid entry of each sweep, each on the matched-context pipeline of quality_diag (the
# sweep's through a retriever knob that moves the metrics here; the index-side levers are held
# to crs_tpu's in test_torch_lexical.py)
SWEEP_ENTRY = ("ship+mmr4", {"expansion_terms": 4, "expansion_weight": 0.3,
                             "expansion_sim_threshold": 0.35}, {"diversity_penalty": 0.4})
DOCSIDE_ENTRY = {}
GEOMETRY_ENTRY = (90, 18, 25, 3)
MODULES = ("ir_eval", "quality_eval", "oracle_bounds", "quality_diag", "quality_sweep",
           "quality_docside_sweep", "quality_geometry_sweep")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


def _load_jax_script(path: str):
    spec = importlib.util.spec_from_file_location(f"_jax_{pathlib.Path(path).stem}", REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span_qa():
    """The held-out questions and sections, each answer 8 words cut from the corpus."""
    with open(CORPUS) as fh:
        words = fh.read().split()
    return [dict(q, answer=" ".join(words[40 * i + 5:40 * i + 13]))
            for i, q in enumerate(_load_json(QA))]


# the JAX side: one job a child; the scripts' reads of the survey and its questions are
# pointed at the held-out files (the questions by their file name), and a child indexes each
# (chunking, embedding, store) configuration once: a pipeline of a configuration indexed
# before takes that one's store and embedder (the fit is deterministic) and its own retriever
JAX_SIDE = """
import builtins, contextlib, importlib.util, io, json, os, sys
job, corpus, qa_path, arg = json.loads(sys.argv[1])
def load(path):
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.open = lambda p, *a, **k: builtins.open(
        qa_path if os.path.basename(str(p)) == "2308.07633v4-qa.json" else p, *a, **k)
    return mod
from crs_tpu.rag import pipeline
from crs_tpu.rag.retrieval import ContextRetriever
index, indexed = pipeline.RAGPipeline.index_documents, {}
def index_once(self, source):
    key = json.dumps([self.config.get(k) for k in ("chunking", "embedding", "vector_store")],
                     sort_keys=True)
    if key not in indexed:
        indexed[key] = self
        return index(self, corpus if isinstance(source, str) else source)
    done = indexed[key]
    self.store, self.embedder, self.num_documents = done.store, done.embedder, done.num_documents
    self.retriever = ContextRetriever(self.store, self.embedder, self.config.get("retrieval"))
    return done.index_time_s
pipeline.RAGPipeline.index_documents = index_once
qa = json.load(open(qa_path))
out = {}
if job == "ir_eval":
    mod = load("tools/ir_eval.py")
    mod.CORPUS, mod.QA = corpus, qa_path
    sys.argv = ["ir_eval.py", "--out", arg]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        mod.main()
    out["lines"] = buf.getvalue()
elif job == "quality_eval":
    sys.argv = ["quality_eval.py", "--output-dir", arg]
    with contextlib.redirect_stdout(io.StringIO()):
        load("tools/quality_eval.py").main()
elif job == "diag_sweeps":
    (tag, emb, ret), docside, geometry = arg
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        load("tools/quality_diag.py").main()
    out["diag"] = buf.getvalue()
    out["sweep"] = load("tools/quality_sweep.py").run_config(qa, emb, ret)
    out["docside"] = load("tools/quality_docside_sweep.py").run_config(docside, qa)
    mod = load("tools/quality_geometry_sweep.py")
    out["geometry"] = [mod.run(qa, *geometry, nq) for nq in (10, 41)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    base = tmp_path_factory.mktemp("quality")
    span_qa = base / "span_qa.json"
    span_qa.write_text(json.dumps(_span_qa()))
    return {"base": base, "span_qa": str(span_qa), "jax_ir": str(base / "jax_ir"),
            "jax_qe": str(base / "jax_qe")}


@pytest.fixture(autouse=True, scope="module")
def _jax_side_procs(files):
    """The JAX side's three children, started with the file's first test."""
    jobs = {"ir_eval": (files["span_qa"], files["jax_ir"]),
            "quality_eval": (QA, files["jax_qe"]),
            "diag_sweeps": (QA, (SWEEP_ENTRY, DOCSIDE_ENTRY, GEOMETRY_ENTRY))}
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    procs = {job: subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, json.dumps([job, CORPUS, qa, arg])], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for job, (qa, arg) in jobs.items()}
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


def _jax(procs, job) -> dict:
    proc = procs[job]
    if not hasattr(proc, "result"):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (job, err)
        proc.result = json.loads(out.strip().splitlines()[-1])
    return proc.result


def _port_main(module, *argv):
    mod = importlib.import_module(f"crs_tpu_torch.tools.{module}")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert mod.main([*argv, *CPU_ARGS]) == 0
    return buf.getvalue()


def _tree_digest(*dirs) -> str:
    h = hashlib.sha256()
    for d in dirs:
        for p in sorted((REPO / d).rglob("*")):
            if p.is_file():
                h.update(str(p.relative_to(REPO)).encode())
                h.update(p.read_bytes())
    return h.hexdigest()


# -- the scripts as children (first: they run while the JAX side's children work) ----------

def test_scripts_run_as_children(tmp_path):
    before = _tree_digest("results", "report")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", TMPDIR=str(tmp_path))
    extra = {"ir_eval": ["--judgments", "section"]}

    def start(module):
        return subprocess.Popen([sys.executable, "-m", f"crs_tpu_torch.tools.{module}",
                                 *extra.get(module, []), *CPU_ARGS], cwd=REPO, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    procs = {m: start(m) for m in MODULES if m != "oracle_bounds"}
    outs = {}
    for module, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (module, out, err)
        outs[module] = out
    # after quality_eval: the oracle reads "ours" from its output
    proc = start("oracle_bounds")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, (out, err)
    root = tmp_path / "crs_tpu_torch"
    ours = _load_json(root / "quality_eval" / "retrieval_quality_matched-ctx90_10q.json")
    oracle = _load_json(root / "oracle_bounds" / "oracle_bounds.json")
    assert oracle["ours_10q"]["coverage"] == round(ours["context_coverage"], 4)
    assert sorted(p.name for p in (root / "ir_eval").iterdir()) == [
        "ir_results_section_fp32.json", "ir_results_section_int8.json",
        "ir_results_section_pq.json", "ir_summary.json", "judgments_section.json"]
    assert len(outs["quality_eval"].strip().splitlines()) == 4
    assert outs["quality_diag"].count("\nQ") == 10
    assert len(_load_json(root / "quality_sweep" / "sweep.json")) == 8
    assert len(_load_json(root / "quality_docside_sweep" / "docside_sweep.json")) == 10
    assert len(_load_json(root / "quality_geometry_sweep" / "geometry_sweep.json")) == 8
    assert _tree_digest("results", "report") == before


# -- the oracle (no JAX program: this process) and the judgments ------------------------------

def test_oracle_bounds_equal_the_jax_tool(tmp_path, monkeypatch):
    from crs_tpu.rag import document_processing
    from crs_tpu_torch.tools import output_dir

    jax_oracle = _load_jax_script("tools/oracle_bounds.py")
    jax_oracle.open = lambda p, *a, **k: builtins.open(
        QA if os.path.basename(str(p)) == "2308.07633v4-qa.json" else p, *a, **k)
    process_file = document_processing.DocumentProcessor.process_file
    monkeypatch.setattr(document_processing.DocumentProcessor, "process_file",
                        lambda self, path: process_file(self, CORPUS))
    monkeypatch.setattr(sys, "argv", ["oracle_bounds.py", "--output", str(tmp_path / "jax.json")])
    with contextlib.redirect_stdout(io.StringIO()) as want_lines:
        jax_oracle.main()
    want = _load_json(tmp_path / "jax.json")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the port's default directories
    got_lines = _port_main("oracle_bounds", "--output", str(tmp_path / "port.json"))
    got = _load_json(tmp_path / "port.json")
    assert got_lines.splitlines()[:3] == want_lines.getvalue().splitlines()[:3]
    for key in ("chunking", "top_k", "per_question", "10q", "41q", "reference_10q"):
        assert got[key] == want[key], key
    assert got["per_question"] and got["10q"]["oracle_coverage"] > 0
    # "ours": the JAX tool's fixed row until the port's quality_eval has written its own
    assert got["ours_10q"] == {"sufficiency": 0.727, "precision": 0.617, "coverage": 0.640}
    ours = pathlib.Path(output_dir("quality_eval"))
    ours.mkdir(parents=True)
    (ours / "retrieval_quality_matched-ctx90_10q.json").write_text(json.dumps(
        {"context_sufficiency": 0.25, "context_precision": 0.5, "context_coverage": 0.125}))
    _port_main("oracle_bounds", "--output", str(tmp_path / "port.json"))
    assert _load_json(tmp_path / "port.json")["ours_10q"] == {
        "sufficiency": 0.25, "precision": 0.5, "coverage": 0.125}


def test_oracle_for_tokens_equals_the_jax_helper():
    from crs_tpu_torch.tools.oracle_bounds import oracle_for_tokens

    jax_oracle = _load_jax_script("tools/oracle_bounds.py")
    sets = [set("a b c".split()), set("c d".split()), set("e".split()), set(), set("a e f".split())]
    for target in (set("a b c d e f".split()), set("z".split()), set(), set("c e".split())):
        for k, cand in ((3, 24), (2, 3), (1, 2)):
            assert oracle_for_tokens(target, sets, k, cand) == \
                jax_oracle._oracle_for_tokens(target, sets, k, cand)


@pytest.mark.parametrize("qa_kind", ["held_out", "answer_spans"])
def test_judgments_equal_crs_tpus(qa_kind):
    from crs_tpu.rag.chunking import TextChunker
    from crs_tpu.rag.document_processing import DocumentProcessor
    from crs_tpu_torch.rag.chunking import TextChunker as PortChunker
    from crs_tpu_torch.rag.document_processing import DocumentProcessor as PortProcessor
    from crs_tpu_torch.tools import ir_eval as port

    jax_ir = _load_jax_script("tools/ir_eval.py")
    qa = _load_json(QA) if qa_kind == "held_out" else _span_qa()
    cfg = {"strategy": "semantic", "chunk_size": 160, "chunk_overlap": 30, "min_chunk_size": 10}

    def chunks_of(dp, ck):
        out = []
        for text, page in dp.process_file(CORPUS):
            for title, body in dp.extract_sections(text):
                out.extend(ck.chunk(body, page_number=page, section=title or None))
        return out

    want_chunks = chunks_of(DocumentProcessor({}), TextChunker(cfg))
    got_chunks = chunks_of(PortProcessor({}), PortChunker(cfg))
    assert [(c.chunk_id, c.text, c.section) for c in got_chunks] == \
        [(c.chunk_id, c.text, c.section) for c in want_chunks]
    assert port.build_judgments(got_chunks, qa) == jax_ir.build_judgments(want_chunks, qa)
    got = port.build_judgments_answer_span(got_chunks, qa)
    assert got == jax_ir.build_judgments_answer_span(want_chunks, qa)
    # the held-out answers are paraphrases: no chunk holds one
    assert any(j["relevant_doc_ids"] for j in got) == (qa_kind == "answer_spans")


def test_ir_eval_refuses_a_judgment_without_relevant_chunks(tmp_path):
    from crs_tpu_torch.tools import ir_eval

    with contextlib.redirect_stdout(io.StringIO()) as buf, \
            pytest.raises(ValueError, match="no test questions"):
        ir_eval.main(["--judgments", "answer", "--formats", "int8", "--out", str(tmp_path),
                      *CPU_ARGS])
    assert "[answer] 5 chunks; 0/10 questions judged" in buf.getvalue()


# -- their defaults and the device rule ----------------------------------------------------------

@pytest.mark.parametrize("module", MODULES)
def test_default_outputs_lie_outside_the_repository(module, monkeypatch, tmp_path):
    """Every default output path lies under ``<TMPDIR>/crs_tpu_torch``; the
    sweeps without an output flag write there too."""
    import argparse

    from crs_tpu_torch.tools import output_dir

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    mod = importlib.import_module(f"crs_tpu_torch.tools.{module}")
    parsed = {}

    def capture(self, args=None, namespace=None):
        parsed.update(vars(argparse.ArgumentParser.parse_known_args(self, args, namespace)[0]))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        mod.main([])
    assert parsed["corpus"] == CORPUS and parsed["qa"] == QA
    paths = [v for k, v in parsed.items() if k in ("out", "output", "output_dir")]
    for value in paths:
        assert value.startswith(str(tmp_path / "crs_tpu_torch")), value
    assert paths or module in ("quality_diag", "quality_sweep", "quality_geometry_sweep")
    assert output_dir(module).startswith(str(tmp_path / "crs_tpu_torch"))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("module", MODULES)
def test_scripts_raise_without_cuda_unless_cpu_is_asked(no_cuda, module):
    mod = importlib.import_module(f"crs_tpu_torch.tools.{module}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


# -- against the JAX scripts (their children started with the first test: the tests above
# run while they work) ----------------------------------------------------------------------

def _close(got, want, keys, tol, what):
    for key in keys:
        assert abs(got[key] - want[key]) <= tol, (what, key, got[key], want[key])


def test_ir_eval_equals_the_jax_tool(_jax_side_procs, files, tmp_path):
    port_out = tmp_path / "port_ir"
    got_lines = _port_main("ir_eval", "--out", str(port_out), "--corpus", CORPUS,
                           "--qa", files["span_qa"])
    want = _jax(_jax_side_procs, "ir_eval")
    jax_out = pathlib.Path(files["jax_ir"])
    assert got_lines == want["lines"]
    for jname in ("section", "answer"):
        assert _load_json(port_out / f"judgments_{jname}.json") == \
            _load_json(jax_out / f"judgments_{jname}.json")
    got_sum, want_sum = _load_json(port_out / "ir_summary.json"), \
        _load_json(jax_out / "ir_summary.json")
    assert got_sum.keys() == want_sum.keys() == {"section", "answer"}
    for jname, jsum in want_sum.items():
        for key in ("mean_relevant_per_question", "questions_with_judgments"):
            assert got_sum[jname][key] == jsum[key]
        for fmt in ("fp32", "int8", "pq"):
            keys = [k for k in jsum[fmt] if k.startswith(IR_PREFIXES)]
            assert keys and set(got_sum[jname][fmt]) == set(jsum[fmt])
            _close(got_sum[jname][fmt], jsum[fmt], keys, PQ_TOL if fmt == "pq" else IR_TOL,
                   f"{jname}/{fmt}")
            got_res = _load_json(port_out / f"ir_results_{jname}_{fmt}.json")
            want_res = _load_json(jax_out / f"ir_results_{jname}_{fmt}.json")
            assert got_res["metrics"]["mode"] == want_res["metrics"]["mode"] == "ir"


def test_quality_eval_equals_the_jax_tool(_jax_side_procs, files, tmp_path):
    lines = _port_main("quality_eval", "--output-dir", str(tmp_path))
    _jax(_jax_side_procs, "quality_eval")
    names = sorted(p.name for p in pathlib.Path(files["jax_qe"]).iterdir())
    assert names == sorted(p.name for p in tmp_path.iterdir()) and len(names) == 4
    for name in names:
        got, want = _load_json(tmp_path / name), _load_json(pathlib.Path(files["jax_qe"]) / name)
        assert got["config"] == want["config"] and got["mode"] == want["mode"] == "qa"
        _close(got, want, CONTEXT_KEYS, CONTEXT_TOL, name)
        _close(got, want, SCORE_KEYS, SCORE_TOL, name)
    assert [line.split(":")[0] for line in lines.splitlines()] == [
        f"{tag} {nq}q" for tag in ("default240", "matched-ctx90") for nq in (41, 10)]


def test_quality_diag_prints_the_jax_tools_lines(_jax_side_procs):
    got = _port_main("quality_diag")
    assert got == _jax(_jax_side_procs, "diag_sweeps")["diag"]
    assert got.count("\nQ") == 10


def test_sweep_entries_equal_the_jax_tools(_jax_side_procs):
    from crs_tpu_torch.tools import quality_docside_sweep, quality_geometry_sweep, quality_sweep

    qa = _load_json(QA)
    tag, emb, ret = SWEEP_ENTRY
    assert (tag, emb, ret) in quality_sweep.grid(False)
    got = quality_sweep.run_config(qa, emb, ret, CORPUS, "cpu")
    want = _jax(_jax_side_procs, "diag_sweeps")["sweep"]
    for nq in (10, 41):
        for g, w in zip(got[nq], want[str(nq)], strict=True):
            assert abs(g - w) <= CONTEXT_TOL, (nq, got, want)
    jax_side = _jax(_jax_side_procs, "diag_sweeps")
    assert DOCSIDE_ENTRY in quality_docside_sweep.grid(1)
    assert quality_docside_sweep.run_config(DOCSIDE_ENTRY, qa, corpus=CORPUS, dev="cpu") == \
        jax_side["docside"]
    assert GEOMETRY_ENTRY in quality_geometry_sweep.GEOMETRIES
    for nq, want_row in zip((10, 41), jax_side["geometry"]):
        got_row = quality_geometry_sweep.run(qa, *GEOMETRY_ENTRY, nq, CORPUS, "cpu")
        for g, w in zip(got_row, want_row, strict=True):
            assert abs(g - w) <= CONTEXT_TOL, (nq, got_row, want_row)
