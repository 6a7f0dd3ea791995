"""The port's five analysis tools (``crs_tpu_torch.evaluation.summary``,
``comparator``, ``export``, ``visualizer``, ``reporter``) against
``crs_tpu``'s, on the CPU.

Two sets of result directories:
- ``runner``: the port's ``EvaluationRunner`` over two ``tiny`` models
  (int8 and int4, random init from one seed; the efficiency, performance
  and retrieval benchmarks at small settings);
- ``selftrained``: ``results/selftrained/*/``, the files ``crs_tpu``'s runner
  wrote, in the order whose export is ``results/selftrained/export/``.

Tolerances: none. Every text output (tables, rankings, JSON, CSV, Markdown,
LaTeX, HTML, the command lines' output) equals ``crs_tpu``'s byte for byte;
the report does too but for its time stamp; the plots have the same file
names and bytes.
"""

import contextlib
import io
import json
import logging
import os
import pathlib
import re

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
SELF = REPO / "results" / "selftrained"
SELF_ORDER = ("bf16", "int8", "int4", "nf4", "gptq", "awq")  # the committed export's order
CORPUS = SELF / "heldout_corpus.txt"
QA = SELF / "heldout_qa.json"
MODEL = {"config": "tiny", "seed": 0}
EFFICIENCY = {"num_warmup": 1, "num_runs": 1, "max_new_tokens": 2, "batch_sizes": [1],
              "prefill_mfu_batch": 1, "prefill_mfu_seq_len": 32}
PIPE_CFG = {
    "chunking": {"strategy": "semantic", "chunk_size": 160, "chunk_overlap": 30,
                 "min_chunk_size": 10},
    "embedding": {"backend": "hashed", "embedding_dim": 384},
    "vector_store": {"format": "int8", "block_size": 256, "rescore_k": 64},
    "retrieval": {"top_k": 3, "similarity_threshold": 0.05, "rerank": True,
                  "diversity_penalty": 0.1},
    "generation": {"max_new_tokens": 4, "temperature": 0.0},
}
METRICS = ("latency_ms_per_token", "perplexity", "average_accuracy", "f1_score",
           "avg_retrieval_time_ms", "model_size_gb", "context_sufficiency", "mrr")
STAMP = re.compile(r"generated \d{4}-\d\d-\d\d \d\d:\d\d:\d\d")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def runner_dirs(tmp_path_factory):
    """Two directories the port's runner wrote (tiny int8 and int4)."""
    from crs_tpu_torch.evaluation.performance.tasks import build_corpus_qa_task
    from crs_tpu_torch.evaluation.runner import EvaluationRunner
    from crs_tpu_torch.models.model_interface import create_model_interface
    from crs_tpu_torch.rag.pipeline import RAGPipeline

    root = tmp_path_factory.mktemp("runner")
    mc = root / "mc.json"
    mc.write_text(json.dumps(build_corpus_qa_task(str(QA)).items))
    questions = json.loads(QA.read_text())[:3]
    cfg = {"efficiency": EFFICIENCY,
           "performance": {"perplexity": {"dataset_path": str(CORPUS), "max_samples": 2,
                                          "max_length": 64},
                           "tasks": {"corpus_qa_mc": {"enabled": True,
                                                      "dataset_path": str(mc)}},
                           "task_limit": 3},
           "retrieval": {"test_questions": questions, "compare_no_rag": False}}
    dirs = []
    for kind in ("int8", "int4"):
        pipe = RAGPipeline(dict(PIPE_CFG, vector_store=dict(
            PIPE_CFG["vector_store"], persist_directory=str(root / f"index_{kind}"))),
            device="cpu").setup(create_model_interface(kind, MODEL, device="cpu"))
        pipe.index_documents(str(CORPUS))
        res = EvaluationRunner(pipe.model_interface, pipe, cfg, str(root / kind)).run_all()
        assert res.errors == {}
        dirs.append(str(root / kind))
    return dirs


@pytest.fixture(params=["runner", "selftrained"])
def dirs(request, runner_dirs):
    if request.param == "runner":
        return runner_dirs
    return [str(SELF / name) for name in SELF_ORDER]


def _both(name: str):
    """(crs_tpu's module, the port's module) of one tool."""
    import importlib

    return (importlib.import_module(f"crs_tpu.evaluation.{name}"),
            importlib.import_module(f"crs_tpu_torch.evaluation.{name}"))


def _stdout(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(*args) == 0
    return buf.getvalue()


def _bytes_of(folder) -> dict:
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(folder).iterdir())}


def test_summary_text_equals_crs_tpu(dirs):
    j, t = (m.ResultsSummary(dirs) for m in _both("summary"))
    assert json.dumps(t.results, sort_keys=True) == json.dumps(j.results, sort_keys=True)
    assert t.print_summary() == j.print_summary()
    assert t.comparison_table(list(METRICS)) == j.comparison_table(list(METRICS))
    for metric in METRICS + ("ttft_ms", "no_such_metric"):
        assert t.rank(metric) == j.rank(metric)
        assert t.metric_across_results(metric) == j.metric_across_results(metric)


def test_summary_cli_equals_crs_tpu(dirs):
    j, t = _both("summary")
    for extra in ([], ["--metric", "perplexity"], ["--compare", "perplexity", "f1_score"]):
        assert _stdout(t.main, dirs + extra) == _stdout(j.main, dirs + extra)


def test_comparator_equals_crs_tpu(dirs):
    j, t = (m.ResultsComparator.from_directories(dirs) for m in _both("comparator"))
    assert t.compare_all_pairs(list(METRICS)) == j.compare_all_pairs(list(METRICS))
    labels = list(j.results)
    assert t.compare_two(labels[-1], labels[0], list(METRICS)) == \
        j.compare_two(labels[-1], labels[0], list(METRICS))
    for metric in METRICS:
        assert t.best_model(metric) == j.best_model(metric)
    weights = {"latency_ms_per_token": 1.0, "perplexity": 2.0, "f1_score": 0.5}
    assert t.create_leaderboard(weights) == j.create_leaderboard(weights)


@pytest.mark.parametrize("stats", [(10.0, 0.5, 10, 12.0, 0.5, 10), (1.0, 0.0, 3, 1.0, 0.0, 3),
                                   (5.0, 2.0, 1, 4.7, 1.0, 40), (0.3, 0.1, 0, 0.31, 0.2, 5)])
def test_comparator_significance_equals_crs_tpu(stats):
    j, t = _both("comparator")
    assert t.ResultsComparator.statistical_significance_test(*stats) == \
        j.ResultsComparator.statistical_significance_test(*stats)


def test_comparator_cli_equals_crs_tpu(dirs):
    j, t = _both("comparator")
    for extra in ([], ["--leaderboard"], ["--metrics", "perplexity", "mrr", "--leaderboard"]):
        assert _stdout(t.main, dirs + extra) == _stdout(j.main, dirs + extra)


@pytest.mark.parametrize("metrics", [None, ["perplexity", "f1_score", "no_such_metric"]])
def test_exporter_files_equal_crs_tpu(dirs, metrics, tmp_path):
    j, t = (m.ResultsExporter.from_directories(dirs) for m in _both("export"))
    assert t.auto_metrics() == j.auto_metrics()
    t.export_all(str(tmp_path / "t"), metrics)
    j.export_all(str(tmp_path / "j"), metrics)
    assert _bytes_of(tmp_path / "t") == _bytes_of(tmp_path / "j")
    assert t.to_markdown(None, metrics) == j.to_markdown(None, metrics)
    assert t.to_latex(None, metrics, caption="A_b & 100%") == \
        j.to_latex(None, metrics, caption="A_b & 100%")
    assert t.to_html(None, metrics) == j.to_html(None, metrics)


def test_exporter_reproduces_the_committed_export(tmp_path):
    from crs_tpu_torch.evaluation.export import ResultsExporter

    ResultsExporter.from_directories([str(SELF / n) for n in SELF_ORDER]).export_all(
        str(tmp_path))
    assert _bytes_of(tmp_path) == _bytes_of(SELF / "export")


def test_exporter_cli_equals_crs_tpu(dirs, tmp_path):
    j, t = _both("export")
    for fmt in ("markdown", "latex", "html"):
        args = dirs + ["--format", fmt, "--metrics", "perplexity", "latency_ms_per_token"]
        assert _stdout(t.main, args) == _stdout(j.main, args)
    for fmt in ("csv", "all"):
        outs = {}
        for name, mod in (("t", t), ("j", j)):
            text = _stdout(mod.main, dirs + ["--format", fmt, "--out", str(tmp_path / fmt / name)])
            outs[name] = (text.replace(str(tmp_path / fmt / name), "OUT"),
                          _bytes_of(tmp_path / fmt / name))
        assert outs["t"] == outs["j"]


def _plots(viz_cls, dirs, out: str) -> list:
    v = viz_cls.from_directories(dirs, out)
    paths = v.plot_efficiency() + v.plot_performance() + v.plot_retrieval()
    paths += [v.plot_dashboard(), v.plot_radar(list(METRICS)),
              v.plot_metric_comparison("perplexity"), v.plot_metric_comparison("no_such_metric")]
    return [None if p is None else os.path.relpath(p, out) for p in paths]


def test_visualizer_writes_the_same_plots(dirs, tmp_path):
    j, t = _both("visualizer")
    got = _plots(t.ResultsVisualizer, dirs, str(tmp_path / "t"))
    ref = _plots(j.ResultsVisualizer, dirs, str(tmp_path / "j"))
    assert got == ref and "dashboard.png" in got
    assert _bytes_of(tmp_path / "t") == _bytes_of(tmp_path / "j")


def test_visualizer_cli_equals_crs_tpu(dirs, tmp_path):
    j, t = _both("visualizer")
    for extra in ([], ["--metric", "f1_score"]):
        outs = {}
        for name, mod in (("t", t), ("j", j)):
            out = str(tmp_path / name / "_".join(extra))
            outs[name] = (_stdout(mod.main, dirs + ["--out", out] + extra).replace(out, "OUT"),
                          _bytes_of(out))
        assert outs["t"] == outs["j"]


def _report(mod, dirs, path) -> str:
    mod.ReportGenerator.from_directories(dirs).generate(str(path), title="Q & A <report>")
    return STAMP.sub("generated STAMP", path.read_text())


def test_reporter_equals_crs_tpu_but_the_stamp(dirs, tmp_path):
    j, t = _both("reporter")
    got, ref = _report(t, dirs, tmp_path / "t.html"), _report(j, dirs, tmp_path / "j.html")
    assert got == ref
    assert got.count("generated STAMP") == 1 and "data:image/png;base64," in got


def test_without_matplotlib_plots_are_skipped_alike(dirs, tmp_path, monkeypatch, caplog):
    """The matplotlib gate: each plot returns None (one with a warning) and
    the report carries no image; both packages alike."""
    j, t = _both("visualizer")
    jr, tr = _both("reporter")
    for mod in (j, t):
        monkeypatch.setattr(mod, "_mpl", lambda: None)
    with caplog.at_level(logging.WARNING):
        got = _plots(t.ResultsVisualizer, dirs, str(tmp_path / "t"))
    assert got == _plots(j.ResultsVisualizer, dirs, str(tmp_path / "j"))
    assert set(got) == {None} and not (tmp_path / "t").exists()
    assert any("matplotlib unavailable" in r.getMessage() for r in caplog.records)
    report = _report(tr, dirs, tmp_path / "t.html")
    assert report == _report(jr, dirs, tmp_path / "j.html") and "<img" not in report


def test_the_tools_are_the_ports_own():
    """Same public names and command lines as crs_tpu's tools (the reporter
    has none in either); the port's higher_is_better decides every
    direction."""
    import crs_tpu_torch.evaluation.base as base

    for name, public in (("summary", "ResultsSummary"), ("comparator", "ResultsComparator"),
                         ("export", "ResultsExporter"), ("visualizer", "ResultsVisualizer"),
                         ("reporter", "ReportGenerator")):
        j, t = _both(name)
        assert t.__all__ == j.__all__ == [public]
        assert hasattr(t, "main") == hasattr(j, "main") == (name != "reporter")
    from crs_tpu_torch.evaluation import comparator, export, summary

    for mod in (comparator, export, summary):
        assert mod.higher_is_better is base.higher_is_better
