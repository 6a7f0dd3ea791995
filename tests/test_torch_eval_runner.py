"""The port's ``RAGPipeline.evaluate``, retrieval benchmark, evaluation
runner and ``python -m crs_tpu_torch --evaluate`` against ``crs_tpu``'s, on
the CPU.

Both pipelines index the held-out corpus with the hashed embedding and an
int8 store and generate greedily with the ``tiny`` int8 model (random init
from one seed), whose logits are bit-identical in both packages. So:
- ``RAGPipeline.evaluate``: the same chunk ids, contexts and answers, with
  and without RAG;
- ``RetrievalBenchmark`` in ``qa`` and ``ir`` mode, its detailed responses
  and its top-k ablation: every metric but the timings equal, but the
  retrieval scores' mean and spread, and each score in the responses:
  within SCORE_ATOL (the stores' f32 scores differ in the last bits, one
  f32 step at 0.19 measured);
- ``EvaluationRunner``: the same five files and the same summary keys, a
  partial run keeping the earlier results;
- the command line's ``--evaluate --device cpu`` writes the five files and
  prints a summary with no errors; without ``--device`` and without CUDA
  it raises.
"""

import io
import json
import pathlib
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = REPO / "results" / "selftrained" / "heldout_corpus.txt"
QA = REPO / "results" / "selftrained" / "heldout_qa.json"
FILES = ["comprehensive_results.json", "efficiency_results.json", "performance_results.json",
         "retrieval_results.json", "summary.json"]
TIMING_WORDS = ("time", "qps", "tokens_per_sec", "speedup")
SCORE_KEYS = ("avg_retrieval_score", "retrieval_consistency")
SCORE_ATOL = 1e-6
ROOFLINE = {"hbm_gbps_achieved", "hbm_utilization_percent", "decode_roofline"}
PIPE_CFG = {
    "chunking": {"strategy": "semantic", "chunk_size": 160, "chunk_overlap": 30,
                 "min_chunk_size": 10},
    "embedding": {"backend": "hashed", "embedding_dim": 384},
    "vector_store": {"format": "int8", "block_size": 256, "rescore_k": 64},
    "retrieval": {"top_k": 2, "similarity_threshold": 0.05, "rerank": True,
                  "diversity_penalty": 0.1},
    "generation": {"max_new_tokens": 6, "temperature": 0.0, "max_context_chars": 400},
}
MODEL = {"config": "tiny", "seed": 0}
EFFICIENCY = {"num_warmup": 1, "num_runs": 1, "max_new_tokens": 2, "batch_sizes": [1],
              "prefill_mfu_batch": 1, "prefill_mfu_seq_len": 32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def pipes():
    """(crs_tpu's pipeline, the port's), each indexed and with its model."""
    from crs_tpu.models.model_interface import create_model_interface as jcmi
    from crs_tpu.rag.pipeline import RAGPipeline as JP

    from crs_tpu_torch.models.model_interface import create_model_interface as tcmi
    from crs_tpu_torch.rag.pipeline import RAGPipeline as TP

    jp = JP(PIPE_CFG).setup(jcmi("int8", MODEL))
    tp = TP(PIPE_CFG, device="cpu").setup(tcmi("int8", MODEL, device="cpu"))
    jp.index_documents(str(CORPUS))
    tp.index_documents(str(CORPUS))
    assert tp.store.ids == jp.store.ids
    return jp, tp


def _questions(n: int = 6):
    return json.loads(QA.read_text())[:n]


def _untimed(metrics: dict) -> dict:
    return {k: v for k, v in metrics.items() if not any(w in k for w in TIMING_WORDS)}


def _same_metrics(got: dict, ref: dict) -> None:
    got, ref = _untimed(got), _untimed(ref)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k in SCORE_KEYS:
            assert abs(got[k] - v) <= SCORE_ATOL, k
        else:
            assert got[k] == v, k


def _same_details(tdir: pathlib.Path, jdir: pathlib.Path) -> None:
    """The saved responses: equal, each score within SCORE_ATOL."""
    import csv

    got = json.loads((tdir / "detailed_responses.json").read_text())
    ref = json.loads((jdir / "detailed_responses.json").read_text())
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        gs, rs = g.pop("retrieved_chunks"), r.pop("retrieved_chunks")
        assert g == r
        assert [(c["id"], c["text"]) for c in gs] == [(c["id"], c["text"]) for c in rs]
        assert all(abs(a["score"] - b["score"]) <= SCORE_ATOL for a, b in zip(gs, rs))
    assert (tdir / "detailed_responses.txt").read_text() == \
        (jdir / "detailed_responses.txt").read_text()
    rows = [list(csv.reader((d / "detailed_responses.csv").open())) for d in (tdir, jdir)]
    assert [r[:-1] for r in rows[0]] == [r[:-1] for r in rows[1]]
    for a, b in zip(rows[0][1:], rows[1][1:]):
        assert (a[-1] == b[-1] == "") or abs(float(a[-1]) - float(b[-1])) <= SCORE_ATOL


def test_rag_pipeline_evaluate_matches(pipes):
    jp, tp = pipes
    qs = _questions()
    got, ref = tp.evaluate(qs), jp.evaluate(qs)
    assert got["questions"] == ref["questions"] == [q["question"] for q in qs]
    assert [[c["id"] for c in cs] for cs in got["chunks"]] == \
        [[c["id"] for c in cs] for cs in ref["chunks"]]
    assert got["contexts"] == ref["contexts"] and any(got["contexts"])
    assert got["rag_answers"] == ref["rag_answers"] and len(got["rag_answers"]) == len(qs)
    assert got["no_rag_answers"] == ref["no_rag_answers"]
    for key in ("retrieval_time_s", "rag_generation_time_s", "no_rag_generation_time_s"):
        assert got[key] >= 0
    one = tp.evaluate(qs[:2], compare_no_rag=False)
    assert "no_rag_answers" not in one and one["rag_answers"] == ref["rag_answers"][:2]


@pytest.mark.parametrize("mode", ["qa", "ir"])
def test_retrieval_benchmark_matches(pipes, tmp_path, mode):
    from crs_tpu.evaluation.retrieval.benchmark import RetrievalBenchmark as J

    from crs_tpu_torch.evaluation.retrieval.benchmark import RetrievalBenchmark as T

    jp, tp = pipes
    qs = _questions()
    if mode == "ir":  # relevant ids drawn from the store with a seed
        rng = np.random.default_rng(5)
        qs = [dict(q, relevant_doc_ids=list(rng.choice(tp.store.ids, 3, replace=False)))
              for q in qs]
    cfg = {"test_questions": qs, "save_detailed_responses": True, "k_values": [1, 3]}
    got = T(tp, {**cfg, "output_dir": str(tmp_path / "t")}).run_all()
    ref = J(jp, {**cfg, "output_dir": str(tmp_path / "j")}).run_all()
    assert got.metrics["mode"] == ref.metrics["mode"] == mode
    assert got.metadata == ref.metadata
    _same_metrics(got.metrics, ref.metrics)
    assert "f1_score" in got.metrics and "context_sufficiency" in got.metrics
    if mode == "ir":
        assert "precision_at_3" in got.metrics and "map" in got.metrics
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == [
        "detailed_responses.csv", "detailed_responses.json", "detailed_responses.txt",
        "metrics.json"]
    _same_details(tmp_path / "t", tmp_path / "j")
    loaded = T.load_dataset_file(str(QA))
    assert loaded == J.load_dataset_file(str(QA)) and len(loaded) == len(json.loads(QA.read_text()))
    wrapped = tmp_path / "wrapped.json"
    wrapped.write_text(json.dumps({"questions": qs[:2] + [{"no": "question"}]}))
    assert T.load_dataset_file(str(wrapped)) == J.load_dataset_file(str(wrapped)) == qs[:2]


def test_ablation_study_and_evaluate_from_file(pipes, tmp_path):
    from crs_tpu.evaluation.retrieval.benchmark import RetrievalBenchmark as J

    from crs_tpu_torch.evaluation.retrieval.benchmark import RetrievalBenchmark as T

    jp, tp = pipes
    cfg = {"test_questions": _questions(4), "compare_no_rag": False,
           "generation_warmup": False}
    got = T(tp, cfg).ablation_study((1, 3))
    ref = J(jp, cfg).ablation_study((1, 3))
    assert got["best_k"] == ref["best_k"] and tp.retriever.top_k == PIPE_CFG["retrieval"]["top_k"]
    assert [r["top_k"] for r in got["rows"]] == [r["top_k"] for r in ref["rows"]] == [1, 3]
    for g, r in zip(got["rows"], ref["rows"]):
        _same_metrics(g, r)
    qa = tmp_path / "qa.json"
    qa.write_text(json.dumps(_questions(3)))
    _same_metrics(T(tp, {"compare_no_rag": False}).evaluate_from_file(str(qa)).metrics,
                  J(jp, {"compare_no_rag": False}).evaluate_from_file(str(qa)).metrics)


def test_retrieval_benchmark_refuses(pipes):
    from crs_tpu_torch.evaluation.retrieval.benchmark import RetrievalBenchmark
    from crs_tpu_torch.rag.pipeline import RAGPipeline

    _, tp = pipes
    with pytest.raises(ValueError, match="no test questions"):
        RetrievalBenchmark(tp, {}).run_all()
    empty = RAGPipeline(PIPE_CFG, device="cpu").setup(None)
    with pytest.raises(ValueError, match="vector store is empty"):
        RetrievalBenchmark(empty, {"test_questions": _questions(2)}).run_all()


def _eval_config(mc_path: str) -> dict:
    return {"efficiency": EFFICIENCY,
            "performance": {"perplexity": {"dataset_path": str(CORPUS), "max_samples": 2,
                                           "max_length": 64},
                            "tasks": {"corpus_qa_mc": {"enabled": True, "dataset_path": mc_path}},
                            "task_limit": 3},
            "retrieval": {"test_questions": _questions(3), "compare_no_rag": True}}


def test_runner_writes_the_files_and_summary_of_crs_tpu(pipes, tmp_path):
    from crs_tpu.evaluation.performance.tasks import build_corpus_qa_task
    from crs_tpu.evaluation.runner import EvaluationRunner as J

    from crs_tpu_torch.evaluation.runner import EvaluationRunner as T

    jp, tp = pipes
    mc = tmp_path / "mc.json"
    mc.write_text(json.dumps(build_corpus_qa_task(str(QA)).items))
    cfg = _eval_config(str(mc))
    got = T(tp.model_interface, tp, cfg, str(tmp_path / "t")).run_all()
    ref = J(jp.model_interface, jp, cfg, str(tmp_path / "j")).run_all()
    assert got.errors == ref.errors == {}
    for d in ("t", "j"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == FILES
    summary = json.loads((tmp_path / "t" / "summary.json").read_text())
    ref_summary = json.loads((tmp_path / "j" / "summary.json").read_text())
    # the roofline row needs decode_ms_per_token > 0: generate minus a one-token
    # generate, which a loaded host can make 0 at these few tokens
    for res, summ in ((got, summary), (ref, ref_summary)):
        assert (ROOFLINE <= set(summ)) == (res.efficiency["decode_ms_per_token"] > 0)
    assert set(summary) - ROOFLINE == set(ref_summary) - ROOFLINE
    assert set(summary) == set(got.get_summary()) and summary["errors"] == {}
    for key in ("latency_ms_per_token", "ttft_ms", "throughput_tokens_per_sec",
                "prefill_mfu_percent", "perplexity", "average_accuracy", "f1_score",
                "avg_retrieval_time_ms"):
        assert summary[key] is not None, key
    assert got.performance["tasks"] == ref.performance["tasks"]
    assert got.performance["num_tokens"] == ref.performance["num_tokens"]
    _same_metrics(got.retrieval, ref.retrieval)
    eff_keys = set(json.loads((tmp_path / "j" / "efficiency_results.json").read_text())["metrics"])
    assert set(got.efficiency) - ROOFLINE - {"hbm_gbps_peak"} == \
        eff_keys - ROOFLINE - {"hbm_gbps_peak"}
    assert got.efficiency["device"] == ref.efficiency["device"] == "cpu"
    assert got.efficiency["device_memory_peak_mb"] is None
    assert got.metadata["device"] == "cpu" and got.metadata["backend"] == "cpu"
    assert got.metadata["model"]["quantization"] == "int8"
    comp = json.loads((tmp_path / "t" / "comprehensive_results.json").read_text())
    assert set(comp) == set(ref.to_dict()) and set(got.timing) == set(ref.timing)


def test_efficiency_benchmark_profile_and_baseline(pipes, tmp_path, monkeypatch):
    """The optional profiler stage writes a Chrome trace; the baseline
    comparison adds its three ratios; a failing stage leaves only its own
    metrics out."""
    from crs_tpu_torch.evaluation.efficiency import latency
    from crs_tpu_torch.evaluation.efficiency.benchmark import EfficiencyBenchmark

    _, tp = pipes
    cfg = {**EFFICIENCY, "capture_profile": True, "profile_dir": str(tmp_path / "trace"),
           "baseline": {"model_size_gb": 1.0, "latency_ms_per_token": 100.0,
                        "peak_memory_mb": 10.0}}
    m = EfficiencyBenchmark(tp.model_interface, cfg).run_all().metrics
    assert m["profile_trace_dir"] == str(tmp_path / "trace")
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert m["compression_ratio"] == 1.0 / m["model_size_gb"]
    assert m["speedup_vs_baseline"] == 100.0 / m["latency_ms_per_token"]
    assert "memory_reduction" not in m  # no device memory on the CPU
    monkeypatch.setattr(latency, "measure_ttft", lambda *a, **k: 1 / 0)
    m2 = EfficiencyBenchmark(tp.model_interface, EFFICIENCY).run_all().metrics
    assert "ttft_ms" not in m2 and m2["latency_ms_per_token"] > 0


def test_runner_partial_run_keeps_earlier_results(pipes, tmp_path):
    from crs_tpu_torch.evaluation.runner import EvaluationRunner

    _, tp = pipes
    cfg = {"retrieval": {"test_questions": _questions(2), "compare_no_rag": False},
           "performance": {"run_perplexity": False, "tasks": {}}}
    runner = EvaluationRunner(tp.model_interface, tp, cfg, str(tmp_path))
    first = runner.run_retrieval_only()
    assert first.retrieval and first.efficiency is None and first.performance is None
    second = runner.run_performance_only()
    assert second.retrieval == json.loads((tmp_path / "retrieval_results.json").read_text())[
        "metrics"]
    assert second.performance == {"tasks": {}, "average_accuracy": None}
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["f1_score"] == first.retrieval["f1_score"]
    missing = EvaluationRunner(None, None, cfg, str(tmp_path / "none")).run_all(True, False, True)
    assert missing.errors == {"efficiency": "no model provided",
                              "retrieval": "no pipeline provided"}
    (tmp_path / "retrieval_results.json").write_text("not json")
    assert runner.run_performance_only().retrieval is None  # unreadable: left out


def _cli_config(tmp_path) -> str:
    with open(REPO / "config.json") as f:
        cfg = json.load(f)
    cfg["model"] = {**cfg["model"], "config": "tiny", "seed": 0}
    cfg["rag"]["vector_store"]["persist_directory"] = str(tmp_path / "vdb")
    cfg["rag"]["generation"]["max_new_tokens"] = 4
    ev = cfg["evaluation"]
    ev["efficiency"] = EFFICIENCY
    ev["performance"]["perplexity"].update(dataset_path=str(CORPUS), max_samples=2, max_length=64)
    ev["performance"]["tasks"]["corpus_qa_mc"]["qa_path"] = str(QA)
    ev["performance"]["task_limit"] = 3
    ev["retrieval"].update(test_questions_file=str(QA), corpus_file=str(CORPUS), max_questions=3)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture
def root_logger():
    """The root logger's handlers and level, restored after the test."""
    import logging

    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    yield root
    root.handlers[:] = saved[0]
    root.setLevel(saved[1])


def test_cli_evaluate_on_the_cpu(tmp_path, root_logger):
    from crs_tpu_torch.__main__ import main

    cfg = _cli_config(tmp_path)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(["--config", cfg, "--evaluate", "--device", "cpu",
                   "--output-dir", str(tmp_path / "results")])
    assert rc == 0
    assert sorted(p.name for p in (tmp_path / "results").iterdir()) == FILES
    summary = json.loads(out.getvalue())
    assert summary == json.loads((tmp_path / "results" / "summary.json").read_text())
    assert summary["errors"] == {}
    for key in ("latency_ms_per_token", "perplexity", "average_accuracy", "f1_score",
                "avg_retrieval_time_ms"):
        assert summary[key] is not None, key
    # the store was empty: the corpus was indexed into the configured directory
    assert sorted(p.name for p in (tmp_path / "vdb").iterdir()) == [
        "index_arrays.npz", "index_meta.json", "lexical_state.npz"]
    retrieval = json.loads((tmp_path / "results" / "retrieval_results.json").read_text())
    assert retrieval["metrics"]["num_questions"] == 3
    # one benchmark alone keeps the others' earlier results
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(["--config", cfg, "--eval-retrieval", "--device", "cpu", "--no-model",
                   "--output-dir", str(tmp_path / "results")])
    assert rc == 0
    again = json.loads(out.getvalue())
    assert again["perplexity"] == summary["perplexity"] and again["errors"] == {}


def test_cli_evaluate_needs_a_card_by_default(tmp_path, monkeypatch, root_logger):
    from crs_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", _cli_config(tmp_path), "--evaluate",
              "--output-dir", str(tmp_path / "results")])
    assert not (tmp_path / "results").exists()
