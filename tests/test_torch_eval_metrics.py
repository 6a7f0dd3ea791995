"""The port's evaluation metrics, results, spec table and formulas against
``crs_tpu``'s, on the CPU.

Every comparison here is exact (host arithmetic in the same order):
- IR metrics (P/R/F1@k, MRR, AP, nDCG, ``evaluate_retrieval``) on seeded
  random rankings, and the RAG answer metrics on seeded random texts;
- ``BenchmarkResult``: the JSON round trip, ``compare_with``,
  ``aggregate_from_runs`` (scipy's t quantile), ``statistical_test`` and
  ``validate``; ``ModelBenchmark.run_multiple``;
- ``device_specs`` for every row and for the names the card and the TPUs
  report; flops, MFU, memory-rate use, energy and the KV-cache size for
  every ``CONFIGS`` preset;
- the task registry, the presets and the ``corpus_qa_mc`` items built from
  ``results/selftrained/heldout_qa.json``.
The profiling helpers are checked on their own (they have no ``crs_tpu``
counterpart on the CPU worth comparing: its trace is a JAX trace).
"""

import json
import math
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
QA = REPO / "results" / "selftrained" / "heldout_qa.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- retrieval and RAG metrics ---------------------------------------------------------

def _rankings(seed: int):
    rng = np.random.default_rng(seed)
    pool = [f"doc_{i}" for i in range(30)]
    retrieved = [list(rng.choice(pool, size=int(rng.integers(0, 15)), replace=True))
                 for _ in range(12)]
    relevant = [list(rng.choice(pool, size=int(rng.integers(0, 6)), replace=False))
                for _ in range(12)]
    grades = [{d: float(rng.integers(0, 4)) for d in rel} for rel in relevant]
    return retrieved, relevant, grades


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retrieval_metrics_equal(seed):
    from crs_tpu.evaluation.retrieval.retrieval_metrics import RetrievalMetrics as J

    from crs_tpu_torch.evaluation.retrieval.retrieval_metrics import RetrievalMetrics as T

    retrieved, relevant, grades = _rankings(seed)
    for ret, rel, gr in zip(retrieved, relevant, grades):
        for k in (0, 1, 3, 5, 10):
            assert T.precision_at_k(ret, rel, k) == J.precision_at_k(ret, rel, k)
            assert T.recall_at_k(ret, rel, k) == J.recall_at_k(ret, rel, k)
            assert T.f1_at_k(ret, rel, k) == J.f1_at_k(ret, rel, k)
            for gain in ("exponential", "linear"):
                assert T.ndcg_at_k(ret, gr, k, gain) == J.ndcg_at_k(ret, gr, k, gain)
        assert T.mrr(ret, rel) == J.mrr(ret, rel)
        assert T.average_precision(ret, rel) == J.average_precision(ret, rel)
    got = T.evaluate_retrieval(retrieved, relevant, (1, 3, 5, 10))
    assert got == J.evaluate_retrieval(retrieved, relevant, (1, 3, 5, 10)) and got["mrr"] >= 0
    assert T.evaluate_retrieval([], []) == J.evaluate_retrieval([], []) == {}
    assert T.context_relevance("What is GPTQ?", "GPTQ is a method") == \
        J.context_relevance("What is GPTQ?", "GPTQ is a method")


_WORDS = ("the", "model", "quantization", "GPTQ", "weights", "bits", "error", "a", "of",
          "Compression,", "memory.", "layer", "int8", "scale!", "AWQ", "and")


def _texts(rng, n: int):
    return [" ".join(rng.choice(_WORDS, size=int(rng.integers(0, 14)))) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rag_metrics_equal(seed):
    from crs_tpu.evaluation.retrieval.rag_metrics import RAGMetrics as J

    from crs_tpu_torch.evaluation.retrieval.rag_metrics import RAGMetrics as T

    rng = np.random.default_rng(seed)
    preds, refs, questions, contexts, no_rag = (_texts(rng, 10) for _ in range(5))
    refs[0] = preds[0]  # one exact match
    for p, r, q, c in zip(preds, refs, questions, contexts):
        assert T.exact_match(p, r) == J.exact_match(p, r)
        assert T.token_f1(p, r) == J.token_f1(p, r)
        assert T.bleu(p, r) == J.bleu(p, r)
        assert T.rouge_n(p, r) == J.rouge_n(p, r)
        assert T.rouge_n(p, r, 2) == J.rouge_n(p, r, 2)
        assert T.rouge_l(p, r) == J.rouge_l(p, r)
        assert T.answer_relevance(p, q) == J.answer_relevance(p, q)
        assert T.faithfulness(p, c) == J.faithfulness(p, c)
    got = T().evaluate_rag_system(questions, preds, refs, contexts, no_rag,
                                  compute_bertscore=True)
    ref = J().evaluate_rag_system(questions, preds, refs, contexts, no_rag,
                                  compute_bertscore=True)
    assert got == ref and got["exact_match"] > 0
    assert got["bertscore_f1"] is None  # no bert_score package here
    assert T().evaluate_rag_system([], [], []) == {}


# -- results and statistics ------------------------------------------------------------

def _runs(cls, seed: int):
    rng = np.random.default_rng(seed)
    return [cls(name="efficiency", metadata={"model": "tiny"},
                metrics={"latency_ms_per_token": float(rng.uniform(1, 2)),
                         "throughput_tokens_per_sec": float(rng.uniform(100, 200)),
                         "perplexity": float(rng.uniform(5, 9)), "count": int(rng.integers(9)),
                         "mode": "qa", "flag": True})
            for _ in range(5)]


def test_benchmark_result_round_trip_and_compare(tmp_path):
    from crs_tpu.evaluation.base import BenchmarkResult as J, higher_is_better as jh

    from crs_tpu_torch.evaluation.base import BenchmarkResult as T, higher_is_better as th

    tr, jr = _runs(T, 0), _runs(J, 0)
    tr[0].metrics["arr"] = np.arange(3)
    jr[0].metrics["arr"] = np.arange(3)
    tr[0].to_json(str(tmp_path / "t" / "r.json"))
    jr[0].to_json(str(tmp_path / "j" / "r.json"))
    assert (tmp_path / "t" / "r.json").read_text() == (tmp_path / "j" / "r.json").read_text()
    back = T.from_json(str(tmp_path / "t" / "r.json"))
    assert back.to_dict() == J.from_json(str(tmp_path / "j" / "r.json")).to_dict()
    assert back.metrics["arr"] == [0, 1, 2] and str(back) == str(J.from_json(
        str(tmp_path / "j" / "r.json")))
    for i in range(1, 5):
        assert tr[0].compare_with(tr[i]) == jr[0].compare_with(jr[i])
    zero = T(name="z", metrics={"latency_ms_per_token": 0.0})
    assert tr[0].compare_with(zero) == jr[0].compare_with(J(name="z", metrics=zero.metrics))
    for name in ("latency_ms_per_token", "f1_score", "perplexity", "mfu_percent", "weird",
                 "energy_per_token_mj", "recall_at_10", "bits_per_param"):
        assert th(name) == jh(name)


def test_aggregate_and_statistical_test():
    from crs_tpu.evaluation.base import BenchmarkResult as J

    from crs_tpu_torch.evaluation.base import BenchmarkResult as T

    got = T.aggregate_from_runs(_runs(T, 1))
    ref = J.aggregate_from_runs(_runs(J, 1))
    assert got.to_dict() == ref.to_dict()
    assert "latency_ms_per_token_ci_low" in got.metrics and got.metrics["num_runs"] == 5
    assert T.aggregate_from_runs(_runs(T, 2)[:1]).to_dict() == \
        J.aggregate_from_runs(_runs(J, 2)[:1]).to_dict()
    with pytest.raises(ValueError):
        T.aggregate_from_runs([])
    rng = np.random.default_rng(3)
    a, b = rng.normal(0, 1, 12), rng.normal(0.8, 1, 9)
    for test in ("t", "mannwhitney"):
        assert T.statistical_test(a, b, test) == J.statistical_test(a, b, test)
    one = T.statistical_test([1.0], [2.0])  # NaN statistic and p: compare as JSON
    assert json.dumps(one, sort_keys=True) == json.dumps(J.statistical_test([1.0], [2.0]),
                                                         sort_keys=True)


def test_validate_and_run_multiple():
    from crs_tpu.evaluation.base import BenchmarkResult as J, ModelBenchmark as JB

    from crs_tpu_torch.evaluation.base import BenchmarkResult as T, ModelBenchmark as TB

    for metrics in ({}, {"a": None}, {"a": float("nan")}, {"a": float("inf")},
                    {"a": 1.0, "b": "x"}, {"flag": True}):
        assert T(name="r", metrics=metrics).validate() == J(name="r", metrics=metrics).validate()

    def bench(base, result):
        class Counting(base):
            n = 0

            def run_all(self):
                Counting.n += 1
                return result(name="b", metrics={"x": float(Counting.n), "y": 2.0})
        return Counting({"k": 1})

    got, ref = bench(TB, T).run_multiple(4), bench(JB, J).run_multiple(4)
    assert got.to_dict() == ref.to_dict() and got.metrics["x_mean"] == 2.5


# -- the spec table and the formulas ---------------------------------------------------

def _spec_names():
    from crs_tpu.evaluation.efficiency.device_specs import DEVICE_SPECS

    return sorted(DEVICE_SPECS) + ["NVIDIA H100 80GB HBM3", "nvidia h100 pcie", "TPU v5 lite",
                                   "NVIDIA A100-SXM4-80GB", "Tesla T4", "cpu", "something else"]


@pytest.mark.parametrize("name", _spec_names())
def test_device_specs_equal(name):
    from crs_tpu.evaluation.efficiency import device_specs as J

    from crs_tpu_torch.evaluation.efficiency import device_specs as T

    assert T.DEVICE_SPECS == J.DEVICE_SPECS
    assert T.get_device_specs(name) == J.get_device_specs(name)
    assert T.detect_tdp(name) == J.detect_tdp(name)
    assert T.detect_hbm_gbps(name) == J.detect_hbm_gbps(name)
    for dtype in ("bf16", "int8"):
        assert T.detect_peak_tflops(name, dtype) == J.detect_peak_tflops(name, dtype)


def test_device_detection(monkeypatch):
    """The CPU is "cpu" in both packages; a CUDA device is its
    ``get_device_name``, and the H100's name matches the "h100" row."""
    from crs_tpu.evaluation.efficiency import device_specs as J, memory as JM

    from crs_tpu_torch.evaluation.efficiency import device_specs as T, memory as TM

    assert T.detect_device_name("cpu") == T.detect_device_name() == J.detect_device_name() == "cpu"
    assert TM.get_device_memory("cpu") == TM.get_device_memory() == JM.get_device_memory()
    assert TM.get_device_memory("cpu") == {"device_memory_in_use_mb": None,
                                           "device_memory_peak_mb": None}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    name = T.detect_device_name("cuda")
    assert name == "nvidia h100 80gb hbm3"
    spec = T.get_device_specs(name)
    assert spec["matched"] and spec["tdp_w"] == 700.0 and spec["peak_int8_tops"] == 1979.0


def _preset_names():
    from crs_tpu_torch.models.transformer import CONFIGS

    return sorted(CONFIGS)


@pytest.mark.parametrize("preset", _preset_names())
def test_formulas_equal_for_every_preset(preset):
    from crs_tpu.evaluation.efficiency import energy as JE, flops as JF, memory as JM
    from crs_tpu.models.transformer import CONFIGS as JC

    from crs_tpu_torch.evaluation.efficiency import energy as TE, flops as TF, memory as TM
    from crs_tpu_torch.models.transformer import CONFIGS as TC

    jc, tc = JC[preset], TC[preset]
    for seq in (1, 256, 512):
        assert TF.flops_breakdown(tc, seq) == JF.flops_breakdown(jc, seq)
        assert TF.estimate_flops_per_token(tc, seq) == JF.estimate_flops_per_token(jc, seq)
    gf = TF.estimate_flops_per_token(tc)["gflops_per_token"]
    for name in ("nvidia h100 80gb hbm3", "tpu v5 lite", "cpu"):
        for dtype in ("bf16", "int8"):
            assert TF.calculate_mfu(gf, 1234.5, name, dtype) == \
                JF.calculate_mfu(gf, 1234.5, name, dtype)
        assert TF.calculate_bandwidth_utilization(1.7, 2.5, name, 0.01) == \
            JF.calculate_bandwidth_utilization(1.7, 2.5, name, 0.01)
        assert TE.estimate_energy_per_token(2.5, name) == JE.estimate_energy_per_token(2.5, name)
    assert TF.calculate_mfu(None, 5.0) == JF.calculate_mfu(None, 5.0)
    assert TF.calculate_bandwidth_utilization(None, 1.0) == \
        JF.calculate_bandwidth_utilization(None, 1.0)
    assert TE.estimate_energy_per_token(None) == JE.estimate_energy_per_token(None)
    assert TE.estimate_energy_per_token(2.0, tdp_w=300.0) == \
        JE.estimate_energy_per_token(2.0, tdp_w=300.0)
    assert TE.estimate_total_energy(1.75, 640) == JE.estimate_total_energy(1.75, 640)
    assert TE.estimate_total_energy(None, 5) == JE.estimate_total_energy(None, 5) == {}
    assert TE.compare_energy_efficiency(1.0, 2.0) == JE.compare_energy_efficiency(1.0, 2.0)
    for seq, batch, nbytes in ((2048, 1, 2), (512, 8, 1)):
        args = (tc.num_layers, tc.num_kv_heads, tc.head_dim, seq, batch, nbytes)
        assert TM.estimate_kv_cache_size(*args) == JM.estimate_kv_cache_size(*args)
    assert TM.get_memory_efficiency(100.0, 400.0) == JM.get_memory_efficiency(100.0, 400.0)
    assert TM.get_memory_efficiency(None, 400.0) == JM.get_memory_efficiency(None, 400.0)


# -- tasks -------------------------------------------------------------------------------

def test_task_registry_and_corpus_qa_items(tmp_path):
    from crs_tpu.evaluation.performance import tasks as J

    from crs_tpu_torch.evaluation.performance import tasks as T

    assert T.TASK_REGISTRY == J.TASK_REGISTRY and len(T.TASK_REGISTRY) == 23
    assert T.PRESETS == J.PRESETS
    for preset in T.PRESETS:
        assert T.generate_config_template(preset) == J.generate_config_template(preset)
    with pytest.raises(ValueError):
        T.generate_config_template("nope")
    cfg = {"corpus_qa_mc": {"enabled": True}, "arc_easy": {"enabled": False}, "nope": True,
           "hellaswag": True}
    assert T.validate_task_config(cfg) == J.validate_task_config(cfg) == ["corpus_qa_mc",
                                                                          "hellaswag"]
    for seed, choices in ((0, 4), (5, 3)):
        got = T.build_corpus_qa_task(str(QA), choices, seed)
        ref = J.build_corpus_qa_task(str(QA), choices, seed)
        assert got.name == ref.name == "corpus_qa_mc" and got.items == ref.items
        assert len(got.items) == len(json.loads(QA.read_text()))
    assert T.build_corpus_qa_task(None) is None
    assert T.build_corpus_qa_task(str(tmp_path / "absent.json")) is None
    path = tmp_path / "mc.json"
    path.write_text(json.dumps(T.build_corpus_qa_task(str(QA)).items))
    assert T.MultipleChoiceTask.from_file("x", str(path)).items == \
        J.MultipleChoiceTask.from_file("x", str(path)).items


def test_tasks_cli(capsys):
    from crs_tpu.evaluation.performance.tasks import main as jmain

    from crs_tpu_torch.evaluation.performance.tasks import main as tmain

    for argv in (["--list"], ["--presets"], ["--template", "offline"], []):
        assert tmain(argv) == 0
        got = capsys.readouterr().out
        assert jmain(argv) == 0
        assert got == capsys.readouterr().out and got


# -- profiling ---------------------------------------------------------------------------

def test_profiling_helpers_on_the_cpu(tmp_path):
    from crs_tpu_torch.utils.profiling import capture_trace, device_timer, fence_outputs, timed

    x = torch.ones(4)
    out, secs = timed(lambda a: {"y": [a * 2]}, x)
    assert torch.equal(out["y"][0], x * 2) and secs >= 0
    assert fence_outputs((x, [x], {"k": x}, "s")) is not None
    times = {}
    with device_timer("blk", times, device="cpu"):
        math.sqrt(2.0)
    assert times["blk"] >= 0
    res, trace_dir = capture_trace(lambda: torch.mm(torch.ones(8, 8), torch.ones(8, 8)),
                                   str(tmp_path / "trace"))
    assert trace_dir == str(tmp_path / "trace") and float(res[0, 0]) == 8.0
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
