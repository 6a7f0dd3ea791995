"""Evaluation orchestration (port of ``crs_tpu.evaluation.runner``).

``ComprehensiveResults``: the three benchmarks' metrics, timing, errors,
metadata, and the headline ``get_summary``. ``EvaluationRunner`` runs the
selected benchmarks in order (efficiency, performance, retrieval), each
isolated (its exception goes into ``errors``), validated and timed, and
writes ``efficiency_results.json``, ``performance_results.json``,
``retrieval_results.json``, ``comprehensive_results.json`` and
``summary.json`` into ``output_dir``; a benchmark left out keeps its
results from an earlier run there.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch

from .base import BenchmarkResult

logger = logging.getLogger(__name__)

__all__ = ["ComprehensiveResults", "EvaluationRunner"]


@dataclasses.dataclass
class ComprehensiveResults:
    efficiency: Optional[Dict[str, Any]] = None
    performance: Optional[Dict[str, Any]] = None
    retrieval: Optional[Dict[str, Any]] = None
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)
    errors: Dict[str, str] = dataclasses.field(default_factory=dict)
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def get_summary(self) -> Dict[str, Any]:
        """Headline metrics."""
        s: Dict[str, Any] = {}
        if self.efficiency:
            for k in ("latency_ms_per_token", "ttft_ms", "throughput_tokens_per_sec",
                      "model_size_gb", "device_memory_peak_mb", "mfu_percent",
                      "mfu_batched_percent", "prefill_mfu_percent",
                      "hbm_gbps_achieved",
                      "hbm_utilization_percent", "decode_roofline",
                      "energy_per_token_mj"):
                if self.efficiency.get(k) is not None:
                    s[k] = self.efficiency[k]
        if self.performance:
            for k in ("perplexity", "average_accuracy"):
                if self.performance.get(k) is not None:
                    s[k] = self.performance[k]
        if self.retrieval:
            for k in ("avg_retrieval_time_ms", "avg_retrieval_score", "f1_score",
                      "context_sufficiency", "exact_match", "f1_improvement",
                      "recall_at_10", "mrr"):
                if self.retrieval.get(k) is not None:
                    s[k] = self.retrieval[k]
        s["errors"] = dict(self.errors)
        s["total_time_s"] = self.timing.get("total")
        return s


class EvaluationRunner:
    """Runs selected benchmarks with isolation + persistence."""

    def __init__(
        self,
        model=None,
        pipeline=None,
        config: Optional[Dict[str, Any]] = None,
        output_dir: str = "results",
    ):
        self.model = model
        self.pipeline = pipeline
        self.config = config or {}
        self.output_dir = output_dir

    # benchmarks are built when they run
    def _efficiency(self):
        from .efficiency.benchmark import EfficiencyBenchmark

        return EfficiencyBenchmark(self.model, self.config.get("efficiency", {}))

    def _performance(self):
        from .performance.benchmark import PerformanceBenchmark

        return PerformanceBenchmark(self.model, self.config.get("performance", {}))

    def _retrieval(self):
        from .retrieval.benchmark import RetrievalBenchmark

        return RetrievalBenchmark(self.pipeline, self.config.get("retrieval", {}))

    def run_all(
        self,
        run_efficiency: bool = True,
        run_performance: bool = True,
        run_retrieval: bool = True,
    ) -> ComprehensiveResults:
        os.makedirs(self.output_dir, exist_ok=True)
        out = ComprehensiveResults(metadata=self._metadata())
        t_start = time.perf_counter()

        def run_one(name: str, enabled: bool, factory, needs):
            if not enabled:
                # keep previously persisted results so partial runs don't
                # blank the comprehensive summary
                prior = os.path.join(self.output_dir, f"{name}_results.json")
                if os.path.exists(prior):
                    try:
                        return BenchmarkResult.from_json(prior).metrics
                    except Exception:
                        return None
                return None
            if needs is None:
                out.errors[name] = f"no {'pipeline' if name == 'retrieval' else 'model'} provided"
                return None
            t0 = time.perf_counter()
            try:
                result: BenchmarkResult = factory().run_all()
                out.timing[name] = time.perf_counter() - t0
                if not result.validate():
                    out.errors[name] = "Validation failed"
                result.to_json(os.path.join(self.output_dir, f"{name}_results.json"))
                return result.metrics
            except Exception as e:  # each benchmark isolated
                out.timing[name] = time.perf_counter() - t0
                logger.exception("%s benchmark failed", name)
                out.errors[name] = str(e)
                return None

        out.efficiency = run_one("efficiency", run_efficiency, self._efficiency, self.model)
        out.performance = run_one("performance", run_performance, self._performance, self.model)
        out.retrieval = run_one("retrieval", run_retrieval, self._retrieval, self.pipeline)

        out.timing["total"] = time.perf_counter() - t_start
        with open(os.path.join(self.output_dir, "comprehensive_results.json"), "w") as f:
            json.dump(out.to_dict(), f, indent=2, default=str)
        with open(os.path.join(self.output_dir, "summary.json"), "w") as f:
            json.dump(out.get_summary(), f, indent=2, default=str)
        return out

    # one benchmark alone
    def run_efficiency_only(self) -> ComprehensiveResults:
        return self.run_all(True, False, False)

    def run_performance_only(self) -> ComprehensiveResults:
        return self.run_all(False, True, False)

    def run_retrieval_only(self) -> ComprehensiveResults:
        return self.run_all(False, False, True)

    def _metadata(self) -> Dict[str, Any]:
        """When, on what device (``torch.cuda.get_device_name`` of the
        model's or the pipeline's CUDA device, else "cpu") and backend
        ("cuda" / "cpu"), and the model's info."""
        md: Dict[str, Any] = {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}
        try:
            dev = getattr(self.model, "device", None) or getattr(self.pipeline, "device", None)
            dev = torch.device(dev if dev is not None else
                               ("cuda" if torch.cuda.is_available() else "cpu"))
            md["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            md["backend"] = dev.type
        except Exception:
            pass
        if self.model is not None:
            try:
                md["model"] = self.model.get_model_info()
            except Exception:
                pass
        return md
