"""Benchmark results and their statistics (port of ``crs_tpu.evaluation.base``).

- ``BenchmarkResult``: a named dict of metrics and metadata with a JSON
  round trip, ``compare_with`` (improved / regressed by the metric name's
  direction, ``higher_is_better``), ``aggregate_from_runs`` (mean, std,
  stderr, median and a t-distribution confidence interval), and
  ``statistical_test`` (Welch's t or Mann-Whitney U with scipy, Cohen's d),
  ``validate`` (no empty, all-None, NaN or infinite metrics).
- ``ModelBenchmark``: the base of the three benchmarks, ``run_all`` and
  ``run_multiple`` (n runs aggregated).

Host code only: nothing here touches a device.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
from abc import ABC, abstractmethod
from typing import Any, Dict, Generic, List, Optional, Sequence, TypeVar

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["BenchmarkResult", "ModelBenchmark"]

# metric-name keywords → direction (higher better?)
_LOWER_IS_BETTER = (
    "latency", "time", "ms", "memory", "size", "perplexity", "energy",
    "loss", "error", "bits", "cost",
)
_HIGHER_IS_BETTER = (
    "throughput", "accuracy", "f1", "recall", "precision", "mrr", "map",
    "ndcg", "score", "tokens_per_sec", "qps", "mfu", "efficiency", "speedup",
    "bleu", "rouge", "faithfulness", "sufficiency", "coverage", "relevance",
    "exact_match", "improvement",
)


def higher_is_better(metric_name: str) -> Optional[bool]:
    name = metric_name.lower()
    for kw in _HIGHER_IS_BETTER:
        if kw in name:
            return True
    for kw in _LOWER_IS_BETTER:
        if kw in name:
            return False
    return None


@dataclasses.dataclass
class BenchmarkResult:
    name: str
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "metrics": self.metrics, "metadata": self.metadata}

    def to_json(self, path: str) -> None:
        import os

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=_json_default)

    @classmethod
    def from_json(cls, path: str) -> "BenchmarkResult":
        with open(path) as f:
            d = json.load(f)
        return cls(name=d.get("name", "unknown"), metrics=d.get("metrics", {}), metadata=d.get("metadata", {}))

    def __str__(self) -> str:
        lines = [f"=== {self.name} ==="]
        for k, v in self.metrics.items():
            if isinstance(v, float):
                lines.append(f"  {k}: {v:.4f}")
            else:
                lines.append(f"  {k}: {v}")
        return "\n".join(lines)

    # -- comparison ----------------------------------------------------------
    def compare_with(self, other: "BenchmarkResult") -> Dict[str, Dict[str, Any]]:
        """Per-metric diff vs another result, classified improved/regressed."""
        out: Dict[str, Dict[str, Any]] = {}
        for key, v1 in self.metrics.items():
            v2 = other.metrics.get(key)
            if not _is_number(v1) or not _is_number(v2):
                continue
            diff = v1 - v2
            pct = (diff / abs(v2) * 100.0) if v2 else float("inf") if diff else 0.0
            hib = higher_is_better(key)
            direction = None
            if hib is not None and diff != 0:
                direction = "improved" if (diff > 0) == hib else "regressed"
            out[key] = {
                "this": v1,
                "other": v2,
                "diff": diff,
                "pct_change": pct,
                "direction": direction,
            }
        return out

    # -- aggregation ---------------------------------------------------------
    @classmethod
    def aggregate_from_runs(cls, runs: Sequence["BenchmarkResult"], confidence: float = 0.95) -> "BenchmarkResult":
        """mean/std/stderr/median + t-distribution CI across runs."""
        if not runs:
            raise ValueError("no runs to aggregate")
        keys = [k for k, v in runs[0].metrics.items() if _is_number(v)]
        agg: Dict[str, Any] = {"num_runs": len(runs)}
        for k in keys:
            vals = np.array([r.metrics[k] for r in runs if _is_number(r.metrics.get(k))], float)
            if len(vals) == 0:
                continue
            mean = float(np.mean(vals))
            std = float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0
            stderr = std / math.sqrt(len(vals)) if len(vals) > 1 else 0.0
            agg[f"{k}_mean"] = mean
            agg[f"{k}_std"] = std
            agg[f"{k}_stderr"] = stderr
            agg[f"{k}_median"] = float(np.median(vals))
            if len(vals) > 1:
                t = _t_critical(len(vals) - 1, confidence)
                agg[f"{k}_ci_low"] = mean - t * stderr
                agg[f"{k}_ci_high"] = mean + t * stderr
        return cls(name=f"{runs[0].name}_aggregate", metrics=agg, metadata=dict(runs[0].metadata))

    # -- significance --------------------------------------------------------
    @staticmethod
    def statistical_test(
        a: Sequence[float], b: Sequence[float], test: str = "t"
    ) -> Dict[str, Any]:
        """Independent t-test or Mann-Whitney U + Cohen's d."""
        a = np.asarray(a, float)
        b = np.asarray(b, float)
        out: Dict[str, Any] = {
            "mean_a": float(a.mean()), "mean_b": float(b.mean()),
            "n_a": len(a), "n_b": len(b), "test": test,
        }
        pooled = math.sqrt(
            ((len(a) - 1) * a.var(ddof=1) + (len(b) - 1) * b.var(ddof=1))
            / max(len(a) + len(b) - 2, 1)
        ) if len(a) > 1 and len(b) > 1 else 0.0
        out["cohens_d"] = float((a.mean() - b.mean()) / pooled) if pooled > 0 else 0.0
        out["effect_size"] = _effect_label(abs(out["cohens_d"]))
        try:
            from scipy import stats as sps  # type: ignore

            if test == "t":
                stat, p = sps.ttest_ind(a, b, equal_var=False)
            else:
                stat, p = sps.mannwhitneyu(a, b, alternative="two-sided")
            out["statistic"] = float(stat)
            out["p_value"] = float(p)
            out["significant"] = bool(p < 0.05)
        except ImportError:  # welch-t fallback without scipy
            if len(a) > 1 and len(b) > 1:
                se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
                t_stat = (a.mean() - b.mean()) / se if se > 0 else 0.0
                out["statistic"] = float(t_stat)
                out["p_value"] = None
                out["significant"] = bool(abs(t_stat) > 2.0)
        return out

    # -- validation ----------------------------------------------------------
    def validate(self) -> bool:
        """Reject empty/all-None results and NaN/inf metric values."""
        numeric = [v for v in self.metrics.values() if _is_number(v)]
        if not self.metrics or all(v is None for v in self.metrics.values()):
            logger.warning("%s: empty/all-None metrics", self.name)
            return False
        for k, v in self.metrics.items():
            if _is_number(v) and (math.isnan(v) or math.isinf(v)):
                logger.warning("%s: metric %s is %s", self.name, k, v)
                return False
        return True


T = TypeVar("T", bound=BenchmarkResult)


class ModelBenchmark(ABC, Generic[T]):
    """Abstract benchmark over a model or a pipeline."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}

    @abstractmethod
    def run_all(self) -> T: ...

    def run_multiple(self, num_runs: int = 3, confidence: float = 0.95) -> BenchmarkResult:
        runs: List[BenchmarkResult] = []
        for i in range(num_runs):
            logger.info("run %d/%d", i + 1, num_runs)
            runs.append(self.run_all())
        return BenchmarkResult.aggregate_from_runs(runs, confidence)


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _effect_label(d: float) -> str:
    if d < 0.2:
        return "negligible"
    if d < 0.5:
        return "small"
    if d < 0.8:
        return "medium"
    return "large"


# Two-sided t critical values (df → value) at 95%; scipy used when present.
_T_TABLE_95 = {
    1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447, 7: 2.365,
    8: 2.306, 9: 2.262, 10: 2.228, 15: 2.131, 20: 2.086, 30: 2.042, 60: 2.000,
}


def _t_critical(df: int, confidence: float) -> float:
    try:
        from scipy import stats as sps  # type: ignore

        return float(sps.t.ppf(0.5 + confidence / 2.0, df))
    except ImportError:
        if confidence != 0.95:
            return 2.0
        keys = sorted(_T_TABLE_95)
        for k in keys:
            if df <= k:
                return _T_TABLE_95[k]
        return 1.96


def _json_default(o: Any):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)
