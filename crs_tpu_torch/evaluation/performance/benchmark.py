"""Performance benchmark (port of ``crs_tpu.evaluation.performance.benchmark``).

``PerformanceResults``: perplexity, each task's score and the average
accuracy, printed by category. ``run_all`` runs perplexity, then the
enabled tasks: those without local data through the lm-eval harness (when
``lm_eval`` is there; else skipped), the local ones (a ``dataset_path`` of
MC items, or ``corpus_qa_mc`` from the QA file in its ``qa_path``) through
:class:`MultipleChoiceTask` and the model's batched scoring.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from ..base import BenchmarkResult, ModelBenchmark
from .perplexity import PerplexityEvaluator
from .tasks import TASK_REGISTRY, MultipleChoiceTask, build_corpus_qa_task, validate_task_config

logger = logging.getLogger(__name__)

__all__ = ["PerformanceBenchmark", "PerformanceResults"]


class PerformanceResults(BenchmarkResult):
    def pretty(self) -> str:
        """Category-grouped printout."""
        lines = [f"=== {self.name} ==="]
        if self.metrics.get("perplexity") is not None:
            lines.append(f"  perplexity: {self.metrics['perplexity']:.3f}")
        by_cat: Dict[str, List[str]] = {}
        for task, info in self.metrics.get("tasks", {}).items():
            cat = TASK_REGISTRY.get(task, {}).get("category", "other")
            score = info.get("score")
            by_cat.setdefault(cat, []).append(
                f"    {task}: {score:.3f}" if score is not None else f"    {task}: n/a"
            )
        for cat in sorted(by_cat):
            lines.append(f"  [{cat}]")
            lines.extend(by_cat[cat])
        if self.metrics.get("average_accuracy") is not None:
            lines.append(f"  average_accuracy: {self.metrics['average_accuracy']:.4f}")
        return "\n".join(lines)


class PerformanceBenchmark(ModelBenchmark[PerformanceResults]):
    def __init__(self, model, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.model = model
        cfg = self.config
        self.run_perplexity = bool(cfg.get("run_perplexity", True))
        self.run_tasks = bool(cfg.get("run_tasks", True))
        self.perplexity_cfg = cfg.get("perplexity", {})
        self.tasks_cfg: Dict[str, Any] = cfg.get("tasks", {"corpus_qa_mc": {"enabled": True}})
        self.task_limit = cfg.get("task_limit")

    def run_all(self) -> PerformanceResults:
        m: Dict[str, Any] = {}
        if self.run_perplexity:
            try:
                m.update(PerplexityEvaluator(self.model, self.perplexity_cfg).calculate())
            except Exception as e:  # pragma: no cover
                logger.warning("perplexity failed: %s", e)
        if self.run_tasks:
            m["tasks"] = self._run_tasks()
            scores = [t["score"] for t in m["tasks"].values() if t.get("score") is not None]
            m["average_accuracy"] = sum(scores) / len(scores) if scores else None
        return PerformanceResults(
            name="performance", metrics=m, metadata={"config": dict(self.config)}
        )

    def _run_tasks(self) -> Dict[str, Any]:
        names = validate_task_config(self.tasks_cfg)
        out: Dict[str, Any] = {}
        harness_tasks = [n for n in names if not TASK_REGISTRY[n].get("local")]
        # harness path (gated)
        if harness_tasks:
            try:
                from .lm_eval_adapter import run_lm_eval_harness

                # per-task config blocks flow through (enabled / num_fewshot
                # / limit / batch_size)
                harness_cfg = {n: self.tasks_cfg.get(n, True) for n in harness_tasks}
                results = run_lm_eval_harness(self.model, harness_cfg, limit=self.task_limit)
                for name in harness_tasks:
                    metric = TASK_REGISTRY[name]["metric"]
                    out[name] = {"metric": metric, "score": results.get(name)}
            except Exception as e:
                logger.warning("lm-eval harness unavailable (%s); %d tasks skipped",
                               e, len(harness_tasks))
                for name in harness_tasks:
                    out[name] = {"metric": TASK_REGISTRY[name]["metric"], "score": None,
                                 "skipped": "lm_eval unavailable"}
        # native local tasks
        for name in names:
            if not TASK_REGISTRY[name].get("local"):
                continue
            task = self._load_local_task(name)
            if task is None:
                out[name] = {"metric": "acc", "score": None, "skipped": "no local data"}
                continue
            cfg = self.tasks_cfg.get(name, {})
            fewshot = int(cfg.get("num_fewshot", TASK_REGISTRY[name].get("num_fewshot", 0))) \
                if isinstance(cfg, dict) else 0
            try:
                out[name] = task.evaluate(
                    self.model, limit=self.task_limit, num_fewshot=fewshot
                )
            except Exception as e:  # pragma: no cover
                logger.warning("task %s failed: %s", name, e)
                out[name] = {"metric": "acc", "score": None, "error": str(e)}
        return out

    def _load_local_task(self, name: str) -> Optional[MultipleChoiceTask]:
        cfg = self.tasks_cfg.get(name, {})
        if isinstance(cfg, dict) and cfg.get("dataset_path"):
            return MultipleChoiceTask.from_file(name, cfg["dataset_path"])
        if name == "corpus_qa_mc" and isinstance(cfg, dict):
            return build_corpus_qa_task(cfg.get("qa_path"))
        return None
