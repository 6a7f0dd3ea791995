"""lm-eval-harness adapter (port of ``crs_tpu.evaluation.performance.lm_eval_adapter``).

Wraps a :class:`~crs_tpu_torch.models.model_interface.TorchModel` as an
``lm_eval.api.model.LM`` so harness tasks run against the port's model.
Importing this module without ``lm_eval`` raises ImportError, which
callers read as "harness unavailable". ``tests/stubs/lm_eval`` drives the
whole adapter in the tests.

- ``loglikelihood`` returns lm-eval's ``is_greedy`` beside each sum,
  computed on the device with it (greedy-match tasks such as lambada score
  on it); ``loglikelihood_rolling``; ``generate_until`` with stop strings,
- per-task config blocks ``{enabled, num_fewshot, limit, batch_size}``,
- the new (``simple_evaluate``) and old (``evaluator.simple_evaluate``)
  harness APIs, and ``confirm_run_unsafe_code`` dropped for versions that
  predate it,
- metric-name fallbacks, nested dict values included,
- each task's failure isolated.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple, Union

from lm_eval.api.model import LM  # type: ignore

from .tasks import TASK_REGISTRY

logger = logging.getLogger(__name__)

__all__ = [
    "TorchLM",
    "run_lm_eval_harness",
    "parse_task_config",
    "get_metric_from_results",
]


class TorchLM(LM):
    """Harness-facing model: batches requests into the bucketed device calls."""

    def __init__(self, model, batch_size: int = 8):
        super().__init__()
        self.model = model
        self.batch_size = batch_size

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        pairs = [tuple(req.args) for req in requests]
        return self.model.get_loglikelihood_batch_scored(pairs)

    def loglikelihood_rolling(self, requests) -> List[float]:
        pairs = [("", req.args[0]) for req in requests]
        return [ll for ll, _ in self.model.get_loglikelihood_batch_scored(pairs)]

    def generate_until(self, requests) -> List[str]:
        out = []
        for start in range(0, len(requests), self.batch_size):
            batch = requests[start : start + self.batch_size]
            prompts, untils, max_toks = [], [], []
            for req in batch:
                context, gen_kwargs = req.args
                gen_kwargs = gen_kwargs or {}
                prompts.append(context)
                until = gen_kwargs.get("until", [])
                untils.append([until] if isinstance(until, str) else list(until))
                max_toks.append(int(gen_kwargs.get("max_gen_toks", 128)))
            texts = self.model.generate_batch(
                prompts, max_new_tokens=max(max_toks), temperature=0.0
            )
            for text, until in zip(texts, untils):
                for stop in until:
                    idx = text.find(stop)
                    if idx >= 0:
                        text = text[:idx]
                out.append(text)
        return out


def parse_task_config(task_config: Union[bool, Dict[str, Any], None]) -> Optional[Dict[str, Any]]:
    """Normalize a per-task config block.

    ``True`` → enabled with defaults, ``False``/``{"enabled": false}`` → None
    (skip), dict → the dict itself when enabled.
    """
    if isinstance(task_config, bool):
        return {"enabled": True} if task_config else None
    if isinstance(task_config, dict):
        if not task_config.get("enabled", True):
            return None
        return task_config
    return None


def get_metric_from_results(task_results: Dict[str, Any], task_name: str) -> Optional[float]:
    """Metric extraction with name-variation + nested-dict fallbacks
   ."""
    preferred = TASK_REGISTRY.get(task_name, {}).get("metric", "acc")
    variations = [
        preferred,
        f"{preferred},none",
        f"{preferred}_norm",
        f"{preferred}_norm,none",
        "acc_norm", "acc_norm,none",
        "acc", "acc,none",
        "exact_match", "exact_match,none",
        "pass@1", "f1", "em",
    ]
    for name in variations:
        if name in task_results:
            value = task_results[name]
            if isinstance(value, dict):
                for key in ("mean", "value", "score"):
                    if key in value:
                        return float(value[key])
            elif isinstance(value, (int, float)):
                return float(value)
    # last resort: the first numeric value anywhere in the dict
    for key, value in task_results.items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            logger.debug("fallback metric %r for task %s", key, task_name)
            return float(value)
        if isinstance(value, dict):
            for subkey in ("mean", "value", "score"):
                sub = value.get(subkey)
                if isinstance(sub, (int, float)) and not isinstance(sub, bool):
                    logger.debug("fallback metric %r.%s for %s", key, subkey, task_name)
                    return float(sub)
    logger.warning(
        "no valid metric for %s (available: %s)", task_name, sorted(task_results)
    )
    return None


def _simple_evaluate_compat(evaluate_fn, new_api: bool, **kw):
    """Call the harness entry point, dropping kwargs old versions reject."""
    if not new_api:
        legacy = {k: kw[k] for k in ("model", "tasks", "num_fewshot", "limit", "batch_size") if k in kw}
        return evaluate_fn(**legacy)
    try:
        return evaluate_fn(**kw)
    except TypeError:
        # pre-confirm_run_unsafe_code harness versions
        kw.pop("confirm_run_unsafe_code", None)
        return evaluate_fn(**kw)


def run_lm_eval_harness(
    model,
    tasks: Union[List[str], Dict[str, Any]],
    num_fewshot: Optional[int] = None,
    limit: Optional[int] = None,
    batch_size: int = 8,
    seed: int = 1234,
) -> Dict[str, float]:
    """Per-task harness loop: task-specific config,
    failure isolation, metric fallbacks. Returns {task: score}."""
    try:
        from lm_eval import simple_evaluate  # type: ignore
        evaluate_fn, new_api = simple_evaluate, True
    except ImportError:
        from lm_eval import evaluator  # type: ignore
        evaluate_fn, new_api = evaluator.simple_evaluate, False

    if isinstance(tasks, dict):
        task_configs = {
            name: cfg for name, cfg in
            ((n, parse_task_config(c)) for n, c in tasks.items())
            if cfg is not None
        }
    else:
        task_configs = {name: {} for name in tasks}
    if not task_configs:
        logger.warning("no tasks enabled for lm-eval")
        return {}

    lm = model if isinstance(model, LM) else TorchLM(model, batch_size=batch_size)
    all_metrics: Dict[str, float] = {}
    for task_name, task_cfg in task_configs.items():
        try:
            if "num_fewshot" in task_cfg:
                task_fewshot = task_cfg["num_fewshot"]
            elif num_fewshot is not None:
                task_fewshot = num_fewshot
            else:
                task_fewshot = TASK_REGISTRY.get(task_name, {}).get("num_fewshot", 0)
            task_limit = task_cfg.get("limit", limit)
            task_batch = task_cfg.get("batch_size", batch_size)
            logger.info("lm-eval: %s (%d-shot)", task_name, task_fewshot)
            results = _simple_evaluate_compat(
                evaluate_fn, new_api,
                model=lm,
                tasks=[task_name],
                num_fewshot=task_fewshot,
                limit=task_limit,
                batch_size=task_batch,
                random_seed=seed,
                numpy_random_seed=seed,
                torch_random_seed=seed,
                fewshot_random_seed=seed,
                confirm_run_unsafe_code=True,  # HumanEval code execution
            )
            task_results = (results or {}).get("results", {}).get(task_name)
            if not task_results:
                logger.warning("lm-eval: %s returned no results", task_name)
                continue
            score = get_metric_from_results(task_results, task_name)
            if score is not None:
                all_metrics[task_name] = score
                logger.info("  %s: %.4f", task_name, score)
        except Exception as e:  # per-task isolation
            logger.error("  %s failed: %s", task_name, e)
            continue
    logger.info("lm-eval: %d/%d tasks scored", len(all_metrics), len(task_configs))
    return all_metrics
