"""Throughput (port of ``crs_tpu.evaluation.efficiency.throughput``).

- single-stream tokens/s over repeated greedy generates,
- a batch-size sweep through ``generate_batch``, stopped at the first
  failing size (out of memory).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["measure_throughput", "measure_batch_throughput"]

_PROMPT = "Model compression techniques such as quantization and pruning"


def measure_throughput(
    model,
    prompt: Optional[str] = None,
    max_new_tokens: int = 64,
    num_warmup: int = 2,
    num_runs: int = 3,
) -> Dict[str, Any]:
    prompt = prompt or _PROMPT
    for _ in range(num_warmup):
        try:
            model.generate(prompt, max_new_tokens=max_new_tokens, temperature=0.0)
        except Exception:  # pragma: no cover
            pass
    total_tokens, total_time = 0, 0.0
    for _ in range(num_runs):
        try:
            t0 = time.perf_counter()
            model.generate(prompt, max_new_tokens=max_new_tokens, temperature=0.0)
            total_time += time.perf_counter() - t0
            total_tokens += max_new_tokens
        except Exception as e:  # pragma: no cover
            logger.warning("throughput run failed: %s", e)
    if total_time == 0:
        return {"throughput_tokens_per_sec": None}
    return {"throughput_tokens_per_sec": total_tokens / total_time}


def measure_batch_throughput(
    model,
    prompt: Optional[str] = None,
    batch_sizes: Sequence[int] = (1, 2, 4, 8),
    max_new_tokens: int = 32,
) -> Dict[str, Any]:
    """Sweep batch sizes; stop early on OOM."""
    prompt = prompt or _PROMPT
    results: Dict[str, Any] = {"batch_throughput": {}}
    best = None
    for bs in batch_sizes:
        prompts = [prompt] * bs
        try:
            model.generate_batch(prompts, max_new_tokens=max_new_tokens, temperature=0.0)
            t0 = time.perf_counter()
            model.generate_batch(prompts, max_new_tokens=max_new_tokens, temperature=0.0)
            dt = time.perf_counter() - t0
            tps = bs * max_new_tokens / dt
            results["batch_throughput"][str(bs)] = tps
            best = max(best or 0.0, tps)
        except Exception as e:  # out of memory or other: stop the sweep
            logger.warning("batch size %d failed (%s); stopping sweep", bs, e)
            break
    if best is not None:
        results["batch_throughput_best_tokens_per_sec"] = best
    return results
