"""Latency, fenced on the device (port of ``crs_tpu.evaluation.efficiency.latency``).

- ``measure_latency``: warm-ups, then timed greedy generates; ms/token
  mean, std, min and max,
- ``measure_ttft``: time to the first token (``max_new_tokens=1``),
- ``measure_prefill_decode_latency``: the on-device forward (fenced with
  ``torch.cuda.synchronize``, its logits not copied) against generate
  minus a one-token generate,
- ``measure_prefill_mfu``: batched prefill MFU, the compute-bound regime.

A generate returns host strings, so its time is fenced already. Every loop
tolerates a failed iteration.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...utils.profiling import fence_outputs

logger = logging.getLogger(__name__)

__all__ = [
    "measure_latency", "measure_ttft", "measure_prefill_decode_latency",
    "measure_prefill_mfu",
]

_DEFAULT_PROMPTS = [
    "The key idea of model quantization is",
    "Retrieval augmented generation improves answers by",
    "In distributed training, tensor parallelism splits",
    "The transformer attention mechanism computes",
]


def _timed_generate(model, prompt: str, max_new_tokens: int) -> float:
    t0 = time.perf_counter()
    model.generate(prompt, max_new_tokens=max_new_tokens, temperature=0.0)
    return time.perf_counter() - t0


def measure_latency(
    model,
    prompts: Optional[Sequence[str]] = None,
    max_new_tokens: int = 32,
    num_warmup: int = 3,
    num_runs: int = 10,
) -> Dict[str, Any]:
    """Per-token decode latency stats over repeated greedy generates."""
    prompts = list(prompts or _DEFAULT_PROMPTS)
    for i in range(num_warmup):
        try:
            _timed_generate(model, prompts[i % len(prompts)], max_new_tokens)
        except Exception as e:  # pragma: no cover
            logger.warning("warmup failed: %s", e)
    times: List[float] = []
    for i in range(num_runs):
        prompt = prompts[i % len(prompts)]
        try:
            times.append(_timed_generate(model, prompt, max_new_tokens))
        except Exception as e:  # pragma: no cover - error tolerant like ref
            logger.warning("latency run %d failed: %s", i, e)
    if not times:
        return {"latency_ms_per_token": None}
    per_token = np.array(times) * 1000.0 / max_new_tokens
    return {
        "latency_ms_per_token": float(per_token.mean()),
        "latency_ms_per_token_std": float(per_token.std()),
        "latency_ms_per_token_min": float(per_token.min()),
        "latency_ms_per_token_max": float(per_token.max()),
        "latency_num_runs": len(times),
        "latency_max_new_tokens": max_new_tokens,
    }


def measure_ttft(
    model,
    prompts: Optional[Sequence[str]] = None,
    num_warmup: int = 2,
    num_runs: int = 5,
) -> Dict[str, Any]:
    """Time to first token: one-token generates."""
    prompts = list(prompts or _DEFAULT_PROMPTS)
    for i in range(num_warmup):
        try:
            _timed_generate(model, prompts[i % len(prompts)], 1)
        except Exception:  # pragma: no cover
            pass
    times = []
    for i in range(num_runs):
        try:
            times.append(_timed_generate(model, prompts[i % len(prompts)], 1))
        except Exception as e:  # pragma: no cover
            logger.warning("ttft run failed: %s", e)
    if not times:
        return {"ttft_ms": None}
    arr = np.array(times) * 1000.0
    return {"ttft_ms": float(arr.mean()), "ttft_ms_std": float(arr.std())}


def measure_prefill_decode_latency(
    model,
    prompt: Optional[str] = None,
    max_new_tokens: int = 32,
    num_runs: int = 5,
) -> Dict[str, Any]:
    """Split prefill (forward-only) from decode (generate minus prefill)."""
    prompt = prompt or _DEFAULT_PROMPTS[0]
    try:
        seq = model.tokenizer.encode(prompt)
        # padded to a power-of-two bucket, as generate pads its prompts
        blen = 32
        while blen < len(seq):
            blen *= 2
        ids = np.zeros((1, blen), np.int32)
        ids[0, : len(seq)] = seq
    except Exception:
        ids = None

    prefill_times = []
    if ids is not None:
        # on the device, fenced: the logits are not copied to the host
        fwd = model.forward_device
        try:
            fence_outputs(fwd(ids))  # warm
            for _ in range(num_runs):
                t0 = time.perf_counter()
                fence_outputs(fwd(ids))
                prefill_times.append(time.perf_counter() - t0)
        except Exception as e:  # pragma: no cover
            logger.warning("prefill measurement failed: %s", e)

    total_times = []
    try:
        _timed_generate(model, prompt, max_new_tokens)
        for _ in range(num_runs):
            total_times.append(_timed_generate(model, prompt, max_new_tokens))
    except Exception as e:  # pragma: no cover
        logger.warning("decode measurement failed: %s", e)

    # One-token generates give prefill+first-token without the full-logits
    # host transfer that a raw forward would include.
    first_token_times = []
    try:
        model.generate(prompt, max_new_tokens=1, temperature=0.0)
        for _ in range(num_runs):
            t0 = time.perf_counter()
            model.generate(prompt, max_new_tokens=1, temperature=0.0)
            first_token_times.append(time.perf_counter() - t0)
    except Exception as e:  # pragma: no cover
        logger.warning("first-token measurement failed: %s", e)

    out: Dict[str, Any] = {}
    if prefill_times:
        out["prefill_ms"] = float(np.mean(prefill_times) * 1000.0)
    if total_times and first_token_times:
        decode_s = max(np.mean(total_times) - np.mean(first_token_times), 0.0)
        out["decode_ms_per_token"] = float(decode_s * 1000.0 / max(max_new_tokens - 1, 1))
    elif total_times:
        out["decode_ms_per_token"] = float(np.mean(total_times) * 1000.0 / max_new_tokens)
    return out


def measure_prefill_mfu(
    model,
    batch: int = 8,
    seq_len: int = 512,
    num_runs: int = 5,
    dtype: str = "bf16",
    device_name: Optional[str] = None,
) -> Dict[str, Any]:
    """Compute-bound MFU: batched prefill over long prompts.

    Decode is bandwidth-bound, so its MFU is structurally tiny on any
    hardware (the roofline row ``hbm_utilization_percent`` is the honest
    decode metric); prefill is the regime where the tensor cores run large
    matmuls and MFU means what it says. Analytic FLOPs use the
    causal-average attention span S/2.
    """
    cfg = model.cfg
    seq_len = min(seq_len, cfg.max_seq_len)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size, (batch, seq_len)).astype(np.int32)
    # forward() copies the full [B, S, V] f32 logits to the host (~0.5 GB
    # at 1b dims): time the on-device forward, fenced, instead
    fwd = model.forward_device
    try:
        fence_outputs(fwd(ids))  # warm
        times = []
        for _ in range(num_runs):
            t0 = time.perf_counter()
            fence_outputs(fwd(ids))
            times.append(time.perf_counter() - t0)
    except Exception as e:  # pragma: no cover
        logger.warning("prefill MFU measurement failed: %s", e)
        return {}
    from .flops import calculate_mfu, flops_breakdown

    dt = float(np.median(times))
    bd = flops_breakdown(cfg, seq_len=seq_len // 2)
    tok_per_s = batch * seq_len / dt
    mfu = calculate_mfu(bd["total_flops_per_token"] / 1e9, tok_per_s, device_name, dtype=dtype)
    if mfu.get("mfu_percent") is None:
        return {}
    return {
        "prefill_mfu_percent": mfu["mfu_percent"],
        "prefill_tflops_achieved": mfu.get("achieved_tflops"),
        "prefill_batch": batch,
        "prefill_seq_len": seq_len,
        "prefill_tokens_per_sec": tok_per_s,
    }
