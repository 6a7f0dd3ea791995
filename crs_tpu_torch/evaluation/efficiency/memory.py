"""Memory accounting (port of ``crs_tpu.evaluation.efficiency.memory``).

Model size, parameter count and bits per parameter from the model's info;
device memory from ``torch.cuda.memory_allocated`` /
``max_memory_allocated`` and the device's total; the analytic KV-cache size
``2·L·B·H_kv·S·hd·bytes``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Union

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "get_model_size",
    "get_parameter_count",
    "get_bits_per_param",
    "get_device_memory",
    "get_memory_efficiency",
    "estimate_kv_cache_size",
]


def get_model_size(model) -> Dict[str, Any]:
    info = model.get_model_info()
    return {
        "model_size_gb": info.get("model_size_gb"),
        "model_size_mb": (info.get("model_size_gb") or 0.0) * 1000.0,
    }


def get_parameter_count(model) -> Dict[str, Any]:
    info = model.get_model_info()
    n = info.get("num_parameters", 0)
    return {"num_parameters": n, "num_parameters_b": n / 1e9}


def get_bits_per_param(model) -> Dict[str, Any]:
    info = model.get_model_info()
    return {
        "bits_per_param": info.get("bits_per_param"),
        "quantization": info.get("quantization"),
    }


def get_device_memory(device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """Memory of ``device`` (default: the current CUDA device when there is
    one): bytes allocated now, the peak since the process started (never
    reset here) and the device's total. The CPU exposes none: None."""
    none = {"device_memory_in_use_mb": None, "device_memory_peak_mb": None}
    try:
        dev = torch.device(device if device is not None else
                           ("cuda" if torch.cuda.is_available() else "cpu"))
        if dev.type != "cuda":
            return none
        in_use = torch.cuda.memory_allocated(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        if peak == 0:
            return none
        return {
            "device_memory_in_use_mb": in_use / 1e6,
            "device_memory_peak_mb": peak / 1e6,
            "device_memory_limit_mb": torch.cuda.get_device_properties(dev).total_memory / 1e6,
        }
    except Exception as e:  # pragma: no cover - CUDA runtime dependent
        logger.warning("memory stats unavailable: %s", e)
        return none


def get_memory_efficiency(model_size_mb: Optional[float], peak_mb: Optional[float]) -> Dict[str, Any]:
    """size/peak ratio."""
    if not model_size_mb or not peak_mb:
        return {"memory_efficiency": None}
    return {"memory_efficiency": model_size_mb / peak_mb}


def estimate_kv_cache_size(
    num_layers: int,
    num_kv_heads: int,
    head_dim: int,
    seq_len: int = 2048,
    batch_size: int = 1,
    bytes_per_elem: int = 2,
) -> Dict[str, Any]:
    """Analytic 2·L·B·Hkv·S·hd·bytes."""
    size = 2 * num_layers * batch_size * num_kv_heads * seq_len * head_dim * bytes_per_elem
    return {"kv_cache_size_mb": size / 1e6, "kv_cache_seq_len": seq_len}
