"""Accelerator spec table (port of ``crs_tpu.evaluation.efficiency.device_specs``).

Peak bf16 / int8 rates, memory rate, memory size and TDP by device name,
the same rows as ``crs_tpu``'s (TPU generations and GPUs). A name matches
the row whose key is its longest substring: ``torch.cuda.get_device_name``
of an H100 ("NVIDIA H100 80GB HBM3") matches ``"h100"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

__all__ = ["DEVICE_SPECS", "detect_device_name", "get_device_specs", "detect_tdp",
           "detect_peak_tflops", "detect_hbm_gbps"]

# name → {tdp_w, peak_bf16_tflops, peak_int8_tops, memory_gb, hbm_gbps}
DEVICE_SPECS: Dict[str, Dict[str, float]] = {
    # TPU generations (public cloud specs)
    "tpu v2": {"tdp_w": 280.0, "peak_bf16_tflops": 45.0, "peak_int8_tops": 45.0, "memory_gb": 8.0, "hbm_gbps": 600.0},
    "tpu v3": {"tdp_w": 220.0, "peak_bf16_tflops": 61.0, "peak_int8_tops": 61.0, "memory_gb": 16.0, "hbm_gbps": 900.0},
    "tpu v4": {"tdp_w": 170.0, "peak_bf16_tflops": 137.5, "peak_int8_tops": 275.0, "memory_gb": 32.0, "hbm_gbps": 1200.0},
    "tpu v5 lite": {"tdp_w": 140.0, "peak_bf16_tflops": 197.0, "peak_int8_tops": 394.0, "memory_gb": 16.0, "hbm_gbps": 820.0},
    "tpu v5e": {"tdp_w": 140.0, "peak_bf16_tflops": 197.0, "peak_int8_tops": 394.0, "memory_gb": 16.0, "hbm_gbps": 820.0},
    "tpu v5p": {"tdp_w": 350.0, "peak_bf16_tflops": 459.0, "peak_int8_tops": 918.0, "memory_gb": 95.0, "hbm_gbps": 2765.0},
    "tpu v6": {"tdp_w": 300.0, "peak_bf16_tflops": 918.0, "peak_int8_tops": 1836.0, "memory_gb": 32.0, "hbm_gbps": 1640.0},
    # GPUs
    "t4": {"tdp_w": 70.0, "peak_bf16_tflops": 65.0, "peak_int8_tops": 130.0, "memory_gb": 16.0, "hbm_gbps": 300.0},
    "v100": {"tdp_w": 300.0, "peak_bf16_tflops": 125.0, "peak_int8_tops": 125.0, "memory_gb": 16.0, "hbm_gbps": 900.0},
    "a100": {"tdp_w": 400.0, "peak_bf16_tflops": 312.0, "peak_int8_tops": 624.0, "memory_gb": 40.0, "hbm_gbps": 1555.0},
    "h100": {"tdp_w": 700.0, "peak_bf16_tflops": 989.0, "peak_int8_tops": 1979.0, "memory_gb": 80.0, "hbm_gbps": 3350.0},
    "h200": {"tdp_w": 700.0, "peak_bf16_tflops": 989.0, "peak_int8_tops": 1979.0, "memory_gb": 141.0, "hbm_gbps": 4800.0},
    "l4": {"tdp_w": 72.0, "peak_bf16_tflops": 121.0, "peak_int8_tops": 242.0, "memory_gb": 24.0, "hbm_gbps": 300.0},
    "cpu": {"tdp_w": 100.0, "peak_bf16_tflops": 1.0, "peak_int8_tops": 2.0, "memory_gb": 64.0, "hbm_gbps": 50.0},
}

_DEFAULT = DEVICE_SPECS["tpu v5e"]


def detect_device_name(device: Optional[Union[str, torch.device]] = None) -> str:
    """The lower-cased name of ``device``: ``torch.cuda.get_device_name`` of
    a CUDA device, "cpu" for the CPU. ``None`` means the current CUDA device
    when there is one, else the CPU."""
    try:
        dev = torch.device(device if device is not None else
                           ("cuda" if torch.cuda.is_available() else "cpu"))
        if dev.type == "cuda":
            return torch.cuda.get_device_name(dev).lower()
        return dev.type
    except Exception:
        return "unknown"


def get_device_specs(name: Optional[str] = None) -> Dict[str, Any]:
    """Spec row by longest name-substring match."""
    device = (name or detect_device_name()).lower()
    best, best_len = None, 0
    for key, specs in DEVICE_SPECS.items():
        if key in device and len(key) > best_len:
            best, best_len = specs, len(key)
    specs = dict(best or _DEFAULT)
    specs["device_name"] = device
    specs["matched"] = best is not None
    return specs


def detect_tdp(name: Optional[str] = None) -> float:
    return float(get_device_specs(name)["tdp_w"])


def detect_peak_tflops(name: Optional[str] = None, dtype: str = "bf16") -> float:
    s = get_device_specs(name)
    return float(s["peak_int8_tops"] if dtype == "int8" else s["peak_bf16_tflops"])


def detect_hbm_gbps(name: Optional[str] = None) -> float:
    return float(get_device_specs(name)["hbm_gbps"])
