"""Analytic FLOPs, MFU and memory-rate use (port of ``crs_tpu.evaluation.efficiency.flops``).

FLOPs per token from the model's dims (q/k/v, attention over ``seq_len``
keys, output projection, gated MLP, LM head), MFU = FLOPs · tokens/s over
the device's peak from the spec table, and the decode roofline row: weight
(and KV) bytes per token over ms per token against the memory rate.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .device_specs import detect_hbm_gbps, detect_peak_tflops

__all__ = [
    "estimate_flops_per_token",
    "calculate_mfu",
    "flops_breakdown",
    "calculate_bandwidth_utilization",
]


def _dims(cfg) -> Dict[str, int]:
    return {
        "d": cfg.hidden_size,
        "L": cfg.num_layers,
        "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads,
        "hd": cfg.head_dim,
        "ffn": cfg.intermediate_size,
        "vocab": cfg.vocab_size,
    }


def flops_breakdown(cfg, seq_len: int = 1) -> Dict[str, float]:
    """FLOPs per generated token (decode regime: attention over seq_len keys)."""
    m = _dims(cfg)
    d, hd = m["d"], m["hd"]
    qkv = 2 * d * (m["heads"] * hd + 2 * m["kv_heads"] * hd)
    attn = 2 * 2 * m["heads"] * hd * seq_len  # scores + context
    out_proj = 2 * m["heads"] * hd * d
    mlp = 2 * 3 * d * m["ffn"]  # gate, up, down
    per_layer = qkv + attn + out_proj + mlp
    lm_head = 2 * d * m["vocab"]
    return {
        "qkv_flops": float(m["L"] * qkv),
        "attention_flops": float(m["L"] * attn),
        "out_proj_flops": float(m["L"] * out_proj),
        "mlp_flops": float(m["L"] * mlp),
        "lm_head_flops": float(lm_head),
        "total_flops_per_token": float(m["L"] * per_layer + lm_head),
    }


def estimate_flops_per_token(cfg, seq_len: int = 512) -> Dict[str, Any]:
    bd = flops_breakdown(cfg, seq_len)
    return {
        "gflops_per_token": bd["total_flops_per_token"] / 1e9,
        "flops_seq_len": seq_len,
    }


def calculate_mfu(
    gflops_per_token: Optional[float],
    throughput_tokens_per_sec: Optional[float],
    device_name: Optional[str] = None,
    dtype: str = "bf16",
) -> Dict[str, Any]:
    if not gflops_per_token or not throughput_tokens_per_sec:
        return {"mfu_percent": None}
    peak_tflops = detect_peak_tflops(device_name, dtype)
    achieved_tflops = gflops_per_token * throughput_tokens_per_sec / 1000.0
    return {
        "mfu_percent": 100.0 * achieved_tflops / peak_tflops,
        "achieved_tflops": achieved_tflops,
        "peak_tflops": peak_tflops,
    }


def calculate_bandwidth_utilization(
    model_size_gb: Optional[float],
    decode_ms_per_token: Optional[float],
    device_name: Optional[str] = None,
    kv_read_gb_per_token: float = 0.0,
) -> Dict[str, Any]:
    """The memory-rate roofline row.

    Single-stream decode reads every weight byte once per token, so the
    achieved streaming rate is ``(model bytes + KV read bytes) / latency``
    against the device HBM peak. This — not MFU — is the binding roofline
    for decode: a bandwidth-bound kernel at 85% of HBM peak can sit at
    <1% MFU while being near speed-of-light. Reported next to
    ``mfu_percent`` so the single-stream MFU is never read as the
    efficiency headline.
    """
    if not model_size_gb or not decode_ms_per_token:
        return {"hbm_utilization_percent": None}
    peak_gbps = detect_hbm_gbps(device_name)
    achieved_gbps = (model_size_gb + kv_read_gb_per_token) / (
        decode_ms_per_token / 1000.0
    )
    return {
        "hbm_gbps_achieved": achieved_gbps,
        "hbm_gbps_peak": peak_gbps,
        "hbm_utilization_percent": 100.0 * achieved_gbps / peak_gbps,
        "decode_roofline": "bandwidth-bound",
    }
