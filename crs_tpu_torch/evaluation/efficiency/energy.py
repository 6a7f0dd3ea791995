"""Energy estimates from the device's TDP (port of ``crs_tpu.evaluation.efficiency.energy``).

``energy_mJ/token = TDP · (1 − idle ratio 0.3) · ms/token``, with total
energy, cost and CO₂ helpers and a comparison of two devices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .device_specs import detect_tdp

__all__ = ["estimate_energy_per_token", "estimate_total_energy", "compare_energy_efficiency"]

IDLE_RATIO = 0.3


def estimate_energy_per_token(
    latency_ms_per_token: Optional[float],
    device_name: Optional[str] = None,
    tdp_w: Optional[float] = None,
) -> Dict[str, Any]:
    if latency_ms_per_token is None:
        return {"energy_per_token_mj": None}
    tdp = tdp_w if tdp_w is not None else detect_tdp(device_name)
    active_w = tdp * (1.0 - IDLE_RATIO)
    energy_mj = active_w * latency_ms_per_token  # W · ms = mJ
    return {
        "energy_per_token_mj": energy_mj,
        "device_tdp_w": tdp,
    }


def estimate_total_energy(
    energy_per_token_mj: Optional[float],
    num_tokens: int,
    electricity_usd_per_kwh: float = 0.12,
    co2_kg_per_kwh: float = 0.4,
) -> Dict[str, Any]:
    if energy_per_token_mj is None:
        return {}
    kwh = energy_per_token_mj * num_tokens / 1e6 / 3600.0
    return {
        "total_energy_kwh": kwh,
        "energy_cost_usd": kwh * electricity_usd_per_kwh,
        "co2_kg": kwh * co2_kg_per_kwh,
    }


def compare_energy_efficiency(a_mj: float, b_mj: float) -> Dict[str, Any]:
    return {
        "energy_ratio": a_mj / b_mj if b_mj else None,
        "more_efficient": "a" if a_mj < b_mj else "b",
    }
