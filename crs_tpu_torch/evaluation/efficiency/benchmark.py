"""Efficiency benchmark (port of ``crs_tpu.evaluation.efficiency.benchmark``).

``EfficiencyBenchmark.run_all`` runs the measurements in a fixed order —
static info → latency → TTFT → prefill / decode → throughput → batch sweep
→ memory → FLOPs / MFU → prefill MFU → memory-rate roofline → energy →
an optional profiler trace → the baseline comparison — each stage isolated
(a failure is logged and its metrics are left out). The device's name, and
so its spec row, is the model's device's.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from ..base import BenchmarkResult, ModelBenchmark
from . import device_specs, energy, flops, latency, memory, throughput

logger = logging.getLogger(__name__)

__all__ = ["EfficiencyBenchmark", "EfficiencyResults"]


class EfficiencyResults(BenchmarkResult):
    pass


class EfficiencyBenchmark(ModelBenchmark[EfficiencyResults]):
    def __init__(self, model, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        self.model = model
        cfg = self.config
        self.num_warmup = int(cfg.get("num_warmup", 3))
        self.num_runs = int(cfg.get("num_runs", 10))
        self.max_new_tokens = int(cfg.get("max_new_tokens", 32))
        self.prompts = cfg.get("prompts")
        self.batch_sizes = cfg.get("batch_sizes", (1, 2, 4, 8))
        self.baseline: Optional[Dict[str, float]] = cfg.get("baseline")

    def run_all(self) -> EfficiencyResults:
        m: Dict[str, Any] = {}

        def stage(name, fn):
            try:
                m.update(fn() or {})
            except Exception as e:  # pragma: no cover - each stage isolated
                logger.warning("efficiency stage %s failed: %s", name, e)

        # static info
        stage("model_size", lambda: memory.get_model_size(self.model))
        stage("param_count", lambda: memory.get_parameter_count(self.model))
        stage("bits", lambda: memory.get_bits_per_param(self.model))
        dev_name = device_specs.detect_device_name(self.model.device)
        m["device"] = dev_name

        # timing
        stage("latency", lambda: latency.measure_latency(
            self.model, self.prompts, self.max_new_tokens, self.num_warmup, self.num_runs))
        stage("ttft", lambda: latency.measure_ttft(self.model, self.prompts))
        stage("prefill_decode", lambda: latency.measure_prefill_decode_latency(
            self.model, max_new_tokens=self.max_new_tokens))
        stage("throughput", lambda: throughput.measure_throughput(
            self.model, max_new_tokens=self.max_new_tokens))
        stage("batch_throughput", lambda: throughput.measure_batch_throughput(
            self.model, batch_sizes=self.batch_sizes, max_new_tokens=self.max_new_tokens))

        # memory
        stage("device_memory", lambda: memory.get_device_memory(self.model.device))
        stage("memory_efficiency", lambda: memory.get_memory_efficiency(
            (m.get("model_size_gb") or 0) * 1000.0, m.get("device_memory_peak_mb")))
        cfg_obj = self.model.cfg
        stage("kv_cache", lambda: memory.estimate_kv_cache_size(
            cfg_obj.num_layers, cfg_obj.num_kv_heads, cfg_obj.head_dim))

        # compute
        stage("flops", lambda: flops.estimate_flops_per_token(cfg_obj))
        stage("mfu", lambda: flops.calculate_mfu(
            m.get("gflops_per_token"), m.get("throughput_tokens_per_sec"), dev_name,
            dtype="int8" if (m.get("quantization") or "").startswith("int") else "bf16"))

        # roofline rows: batched MFU + memory-rate use next to the
        # single-stream MFU — decode is bandwidth-bound, so
        # single-stream mfu_percent alone invites a misread
        def _batched_mfu():
            best = m.get("batch_throughput_best_tokens_per_sec")
            out = flops.calculate_mfu(
                m.get("gflops_per_token"), best, dev_name,
                dtype="int8" if (m.get("quantization") or "").startswith("int") else "bf16")
            return ({"mfu_batched_percent": out["mfu_percent"]}
                    if out.get("mfu_percent") is not None else {})

        stage("mfu_batched", _batched_mfu)
        # compute-bound regime: prefill MFU at batch>=8
        # — the one row where MFU is the honest efficiency metric
        stage("prefill_mfu", lambda: latency.measure_prefill_mfu(
            self.model,
            batch=int(self.config.get("prefill_mfu_batch", 8)),
            seq_len=int(self.config.get("prefill_mfu_seq_len", 512)),
            dtype="int8" if (m.get("quantization") or "").startswith("int") else "bf16",
            device_name=dev_name))
        stage("bandwidth", lambda: flops.calculate_bandwidth_utilization(
            m.get("model_size_gb"), m.get("decode_ms_per_token"), dev_name))

        # energy
        stage("energy", lambda: energy.estimate_energy_per_token(m.get("latency_ms_per_token"),
                                                                 dev_name))
        stage("total_energy", lambda: energy.estimate_total_energy(
            m.get("energy_per_token_mj"),
            num_tokens=self.num_runs * self.max_new_tokens))

        # optional torch.profiler trace of one generate call
        if self.config.get("capture_profile"):
            def _trace():
                from ...utils.profiling import capture_trace

                _, trace_dir = capture_trace(
                    lambda: self.model.generate("profile trace prompt", max_new_tokens=8),
                    self.config.get("profile_dir"),
                )
                return {"profile_trace_dir": trace_dir}

            stage("profile", _trace)

        # baseline comparison (compression / speedup / memory reduction)
        if self.baseline:
            b = self.baseline
            if m.get("model_size_gb") and b.get("model_size_gb"):
                m["compression_ratio"] = b["model_size_gb"] / m["model_size_gb"]
            if m.get("latency_ms_per_token") and b.get("latency_ms_per_token"):
                m["speedup_vs_baseline"] = b["latency_ms_per_token"] / m["latency_ms_per_token"]
            if m.get("device_memory_peak_mb") and b.get("peak_memory_mb"):
                m["memory_reduction"] = b["peak_memory_mb"] / m["device_memory_peak_mb"]

        return EfficiencyResults(
            name="efficiency",
            metrics=m,
            metadata={"model": self.model.get_model_info(), "config": dict(self.config)},
        )
