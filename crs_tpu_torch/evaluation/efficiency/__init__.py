from .benchmark import EfficiencyBenchmark, EfficiencyResults

__all__ = ["EfficiencyBenchmark", "EfficiencyResults"]
