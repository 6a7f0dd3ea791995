from .base import BenchmarkResult, ModelBenchmark
from .runner import ComprehensiveResults, EvaluationRunner

__all__ = [
    "BenchmarkResult",
    "ModelBenchmark",
    "ComprehensiveResults",
    "EvaluationRunner",
]
