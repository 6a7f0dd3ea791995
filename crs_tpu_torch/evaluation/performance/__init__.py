from .perplexity import PerplexityEvaluator
from .benchmark import PerformanceBenchmark, PerformanceResults

__all__ = ["PerplexityEvaluator", "PerformanceBenchmark", "PerformanceResults"]
