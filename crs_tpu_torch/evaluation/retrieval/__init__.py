from .retrieval_metrics import RetrievalMetrics
from .rag_metrics import RAGMetrics
from .benchmark import RetrievalBenchmark, RetrievalResults

__all__ = ["RetrievalMetrics", "RAGMetrics", "RetrievalBenchmark", "RetrievalResults"]
