"""The port's RAG layer: text, embedding (hashed, lexical LSA, MiniLM),
fp32/bf16/int8/pq store, retriever, answer generation and the pipeline."""

from .chunking import Chunk, TextChunker
from .document_processing import DocumentProcessor
from .embedding import EmbeddingModel, HashedEncoder, LexicalLSAEncoder
from .generation import RAGGenerator
from .index import VectorStore
from .pipeline import RAGPipeline
from .retrieval import ContextRetriever

__all__ = [
    "Chunk", "TextChunker", "DocumentProcessor", "EmbeddingModel", "HashedEncoder",
    "LexicalLSAEncoder",
    "VectorStore", "ContextRetriever", "RAGGenerator", "RAGPipeline",
]
