"""The port's RAG layer: text, hashed embedding, int8 store, retriever."""

from .chunking import Chunk, TextChunker
from .document_processing import DocumentProcessor
from .embedding import EmbeddingModel, HashedEncoder
from .index import VectorStore
from .retrieval import ContextRetriever

__all__ = [
    "Chunk", "TextChunker", "DocumentProcessor", "EmbeddingModel", "HashedEncoder",
    "VectorStore", "ContextRetriever",
]
