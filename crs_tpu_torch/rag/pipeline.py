"""End-to-end RAG pipeline (port of ``crs_tpu.rag.pipeline``).

Wires DocumentProcessor → TextChunker → EmbeddingModel → VectorStore →
ContextRetriever → RAGGenerator from the config's sections: ``setup``,
``index_documents`` (a ``.txt`` / ``.md`` path or a list of texts),
``retrieve``, ``retrieve_batch``, ``validate_retrieval``,
``generate_answer``, ``query`` (one retrieve, reused for the context) and
``get_stats``. The store, the embedder and the model run on the pipeline's
device. A persisted index carries the lexical backend's fitted state
(``lexical_state.npz`` beside it): ``setup`` reloads it, and
``index_documents`` fits the embedder on the chunks and saves it there.
``evaluate`` comes with the evaluation slice.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .chunking import Chunk, TextChunker
from .document_processing import DocumentProcessor
from .embedding import EmbeddingModel
from .generation import RAGGenerator
from .index import VectorStore
from .retrieval import ContextRetriever

logger = logging.getLogger(__name__)

__all__ = ["RAGPipeline"]


class RAGPipeline:
    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config or {}
        self.device = device
        self.doc_processor: Optional[DocumentProcessor] = None
        self.chunker: Optional[TextChunker] = None
        self.embedder: Optional[EmbeddingModel] = None
        self.store: Optional[VectorStore] = None
        self.retriever: Optional[ContextRetriever] = None
        self.generator: Optional[RAGGenerator] = None
        self.model_interface = None
        self.num_documents = 0
        self.index_time_s = 0.0

    # -- wiring ---------------------------------------------------------------
    def setup(self, model_interface=None) -> "RAGPipeline":
        cfg = self.config
        self.doc_processor = DocumentProcessor(cfg.get("document_processing"))
        self.chunker = TextChunker(cfg.get("chunking"))
        self.embedder = EmbeddingModel(cfg.get("embedding"), device=self.device)
        self.store = VectorStore(cfg.get("vector_store"), device=self.device)
        if self.store.persist_directory and self.store.n > 0:
            self.embedder.load_state(self.store.persist_directory)
        self.retriever = ContextRetriever(self.store, self.embedder, cfg.get("retrieval"))
        self.model_interface = model_interface
        if model_interface is not None:
            self.generator = RAGGenerator(model_interface, cfg.get("generation"))
        return self

    def _require_setup(self) -> None:
        if self.retriever is None:
            raise RuntimeError("pipeline not set up — call setup() first")

    # -- indexing -------------------------------------------------------------
    def index_documents(self, source: Union[str, Sequence[str]]) -> float:
        """Index a ``.txt`` / ``.md`` path or a list of raw texts; returns
        the seconds it took."""
        self._require_setup()
        t0 = time.perf_counter()
        last_title = ""  # a section runs on across bodies and pages
        pages: List = []
        if isinstance(source, str):
            pages = self.doc_processor.process_file(source)
            self.num_documents = 1
        else:
            for text in source:
                pages.extend(self.doc_processor.process_text(text))
            self.num_documents = len(list(source))
        self.chunker.reset_ids()
        chunks: List[Chunk] = []
        for text, page in pages:
            if not self.doc_processor.extract_sections_enabled:
                chunks.extend(self.chunker.chunk(text, page_number=page))
                continue
            # chunk boundaries from the header rules; each chunk's label is
            # the title-case span it overlaps most
            for title, body in self.doc_processor.extract_sections(text):
                eff_title = title or last_title
                body_chunks = self.chunker.chunk(body, page_number=page,
                                                 section=eff_title or None)
                spans = self.doc_processor.section_spans(body, default_title=eff_title)
                for c in body_chunks:
                    best, best_ov = c.section, 0
                    for t, s0, s1 in spans:
                        ov = min(c.end_char, s1) - max(c.start_char, s0)
                        if ov > best_ov:
                            best, best_ov = t, ov
                    c.section = best or None
                if spans:
                    last_title = spans[-1][0]
                chunks.extend(body_chunks)
        if not chunks:
            raise ValueError("no chunks produced from input documents")
        self.embedder.fit([c.text for c in chunks])
        self.store.create_index(chunks, self.embedder.embed_chunks(chunks))
        if self.store.persist_directory:
            self.embedder.save_state(self.store.persist_directory)
        self.index_time_s = time.perf_counter() - t0
        logger.info("Indexed %d chunks in %.2fs", len(chunks), self.index_time_s)
        return self.index_time_s

    # -- retrieval ------------------------------------------------------------
    def retrieve(self, query: str, top_k: Optional[int] = None) -> List[Dict[str, Any]]:
        self._require_setup()
        return self.retriever.retrieve(query, top_k=top_k)

    def retrieve_batch(self, queries: Sequence[str], top_k: Optional[int] = None):
        self._require_setup()
        return self.retriever.retrieve_batch(queries, top_k=top_k)

    def validate_retrieval(self, query: str, expected_terms: Sequence[str]) -> Dict[str, Any]:
        """Term recall of the retrieved context: a smoke check."""
        chunks = self.retrieve(query)
        context = " ".join(c["text"].lower() for c in chunks)
        found = [t for t in expected_terms if t.lower() in context]
        return {"query": query, "num_chunks": len(chunks), "terms_found": found,
                "term_recall": len(found) / len(expected_terms) if expected_terms else 0.0}

    # -- generation -----------------------------------------------------------
    def generate_answer(self, question: str, context: Optional[str] = None,
                        use_rag: bool = True) -> str:
        self._require_setup()
        if self.generator is None:
            raise RuntimeError("no model interface — call setup(model_interface)")
        if context is None and use_rag:
            context = ContextRetriever.context_from_results(self.retrieve(question))
        return self.generator.generate(question, context or "")

    def query(self, question: str, return_context: bool = False, return_chunks: bool = False,
              use_rag: bool = True) -> Dict[str, Any]:
        """Retrieve once, generate, return the envelope."""
        self._require_setup()
        chunks = self.retrieve(question) if use_rag else []
        context = ContextRetriever.context_from_results(chunks)
        answer = None
        if self.generator is not None:
            answer = self.generator.generate(question, context)
        out: Dict[str, Any] = {"question": question, "answer": answer}
        if return_context:
            out["context"] = context
        if return_chunks:
            out["chunks"] = chunks
        return out

    def evaluate(self, test_questions, compare_no_rag: bool = True):
        raise NotImplementedError("RAGPipeline.evaluate comes with the evaluation slice "
                                  "(ROADMAP: modules to port)")

    # -- stats ----------------------------------------------------------------
    def get_stats(self) -> Dict[str, Any]:
        self._require_setup()
        return {
            "num_documents": self.num_documents,
            "index_time_s": self.index_time_s,
            "vector_store": self.store.get_stats(),
            "embedding": self.embedder.get_stats(),
            "retrieval": {
                "top_k": self.retriever.top_k,
                "similarity_threshold": self.retriever.similarity_threshold,
                "rerank": self.retriever.rerank,
                "diversity_penalty": self.retriever.diversity_penalty,
            },
            "model": self.model_interface.get_model_info() if self.model_interface else None,
        }
