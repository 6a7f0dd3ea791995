"""Text chunking: semantic / sentence / fixed strategies.

The port's own copy of ``crs_tpu.rag.chunking`` (no framework code; kept
separate so this package imports nothing of ``crs_tpu``).

Capability parity with the reference's ``rag/chunking.py``:
- ``Chunk`` dataclass with text, id, char offsets, page, section, token count
  (reference :24-33),
- semantic chunking: paragraph-boundary packing with word-overlap carry
  (reference :104-148),
- sentence chunking: sentence grouping (reference :150-187; punkt replaced by
  our rule-based splitter),
- fixed chunking: word windows with overlap (reference :189-217),
- globally monotonically increasing ids ``chunk_N`` (reference :98-102),
- overlap = the last ``chunk_overlap`` words of the previous chunk
  (reference :235-242).

Token counts are whitespace word counts (the reference's proxy as well).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..utils.sentences import split_sentences

logger = logging.getLogger(__name__)

__all__ = ["Chunk", "TextChunker"]


@dataclass
class Chunk:
    text: str
    chunk_id: str
    start_char: int = 0
    end_char: int = 0
    page_number: Optional[int] = None
    section: Optional[str] = None
    tokens: int = 0

    def to_metadata(self) -> Dict[str, Any]:
        return {
            "page_number": self.page_number if self.page_number is not None else -1,
            "section": self.section or "",
            "tokens": self.tokens,
        }


class TextChunker:
    """Stateful chunker with a global monotonically increasing id counter."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.strategy = config.get("strategy", "semantic")
        self.chunk_size = int(config.get("chunk_size", 512))
        self.chunk_overlap = int(config.get("chunk_overlap", 128))
        self.min_chunk_size = int(config.get("min_chunk_size", 150))
        if self.strategy not in ("semantic", "sentence", "fixed"):
            raise ValueError(f"unknown chunking strategy: {self.strategy}")
        if self.chunk_overlap >= self.chunk_size:
            raise ValueError("chunk_overlap must be smaller than chunk_size")
        self._next_id = 0

    def reset_ids(self) -> None:
        self._next_id = 0

    def _new_id(self) -> str:
        cid = f"chunk_{self._next_id}"
        self._next_id += 1
        return cid

    # -- public ------------------------------------------------------------
    def chunk(
        self,
        text: str,
        page_number: Optional[int] = None,
        section: Optional[str] = None,
    ) -> List[Chunk]:
        if not text or not text.strip():
            return []
        if self.strategy == "semantic":
            parts = self._semantic_chunking(text)
        elif self.strategy == "sentence":
            parts = self._sentence_chunking(text)
        else:
            parts = self._fixed_chunking(text)
        chunks: List[Chunk] = []
        cursor = 0
        for part in parts:
            words = part.split()
            if len(words) < max(1, self.min_chunk_size) and len(parts) > 1:
                # Too-small trailing fragments are dropped unless they are the
                # only content (mirrors the reference's min_chunk_size gate).
                if part is not parts[-1] or chunks:
                    continue
            start = text.find(part[:50], cursor)
            if start < 0:
                start = cursor
            end = start + len(part)
            cursor = max(cursor, start)
            chunks.append(
                Chunk(
                    text=part,
                    chunk_id=self._new_id(),
                    start_char=start,
                    end_char=end,
                    page_number=page_number,
                    section=section,
                    tokens=len(words),
                )
            )
        return chunks

    # -- strategies ---------------------------------------------------------
    def _semantic_chunking(self, text: str) -> List[str]:
        """Pack paragraphs up to chunk_size words, carrying word overlap."""
        paragraphs = [p.strip() for p in re.split(r"\n\s*\n|\n", text) if p.strip()]
        chunks: List[str] = []
        current: List[str] = []  # words
        for para in paragraphs:
            words = para.split()
            if len(current) + len(words) <= self.chunk_size:
                current.extend(words)
                continue
            if current:
                chunks.append(" ".join(current))
                current = self._overlap_words(current)
            # A single paragraph larger than chunk_size is window-split.
            while len(words) > self.chunk_size - len(current):
                space = self.chunk_size - len(current)
                current.extend(words[:space])
                chunks.append(" ".join(current))
                current = self._overlap_words(current)
                words = words[space:]
            current.extend(words)
        if current:
            chunks.append(" ".join(current))
        return chunks

    def _sentence_chunking(self, text: str) -> List[str]:
        """Group whole sentences up to chunk_size words."""
        sentences = split_sentences(text)
        chunks: List[str] = []
        current: List[str] = []
        count = 0
        for sent in sentences:
            n = len(sent.split())
            if count + n > self.chunk_size and current:
                chunks.append(" ".join(current))
                carry = self._overlap_words(" ".join(current).split())
                current = [" ".join(carry)] if carry else []
                count = len(carry)
            current.append(sent)
            count += n
        if current:
            chunks.append(" ".join(current))
        return chunks

    def _fixed_chunking(self, text: str) -> List[str]:
        """Sliding word windows of chunk_size with chunk_overlap words."""
        words = text.split()
        if not words:
            return []
        step = self.chunk_size - self.chunk_overlap
        chunks = []
        for start in range(0, len(words), step):
            window = words[start : start + self.chunk_size]
            chunks.append(" ".join(window))
            if start + self.chunk_size >= len(words):
                break
        return chunks

    def _overlap_words(self, words: List[str]) -> List[str]:
        if self.chunk_overlap <= 0:
            return []
        return words[-self.chunk_overlap :]
