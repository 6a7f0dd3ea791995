"""Tokenizers for the embedding stack (the port's own copy of
``crs_tpu.models.tokenizer``: pure Python, the same ids).

Two implementations behind one interface (``encode(text) -> List[int]``):

- ``WordPieceTokenizer`` — BERT-style basic tokenization (lowercasing, accent
  stripping, punctuation/CJK splitting) + greedy longest-match WordPiece.
  Loads a standard ``vocab.txt``; used when real MiniLM weights are available.
  (Capability parity with the sentence-transformers tokenizer used at
  reference ``rag/embedding.py:33``.)
- ``HashTokenizer`` — deterministic, vocabulary-free fallback for zero-egress
  environments: words map to stable hash buckets. Combined with a fixed
  random projection encoder this yields meaningful lexical-similarity
  embeddings without any downloaded artifacts.
"""

from __future__ import annotations

import hashlib
import unicodedata
from typing import Dict, List, Optional

__all__ = ["WordPieceTokenizer", "HashTokenizer", "basic_tokenize"]

_PUNCT_CATEGORIES = ("P",)


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith(_PUNCT_CATEGORIES)


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0xF900 <= cp <= 0xFAFF
        or 0x20000 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT BasicTokenizer behavior: NFD-strip accents, split punct and CJK."""
    if lowercase:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out: List[str] = []
    current: List[str] = []

    def flush() -> None:
        if current:
            out.append("".join(current))
            current.clear()

    for ch in text:
        if ch.isspace():
            flush()
        elif _is_punct(ch) or _is_cjk(ch):
            flush()
            out.append(ch)
        else:
            current.append(ch)
    flush()
    return out


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT vocab."""

    def __init__(
        self,
        vocab: Dict[str, int],
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_input_chars_per_word: int = 100,
        lowercase: bool = True,
    ):
        self.vocab = vocab
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_input_chars_per_word = max_input_chars_per_word
        self.lowercase = lowercase

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """[CLS] tokens [SEP], truncated to max_length."""
        ids = [self.cls_id]
        for word in basic_tokenize(text, self.lowercase):
            ids.extend(self._wordpiece(word))
        ids.append(self.sep_id)
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id]
        return ids


class HashTokenizer:
    """Vocabulary-free tokenizer: stable blake2 hash of each word → bucket id.

    ids 0..3 are reserved (pad/cls/sep/unk) so they line up with typical
    embedding-table layouts.
    """

    RESERVED = 4

    def __init__(self, vocab_size: int = 30522, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_id, self.cls_id, self.sep_id, self.unk_id = 0, 1, 2, 3

    def _bucket(self, word: str) -> int:
        h = hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest()
        return self.RESERVED + int.from_bytes(h, "big") % (self.vocab_size - self.RESERVED)

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = [self.cls_id]
        ids.extend(self._bucket(w) for w in basic_tokenize(text, self.lowercase))
        ids.append(self.sep_id)
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id]
        return ids
