"""Dependency-free sentence segmentation.

The port's own copy of ``crs_tpu.utils.sentences``.

Replaces the reference's NLTK punkt usage (``rag/chunking.py:46-62``) — the
runtime image has no punkt data and zero egress, so we ship a rule-based
splitter: split on sentence-final punctuation followed by whitespace and an
upper-case/digit/opening-quote start, protected by an abbreviation list and a
decimal-number guard.
"""

from __future__ import annotations

import re
from typing import List

__all__ = ["split_sentences"]

# Common abbreviations that should not end a sentence.
_ABBREVIATIONS = {
    "al", "etc", "e.g", "i.e", "cf", "vs", "fig", "figs", "eq", "eqs",
    "sec", "secs", "ref", "refs", "no", "nos", "vol", "pp", "p",
    "dr", "mr", "mrs", "ms", "prof", "st", "jr", "sr", "inc", "ltd",
    "dept", "univ", "approx", "resp", "ca", "est",
}

_BOUNDARY_RE = re.compile(r'(?<=[.!?])(["\')\]]*)\s+(?=["\'(\[]*[A-Z0-9])')


def _ends_with_abbreviation(text: str) -> bool:
    m = re.search(r"([A-Za-z][A-Za-z.]*)\.$", text)
    if not m:
        return False
    word = m.group(1).rstrip(".").lower()
    if word in _ABBREVIATIONS:
        return True
    # Single capital letter: an initial ("J. Smith").
    if len(word) == 1 and m.group(1)[0].isupper():
        return True
    return False


def split_sentences(text: str) -> List[str]:
    """Split text into sentences. Whitespace-normalizes each sentence."""
    text = re.sub(r"\s+", " ", text).strip()
    if not text:
        return []
    pieces: List[str] = []
    start = 0
    for m in _BOUNDARY_RE.finditer(text):
        end = m.end(1)
        candidate = text[start:end]
        if _ends_with_abbreviation(candidate.rstrip("\"')]")):
            continue
        # Decimal guard: "3.5 B parameters" — digit on both sides of the dot.
        if re.search(r"\d\.$", candidate) and re.match(r"\d", text[m.end():] or " "):
            continue
        if candidate.strip():
            pieces.append(candidate.strip())
        start = m.end()
    tail = text[start:].strip()
    if tail:
        pieces.append(tail)
    return pieces
