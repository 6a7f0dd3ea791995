"""Document ingestion: PDF / TXT / MD → cleaned per-page text + sections.

The port's own copy of ``crs_tpu.rag.document_processing``, with its own
copy of the PDF extractor (``utils/pdftext.py``).

Capability parity with the reference's ``rag/document_processing.py``:
- per-page PDF extraction (reference :60-90; here via our own extractor since
  the image has no PDF library),
- TXT/MD ingestion (reference :92-115),
- text cleaning rules (reference ``_clean_text`` :129-167): whitespace
  normalization, page-number/header lines, bracketed citations ``[1]`` and
  parenthetical ``(Author, 2020)`` citations, URLs, OCR ligatures, smart
  quotes,
- section extraction by header patterns (reference :169-218).
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ..utils.pdftext import extract_pdf_pages

logger = logging.getLogger(__name__)

__all__ = ["DocumentProcessor"]

_LIGATURES = {
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl",
    "ﬃ": "ffi", "ﬄ": "ffl",
    "‘": "'", "’": "'", "“": '"', "”": '"',
    "–": "-", "—": "-", " ": " ",
}

_SECTION_HEADER_RES = [
    re.compile(r"^\s*(\d+(?:\.\d+)*)\.?\s+([A-Z][^\n]{2,80})$"),
    re.compile(
        r"^\s*(abstract|introduction|background|related work|methods?|methodology"
        r"|experiments?|results?|discussion|conclusions?|references|appendix"
        r"|acknowledg\w*)\s*$",
        re.IGNORECASE,
    ),
]

# stopwords allowed lowercase inside a title-case header ("Metrics and
# Benchmarks"); a header may not START or END with one
_HEADER_STOPWORDS = frozenset(
    "and of for in with on a the to vs via from by at or as".split()
)


def _match_titlecase_header(stripped: str) -> bool:
    """Unnumbered title-case header on its own line (round 4): many PDFs —
    including the bundled survey, whose body headings are all unnumbered
    after cleaning — mark sections as short standalone Title-Case lines
    ("Post-Training Quantization"). Accept 1–7 words, ≤60 chars, no
    terminal punctuation, every non-stopword capitalized, and no leading/
    trailing stopword (rejects sentence fragments that happen to be short).
    """
    if not stripped or len(stripped) > 60 or stripped[-1] in ".:;,!?)":
        return False
    words = stripped.split()
    if not 1 <= len(words) <= 7:
        return False
    if any(ch.isdigit() for ch in stripped[:2]):
        return False  # numbered headings are the first regex's job
    alpha = [w for w in words if w[0].isalpha()]
    if not alpha or not alpha[0][0].isupper():
        return False
    content = [w for w in alpha if w.lower() not in _HEADER_STOPWORDS]
    if not content or any(not w[0].isupper() for w in content):
        return False
    if words[0].lower() in _HEADER_STOPWORDS or words[-1].lower() in _HEADER_STOPWORDS:
        return False
    return True


class DocumentProcessor:
    """Load and clean documents into ``(text, page_number)`` tuples."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.clean_text_enabled = config.get("clean_text", True)
        self.extract_sections_enabled = config.get("extract_sections", True)
        self.remove_citations = config.get("remove_citations", True)
        self.remove_urls = config.get("remove_urls", True)

    # -- entry points ------------------------------------------------------
    def process_file(self, path: str) -> List[Tuple[str, int]]:
        suffix = Path(path).suffix.lower()
        if suffix == ".pdf":
            return self.process_pdf(path)
        if suffix in (".txt", ".md", ".text", ""):
            return self.process_text_file(path)
        raise ValueError(f"unsupported document type: {suffix}")

    def process_pdf(self, path: str) -> List[Tuple[str, int]]:
        pages = extract_pdf_pages(path)
        out: List[Tuple[str, int]] = []
        for i, page in enumerate(pages, start=1):
            text = self._clean_text(page) if self.clean_text_enabled else page
            if text.strip():
                out.append((text, i))
        logger.info("Processed PDF %s: %d non-empty pages", path, len(out))
        return out

    def process_text_file(self, path: str) -> List[Tuple[str, int]]:
        with open(path, encoding="utf-8", errors="replace") as f:
            raw = f.read()
        return self.process_text(raw)

    def process_text(self, raw: str) -> List[Tuple[str, int]]:
        """Plain text: treated as a single page (page 1), like the reference."""
        text = self._clean_text(raw) if self.clean_text_enabled else raw
        return [(text, 1)] if text.strip() else []

    # -- cleaning ----------------------------------------------------------
    def _clean_text(self, text: str) -> str:
        for bad, good in _LIGATURES.items():
            text = text.replace(bad, good)
        # Drop bare page-number lines and "Page N" headers.
        text = re.sub(r"^\s*(?:page\s+)?\d{1,4}\s*$", "", text, flags=re.M | re.I)
        if self.remove_urls:
            text = re.sub(r"https?://\S+|www\.\S+", "", text)
        if self.remove_citations:
            # Bracketed numeric citations: [1], [2, 3], [4-6]
            text = re.sub(r"\[\d+(?:\s*[,–-]\s*\d+)*\]", "", text)
            # Parenthetical author-year citations: (Smith et al., 2020)
            text = re.sub(
                r"\(\s*[A-Z][A-Za-z.\- ]+(?:et al\.?)?,?\s+(?:19|20)\d{2}[a-z]?"
                r"(?:\s*;\s*[A-Z][A-Za-z.\- ]+(?:et al\.?)?,?\s+(?:19|20)\d{2}[a-z]?)*\s*\)",
                "",
                text,
            )
        # Whitespace normalization: collapse runs but preserve paragraph breaks.
        text = re.sub(r"[ \t]+", " ", text)
        text = re.sub(r" ?\n ?", "\n", text)
        text = re.sub(r"\n{3,}", "\n\n", text)
        return text.strip()

    # -- sections ----------------------------------------------------------
    def extract_sections(self, text: str) -> List[Tuple[str, str]]:
        """Split text into ``(section_title, section_text)`` by header lines."""
        if not self.extract_sections_enabled:
            return [("", text)]
        sections: List[Tuple[str, List[str]]] = [("", [])]
        for line in text.split("\n"):
            title = self._match_header(line)
            if title is not None:
                sections.append((title, []))
            else:
                sections[-1][1].append(line)
        out = [(t, "\n".join(ls).strip()) for t, ls in sections]
        return [(t, body) for t, body in out if body or t]

    def section_spans(
        self, text: str, default_title: str = ""
    ) -> List[Tuple[str, int, int]]:
        """``(title, start_char, end_char)`` per section of ``text``.

        LABELING pass (round 4): unlike :meth:`extract_sections` (which
        drives chunk boundaries and deliberately keeps the conservative
        numbered/keyword header rules so chunk geometry is stable), this
        additionally recognizes unnumbered Title-Case headers
        (``_match_titlecase_header``) — the dominant heading style of the
        bundled survey after PDF cleaning — so chunks can inherit their
        section identity as metadata/features without re-chunking.
        """
        spans: List[Tuple[str, int, int]] = []
        title, start, pos = default_title, 0, 0
        for line in text.split("\n"):
            stripped = line.strip()
            matched = self._match_header(line)
            if matched is None and _match_titlecase_header(stripped):
                matched = stripped
            if matched is not None:
                if pos > start or title:
                    spans.append((title, start, pos))
                title = matched
                start = pos + len(line) + 1
            pos += len(line) + 1
        spans.append((title, start, len(text)))
        return [s for s in spans if s[2] > s[1] or s[0]]

    @staticmethod
    def _match_header(line: str) -> Optional[str]:
        stripped = line.strip()
        if not stripped or len(stripped) > 90:
            return None
        for rx in _SECTION_HEADER_RES:
            m = rx.match(stripped)
            if m:
                return stripped
        return None
