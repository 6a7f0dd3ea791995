"""Minimal, dependency-free PDF text extraction (the port's own copy of
``crs_tpu.utils.pdftext``, which is pure Python).

The runtime image has no PDF library, so the document-processing layer
(capability parity with the reference's PyPDF2 path,
``rag/document_processing.py:60-90``) ships its own extractor. Scope is
deliberately narrow but covers the common machine-generated PDF shape:

- classic ``N 0 obj … endobj`` object syntax (no object streams / xref streams
  for the page tree itself are required — objects are discovered by scanning),
- ``FlateDecode`` (zlib) content streams, or uncompressed streams,
- page order recovered by walking the ``/Pages`` → ``/Kids`` tree,
- simple (byte-encoded) fonts and composite Type0 / Identity-H CID fonts with
  ``/ToUnicode`` CMaps (``bfchar`` + ``bfrange``),
- text extracted from ``BT``/``ET`` blocks via ``Tj``, ``'``, ``"``, and ``TJ``
  operators, with newlines inferred from text-matrix vertical movement.

Everything returns plain Python strings; no third-party imports.
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = ["extract_pdf_pages", "extract_pdf_text", "PdfParseError"]


class PdfParseError(ValueError):
    """Raised when a PDF cannot be parsed by this minimal extractor."""


_OBJ_RE = re.compile(rb"(\d+)\s+0\s+obj(.*?)endobj", re.S)
_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.S)
_REF_RE = re.compile(rb"(\d+)\s+0\s+R")


def _parse_objects(data: bytes) -> Dict[int, bytes]:
    objs: Dict[int, bytes] = {}
    for m in _OBJ_RE.finditer(data):
        objs[int(m.group(1))] = m.group(2)
    if not objs:
        raise PdfParseError("no PDF objects found")
    return objs


def _get_stream(body: bytes) -> Optional[bytes]:
    m = _STREAM_RE.search(body)
    if m is None:
        return None
    raw = m.group(1)
    if b"/FlateDecode" in body[: m.start()]:
        try:
            return zlib.decompress(raw)
        except zlib.error:
            # Tolerate trailing garbage after the deflate payload.
            return zlib.decompressobj().decompress(raw)
    return raw


def _dict_region(body: bytes) -> bytes:
    """The dictionary portion of an object body (before any stream)."""
    m = _STREAM_RE.search(body)
    return body[: m.start()] if m else body


# ---------------------------------------------------------------------------
# ToUnicode CMap parsing
# ---------------------------------------------------------------------------

_HEX_PAIR_RE = re.compile(rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>")
_BFRANGE_RE = re.compile(
    rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*(<[0-9A-Fa-f]+>|\[(?:[^\]]*)\])"
)


def _hex_to_unicode(h: bytes) -> str:
    """A ToUnicode destination hex string → Python string (UTF-16BE)."""
    raw = bytes.fromhex(h.decode("ascii"))
    if len(raw) % 2:
        raw = b"\x00" + raw
    return raw.decode("utf-16-be", errors="replace")


def _parse_tounicode(cmap: bytes) -> Dict[int, str]:
    """Parse bfchar/bfrange sections of a ToUnicode CMap into cid→str."""
    table: Dict[int, str] = {}
    for m in re.finditer(rb"beginbfchar(.*?)endbfchar", cmap, re.S):
        for src, dst in _HEX_PAIR_RE.findall(m.group(1)):
            table[int(src, 16)] = _hex_to_unicode(dst)
    for m in re.finditer(rb"beginbfrange(.*?)endbfrange", cmap, re.S):
        for lo, hi, dst in _BFRANGE_RE.findall(m.group(1)):
            lo_i, hi_i = int(lo, 16), int(hi, 16)
            if dst.startswith(b"["):
                dsts = re.findall(rb"<([0-9A-Fa-f]+)>", dst)
                for off, d in enumerate(dsts):
                    if lo_i + off <= hi_i:
                        table[lo_i + off] = _hex_to_unicode(d)
            else:
                base_hex = dst.strip(b"<>")
                base_str = _hex_to_unicode(base_hex)
                # Incrementing ranges apply to the last code unit.
                base_cp = ord(base_str[-1]) if base_str else 0
                prefix = base_str[:-1]
                for off in range(hi_i - lo_i + 1):
                    table[lo_i + off] = prefix + chr(base_cp + off)
    return table


@dataclass
class _Font:
    """Per-font decoding state: 1- or 2-byte codes + optional cid→unicode."""

    two_byte: bool = False
    tounicode: Optional[Dict[int, str]] = None

    def decode(self, raw: bytes) -> str:
        step = 2 if self.two_byte else 1
        out: List[str] = []
        for i in range(0, len(raw) - (step - 1), step):
            cid = int.from_bytes(raw[i : i + step], "big")
            if self.tounicode is not None:
                out.append(self.tounicode.get(cid, ""))
            else:
                out.append(chr(cid) if 32 <= cid < 127 or cid in (9, 10, 13) else "")
        return "".join(out)


def _resolve(objs: Dict[int, bytes], body: bytes, key: bytes) -> Optional[bytes]:
    """Look up `key` in a dict body; follow a single indirect reference."""
    m = re.search(re.escape(key) + rb"\s*(\d+)\s+0\s+R", body)
    if m:
        return objs.get(int(m.group(1)))
    return None


def _load_fonts(objs: Dict[int, bytes], page_body: bytes) -> Dict[bytes, _Font]:
    """Map font resource names (e.g. b'F4') to decoders for one page."""
    resources = _dict_region(page_body)
    ind = _resolve(objs, resources, b"/Resources")
    if ind is not None:
        resources = _dict_region(ind)
    fm = re.search(rb"/Font\s*<<(.*?)>>", resources, re.S)
    font_dict = fm.group(1) if fm else b""
    if not fm:
        ind = _resolve(objs, resources, b"/Font")
        if ind is not None:
            font_dict = _dict_region(ind)
    fonts: Dict[bytes, _Font] = {}
    for name, ref in re.findall(rb"/(\w+)\s+(\d+)\s+0\s+R", font_dict):
        fbody = objs.get(int(ref))
        if fbody is None:
            continue
        fdict = _dict_region(fbody)
        font = _Font()
        if re.search(rb"/Subtype\s*/Type0", fdict) or b"Identity-H" in fdict:
            font.two_byte = True
        tu = _resolve(objs, fdict, b"/ToUnicode")
        if tu is not None:
            stream = _get_stream(tu)
            if stream:
                font.tounicode = _parse_tounicode(stream)
        fonts[name] = font
    return fonts


# ---------------------------------------------------------------------------
# Page tree walking
# ---------------------------------------------------------------------------

def _page_order(objs: Dict[int, bytes]) -> List[int]:
    """Ordered leaf /Page object numbers, by walking the /Pages tree."""
    pages_nodes = {
        n: b for n, b in objs.items() if re.search(rb"/Type\s*/Pages", _dict_region(b))
    }
    children: Dict[int, List[int]] = {}
    has_parent = set()
    for n, b in pages_nodes.items():
        kids_m = re.search(rb"/Kids\s*\[(.*?)\]", _dict_region(b), re.S)
        kids = [int(x) for x in _REF_RE.findall(kids_m.group(1))] if kids_m else []
        children[n] = kids
        has_parent.update(kids)
    roots = [n for n in pages_nodes if n not in has_parent]
    order: List[int] = []

    def walk(n: int) -> None:
        if n in children:  # interior /Pages node
            for k in children[n]:
                walk(k)
        else:  # leaf /Page
            body = objs.get(n)
            if body is not None and re.search(rb"/Type\s*/Page\b", _dict_region(body)):
                order.append(n)

    for r in sorted(roots):
        walk(r)
    if not order:  # fallback: document order of /Page objects
        order = sorted(
            n for n, b in objs.items() if re.search(rb"/Type\s*/Page[^s]", _dict_region(b))
        )
    return order


def _content_streams(objs: Dict[int, bytes], page_body: bytes) -> bytes:
    m = re.search(rb"/Contents\s*(\[(?:[^\]]*)\]|\d+\s+0\s+R)", _dict_region(page_body))
    if m is None:
        return b""
    refs = [int(x) for x in _REF_RE.findall(m.group(1))]
    parts = []
    for r in refs:
        body = objs.get(r)
        if body is None:
            continue
        s = _get_stream(body)
        if s:
            parts.append(s)
    return b"\n".join(parts)


# ---------------------------------------------------------------------------
# Content stream interpretation
# ---------------------------------------------------------------------------

# Tokens: hex string, literal string, name, number, array delimiters, operator.
_TOKEN_RE = re.compile(
    rb"<[0-9A-Fa-f\s]*>"          # hex string
    rb"|\((?:\\.|[^\\()])*\)"      # literal string (no nested parens)
    rb"|/[^\s/<>\[\]()]+"          # name
    rb"|[-+]?\d*\.?\d+"            # number
    rb"|\[|\]"
    rb"|[A-Za-z'\"*]+"             # operator
)

_ESCAPES = {
    b"n": "\n", b"r": "\r", b"t": "\t", b"b": "\b", b"f": "\f",
    b"(": "(", b")": ")", b"\\": "\\",
}


def _decode_literal(tok: bytes, font: _Font) -> str:
    """Decode a (…) literal string token under the current font."""
    body = tok[1:-1]
    out = bytearray()
    i = 0
    while i < len(body):
        c = body[i : i + 1]
        if c == b"\\" and i + 1 < len(body):
            nxt = body[i + 1 : i + 2]
            if nxt.isdigit():  # octal escape, up to 3 digits
                j = i + 1
                while j < len(body) and j < i + 4 and body[j : j + 1].isdigit():
                    j += 1
                out.append(int(body[i + 1 : j], 8) & 0xFF)
                i = j
                continue
            esc = _ESCAPES.get(nxt)
            if esc is not None:
                out.extend(esc.encode("latin-1"))
            i += 2
            continue
        out += c
        i += 1
    return font.decode(bytes(out))


def _extract_page_text(content: bytes, fonts: Dict[bytes, _Font]) -> str:
    """Interpret text operators in one page's content stream."""
    default_font = _Font()
    font = next(iter(fonts.values()), default_font)
    lines: List[str] = []
    current: List[str] = []
    last_name: Optional[bytes] = None
    stack: List[bytes] = []  # recent number/name operands (small sliding window)
    in_text = False
    cur_y: Optional[float] = None

    def newline() -> None:
        nonlocal current
        line = "".join(current)
        if line.strip():
            lines.append(line)
        current = []

    for m in _TOKEN_RE.finditer(content):
        tok = m.group(0)
        c0 = tok[:1]
        if c0 == b"/":
            last_name = tok[1:]
            stack.append(tok)
            if len(stack) > 8:
                stack.pop(0)
        elif c0 in b"<(":
            if in_text:
                text = (
                    _decode_literal(tok, font)
                    if c0 == b"("
                    else font.decode(bytes.fromhex(re.sub(rb"\s", b"", tok[1:-1]).decode("ascii")))
                )
                current.append(text)
        elif c0 in b"[]":
            continue
        elif c0 in b"-+.0123456789":
            stack.append(tok)
            if len(stack) > 8:
                stack.pop(0)
        else:  # operator
            op = tok
            if op == b"BT":
                in_text = True
            elif op == b"ET":
                in_text = False
            elif op == b"Tf" and last_name is not None:
                font = fonts.get(last_name, default_font)
            elif op in (b"Tm",):
                try:
                    y = float(stack[-1])
                except (ValueError, IndexError):
                    y = None
                if y is not None and cur_y is not None and abs(y - cur_y) > 1e-6:
                    newline()
                if y is not None:
                    cur_y = y
            elif op in (b"Td", b"TD"):
                try:
                    ty = float(stack[-1])
                except (ValueError, IndexError):
                    ty = 0.0
                if abs(ty) > 1e-6:
                    newline()
                    if cur_y is not None:
                        cur_y += ty
            elif op == b"T*":
                newline()
            elif op in (b"'", b'"'):
                newline()
    newline()
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def extract_pdf_pages(path: str) -> List[str]:
    """Extract text per page. Returns a list of page strings in order."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"%PDF"):
        raise PdfParseError(f"{path}: not a PDF file")
    objs = _parse_objects(data)
    pages = []
    for pnum in _page_order(objs):
        body = objs[pnum]
        fonts = _load_fonts(objs, body)
        content = _content_streams(objs, body)
        pages.append(_extract_page_text(content, fonts))
    return pages


def extract_pdf_text(path: str) -> str:
    """Extract the full document text with pages separated by form feeds."""
    return "\f".join(extract_pdf_pages(path))
