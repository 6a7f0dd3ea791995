"""Hashed n-gram featurization: native C++ fast path + exact Python path.

The port's own copy of ``crs_tpu.rag.hashed_features``. Algorithm spec
(shared verbatim with ``native/text_native.cpp`` — both paths MUST produce
identical features):

- lowercase ASCII; word chars = ``[a-z0-9]`` plus any byte ≥ 0x80,
- grams = unigrams + adjacent bigrams joined with ``\\x1f``,
- bucket = FNV-1a-64(gram) mod num_features,
- weight = 1 + ln(count).

The ``*_counts`` variant additionally supports char 3/4-grams per word
(``^``/``$`` boundary-padded, windows only when the padded word is strictly
longer than n) and returns RAW counts.

``native/text_native.cpp`` is compiled with ``g++`` into this package's own
build directory at first use (plain ``ctypes`` over its ``extern "C"`` API).
When the compiler is missing the Python path runs, with a warning; the two
give identical output.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._build import REPO_ROOT, build_library

logger = logging.getLogger(__name__)

__all__ = [
    "featurize", "featurize_batch", "featurize_batch_counts", "native_available",
    "build_native",
]

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_MASK = (1 << 64) - 1

NATIVE_SOURCE = os.path.join(REPO_ROOT, "native", "text_native.cpp")
_LIB_NAME = "libtext_native.so"

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def build_native():
    """Compile the featurizer when stale; returns the build result."""
    return build_library(NATIVE_SOURCE, _LIB_NAME)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    try:
        lib = ctypes.CDLL(build_native().path)
    except (RuntimeError, OSError) as e:
        logger.warning("native featurizer unavailable (%s); using the Python path", e)
        return None
    lib.featurize.restype = ctypes.c_int
    lib.featurize.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.featurize_batch_ex.restype = ctypes.c_int
    lib.featurize_batch_ex.argtypes = [
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.float32),
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int,
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


# -- pure-Python spec implementation ----------------------------------------

def _fnv1a(data: bytes, h: int = _FNV_OFFSET) -> int:
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def _tokenize_bytes(text: str) -> List[bytes]:
    raw = text.encode("utf-8")
    words: List[bytes] = []
    current = bytearray()
    for b in raw:
        if 65 <= b <= 90:  # ASCII uppercase → lowercase
            b += 32
        if (97 <= b <= 122) or (48 <= b <= 57) or b >= 0x80:
            current.append(b)
        elif current:
            words.append(bytes(current))
            current = bytearray()
    if current:
        words.append(bytes(current))
    return words


def _count_py(
    text: str, num_features: int, char_ngrams: bool = False, word_grams: bool = True
) -> Dict[int, int]:
    words = _tokenize_bytes(text)
    counts: Dict[int, int] = {}
    if word_grams:
        for w in words:
            idx = _fnv1a(w) % num_features
            counts[idx] = counts.get(idx, 0) + 1
        for a, b in zip(words, words[1:]):
            idx = _fnv1a(a + b"\x1f" + b) % num_features
            counts[idx] = counts.get(idx, 0) + 1
    if char_ngrams:
        for w in words:
            # native path caps words at 256 bytes before padding
            padded = b"^" + w[:256] + b"$"
            for n in (3, 4):
                if len(padded) > n:
                    for i in range(len(padded) - n + 1):
                        idx = _fnv1a(padded[i : i + n]) % num_features
                        counts[idx] = counts.get(idx, 0) + 1
    return counts


def _featurize_py(text: str, num_features: int) -> Dict[int, float]:
    counts = _count_py(text, num_features)
    # float32 rounding matches the native path bit-for-bit
    return {i: float(np.float32(1.0) + np.log(np.float32(c))) for i, c in counts.items()}


def _csr(rows: Sequence[Dict[int, float]]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    indices: List[int] = []
    weights: List[float] = []
    offsets = [0]
    for f in rows:
        indices.extend(f.keys())
        weights.extend(float(v) for v in f.values())
        offsets.append(len(indices))
    return (
        np.asarray(indices, np.int64),
        np.asarray(weights, np.float32),
        np.asarray(offsets, np.int64),
    )


def _featurize_batch_py(texts: Sequence[str], num_features: int):
    return _csr([_featurize_py(t, num_features) for t in texts])


def _count_batch_py(texts: Sequence[str], num_features: int, char_ngrams: bool,
                    word_grams: bool):
    return _csr([_count_py(t, num_features, char_ngrams, word_grams) for t in texts])


_NATIVE_PIECE_BYTES = 1 << 24  # text bytes a featurize_batch_ex call takes
_NATIVE_MAX_OUT = (1 << 31) - 1  # its output capacity and count are C ints


def _native_batch(lib, texts: Sequence[str], num_features: int, mode: int,
                  per_char: int):
    """``featurize_batch_ex`` over runs of texts of at most
    _NATIVE_PIECE_BYTES bytes (one text at least), so that each call's
    output capacity fits its C int; the pieces' CSR rows concatenated.
    None when a buffer overflowed."""
    encoded = [t.encode("utf-8") for t in texts]
    cum = np.zeros(len(texts) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=cum[1:])
    out_off = np.zeros(len(texts) + 1, np.int64)
    idx_parts, w_parts = [np.zeros(0, np.int64)], [np.zeros(0, np.float32)]
    start = 0
    while start < len(texts):
        end = int(np.searchsorted(cum, cum[start] + _NATIVE_PIECE_BYTES, side="right")) - 1
        end = min(max(end, start + 1), len(texts))
        blob = b"".join(encoded[start:end])
        cap = max(per_char * len(blob) + 16 * (end - start) + 256, 1024)
        if cap > _NATIVE_MAX_OUT:
            return None
        out_idx = np.zeros(cap, np.int64)
        out_w = np.zeros(cap, np.float32)
        off = np.zeros(end - start + 1, np.int64)
        n = lib.featurize_batch_ex(
            blob, cum[start:end + 1] - cum[start], end - start, num_features, mode,
            out_idx, out_w, off, cap
        )
        if n < 0:
            return None
        idx_parts.append(out_idx[:n].copy())
        w_parts.append(out_w[:n].copy())
        out_off[start + 1:end + 1] = off[1:] + out_off[start]
        start = end
    return np.concatenate(idx_parts), np.concatenate(w_parts), out_off


# -- public API ---------------------------------------------------------------

def featurize(text: str, num_features: int) -> Dict[int, float]:
    lib = _load()
    if lib is None:
        return _featurize_py(text, num_features)
    raw = text.encode("utf-8")
    cap = max(2 * len(raw) + 16, 256)
    idx = (ctypes.c_longlong * cap)()
    w = (ctypes.c_float * cap)()
    n = lib.featurize(raw, len(raw), num_features, idx, w, cap)
    if n < 0:
        return _featurize_py(text, num_features)
    return {int(idx[i]): float(w[i]) for i in range(n)}


def featurize_batch(
    texts: Sequence[str], num_features: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR-style batch featurization: (indices, weights, offsets[n+1])."""
    lib = _load()
    if lib is not None:
        out = _native_batch(lib, texts, num_features, mode=0, per_char=2)
        if out is not None:
            return out
        # overflow: text by text through the per-text entry point
        return _csr([featurize(t, num_features) for t in texts])
    return _featurize_batch_py(texts, num_features)


def featurize_batch_counts(
    texts: Sequence[str], num_features: int, char_ngrams: bool = True,
    parts: str = "both",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR-style batch featurization with RAW counts (+ optional char n-grams):
    (indices, counts, offsets[n+1]). ``parts``: "both", "word" (uni/bigrams
    only) or "char" (char 3/4-grams only)."""
    if parts == "word":
        char_ngrams = False
    word_grams = parts != "char"
    mode = 2 | (1 if char_ngrams else 0) | (0 if word_grams else 4)
    lib = _load()
    if lib is not None:
        out = _native_batch(lib, texts, num_features, mode, per_char=8 if char_ngrams else 2)
        if out is not None:
            return out
    return _count_batch_py(texts, num_features, char_ngrams, word_grams)
