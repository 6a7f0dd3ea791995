"""Byte-level tokenizer: the zero-artifact default for the causal LM (port
of ``crs_tpu.models.bytes_tokenizer``).

Ids 0–255 are raw bytes; BOS, EOS and PAD live above. Works with every
``TransformerConfig`` whose vocab_size is at least 259.
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    BOS = 256
    EOS = 257
    PAD = 258
    VOCAB_SIZE = 259

    def __init__(self, add_bos: bool = True):
        self.add_bos = add_bos
        self.bos_id, self.eos_id, self.pad_id = self.BOS, self.EOS, self.PAD

    def encode(self, text: str, max_length: Optional[int] = None, add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if self.add_bos:
            ids = [self.BOS] + ids
        if add_eos:
            ids.append(self.EOS)
        if max_length is not None and len(ids) > max_length:
            ids = ids[:max_length]
        return ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")
