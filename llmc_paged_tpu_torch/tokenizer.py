"""Decode-only byte tokenizer (reference: Tokenizer, train_gpt2.c:1068-1143;
a copy of llmc_paged_tpu/tokenizer.py).

The reference tokenizer only decodes: token id → raw bytes, with a
"safe print" filter that suppresses single non-printable bytes
(safe_printf, train_gpt2.c:1074-1087). Encoding lives in the prepro
scripts via tiktoken; the repository's `tools/prepro_text.py` covers that
side.
"""

from __future__ import annotations

from typing import List, Optional

from llmc_paged_tpu_torch import formats


class Tokenizer:
    def __init__(self, table: List[bytes]):
        self.table = table
        self.vocab_size = len(table)

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        return cls(formats.read_tokenizer_bin(path))

    def decode(self, token_id: int) -> Optional[bytes]:
        if 0 <= token_id < self.vocab_size:
            return self.table[token_id]
        return None

    def decode_safe(self, token_id: int) -> str:
        """Printable decode, matching safe_printf semantics: a 1-byte token
        that is neither printable nor whitespace renders as ''."""
        piece = self.decode(token_id)
        if not piece:
            return ""
        if len(piece) == 1:
            b = piece[0]
            # isprint(b) || isspace(b) in C's default locale
            if not (32 <= b < 127 or b in (9, 10, 11, 12, 13, 32)):
                return ""
        return piece.decode("utf-8", errors="replace")

    def decode_string(self, token_ids) -> str:
        return "".join(self.decode_safe(int(t)) for t in token_ids)


def byte_fallback_table(vocab_size: int = 256) -> List[bytes]:
    """A minimal synthetic vocabulary (one token per byte, cycled) used for
    tests and for running tiny models without a real GPT-2 tokenizer file."""
    return [bytes([i % 256]) if i % 256 else b"\x00" for i in range(vocab_size)]
