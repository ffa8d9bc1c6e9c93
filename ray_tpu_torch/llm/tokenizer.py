"""Tokenizers for the LLM tier. Port of ``ray_tpu/llm/tokenizer.py``.

``ByteTokenizer`` is the dependency-free default: UTF-8 bytes + 2 specials.
Any object with encode/decode/bos_id/eos_id can stand in for it.
"""

from __future__ import annotations


class ByteTokenizer:
    """vocab: 256 byte values + BOS(256) + EOS(257)."""

    vocab_size = 258

    @property
    def bos_id(self) -> int:
        return 256

    @property
    def eos_id(self) -> int:
        return 257

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.bos_id, *ids] if add_bos else ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", "replace")
