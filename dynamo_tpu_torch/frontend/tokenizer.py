"""Tokenizers and incremental (streaming) detokenization.

Port of dynamo_tpu/frontend/tokenizer.py `Tokenizer`, `ByteTokenizer`,
`IncrementalDetokenizer` and `load_tokenizer`. The byte tokenizer (ids
0..255 are raw bytes, 256 BOS, 257 EOS) needs no model assets. The
reference reads a model's tokenizer.json through the `tokenizers`
package, which the machine with the card does not have; the port has no
reader of its own yet, so `load_tokenizer` refuses such a path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class Tokenizer:
    bos_id: Optional[int] = None
    eos_id: Optional[int] = None
    vocab_size: int = 0

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError


class ByteTokenizer(Tokenizer):
    """ids 0..255 = raw bytes; 256 = BOS, 257 = EOS."""

    BOS = 256
    EOS = 257

    def __init__(self):
        self.bos_id = self.BOS
        self.eos_id = self.EOS
        self.vocab_size = 258

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


def load_tokenizer(spec: Optional[str]) -> Tokenizer:
    """spec: None or 'byte' → ByteTokenizer; a tokenizer.json path raises,
    as the port has no reader for it yet."""
    if not spec or spec == "byte":
        return ByteTokenizer()
    raise ValueError(
        f"tokenizer {spec!r}: the port reads no tokenizer.json yet (the "
        "reference reads it through the `tokenizers` package, which this "
        "port does not use); serve the model with --tokenizer byte")


class IncrementalDetokenizer:
    """Streaming token → text that emits text only once it is
    unambiguous: decode the whole prefix, emit the delta beyond what was
    emitted, and hold back trailing replacement characters (a partial
    UTF-8 sequence)."""

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._emitted = 0  # chars of decode(self._ids) already emitted

    def push(self, ids: Sequence[int]) -> str:
        self._ids.extend(ids)
        text = self._tok.decode(self._ids)
        safe_end = len(text)
        while safe_end > 0 and text[safe_end - 1] == "�":
            safe_end -= 1
        delta = text[self._emitted:safe_end]
        self._emitted = safe_end
        return delta

    def finish(self) -> str:
        text = self._tok.decode(self._ids)
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta
