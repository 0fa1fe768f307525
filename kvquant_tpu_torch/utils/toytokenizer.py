"""Minimal whitespace word tokenizer for zero-egress tests and demos (port
of kvquant_tpu/utils/toytokenizer.py).

The eval harnesses only require encode(str) -> list[int] and
decode(list[int]) -> str. Ids are assigned in order of first appearance.
"""

from __future__ import annotations


class WordTokenizer:
    def __init__(self):
        self.vocab: dict[str, int] = {}
        self.inv: list[str] = []

    def encode(self, text: str) -> list[int]:
        ids = []
        for w in text.split():
            if w not in self.vocab:
                self.vocab[w] = len(self.inv)
                self.inv.append(w)
            ids.append(self.vocab[w])
        return ids

    def decode(self, ids) -> str:
        return " ".join(
            self.inv[i] if 0 <= i < len(self.inv) else "<unk>" for i in ids
        )

    @property
    def vocab_size(self) -> int:
        return len(self.inv)
