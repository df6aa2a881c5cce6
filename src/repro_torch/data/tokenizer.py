"""SSV 'Sequence Encoding': term dictionary with ids in descending collection
frequency (better packing: frequent terms get small ids), encode/decode
(a copy of ``repro.data.tokenizer``, which is numpy only: the port imports
nothing of ``repro``)."""
from __future__ import annotations

from collections import Counter

import numpy as np


class TermDictionary:
    def __init__(self, terms_by_freq: list[str]):
        self.id_to_term = [None] + list(terms_by_freq)       # id 0 = PAD/separator
        self.term_to_id = {t: i for i, t in enumerate(self.id_to_term) if t}

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_term) - 1

    @classmethod
    def build(cls, documents: list[list[str]]) -> "TermDictionary":
        cnt = Counter(t for doc in documents for t in doc)
        return cls([t for t, _ in cnt.most_common()])

    def encode(self, documents: list[list[str]]) -> np.ndarray:
        out: list[int] = []
        for doc in documents:
            out.extend(self.term_to_id[t] for t in doc)
            out.append(0)
        return np.asarray(out, np.int32)

    def decode_gram(self, ids) -> tuple[str, ...]:
        return tuple(self.id_to_term[int(i)] for i in ids if int(i) != 0)


def sentences(text: str) -> list[list[str]]:
    """Whitespace tokenizer with '.'/'?'/'!' sentence boundaries (the paper uses
    OpenNLP; boundaries are n-gram barriers either way)."""
    docs: list[list[str]] = []
    cur: list[str] = []
    for raw in text.split():
        term = raw.strip(",;:\"'()[]").lower()
        end = raw and raw[-1] in ".?!"
        if term.strip(".?!"):
            cur.append(term.strip(".?!"))
        if end and cur:
            docs.append(cur)
            cur = []
    if cur:
        docs.append(cur)
    return docs
