"""Vocabulary builder, ported from ``glint_word2vec_tpu/data/vocab.py``.

Count words, drop those with count < min_count, sort by descending count (stable on
first-seen order for ties), assign indices in that order, and record the total count of
retained training words. Word index order == matrix row order == descending frequency,
the contract both packages' checkpoints rely on.

The parallel slab counter and the native file-corpus counter of the JAX package are not
ported: both produce the identical vocabulary as the serial counter below, so they only
change wall clock.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence

import numpy as np


@dataclass
class Vocabulary:
    """Words sorted by descending corpus frequency: ``words[i]`` has count
    ``counts[i]`` and ``index[word] == i``."""

    words: List[str]
    counts: np.ndarray  # int64 [vocab_size]
    index: Dict[str, int] = field(repr=False)
    train_words_count: int = 0

    @property
    def size(self) -> int:
        return len(self.words)

    def __len__(self) -> int:
        return len(self.words)

    def __contains__(self, word: str) -> bool:
        return word in self.index

    def get(self, word: str, default: int = -1) -> int:
        return self.index.get(word, default)

    @classmethod
    def from_words_and_counts(cls, words: Sequence[str], counts: Sequence[int]) -> "Vocabulary":
        counts = np.asarray(counts, dtype=np.int64)
        index = {w: i for i, w in enumerate(words)}
        return cls(words=list(words), counts=counts, index=index,
                   train_words_count=int(counts.sum()))

    @classmethod
    def from_counter(cls, counter: "collections.Counter[str]", min_count: int) -> "Vocabulary":
        items = [(w, c) for w, c in counter.items() if c >= min_count]
        if not items:
            raise ValueError(
                "The vocabulary size should be > 0. You may need to check the setting of "
                "min_count, which could be large enough to remove all your words in sentences.")
        items.sort(key=lambda wc: -wc[1])  # stable: ties keep first-seen order
        words = [w for w, _ in items]
        counts = np.fromiter((c for _, c in items), dtype=np.int64, count=len(items))
        index = {w: i for i, w in enumerate(words)}
        return cls(words=words, counts=counts, index=index,
                   train_words_count=int(counts.sum()))


def count_words(sentences: Iterable[Sequence[str]]) -> "collections.Counter[str]":
    counter: "collections.Counter[str]" = collections.Counter()
    for sentence in sentences:
        counter.update(sentence)
    return counter


def build_vocab(sentences: Iterable[Sequence[str]], min_count: int = 5) -> Vocabulary:
    """Count -> filter(min_count) -> sort descending -> index."""
    return Vocabulary.from_counter(count_words(sentences), min_count)
