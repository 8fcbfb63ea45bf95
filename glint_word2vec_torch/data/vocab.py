"""Vocabulary builder, ported from ``glint_word2vec_tpu/data/vocab.py``.

Count words, drop those with count < min_count, sort by descending count (stable on
first-seen order for ties), assign indices in that order, and record the total count of
retained training words. Word index order == matrix row order == descending frequency,
the contract both packages' checkpoints rely on.

Besides the serial counter, :func:`build_vocab` has the JAX package's two other routes,
each giving the same vocabulary: a token-file corpus (:class:`.corpus.TokenFileCorpus`)
is counted by the native C++ pass (:mod:`.ingest_native`) when it is built, and
``workers > 1`` counts slabs on a thread pool where that can pay
(:func:`parallel_counting_profitable`).
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Sequence

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


def _count_slab(slab: List[Sequence[str]]) -> "collections.Counter[str]":
    """Count one slab of sentences. ``Counter`` keeps first-seen key order, which the
    slab-order merge relies on (equal counts rank by first appearance)."""
    counter: "collections.Counter[str]" = collections.Counter()
    for s in slab:
        counter.update(s.tolist() if isinstance(s, np.ndarray) else s)
    return counter


def merge_counts(counters: Iterable["collections.Counter[str]"]) -> "collections.Counter[str]":
    total: "collections.Counter[str]" = collections.Counter()
    for c in counters:
        total.update(c)
    return total


def count_words_parallel(
    sentences: Iterable[Sequence[str]],
    workers: int = 1,
    slab_sentences: int = 50_000,
) -> "collections.Counter[str]":
    """Count slabs of ``slab_sentences`` sentences on a ``workers``-thread pool and
    merge them in slab order, so the counts and the Counter's iteration order (the
    tie-break of equal counts) equal the serial :func:`count_words`'s at any worker
    count. ``Counter.update`` holds the GIL, so on a stock CPython this is no faster
    (:func:`parallel_counting_profitable`)."""
    from glint_word2vec_torch.data.pipeline import ordered_pool_map

    def slabs():
        slab: List[Sequence[str]] = []
        for s in sentences:
            slab.append(s)
            if len(slab) >= slab_sentences:
                yield slab
                slab = []
        if slab:
            yield slab

    return merge_counts(ordered_pool_map(_count_slab, slabs(), workers))


def build_vocab(sentences: Iterable[Sequence[str]], min_count: int = 5,
                workers: int = 1) -> Vocabulary:
    """Count -> filter(min_count) -> sort descending -> index.

    A token-file corpus takes the native counting pass when it is built: it returns
    the words in the first-seen order a Python ``Counter`` iterates, so the filter and
    sort below are shared and the vocabulary is the same either way. ``workers > 1``
    routes the Python path through :func:`count_words_parallel` where
    :func:`parallel_counting_profitable` says so."""
    from glint_word2vec_torch.data.corpus import TokenFileCorpus
    if isinstance(sentences, TokenFileCorpus) and not sentences.lowercase:
        from glint_word2vec_torch.data import ingest_native, native
        if ingest_native.ingest_available():
            res = ingest_native.count_words_native(sentences.path,
                                                   native.default_threads())
            if res is not None:
                words, counts = res
                counter = collections.Counter(dict(zip(words, (int(c) for c in counts))))
                return Vocabulary.from_counter(counter, min_count)
    if parallel_counting_profitable(workers):
        return Vocabulary.from_counter(count_words_parallel(sentences, workers),
                                       min_count)
    return Vocabulary.from_counter(count_words(sentences), min_count)


def parallel_counting_profitable(workers: int = 2) -> bool:
    """Whether :func:`build_vocab` should count on ``workers`` threads: only on a
    free-threaded CPython (``sys._is_gil_enabled()`` False). On a stock CPython
    ``Counter.update`` never releases the GIL, and the JAX package measured its slab
    fan-out at 0.66x the serial counter at 4 workers (on a CPU host). The vocabulary
    is the same either way."""
    if workers <= 1:
        return False
    import sys
    try:
        return not sys._is_gil_enabled()
    except AttributeError:
        return False


def read_corpus(path: str, lowercase: bool = False) -> Iterator[List[str]]:
    """Whitespace-tokenized line-per-sentence reader. Only the open is retried: the
    line iteration is one-shot, and re-reading a partly consumed stream would repeat
    lines."""
    from glint_word2vec_torch.train.faults import retry_io

    with retry_io(lambda: open(path, "r", encoding="utf-8"),
                  what=f"open corpus {path!r}") as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            yield [t.lower() for t in toks] if lowercase else toks
