"""Host-side pair feed: index -> subsample -> dynamic window -> fixed-shape pair batches.

Ported from the numpy backend of ``glint_word2vec_tpu/data/pipeline.py``; the stream is
bit-identical to it (tested). Every random decision is position-keyed through
:mod:`.hashrng`, so the stream is a pure function of (seed, iteration, shard) and of the
sentence order.

Two documented divergences from the reference survive unchanged from the JAX package:
subsampling uses the intended float keep formula (the reference's integer division made
it a no-op), and the window keeps the reference's asymmetric shape by default
(``legacy_asymmetric_window=True``: b words of left context, b-1 of right).

Not ported: the native C++ pair generator and the thread-pool fan-out
(``producer_workers``). Both yield the bit-identical stream, so the port runs the
numpy generator serially whatever ``producer_workers`` says.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from glint_word2vec_torch.data.hashrng import (
    STREAM_SUBSAMPLE, STREAM_WINDOW, hash_mod_at, hash_u01_at, stream_base)
from glint_word2vec_torch.data.vocab import Vocabulary


def stream_rng(seed: int, iteration: int, shard: int) -> np.random.Generator:
    """The batch stream's RNG (sentence shuffle): deterministic per
    (seed, iteration, shard); seeds are masked to 64 bits."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed & 0xFFFFFFFFFFFFFFFF,
                               spawn_key=(iteration, shard)))


def encode_sentences(
    sentences: Iterable[Sequence[str]],
    vocab: Vocabulary,
    max_sentence_length: int = 1000,
) -> List[np.ndarray]:
    """Words -> vocab indices, OOV dropped, chunked to max_sentence_length."""
    index = vocab.index
    out: List[np.ndarray] = []
    for sentence in sentences:
        ids = [index[w] for w in sentence if w in index]
        if not ids:
            continue
        arr = np.asarray(ids, dtype=np.int32)
        for start in range(0, len(arr), max_sentence_length):
            chunk = arr[start:start + max_sentence_length]
            if chunk.size:
                out.append(chunk)
    return out


def keep_probabilities(
    counts: np.ndarray, train_words_count: int, subsample_ratio: float
) -> np.ndarray:
    """Per-word keep probability ``(sqrt(pct/ratio)+1)*(ratio/pct)``, capped at 1."""
    if subsample_ratio <= 0:
        return np.ones(counts.shape[0], dtype=np.float64)
    pct = counts.astype(np.float64) / float(train_words_count)
    ratio = float(subsample_ratio)
    keep = (np.sqrt(pct / ratio) + 1.0) * (ratio / pct)
    return np.minimum(keep, 1.0)


def expected_kept_words(
    counts: np.ndarray, train_words_count: int, subsample_ratio: float
) -> int:
    """Expected words surviving subsampling per iteration: the lr-decay clock total."""
    keep = keep_probabilities(counts, train_words_count, subsample_ratio)
    return int(np.round((counts * keep).sum()))


@dataclass
class PairBatch:
    """One fixed-shape batch of training pairs. ``mask`` is 1 for real pairs and 0 for
    the zero-index padding of the last batch; ``words_seen`` is the lr-decay clock
    (kept words consumed up to and including this batch, within the shard)."""

    centers: np.ndarray    # int32 [B]
    contexts: np.ndarray   # int32 [B]
    mask: np.ndarray       # float32 [B]
    words_seen: int
    num_real_pairs: int


class PairBatcher:
    """Accumulates N parallel ragged streams into fixed-size batches along axis 0."""

    def __init__(self, pairs_per_batch: int, num_streams: int = 2):
        self.B = int(pairs_per_batch)
        self.num_streams = num_streams
        self._bufs: List[List[np.ndarray]] = [[] for _ in range(num_streams)]
        self._buffered = 0

    def add(self, *arrays: np.ndarray) -> None:
        if len(arrays) != self.num_streams:
            raise ValueError(f"expected {self.num_streams} streams, got {len(arrays)}")
        if arrays[0].shape[0] == 0:
            return
        for buf, arr in zip(self._bufs, arrays):
            buf.append(arr)
        self._buffered += arrays[0].shape[0]

    def _pop_full(self) -> Iterator[Tuple]:
        if self._buffered < self.B:
            return
        cats = [np.concatenate(buf) for buf in self._bufs]
        n_full = cats[0].shape[0] // self.B
        for i in range(n_full):
            sl = slice(i * self.B, (i + 1) * self.B)
            yield (*(c[sl] for c in cats), self.B)
        rest = [c[n_full * self.B:] for c in cats]
        self._buffered = rest[0].shape[0]
        self._bufs = [[r] if self._buffered else [] for r in rest]

    def drain(self, flush: bool = False) -> Iterator[Tuple]:
        """Yields ``(*stream_slices, num_real)`` tuples of exactly B rows each. With
        ``flush``, the remainder is zero-padded to B and ``num_real < B`` marks it."""
        yield from self._pop_full()
        if flush and self._buffered:
            cats = [np.concatenate(buf) for buf in self._bufs]
            n = cats[0].shape[0]
            pad = self.B - n
            padded = [
                np.concatenate([c, np.zeros((pad, *c.shape[1:]), c.dtype)])
                for c in cats
            ]
            self._bufs = [[] for _ in range(self.num_streams)]
            self._buffered = 0
            yield (*padded, n)


def _subsample_and_window(
    tokens: np.ndarray,
    lengths: np.ndarray,
    keep: np.ndarray,
    window: int,
    seed: int,
    iteration: int,
    shard: int,
    token_base: int,
    legacy_asymmetric_window: bool,
):
    """Subsample a block of sentences and draw each kept position's window.

    Returns (kept_tokens, left, total, Nk) where ``left[i]``/``total[i]`` are the pair
    counts to the left / in total of kept position i, or None for an empty block."""
    N = tokens.shape[0]
    if N == 0:
        return None
    ordinals = np.arange(token_base, token_base + N, dtype=np.uint64)
    sent_ids = np.repeat(np.arange(lengths.shape[0]), lengths)
    sub_base = stream_base(seed, STREAM_SUBSAMPLE, iteration, shard)
    kept_mask = hash_u01_at(sub_base, ordinals) <= keep.astype(np.float32)[tokens]
    toks = tokens[kept_mask]
    sids = sent_ids[kept_mask]
    Nk = toks.shape[0]
    if Nk == 0:
        return None
    new_lengths = np.bincount(sids, minlength=lengths.shape[0])
    new_starts = np.concatenate([[0], np.cumsum(new_lengths)])[:-1]
    pos = np.arange(Nk, dtype=np.int64) - new_starts[sids]
    slen = new_lengths[sids]
    # window draw keyed by the RAW token ordinal, independent of other positions'
    # subsample outcomes
    win_base = stream_base(seed, STREAM_WINDOW, iteration, shard)
    b = hash_mod_at(win_base, ordinals[kept_mask], window)
    left = np.minimum(b, pos)
    right_extent = b if not legacy_asymmetric_window else b - 1
    right = np.clip(np.minimum(right_extent, slen - 1 - pos), 0, None)
    total = (left + right).astype(np.int64)
    return toks, left, total, int(Nk)


def _block_pairs(
    tokens: np.ndarray,          # int32 [N] concatenated sentence tokens
    lengths: np.ndarray,         # int64 [S] sentence lengths (sum == N)
    keep: np.ndarray,            # float32 [V] per-word keep probability
    window: int,
    seed: int,
    iteration: int,
    shard: int,
    token_base: int,             # raw-token ordinal of this block's first token
    legacy_asymmetric_window: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Subsample + window pair generation for a block of sentences, vectorized.

    Returns (centers, contexts, center_word_index, words_kept); ``center_word_index[p]``
    is the 1-based kept-word ordinal of pair p's center, the per-pair lr clock."""
    prologue = _subsample_and_window(
        tokens, lengths, keep, window, seed, iteration, shard, token_base,
        legacy_asymmetric_window)
    if prologue is None:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty(0, np.int64), 0)
    toks, left, total, Nk = prologue
    num_pairs = int(total.sum())
    if num_pairs == 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty(0, np.int64), int(Nk))
    center_flat = np.repeat(np.arange(Nk, dtype=np.int64), total)
    group_starts = np.cumsum(total) - total
    offsets = np.arange(num_pairs, dtype=np.int64) - np.repeat(group_starts, total)
    left_rep = np.repeat(left, total)
    ctx_flat = center_flat - left_rep + offsets + (offsets >= left_rep)
    return (toks[center_flat].astype(np.int32), toks[ctx_flat].astype(np.int32),
            center_flat + 1, int(Nk))


def iter_sentence_slabs(
    sentences: Sequence[np.ndarray],
    order: np.ndarray,
    block_words: int = 1_000_000,
) -> Iterator[List[np.ndarray]]:
    """Whole-sentence slabs of ~``block_words`` raw tokens in the given order."""
    slab: List[np.ndarray] = []
    nwords = 0
    for si in order:
        s = sentences[si]
        slab.append(s)
        nwords += s.shape[0]
        if nwords >= block_words:
            yield slab
            slab, nwords = [], 0
    if slab:
        yield slab


def epoch_batches(
    sentences: Sequence[np.ndarray],
    vocab: Vocabulary,
    *,
    pairs_per_batch: int,
    window: int,
    subsample_ratio: float = 0.0,
    seed: int = 0,
    iteration: int = 1,
    shuffle: bool = True,
    legacy_asymmetric_window: bool = True,
    block_words: int = 1_000_000,
) -> Iterator[PairBatch]:
    """One iteration's stream of fixed-shape pair batches (the JAX package's shard 0
    of 1): sentences shuffled per (seed, iteration), processed in ~``block_words``-word
    slabs, the last batch zero-padded and masked."""
    shard = 0
    rng = stream_rng(seed, iteration, shard)
    keep = keep_probabilities(
        vocab.counts, vocab.train_words_count, subsample_ratio).astype(np.float32)
    order = np.arange(len(sentences))
    if shuffle:
        rng.shuffle(order)
    batcher = PairBatcher(pairs_per_batch, num_streams=3)
    words_base = 0   # kept words fully consumed in prior slabs
    words_seen = 0
    token_base = 0   # raw tokens consumed in prior slabs (position-key base)
    for block in iter_sentence_slabs(sentences, order, block_words):
        tokens = np.concatenate(block) if len(block) > 1 else block[0]
        lengths = np.fromiter((s.shape[0] for s in block), np.int64, len(block))
        c, x, clock, kept = _block_pairs(
            tokens, lengths, keep, window, seed, iteration, shard, token_base,
            legacy_asymmetric_window)
        token_base += int(lengths.sum())
        # the clock credits words as their pairs are emitted, so alpha advances per
        # batch, not per slab
        batcher.add(c, x, words_base + clock)
        words_base += kept
        for bc, bx, bclock, n in batcher.drain():
            words_seen = int(bclock[n - 1])
            yield PairBatch(bc, bx, np.ones(pairs_per_batch, np.float32), words_seen, n)
    for bc, bx, bclock, n in batcher.drain(flush=True):
        mask = (np.arange(pairs_per_batch) < n).astype(np.float32)
        words_seen = int(bclock[n - 1]) if n else words_seen
        yield PairBatch(bc, bx, mask, words_seen, n)
