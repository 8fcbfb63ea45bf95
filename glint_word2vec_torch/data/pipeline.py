"""Host-side pair feed: index -> subsample -> dynamic window -> fixed-shape pair batches,
and its CBOW twin (grouped context windows instead of flat pairs).

Ported from ``glint_word2vec_tpu/data/pipeline.py``; the stream is bit-identical to it
(tested). Every random decision is position-keyed through :mod:`.hashrng`, so the
stream is a pure function of (seed, iteration, shard) and of the sentence order.

Two documented divergences from the reference survive unchanged from the JAX package:
subsampling uses the intended float keep formula (the reference's integer division made
it a no-op), and the window keeps the reference's asymmetric shape by default
(``legacy_asymmetric_window=True``: b words of left context, b-1 of right).

The skip-gram feed generates each slab's pairs with the multithreaded native C++
generator (:mod:`.native`, ``native/pairgen.cpp``) when it is built
(``backend="auto"``), else with numpy; ``producer_workers > 1`` fans the slabs of
either feed over :func:`ordered_pool_map`. Every combination yields the same stream,
bit for bit. There is no native CBOW generator, in either package.
:func:`pack_halo_token_blocks` cuts the kept-token stream into the overlapping blocks
that banded CBOW trains on.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from glint_word2vec_torch.data import native
from glint_word2vec_torch.data.hashrng import (
    STREAM_SUBSAMPLE, STREAM_WINDOW, hash_mod_at, hash_u01_at, stream_base)
from glint_word2vec_torch.data.vocab import Vocabulary

BACKENDS = ("auto", "numpy", "native")


def ordered_pool_map(fn, jobs: Iterable, workers: int, ahead: int = 2):
    """Map ``fn`` over ``jobs`` on a thread pool, yielding the results in job order.

    Every job of the feeds is a pure function of its inputs (the draws are
    position-keyed), so running them concurrently and consuming them in submission
    order yields the same stream at any worker count. ``workers <= 1`` is a plain
    serial loop (no pool, no thread). At most ``workers + ahead`` jobs are in flight,
    so a slow consumer bounds memory. A job's exception is raised at its turn; when
    the consumer stops early (an exception, or the generator closed), the pending jobs
    are cancelled and the pool's threads are joined before this returns.
    """
    if workers <= 1:
        for job in jobs:
            yield fn(job)
        return
    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="glint-feed-worker")
    pending: "collections.deque" = collections.deque()
    try:
        cap = workers + ahead
        for job in jobs:
            pending.append(pool.submit(fn, job))
            if len(pending) >= cap:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def resolve_backend(backend: str) -> str:
    """The pair generator a feed runs, "native" or "numpy": "auto" takes the native
    one when it is built, as the JAX package does."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS} but got {backend!r}")
    if backend == "auto":
        return "native" if native.native_available() else "numpy"
    if backend == "native" and not native.native_available():
        raise RuntimeError("backend 'native' but the native pair generator did not "
                           "build (g++) or GLINT_DISABLE_NATIVE is set")
    return backend


def _slab_jobs(sentences: Sequence[np.ndarray], order: np.ndarray,
               block_words: int) -> Iterator[Tuple[List[np.ndarray], int]]:
    """(slab, token_base) per slab: ``token_base`` is the raw-token ordinal of the
    slab's first token, the position key of its draws."""
    token_base = 0
    for block in iter_sentence_slabs(sentences, order, block_words):
        yield block, token_base
        token_base += sum(int(s.shape[0]) for s in block)


def _slab_arrays(block: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    tokens = np.concatenate(block) if len(block) > 1 else block[0]
    return tokens, np.fromiter((s.shape[0] for s in block), np.int64, len(block))


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
    backend: str = "auto",
    producer_workers: int = 1,
    shard: int = 0,
    num_shards: int = 1,
) -> Iterator[PairBatch]:
    """One iteration's stream of fixed-shape pair batches for one data shard:
    sentences assigned to the ``num_shards`` shards round-robin, this shard's shuffled
    per (seed, iteration, shard), processed in ~``block_words``-word slabs, the last
    batch zero-padded and masked. A multi-process fit's rank pulls its own shard
    (``Trainer._fit_sharded``); a single process, shard 0 of 1.

    ``backend``: "native" generates each slab's pairs with the C++ generator, "numpy"
    with :func:`_block_pairs`, "auto" (the default) with the first when it is built.
    ``producer_workers > 1`` generates the slabs on a thread pool
    (:func:`ordered_pool_map`); the native generator's ``default_threads()`` budget is
    then divided across the concurrent calls, so the pools compose instead of
    multiplying. Only the batching and the clock below stay serial."""
    use_native = resolve_backend(backend) == "native"
    rng = stream_rng(seed, iteration, shard)
    keep = keep_probabilities(
        vocab.counts, vocab.train_words_count, subsample_ratio).astype(np.float32)
    order = np.arange(shard, len(sentences), num_shards)
    if shuffle:
        rng.shuffle(order)
    native_threads = native.threads_per_call(producer_workers)

    def run_slab(job):
        block, token_base = job
        tokens, lengths = _slab_arrays(block)
        if use_native:
            return native.block_pairs_native(
                tokens, lengths, keep, window, seed, iteration, shard, token_base,
                legacy_asymmetric_window, n_threads=native_threads)
        return _block_pairs(tokens, lengths, keep, window, seed, iteration, shard,
                            token_base, legacy_asymmetric_window)

    batcher = PairBatcher(pairs_per_batch, num_streams=3)
    words_base = 0   # kept words fully consumed in prior slabs
    words_seen = 0
    for c, x, clock, kept in ordered_pool_map(
            run_slab, _slab_jobs(sentences, order, block_words), producer_workers):
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


# ---------------------------------------------------------------------------------------
# CBOW variant (BASELINE.md config 5): grouped context windows instead of flat pairs.
# ---------------------------------------------------------------------------------------


def dynamic_window_cbow(
    sentence: np.ndarray,
    window: int,
    rng: np.random.Generator,
    legacy_asymmetric_window: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-position padded context windows of one sentence: (centers [L], contexts
    [L, C], ctx_mask [L, C]) with C = 2·window, positions with no context dropped. The
    window draw is the per-sentence generator's (``rng``), not the hash lattice."""
    L = sentence.shape[0]
    C = 2 * window
    if L == 0:
        return (np.empty(0, np.int32), np.empty((0, C), np.int32),
                np.empty((0, C), np.float32))
    positions = np.arange(L, dtype=np.int64)
    b = rng.integers(0, window, size=L)
    left = np.minimum(b, positions)
    right_extent = b if not legacy_asymmetric_window else b - 1
    right = np.clip(np.minimum(right_extent, L - 1 - positions), 0, None)
    total = left + right
    num_pairs = int(total.sum())
    contexts = np.zeros((L, C), dtype=np.int32)
    ctx_mask = np.zeros((L, C), dtype=np.float32)
    if num_pairs:
        group_starts = np.cumsum(total) - total
        offsets = np.arange(num_pairs, dtype=np.int64) - np.repeat(group_starts, total)
        rows = np.repeat(positions, total)
        left_rep = np.repeat(left, total)
        ctx_pos = rows - left_rep + offsets + (offsets >= left_rep)
        contexts[rows, offsets] = sentence[ctx_pos]
        ctx_mask[rows, offsets] = 1.0
    keep = total > 0
    return (sentence[keep].astype(np.int32), contexts[keep], ctx_mask[keep])


def _block_cbow(
    tokens: np.ndarray,          # int32 [N] concatenated sentence tokens
    lengths: np.ndarray,         # int64 [S] sentence lengths (sum == N)
    keep: np.ndarray,            # float32 [V] per-word keep probability
    window: int,
    seed: int,
    iteration: int,
    shard: int,
    token_base: int,
    legacy_asymmetric_window: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """CBOW analog of :func:`_block_pairs`, with the same position-keyed draws.

    Returns (centers [Nk], contexts [Nk, 2*window] left-packed, n_ctx [Nk],
    center_word_index [Nk], words_kept); positions with no context are dropped."""
    C = 2 * window
    empty = (np.empty(0, np.int32), np.empty((0, C), np.int32),
             np.empty(0, np.int32), np.empty(0, np.int64), 0)
    prologue = _subsample_and_window(
        tokens, lengths, keep, window, seed, iteration, shard, token_base,
        legacy_asymmetric_window)
    if prologue is None:
        return empty
    toks, left, total, Nk = prologue
    j = np.arange(C, dtype=np.int64)[None, :]
    ctx_pos = np.where(j < left[:, None],
                       np.arange(Nk, dtype=np.int64)[:, None] - left[:, None] + j,
                       np.arange(Nk, dtype=np.int64)[:, None] + j - left[:, None] + 1)
    valid = j < total[:, None]
    contexts = np.where(valid, toks[np.clip(ctx_pos, 0, Nk - 1)], 0).astype(np.int32)
    has_ctx = total > 0
    return (toks[has_ctx].astype(np.int32), contexts[has_ctx],
            total[has_ctx].astype(np.int32),
            np.flatnonzero(has_ctx) + 1, int(Nk))


def pack_halo_token_blocks(
    slabs: Iterable[Tuple[np.ndarray, np.ndarray]],
    T: int,
    halo: int,
    tok_dtype=np.int32,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int, int, int]]:
    """Sentence-contiguous [T]-slot blocks of the kept-token stream with a ±``halo``
    overlap, the feed of banded CBOW; the blocks are the JAX function's.

    ``slabs`` yields (kept tokens, start flags) pieces of the stream (the first token
    carries a flag). Blocks advance by the core width ``Tc = T − 2·halo``: block k holds
    stream positions ``[k·Tc − halo, k·Tc − halo + T)``, so every kept token is a core
    slot (``[halo, T − halo)``) of exactly one block. No start bit is set at a cut: the
    overlap makes windows across it exact. Block 0's ``halo`` pre-stream slots are zero
    tokens with no start bit (never centers, never contexts). The last blocks are
    emitted while a token has not been a core slot.

    Yields ``(tokens [T], start bits, n_valid, ordinal base, n_core)``: the valid slot
    prefix, the kept-token ordinal of slot 0 (wrapped to 64 bits: block 0's is −halo)
    and the new core tokens of the block (the lr clock's increment). The unconsumed
    tail is kept as views of the last concatenation, not copied at every cut."""
    if halo <= 0:
        raise ValueError(f"halo must be positive, got {halo}")
    Tc = T - 2 * halo
    if Tc <= 0:
        raise ValueError(f"T={T} leaves no core slots at halo={halo}")
    buf_tok = np.zeros(halo, tok_dtype)   # block 0's pre-stream slots
    buf_start = np.zeros(halo, bool)
    bpos = -halo                          # stream position of buf[0]

    def emit(n_core: int):
        n = min(buf_tok.shape[0], T)
        tokens = np.zeros(T, tok_dtype)
        tokens[:n] = buf_tok[:n]
        bits = np.packbits(np.pad(buf_start[:n], (0, T - n)), bitorder="little")
        return tokens, bits, n, bpos & 0xFFFFFFFFFFFFFFFF, n_core

    for ktoks, kstart in slabs:
        if ktoks.shape[0] == 0:
            continue
        buf_tok = np.concatenate([buf_tok, ktoks.astype(tok_dtype)])
        buf_start = np.concatenate([buf_start, kstart])
        while buf_tok.shape[0] >= T:
            yield emit(Tc)
            buf_tok, buf_start = buf_tok[Tc:], buf_start[Tc:]
            bpos += Tc
    # a stream position >= bpos + halo that has not been a core slot remains
    while buf_tok.shape[0] > halo:
        yield emit(min(buf_tok.shape[0] - halo, Tc))
        buf_tok, buf_start = buf_tok[Tc:], buf_start[Tc:]
        bpos += Tc


@dataclass
class CbowBatch:
    """One fixed-shape CBOW batch. Contexts are left-packed: an example's real slots
    come first, and ``n_ctx`` counts them (``ctx_mask`` rebuilds the float mask)."""

    centers: np.ndarray    # int32 [B]
    contexts: np.ndarray   # int32 [B, C]
    n_ctx: np.ndarray      # int32 [B]
    mask: np.ndarray       # float32 [B]
    words_seen: int
    num_real: int

    @property
    def ctx_mask(self) -> np.ndarray:
        C = self.contexts.shape[1]
        return (np.arange(C)[None, :] < self.n_ctx[:, None]).astype(np.float32)


def epoch_batches_cbow(
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
    producer_workers: int = 1,
) -> Iterator[CbowBatch]:
    """CBOW analog of :func:`epoch_batches` (the JAX package's shard 0 of 1):
    fixed-shape [B, 2·window] context batches over the same position-keyed stream,
    the last batch zero-padded and masked. ``producer_workers``: the same slab pool
    as :func:`epoch_batches`, over the numpy :func:`_block_cbow` (there is no native
    CBOW generator)."""
    B = int(pairs_per_batch)
    shard = 0
    rng = stream_rng(seed, iteration, shard)
    keep = keep_probabilities(
        vocab.counts, vocab.train_words_count, subsample_ratio).astype(np.float32)
    order = np.arange(len(sentences))
    if shuffle:
        rng.shuffle(order)

    def run_slab(job):
        block, token_base = job
        tokens, lengths = _slab_arrays(block)
        return _block_cbow(tokens, lengths, keep, window, seed, iteration, shard,
                           token_base, legacy_asymmetric_window)

    batcher = PairBatcher(B, num_streams=4)
    words_base = 0
    words_seen = 0
    for c, x, nc, clock, kept in ordered_pool_map(
            run_slab, _slab_jobs(sentences, order, block_words), producer_workers):
        batcher.add(c, x, nc, words_base + clock)
        words_base += kept
        for bc, bx, bn, bclock, n in batcher.drain():
            words_seen = int(bclock[n - 1])
            yield CbowBatch(bc, bx, bn, np.ones(B, np.float32), words_seen, n)
    for bc, bx, bn, bclock, n in batcher.drain(flush=True):
        words_seen = int(bclock[n - 1]) if n else words_seen
        yield CbowBatch(bc, bx, bn, (np.arange(B) < n).astype(np.float32),
                        words_seen, n)
