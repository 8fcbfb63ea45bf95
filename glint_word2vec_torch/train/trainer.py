"""Single-device synchronous trainer, ported from the host-feed path of
``glint_word2vec_tpu/train/trainer.py`` (``fit`` and its ``chunk`` function).

The control flow and bookkeeping are the JAX package's, so that a fit from the same
parameters gives the same step count, pair count, alpha trace and (to f32 tolerance)
parameters:

- batches come from the pair feed (native C++ or numpy, ``feed_backend``) or its CBOW
  twin, slabs fanned over ``producer_workers`` threads, and are assembled
  ``steps_per_dispatch`` to a chunk, filled in place;
- with ``device_pairgen`` (``feed_backend == "device"``) the chunks carry token blocks
  instead: the host subsamples (the same hashrng draws), cuts the kept stream into
  ``tokens_per_step``-token blocks and ships them with their sentence-start bits and
  ordinal bases; the device expands a chunk's blocks into its steps' pairs in one
  batched call (``ops/pairgen.device_block_pairs``) before the steps. The lr clock
  advances by the kept tokens; heartbeats count the analytic pair estimate, and the
  exact trained and dropped totals stay on the device until the end of the fit;
- banded CBOW (``cbow_update="banded"``) rides the same token-block feed, cut with a
  ±window halo overlap (``data/pipeline.pack_halo_token_blocks``): the card derives a
  chunk's window extents in one batched call (``ops/pairgen.device_cbow_windows``) and
  each step applies ``ops/cbow_banded.cbow_step_banded_core``; the lr clock advances by
  each block's new core tokens;
- with ``prefetch_chunks > 0`` the chunks are assembled on a producer thread, at most
  that many ahead; on the card that thread also stages each chunk: a copy into pinned
  host memory, asynchronous copies to the card on a stream of their own, and an event
  the consumer's stream waits on before the chunk's first use. The thread only copies:
  every kernel is launched by the consumer. ``prefetch_chunks=0`` assembles and copies
  on the calling thread;
- each batch's mask is rebuilt as a prefix mask from its real pair count, and a CBOW
  batch's context mask from its context counts;
- the negatives of a chunk are drawn at once from the hash PRNG at counter
  ``global_step + 1``: one ``(K, P)`` pool on the shared-pool paths, ``(K, B, n)`` on
  the per-example paths, so the negative stream is a pure function of (seed, step);
- the step follows the JAX trainer's selection matrix: shared pool + skip-gram runs the
  fused kernel, or, with a stabilizer or ``duplicate_scaling`` on (which the kernel does
  not implement, as the JAX package's Pallas kernel does not),
  ``sgns_step_shared_scatter_``; shared pool + CBOW ``cbow_step_shared_core``, banded
  CBOW ``cbow_step_banded_core``, a pool of 0 ``sgns_step_core`` or ``cbow_step_core``
  (all but the fused kernel scatter their rows through the row-scatter kernel), each
  with the config's stabilizers (``self._stabilizers``; all zero runs none of their
  ops);
- the parameters live in ``param_dtype``; every step computes in ``compute_dtype`` with
  its shared-pool logit chain in ``logits_dtype``, as the JAX steps cast (on bf16
  parameters each scatter rounds a row once per step, ``ops/scatter``);
- ``fused_logits`` and ``bf16_chain`` reach every skip-gram step (the fused kernel as
  flags); with ``hot_rows`` the skip-gram steps carry the first K rows' updates in f32
  slabs (``sgns_step_shared_scatter_`` on the shared pool: the fused kernel has no
  slab), flushed every ``hot_flush_every`` steps and at every chunk's end, so
  checkpoints and heartbeats never see a pending slab;
- per-step alphas follow the words clock;
- chunks no heartbeat will sample run the metrics-elided step (same parameters);
- the AUTO pool is re-resolved for vocabularies past 500k words, and an AUTO
  subsample ratio is lowered out of the measured duplicate-overload region.

``host_wait_time`` counts the seconds ``fit`` waited for the next chunk (its assembly,
and its staging when the producer is on); ``dispatch_time`` the seconds spent issuing
its steps (with the copy to the card when the producer is off).

Differences: the steps update the parameters in place, the feed ships int32 indices
(widened to int64 on the card, where the JAX package ships uint16 below 65536 words), a
short last chunk is not padded with the JAX package's masked dummy steps (they are exact
no-ops), the device feed has one data segment (a checkpoint that holds only
per-segment positions is refused), and rollback/recovery, telemetry, statusd,
profiling, stability advisories, ``norm_watch`` (and its recovery ladder) and the
multi-process feeds are not ported yet.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.hashrng import (
    STREAM_SUBSAMPLE, STREAM_WINDOW, hash_u01_at, stream_base)
from glint_word2vec_torch.data.pipeline import (
    epoch_batches, epoch_batches_cbow, expected_kept_words, iter_sentence_slabs,
    keep_probabilities, ordered_pool_map, pack_halo_token_blocks, resolve_backend,
    stream_rng)
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.ops import scatter
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_torch.ops.cbow_banded import cbow_step_banded_core
from glint_word2vec_torch.ops.pairgen import device_block_pairs, device_cbow_windows
from glint_word2vec_torch.ops.sampler import build_alias_table, sample_negatives_hash
from glint_word2vec_torch.ops.sgns import (
    EmbeddingPair, Stabilizers, StepMetrics, alpha_schedule, cbow_step_core,
    cbow_step_shared_core, hot_flush, hot_slabs, init_embeddings, sgns_step_core,
    sgns_step_shared_scatter_)
from glint_word2vec_torch.parallel.mesh import pad_dim_to_lanes, pad_vocab_for_sharding
from glint_word2vec_torch.train.checkpoint import TrainState, save_model

logger = logging.getLogger("glint_word2vec_torch")


def _is_banded(cfg: Word2VecConfig) -> bool:
    return bool(cfg.cbow and cfg.cbow_update == "banded")


class NonFiniteParamsError(RuntimeError):
    """The parameters went non-finite under ``nonfinite_policy='halt'``."""


def _pairs_per_kept_token(window: int) -> float:
    """E[pairs per kept token] under the legacy asymmetric window (sentence-boundary
    clipping ignored, so it overestimates slightly), floored at 1e-3."""
    b = np.arange(window, dtype=np.float64)
    return max(float(b.mean() + np.clip(b - 1, 0, None).mean()), 1e-3)


def _cbow_examples_per_kept_token(window: int) -> float:
    """P[a kept token trains a CBOW example] under the legacy asymmetric window: the
    draw b = 0 gives no context, hence (window - 1)/window (sentence edges ignored;
    heartbeats only), floored at 1e-3."""
    return max((window - 1) / window, 1e-3)


class _threaded_iter:
    """Run a generator on a background thread with a bounded buffer (the JAX
    package's producer).

    An exception of the generator is raised at the consumer's ``next()``. ``close()``
    (also run on garbage collection) stops the producer even when it is blocked on a
    full buffer, and joins it; the producer closes the generator on its own thread, so
    the generator's cleanup (the feed's worker pool) runs before the thread ends.
    """

    _DONE = object()

    def __init__(self, gen: Iterator, maxsize: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()

        def put_checked(item) -> bool:
            """A bounded put that gives up once the consumer signals stop: every put
            (the terminal one too) must be preemptible, or an abandoned iterator leaks
            a blocked producer."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for item in gen:
                    if not put_checked(item):
                        return
                put_checked(self._DONE)
            except BaseException as e:  # relayed to the consumer
                put_checked(e)
            finally:
                gen.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="glint-batch-producer")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


@dataclass
class HeartbeatRecord:
    words: int
    alpha: float
    loss: float
    mean_f_pos: float
    pairs_per_sec: float
    global_step: int = -1


class Trainer:
    """Owns the embedding pair on one device and runs the synchronous SGNS/CBOW
    loop."""

    # duplicate-overload channel (EVAL.md): ~300 expected top-word duplicates per
    # batch trained to NaN; AUTO lowering targets 250
    _DUP_LOAD_REFUSE = 300.0
    _DUP_LOAD_TARGET = 250.0
    # vocab-scaled AUTO pool (EVAL.md round-5): past 500k words the safe pool load
    # tightens from 600 to 160
    _LARGE_VOCAB_BOUNDARY = 500_000
    _LARGE_VOCAB_SAFE_LOAD = 160.0

    def __init__(
        self,
        config: Word2VecConfig,
        vocab: Vocabulary,
        params: Optional[EmbeddingPair] = None,
        train_state: Optional[TrainState] = None,
        device="cuda",
        feed_backend: str = "auto",
    ):
        """``feed_backend``: the skip-gram pair generator, "native", "numpy" or
        "auto" (native when it is built, as the JAX package chooses); CBOW has only
        the numpy generator, and ``device_pairgen`` and banded CBOW only "device" (the
        token-block feed, which "auto" resolves to). The resolved choice is
        ``self.feed_backend``."""
        self.device = resolve_device(device)
        self.config = config
        self.vocab = vocab
        self.feed_backend = self._resolve_feed(feed_backend)
        self._resolve_vocab_scaled_pool()
        config = self.config
        self.padded_vocab = pad_vocab_for_sharding(vocab.size)
        self.padded_dim = pad_dim_to_lanes(config.vector_size, config.pad_vector_to_lanes)
        self.table = build_alias_table(vocab.counts, config.sample_power)
        self._table_prob = torch.from_numpy(self.table.prob).to(self.device)
        self._table_alias = torch.from_numpy(
            self.table.alias.astype(np.int64)).to(self.device)
        self.param_dtype = getattr(torch, config.param_dtype)
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.logits_dtype = getattr(torch, config.logits_dtype)
        if params is None:
            gen = torch.Generator().manual_seed(config.seed & 0xFFFFFFFFFFFFFFFF)
            params = init_embeddings(self.padded_vocab, config.vector_size, gen,
                                     self.param_dtype)
        self.params = self._place_params(params)
        self.state = train_state or TrainState()
        self._resolve_duplicate_channel()
        self._tokens_per_step = 0
        if self.config.device_pairgen:
            self._init_token_block_feed(
                self.config.tokens_per_step or self._auto_tokens_per_step())
        # banded CBOW: the token-block feed with a +-window halo at the block cuts, so
        # windows across a cut are exact; the core slots of a block are one step's
        # examples
        self._banded_cbow = _is_banded(self.config)
        self._block_halo = self.config.window if self._banded_cbow else 0
        if self._banded_cbow:
            self._init_token_block_feed(self.config.pairs_per_batch + 2 * self._block_halo)
        # from the config; all zero runs no stabilizer op
        self._stabilizers = Stabilizers(max_row_norm=self.config.max_row_norm,
                                        update_clip=self.config.update_clip,
                                        row_l2=self.config.row_l2)
        # cross-step hot rows: K clamped to the real vocabulary (the padding rows are
        # never touched), flushed every hot_flush_every steps (0: once per chunk)
        self._hot_rows = int(min(self.config.hot_rows, vocab.size))
        self._hot_flush = self.config.hot_flush_every or self.config.steps_per_dispatch
        self._slabs = (hot_slabs(self._hot_rows, self.padded_dim, self.param_dtype,
                                 self.device) if self._hot_rows else None)
        self._warn_logits_dtype()
        # resume continues the (seed, counter) negative lattice where it left off
        self.global_step = self.state.global_step
        self.pairs_trained = 0.0  # real (unmasked) pairs trained over this trainer
        self.heartbeats: "deque[HeartbeatRecord]" = deque(maxlen=config.heartbeat_ring)
        self.dropped_pairs = 0  # device_pairgen: pairs past the B slots, this trainer
        self.host_wait_time = 0.0
        self.dispatch_time = 0.0

    # -- setup -----------------------------------------------------------------------

    def _resolve_feed(self, backend: str) -> str:
        if self.config.device_pairgen or _is_banded(self.config):
            if backend not in ("auto", "device"):
                raise ValueError(f"feed_backend={backend!r}: with device_pairgen or "
                                 "banded CBOW the host ships token blocks and the "
                                 "device derives the pairs or windows")
            return "device"
        if not self.config.cbow:
            return resolve_backend(backend)
        if backend == "native":
            raise ValueError("feed_backend='native': there is no native CBOW generator; "
                             "CBOW feeds run numpy")
        return resolve_backend("numpy" if backend == "auto" else backend)

    def _place_params(self, params) -> EmbeddingPair:
        """Copy (numpy or torch) parameters into zero-padded [Vp, Dp] tensors of
        ``param_dtype`` on the device (a float32 source is rounded to bf16 once); the
        trainer owns and updates its copy."""
        def pad(a) -> torch.Tensor:
            t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
            if t.dim() != 2 or t.shape[0] > self.padded_vocab or t.shape[1] > self.padded_dim:
                raise ValueError(f"parameter shape {tuple(t.shape)} does not fit the "
                                 f"padded geometry ({self.padded_vocab}, {self.padded_dim})")
            out = torch.zeros((self.padded_vocab, self.padded_dim), dtype=self.param_dtype,
                              device=self.device)
            out[:t.shape[0], :t.shape[1]] = t.to(self.device, self.param_dtype)
            return out

        return EmbeddingPair(pad(params[0]), pad(params[1]))

    def _warn_logits_dtype(self) -> None:
        """The JAX trainer's warning: ``logits_dtype`` applies to the shared-pool paths
        only (the per-pair and per-example chains stay float32)."""
        cfg = self.config
        if cfg.logits_dtype != "float32" and not (
                cfg.negative_pool > 0 and not cfg.use_pallas
                and not (cfg.cbow and cfg.duplicate_scaling)):
            logger.warning(
                "logits_dtype=%s only applies to the shared-pool XLA paths "
                "(negative_pool > 0, no pallas, no CBOW+duplicate_scaling); this "
                "configuration keeps the float32 logit chain", cfg.logits_dtype)

    def _duplicate_load(self, subsample_ratio: float) -> float:
        """Expected in-batch duplicates of the most frequent word."""
        cfg = self.config
        keep = keep_probabilities(
            self.vocab.counts, self.vocab.train_words_count, subsample_ratio)
        eff = np.asarray(self.vocab.counts, np.float64) * keep
        s = float(eff.sum())
        if s <= 0.0:
            return 0.0
        real_pairs = min(float(cfg.pairs_per_batch),
                         s * _pairs_per_kept_token(cfg.window))
        return float(eff.max()) / s * real_pairs

    def _resolve_duplicate_channel(self) -> None:
        """Lower an AUTO subsample ratio until the expected top-word duplicates per
        batch fall under the measured divergence boundary; refuse an explicit ratio
        past it unless ``allow_unstable``."""
        cfg = self.config
        load = self._duplicate_load(cfg.subsample_ratio)
        if load <= self._DUP_LOAD_REFUSE:
            return
        if not getattr(cfg, "_auto_subsample", False):
            if cfg.allow_unstable:
                return
            raise ValueError(
                f"expected duplicates of the most frequent word per "
                f"{cfg.pairs_per_batch}-pair batch = {load:.0f} exceed the measured "
                f"divergence boundary (~{self._DUP_LOAD_REFUSE:.0f}) with "
                f"subsample_ratio={cfg.subsample_ratio}. Lower subsample_ratio (~1e-4), "
                f"shrink pairs_per_batch, or set allow_unstable=True to proceed anyway")
        lo, hi = 1e-12, cfg.subsample_ratio
        if self._duplicate_load(lo) > self._DUP_LOAD_TARGET:
            if cfg.allow_unstable:
                return
            raise ValueError(
                f"the duplicate-overload channel cannot be bounded by subsampling alone "
                f"on this corpus (top-word duplicates per {cfg.pairs_per_batch}-pair "
                f"batch stay > {self._DUP_LOAD_TARGET:.0f} at any ratio); shrink "
                f"pairs_per_batch, or set allow_unstable=True for a short toy run")
        for _ in range(60):
            mid = (lo * hi) ** 0.5  # geometric: the scale spans many decades
            if self._duplicate_load(mid) > self._DUP_LOAD_TARGET:
                hi = mid
            else:
                lo = mid
        logger.warning("auto subsample_ratio lowered 1e-3 -> %.3g (expected top-word "
                       "duplicates per batch %.0f > %.0f)", lo, load,
                       self._DUP_LOAD_REFUSE)
        self.config = cfg.replace(subsample_ratio=lo)
        # replace() re-derives an AUTO pool with the config-level rule; re-apply the
        # large-vocabulary rule
        self._resolve_vocab_scaled_pool()

    def _resolve_vocab_scaled_pool(self) -> None:
        """Grow a still-AUTO pool past 500k words until the load B·n/P <= 160,
        rounded up to a multiple of 128. Explicit pools are never changed."""
        cfg = self.config
        if not getattr(cfg, "_auto_pool", False) or cfg.negative_pool <= 0:
            return
        if self.vocab.size <= self._LARGE_VOCAB_BOUNDARY:
            return
        load = cfg.pairs_per_batch * cfg.negatives / cfg.negative_pool
        if load <= self._LARGE_VOCAB_SAFE_LOAD:
            return
        p_min = -(-cfg.pairs_per_batch * cfg.negatives // int(self._LARGE_VOCAB_SAFE_LOAD))
        pool = max(128, 128 * (-(-p_min // 128)))
        logger.warning("auto negative_pool %d -> %d for a %d-word vocabulary (pool "
                       "load %.0f > %.0f)", cfg.negative_pool, pool, self.vocab.size,
                       load, self._LARGE_VOCAB_SAFE_LOAD)
        new_cfg = cfg.replace(negative_pool=pool)
        new_cfg._auto_pool = True  # still AUTO: geometry changes re-derive
        self.config = new_cfg

    def _init_token_block_feed(self, tokens_per_step: int) -> None:
        """The token-block feed's setup: the keep table on the device (from the
        subsample ratio the duplicate channel resolved), T, and, with
        ``device_pairgen``, the JAX package's 2^24 bound for a T the Trainer sized (the
        config checks an explicit one)."""
        cfg = self.config
        keep = keep_probabilities(self.vocab.counts, self.vocab.train_words_count,
                                  cfg.subsample_ratio).astype(np.float32)
        self._keep_host = keep
        kp = np.zeros(self.padded_vocab, np.float32)
        kp[:self.vocab.size] = keep
        self._keep_prob_dev = torch.from_numpy(kp).to(self.device)
        self._tokens_per_step = tokens_per_step
        if cfg.device_pairgen and tokens_per_step * (2 * cfg.window - 1) >= 1 << 24:
            raise ValueError(
                f"tokens_per_step={tokens_per_step} with window={cfg.window} overflows "
                f"the device generator's exact-f32 prefix-sum bound (T * (2*window - 1) "
                f"must stay below 2^24); lower tokens_per_step or split the batch")

    def _auto_tokens_per_step(self) -> int:
        """Token slots per step for ~93% pair-slot fill from the analytic pairs per
        kept token (sentence-edge clipping ignored, so the fill lands below target
        rather than overflowing)."""
        cfg = self.config
        T = int(np.ceil(0.93 * cfg.pairs_per_batch / _pairs_per_kept_token(cfg.window)))
        return max(T, 64)

    # -- training --------------------------------------------------------------------

    def _with_metrics(self, max_steps: int) -> bool:
        """Whether the next chunk runs the full-metrics step: only if a heartbeat may
        sample it (``max_steps`` bounds the steps it advances)."""
        return (self.global_step + max_steps - self._last_log_step
                >= self.config.heartbeat_every_steps)

    def _batch_stream(self, sentences: Sequence[np.ndarray],
                      iteration: int) -> Iterator[tuple]:
        """(arrays, real, words_seen) per batch: centers/contexts (and CBOW's n_ctx)
        of the iteration's feed."""
        cfg = self.config
        common = dict(pairs_per_batch=cfg.pairs_per_batch, window=cfg.window,
                      subsample_ratio=cfg.subsample_ratio, seed=cfg.seed,
                      iteration=iteration, shuffle=cfg.shuffle,
                      producer_workers=cfg.producer_workers)
        if cfg.cbow:
            for b in epoch_batches_cbow(sentences, self.vocab, **common):
                yield ({"centers": b.centers, "contexts": b.contexts, "nctx": b.n_ctx},
                       b.num_real, b.words_seen)
        else:
            for b in epoch_batches(sentences, self.vocab, backend=self.feed_backend,
                                   **common):
                yield ({"centers": b.centers, "contexts": b.contexts},
                       b.num_real_pairs, b.words_seen)

    def _chunk_stream(self, sentences: Sequence[np.ndarray], total_words: float,
                      train_words: float) -> Iterator[dict]:
        """Numpy chunk assembly: up to K batches filled in place, the alpha schedule
        and the resume skip. No torch call, so it may run on the producer thread; the
        resume position is read here, before the consumer advances ``self.state``."""
        cfg = self.config
        K = cfg.steps_per_dispatch
        start_iter = self.state.iteration
        skip_batches = self.state.batches_done if not self.state.finished else 0

        def chunks() -> Iterator[dict]:
            for k in range(start_iter, cfg.num_iterations + 1):
                prev_words = (k - 1) * train_words
                pending: List[tuple] = []
                batches_in_iter = skip_batches if k == start_iter else 0
                to_skip = batches_in_iter

                def flush() -> dict:
                    nonlocal pending, batches_in_iter
                    real = len(pending)
                    arrays = {name: np.empty((real, *a.shape), a.dtype)
                              for name, a in pending[0][0].items()}
                    for j, (batch, _, _) in enumerate(pending):
                        for name, a in batch.items():
                            arrays[name][j] = a
                    reals = np.asarray([r for _, r, _ in pending], np.float32)
                    alphas = np.asarray([
                        alpha_schedule(float(w), total_words, cfg.learning_rate,
                                       cfg.min_alpha_factor)
                        for _, _, w in pending], np.float32)
                    batches_in_iter += real
                    chunk = dict(arrays=arrays, alphas=alphas, reals=reals, real=real,
                                 iteration=k, words_processed=int(pending[-1][2]),
                                 batches_done=batches_in_iter,
                                 real_pairs=float(reals.sum()))
                    pending = []
                    return chunk

                for arrays, real, words_seen in self._batch_stream(sentences, k):
                    if to_skip:  # fast-forward already-trained batches (exact resume)
                        to_skip -= 1
                        continue
                    pending.append((arrays, real, prev_words + words_seen))
                    if len(pending) == K:
                        yield flush()
                if pending:
                    yield flush()

        return chunks()

    def _device_seg_blocks(self, sentences: Sequence[np.ndarray], k: int,
                           workers: Optional[int] = None) -> Iterator[tuple]:
        """[T]-token blocks of iteration k for the device pair generator, subsampled on
        the host (the feed's hashrng draws on raw ordinals, vectorised over ~1M-token
        slabs fanned over ``workers`` threads, so the stream is the same at any worker
        count), so the wire carries only kept tokens and the lr clock is exact. The
        kept stream is cut at T boundaries: a sentence straddling a cut loses its
        cross-cut windows, as the reference's maxSentenceLength chunking does. Yields
        (tokens int32 [T], start bits uint8 [ceil(T/8)], n_valid, kept-ordinal base,
        kept count). Banded CBOW (``self._block_halo > 0``) cuts the same kept stream
        with a ±halo overlap instead (``pack_halo_token_blocks``), and the count is the
        block's new core tokens. One data segment: the multi-process feed waits with
        the multi-device work."""
        cfg = self.config
        workers = cfg.producer_workers if workers is None else workers
        T = self._tokens_per_step
        keep = self._keep_host
        order = np.arange(len(sentences))
        if cfg.shuffle:
            stream_rng(cfg.seed, k, 0).shuffle(order)
        sub_base = stream_base(cfg.seed, STREAM_SUBSAMPLE, k, 0)

        def slab_jobs():
            raw_ord = 0
            for slab in iter_sentence_slabs(sentences, order):
                yield slab, raw_ord
                raw_ord += sum(int(x.shape[0]) for x in slab)

        def run_slab(job):
            """(kept tokens, sentence-start flags) of one slab, a pure function of
            (slab, raw ordinal base); None when every token was dropped."""
            slab, raw_ord = job
            tokens = np.concatenate(slab) if len(slab) > 1 else slab[0]
            lens = np.fromiter((x.shape[0] for x in slab), np.int64, len(slab))
            sids = np.repeat(np.arange(len(slab)), lens)
            if cfg.subsample_ratio > 0:
                u = hash_u01_at(sub_base, np.arange(
                    raw_ord, raw_ord + tokens.shape[0], dtype=np.uint64))
                m = u <= keep[tokens]
                tokens, sids = tokens[m], sids[m]
            if tokens.shape[0] == 0:
                return None
            starts = np.empty(tokens.shape[0], bool)
            starts[0] = True
            starts[1:] = sids[1:] != sids[:-1]
            return tokens.astype(np.int32), starts

        kept = (res for res in ordered_pool_map(run_slab, slab_jobs(), workers)
                if res is not None)
        if self._block_halo:
            yield from pack_halo_token_blocks(kept, T, self._block_halo)
            return
        base = 0
        rest_tok = np.empty(0, np.int32)
        rest_start = np.empty(0, bool)

        def emit(toks, starts):
            n = toks.shape[0]
            buf = np.zeros(T, np.int32)
            buf[:n] = toks
            bits = np.packbits(np.pad(starts, (0, T - n)), bitorder="little")
            return buf, bits, n, base, float(n)

        for ktoks, kstart in kept:
            rest_tok = np.concatenate([rest_tok, ktoks])
            rest_start = np.concatenate([rest_start, kstart])
            while rest_tok.shape[0] >= T:
                yield emit(rest_tok[:T], rest_start[:T])
                base += T
                # views of the concatenations above, which nothing else holds, so
                # the tail is not copied (a copy per block is quadratic in the slab)
                rest_tok = rest_tok[T:]
                rest_start = rest_start[T:]
                if rest_start.shape[0]:
                    rest_start[0] = True  # the cut tail opens a sentence
        if rest_tok.shape[0]:
            yield emit(rest_tok, rest_start)

    def _token_chunk_stream(self, sentences: Sequence[np.ndarray], total_words: float,
                            train_words: float) -> Iterator[dict]:
        """The token feed's chunks: up to K step rows, their alphas on the words
        clock (advanced by each block's kept or new core tokens), and the analytic
        pair (or CBOW example) estimate the heartbeats read (the exact count stays on
        the device until the end). No torch call, so it may run on the producer
        thread."""
        cfg = self.config
        K, T = cfg.steps_per_dispatch, self._tokens_per_step
        start_iter = self.state.iteration
        skip_steps = self.state.batches_done if not self.state.finished else 0
        rate = (_cbow_examples_per_kept_token(cfg.window) if self._banded_cbow
                else _pairs_per_kept_token(cfg.window))

        def chunks() -> Iterator[dict]:
            for k in range(start_iter, cfg.num_iterations + 1):
                prev_words = (k - 1) * train_words
                to_skip = skip_steps if k == start_iter else 0
                steps_in_iter, clock = to_skip, 0.0
                pending: List[tuple] = []

                def flush() -> dict:
                    nonlocal pending, steps_in_iter
                    real = len(pending)
                    arrays = {
                        "tokens": np.stack([p[0] for p in pending]),
                        "starts": np.stack([p[1] for p in pending]),
                        "nvalid": np.asarray([p[2] for p in pending], np.int64),
                        "obase": np.asarray([[p[3] & 0xFFFFFFFF, p[3] >> 32]
                                             for p in pending], np.int64)}
                    alphas = np.asarray([
                        alpha_schedule(p[5], total_words, cfg.learning_rate,
                                       cfg.min_alpha_factor)
                        for p in pending], np.float32)
                    steps_in_iter += real
                    chunk = dict(
                        arrays=arrays, alphas=alphas, real=real, iteration=k,
                        words_processed=int(pending[-1][5]), batches_done=steps_in_iter,
                        real_pairs=sum(p[4] for p in pending) * rate,
                        shard_progress=[[k, steps_in_iter]], shard_feed="tokens",
                        sub_base=int(stream_base(cfg.seed, STREAM_SUBSAMPLE, k, 0)),
                        win_base=int(stream_base(cfg.seed, STREAM_WINDOW, k, 0)))
                    pending = []
                    return chunk

                # one data segment, so a step row is one block
                for row in self._device_seg_blocks(sentences, k):
                    clock += row[4]
                    if to_skip:  # already trained (exact resume); the clock advances
                        to_skip -= 1
                        continue
                    pending.append((*row, prev_words + clock))
                    if len(pending) == K:
                        yield flush()
                if pending:
                    yield flush()

        return chunks()

    def _stage(self, chunks: Iterator[dict]) -> Iterator[dict]:
        """Send each chunk's arrays to the card from the producer thread: a copy into
        pinned host memory, non-blocking copies on a stream of their own, and an event
        recorded after them (``chunk["staged"]``). The pinned tensors ride with the
        chunk, so they outlive their copies. Only copies are issued here."""
        stream = torch.cuda.Stream(device=self.device)
        for chunk in chunks:
            pinned = {name: torch.from_numpy(a).pin_memory()
                      for name, a in chunk["arrays"].items()}
            with torch.cuda.stream(stream):
                arrays = {name: t.to(self.device, non_blocking=True)
                          for name, t in pinned.items()}
                done = torch.cuda.Event()
                done.record(stream)
            chunk.update(arrays=arrays, pinned=pinned, staged=done)
            yield chunk

    def _device_arrays(self, chunk: dict) -> dict:
        """The chunk's index arrays on the device, widened to int64. A staged chunk's
        tensors were allocated on the copy stream: the consumer's stream waits for
        their copies, and ``record_stream`` keeps the allocator from reusing them
        before the consumer's work on them is done."""
        done = chunk.get("staged")
        if done is None:
            return {name: torch.from_numpy(a).to(self.device).long()
                    for name, a in chunk["arrays"].items()}
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in chunk["arrays"].values():
            t.record_stream(stream)
        return {name: t.long() for name, t in chunk["arrays"].items()}

    def _step_fn(self) -> Callable:
        """The step of this config, ``step(batch, negatives, alpha, with_metrics)``:
        the JAX trainer's single-device selection matrix on the pair feeds (banded CBOW
        runs in ``_run_banded_chunk``; pallas and shard_map are refused by the config).
        The hot slabs ride in ``self._slabs``; the caller flushes them."""
        cfg = self.config
        p, n, mode = self.params, cfg.negatives, cfg.sigmoid_mode
        stab, dup = self._stabilizers, cfg.duplicate_scaling
        cd, ld, slabs = self.compute_dtype, self.logits_dtype, self._slabs
        chain = dict(fused=cfg.fused_logits, bf16_chain=cfg.bf16_chain)
        if cfg.cbow and cfg.negative_pool > 0:
            return lambda b, neg, alpha, wm: cbow_step_shared_core(
                p, b["centers"], b["contexts"], b["ctx_mask"], b["mask"], neg, alpha, n,
                mode, wm, stabilizers=stab, compute_dtype=cd, logits_dtype=ld)
        if cfg.cbow:
            return lambda b, neg, alpha, wm: cbow_step_core(
                p, b["centers"], b["contexts"], b["ctx_mask"], b["mask"], neg, alpha,
                mode, duplicate_scaling=dup, stabilizers=stab, compute_dtype=cd)
        if cfg.negative_pool > 0 and (stab.enabled or dup or slabs is not None):
            # the fused kernel has none of the three (the JAX package's pallas step
            # neither)
            return lambda b, neg, alpha, wm: sgns_step_shared_scatter_(
                p, b["centers"], b["contexts"], b["mask"], neg, alpha, n, mode, wm,
                duplicate_scaling=dup, stabilizers=stab, compute_dtype=cd,
                logits_dtype=ld, hot_slabs=slabs, **chain)
        if cfg.negative_pool > 0:
            return lambda b, neg, alpha, wm: fused_sgns_shared_step(
                p, b["centers"], b["contexts"], b["mask"], neg, alpha, n, mode, wm,
                compute_dtype=cd, logits_dtype=ld, **chain)
        return lambda b, neg, alpha, wm: sgns_step_core(
            p, b["centers"], b["contexts"], b["mask"], neg, alpha, mode,
            duplicate_scaling=dup, stabilizers=stab, compute_dtype=cd, hot_slabs=slabs,
            **chain)

    def _flush_hot(self) -> None:
        """Apply the pending hot-row deltas to the parameters and zero the slabs."""
        if self._slabs is not None:
            hot_flush(self.params.syn0, self._slabs[0])
            hot_flush(self.params.syn1, self._slabs[1])

    def _device_pairs(self, arrays: dict, chunk: dict) -> dict:
        """The chunk's pairs from its token blocks, in one batched call of the device
        generator; the exact pair and drop counts accumulate on the device."""
        cfg = self.config
        obase = arrays["obase"]
        pairs = device_block_pairs(
            arrays["tokens"], arrays["starts"], arrays["nvalid"], obase[:, 0],
            obase[:, 1], self._keep_prob_dev, chunk["sub_base"], chunk["win_base"],
            cfg.window, cfg.pairs_per_batch, presubsampled=True)
        self._exact_pairs += pairs.mask.sum(dim=1).long().sum()  # each row <= B, exact
        self._dropped += pairs.dropped_pairs.sum()
        return {"centers": pairs.centers, "contexts": pairs.contexts,
                "mask": pairs.mask}

    def _run_banded_chunk(self, arrays: dict, chunk: dict) -> StepMetrics:
        """Banded CBOW: the window extents of the chunk's K blocks in one batched call,
        then one banded step per block; the exact example count accumulates on the
        device. Returns the last step's metrics."""
        cfg = self.config
        obase = arrays["obase"]
        band = device_cbow_windows(
            arrays["tokens"], arrays["starts"], arrays["nvalid"], obase[:, 0],
            obase[:, 1], chunk["win_base"], cfg.window, self._block_halo)
        self._exact_pairs += ((band.center > 0) & (band.left + band.right > 0)).sum()
        negatives = sample_negatives_hash(
            self._table_prob, self._table_alias, cfg.seed, self.global_step + 1,
            (cfg.steps_per_dispatch, cfg.negative_pool))
        with_metrics = self._with_metrics(chunk["real"])
        metrics = None
        for k in range(chunk["real"]):
            metrics = cbow_step_banded_core(
                self.params, arrays["tokens"][k], band.left[k], band.right[k],
                band.center[k], band.token[k], negatives[k], float(chunk["alphas"][k]),
                cfg.negatives, cfg.window, cfg.sigmoid_mode, with_metrics,
                stabilizers=self._stabilizers, compute_dtype=self.compute_dtype,
                logits_dtype=self.logits_dtype)
        return metrics

    def _run_chunk(self, chunk: dict) -> StepMetrics:
        """Train the steps of one chunk; returns the last step's metrics. The hot slabs
        (zero at the chunk's start) are flushed every ``hot_flush_every`` steps and
        after the chunk's last step."""
        cfg = self.config
        arrays = self._device_arrays(chunk)
        if self._banded_cbow:
            return self._run_banded_chunk(arrays, chunk)
        if cfg.device_pairgen:
            arrays = self._device_pairs(arrays, chunk)
        K, B = cfg.steps_per_dispatch, arrays["centers"].shape[1]
        shape = ((K, B, cfg.negatives) if cfg.negative_pool == 0
                 else (K, cfg.negative_pool))
        negatives = sample_negatives_hash(
            self._table_prob, self._table_alias, cfg.seed, self.global_step + 1, shape)
        pos = torch.arange(B, device=self.device)
        with_metrics = self._with_metrics(chunk["real"])
        step = self._step_fn()
        metrics = None
        for k in range(chunk["real"]):
            batch = {name: a[k] for name, a in arrays.items()}
            if "mask" not in batch:
                batch["mask"] = (pos < int(chunk["reals"][k])).to(torch.float32)
            if cfg.cbow:
                C = batch["contexts"].shape[1]
                batch["ctx_mask"] = (torch.arange(C, device=self.device)[None, :]
                                     < batch.pop("nctx")[:, None]).to(torch.float32)
            metrics = step(batch, negatives[k], float(chunk["alphas"][k]), with_metrics)
            if (k + 1) % self._hot_flush == 0:
                self._flush_hot()
        if chunk["real"] % self._hot_flush:
            self._flush_hot()
        return metrics

    def fit(
        self,
        sentences: Sequence[np.ndarray],
        checkpoint_path: Optional[str] = None,
        checkpoint_every_steps: Optional[int] = None,
        on_heartbeat: Optional[Callable[[HeartbeatRecord], None]] = None,
    ) -> EmbeddingPair:
        """Run the remaining iterations over encoded sentences (int32 index arrays,
        OOV-filtered and chunked). Resumes from ``self.state``."""
        cfg = self.config
        self._check_resume_position()
        train_words = expected_kept_words(
            self.vocab.counts, self.vocab.train_words_count, cfg.subsample_ratio)
        total_words = float(cfg.num_iterations * train_words + 1)
        self._last_log_time = time.perf_counter()
        self._last_log_step = self.global_step
        self._pairs_since_log = 0.0
        self.host_wait_time = 0.0
        self.dispatch_time = 0.0
        token_feed = cfg.device_pairgen or self._banded_cbow
        if token_feed:
            self._exact_pairs = torch.zeros((), dtype=torch.int64, device=self.device)
            self._dropped = torch.zeros((), dtype=torch.int64, device=self.device)
            est_total = 0.0
            chunks = self._token_chunk_stream(sentences, total_words, float(train_words))
        else:
            chunks = self._chunk_stream(sentences, total_words, float(train_words))
        if cfg.prefetch_chunks > 0:
            if self.device.type == "cuda":
                chunks = self._stage(chunks)
            chunks = _threaded_iter(chunks, cfg.prefetch_chunks)
        try:
            while True:
                t0 = time.perf_counter()
                chunk = next(chunks, None)
                self.host_wait_time += time.perf_counter() - t0
                if chunk is None:
                    break
                t0 = time.perf_counter()
                metrics = self._run_chunk(chunk)
                self.dispatch_time += time.perf_counter() - t0
                if token_feed:
                    est_total += chunk["real_pairs"]
                self._finish_round(chunk, metrics, checkpoint_path,
                                   checkpoint_every_steps, on_heartbeat)
        finally:
            chunks.close()
        scatter.check_errors()
        if token_feed:
            self._settle_device_pairgen_books(est_total)
        self.state = TrainState(
            iteration=cfg.num_iterations,
            words_processed=int(cfg.num_iterations * train_words),
            finished=True, global_step=self.global_step)
        if checkpoint_path:
            self.save_checkpoint(checkpoint_path)
        return self.params

    def _check_resume_position(self) -> None:
        """Refuse a checkpoint whose recorded position indexes another feed's stream.
        A token-feed checkpoint (device pairs or banded CBOW) carries its position
        twice: ``batches_done`` (the step rows of this process's stream, what this
        trainer skips, as the JAX package's single-process device feed does) and
        ``shard_progress`` (per data segment); one without ``batches_done`` needs the
        per-segment resume."""
        st, cfg = self.state, self.config
        if st.shard_progress is None or st.finished:
            return
        if cfg.device_pairgen or self._banded_cbow:
            if st.shard_feed != "tokens":
                raise ValueError(
                    "checkpoint was written by a host-feed sharded-input run (its "
                    "positions index per-process pair streams); resume it with the "
                    "same process count and device_pairgen=False")
            if st.batches_done == 0:
                raise NotImplementedError(
                    "checkpoint records per-segment device-feed positions only "
                    "(shard_progress, from a multi-process run or an elastic resume); "
                    "the per-segment resume is multi-device work, not ported to "
                    "glint_word2vec_torch yet (ROADMAP.md queue A9)")
            return
        if st.shard_feed == "tokens":
            raise ValueError(
                "checkpoint was written by a token-block-feed run (its positions index "
                "per-segment token streams); resume it with the same feed — "
                "device_pairgen=True, or cbow_update='banded' if it was a banded-CBOW "
                "run")
        raise ValueError(
            f"checkpoint was written by a sharded-input multi-process run "
            f"({len(st.shard_progress)} shards); the port resumes single-process runs "
            "only (ROADMAP.md queue A9)")

    def _settle_device_pairgen_books(self, est_total: float) -> None:
        """End of a device-feed run: the heartbeats ran on the analytic pair estimate;
        settle the books against the exact trained and dropped totals, read from the
        device once."""
        exact = float(self._exact_pairs)
        dropped = int(self._dropped)
        self.dropped_pairs += dropped
        self.pairs_trained += exact - est_total
        self._pairs_since_log = max(self._pairs_since_log + exact - est_total, 0.0)
        if dropped > 0.02 * max(exact, 1.0):
            logger.warning(
                "device pairgen dropped %.0f pairs (%.1f%% of %.0f trained) to overflow "
                "— raise tokens_per_step (or lower pairs_per_batch fill pressure)",
                dropped, 100.0 * dropped / max(exact, 1.0), exact)
        elif dropped:
            logger.info("device pairgen: %.0f overflow pairs dropped (%.3f%%)",
                        dropped, 100.0 * dropped / max(exact, 1.0))

    def _finish_round(self, chunk: dict, metrics: StepMetrics,
                      checkpoint_path: Optional[str],
                      checkpoint_every_steps: Optional[int],
                      on_heartbeat: Optional[Callable[[HeartbeatRecord], None]]) -> None:
        """Progress counters, the heartbeat (with the non-finite check at its
        cadence) and periodic checkpoints."""
        cfg = self.config
        real = chunk["real"]
        self.global_step += real
        self._pairs_since_log += chunk["real_pairs"]
        self.pairs_trained += chunk["real_pairs"]
        self.state = TrainState(
            iteration=chunk["iteration"], words_processed=chunk["words_processed"],
            batches_done=chunk["batches_done"], global_step=self.global_step,
            shard_progress=chunk.get("shard_progress"),
            shard_feed=chunk.get("shard_feed"))
        ckpt_due = bool(checkpoint_path and checkpoint_every_steps
                        and self.global_step % checkpoint_every_steps < real)
        hb_due = self.global_step - self._last_log_step >= cfg.heartbeat_every_steps
        if cfg.nonfinite_policy == "halt" and hb_due and not ckpt_due:
            self._nonfinite_guard()  # checkpoint rounds are guarded by the save
        if hb_due:
            scatter.check_errors()
            now = time.perf_counter()
            rec = HeartbeatRecord(
                words=self.state.words_processed,
                alpha=float(chunk["alphas"][real - 1]),
                loss=float(metrics.loss), mean_f_pos=float(metrics.mean_f_pos),
                pairs_per_sec=self._pairs_since_log / max(now - self._last_log_time, 1e-9),
                global_step=self.global_step)
            self._pairs_since_log = 0.0
            self.heartbeats.append(rec)
            logger.info("wordCount = %d, alpha = %.6f, loss = %.4f, fPlus = %.4f, "
                        "pairs/s = %.0f", rec.words, rec.alpha, rec.loss,
                        rec.mean_f_pos, rec.pairs_per_sec)
            if on_heartbeat is not None:
                on_heartbeat(rec)
            self._last_log_time, self._last_log_step = now, self.global_step
        if ckpt_due:
            self.save_checkpoint(checkpoint_path)

    def _nonfinite_guard(self) -> None:
        """Raise if a parameter is NaN or infinite. One read pass per matrix
        (``aminmax`` propagates NaN and keeps infinities); the per-entry count for the
        diagnostic is only taken on failure."""
        if all(bool(torch.isfinite(torch.stack(torch.aminmax(m))).all())
               for m in self.params):
            return
        bad0 = int((~torch.isfinite(self.params.syn0)).sum())
        bad1 = int((~torch.isfinite(self.params.syn1)).sum())
        if bad0 or bad1:
            raise NonFiniteParamsError(
                f"non-finite parameters at global step {self.global_step}: {bad0} "
                f"entries in syn0, {bad1} in syn1 (of {self.padded_vocab}x"
                f"{self.padded_dim} each). Likely causes (EVAL.md): pool-row overload "
                f"(grow negative_pool), duplicate overload (lower subsample_ratio), or "
                f"a learning rate too high")

    # -- export / persistence ----------------------------------------------------------

    def unpadded_params(self) -> EmbeddingPair:
        V, D = self.vocab.size, self.config.vector_size
        return EmbeddingPair(self.params.syn0[:V, :D], self.params.syn1[:V, :D])

    def save_checkpoint(self, path: str) -> None:
        if self.config.nonfinite_policy == "halt":
            self._nonfinite_guard()  # never replace a good checkpoint with NaNs
        p = self.unpadded_params()  # dense saves are float32 (bf16 widens exactly)
        save_model(path, self.vocab.words, self.vocab.counts,
                   p.syn0.float().cpu().numpy(), p.syn1.float().cpu().numpy(),
                   self.config, self.state)
        logger.info("checkpoint saved to %s at step %d", path, self.global_step)
