"""Single-device synchronous trainer, ported from the host-feed path of
``glint_word2vec_tpu/train/trainer.py`` (``fit`` and its ``chunk`` function).

The control flow and bookkeeping are the JAX package's, so that a fit from the same
parameters gives the same step count, pair count, alpha trace and (to f32 tolerance)
parameters:

- batches come from the numpy pair feed and are stacked ``steps_per_dispatch`` to a
  chunk; a short last chunk is padded with masked dummy batches;
- each batch's mask is rebuilt as a prefix mask from its real pair count;
- one ``(K, P)`` pool of negatives is drawn per chunk from the hash PRNG at counter
  ``global_step + 1``, so the negative stream is a pure function of (seed, step);
- per-step alphas follow the words clock;
- chunks no heartbeat will sample run the metrics-elided step (same parameters);
- the AUTO pool is re-resolved for vocabularies past 500k words, and an AUTO
  subsample ratio is lowered out of the measured duplicate-overload region.

Differences: the step updates the parameters in place (the fused wrapper), the feed
runs on the calling thread (``prefetch_chunks``/``producer_workers`` change only wall
clock in the JAX package), the masked dummy steps of a padded chunk are skipped (they
are exact no-ops), and rollback/recovery, telemetry, statusd, profiling, stability
advisories and the multi-process feeds are not ported yet.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.pipeline import (
    epoch_batches, expected_kept_words, keep_probabilities)
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_torch.ops.sampler import build_alias_table, sample_negatives_hash
from glint_word2vec_torch.ops.sgns import (
    EmbeddingPair, StepMetrics, alpha_schedule, init_embeddings)
from glint_word2vec_torch.parallel.mesh import pad_dim_to_lanes, pad_vocab_for_sharding
from glint_word2vec_torch.train.checkpoint import TrainState, save_model

logger = logging.getLogger("glint_word2vec_torch")


class NonFiniteParamsError(RuntimeError):
    """The parameters went non-finite under ``nonfinite_policy='halt'``."""


def _pairs_per_kept_token(window: int) -> float:
    """E[pairs per kept token] under the legacy asymmetric window (sentence-boundary
    clipping ignored, so it overestimates slightly), floored at 1e-3."""
    b = np.arange(window, dtype=np.float64)
    return max(float(b.mean() + np.clip(b - 1, 0, None).mean()), 1e-3)


@dataclass
class HeartbeatRecord:
    words: int
    alpha: float
    loss: float
    mean_f_pos: float
    pairs_per_sec: float
    global_step: int = -1


class Trainer:
    """Owns the embedding pair on one device and runs the synchronous SGNS loop."""

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
    ):
        self.device = resolve_device(device)
        self.config = config
        self.vocab = vocab
        self._resolve_vocab_scaled_pool()
        config = self.config
        self.padded_vocab = pad_vocab_for_sharding(vocab.size)
        self.padded_dim = pad_dim_to_lanes(config.vector_size, config.pad_vector_to_lanes)
        self.table = build_alias_table(vocab.counts, config.sample_power)
        self._table_prob = torch.from_numpy(self.table.prob).to(self.device)
        self._table_alias = torch.from_numpy(
            self.table.alias.astype(np.int64)).to(self.device)
        if params is None:
            gen = torch.Generator().manual_seed(config.seed & 0xFFFFFFFFFFFFFFFF)
            params = init_embeddings(self.padded_vocab, config.vector_size, gen)
        self.params = self._place_params(params)
        self.state = train_state or TrainState()
        self._resolve_duplicate_channel()
        # resume continues the (seed, counter) negative lattice where it left off
        self.global_step = self.state.global_step
        self.pairs_trained = 0.0  # real (unmasked) pairs trained over this trainer
        self.heartbeats: "deque[HeartbeatRecord]" = deque(maxlen=config.heartbeat_ring)

    # -- setup -----------------------------------------------------------------------

    def _place_params(self, params) -> EmbeddingPair:
        """Copy (numpy or torch) parameters into zero-padded [Vp, Dp] float32 tensors
        on the device; the trainer owns and updates its copy."""
        def pad(a) -> torch.Tensor:
            t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
            if t.dim() != 2 or t.shape[0] > self.padded_vocab or t.shape[1] > self.padded_dim:
                raise ValueError(f"parameter shape {tuple(t.shape)} does not fit the "
                                 f"padded geometry ({self.padded_vocab}, {self.padded_dim})")
            out = torch.zeros((self.padded_vocab, self.padded_dim), dtype=torch.float32,
                              device=self.device)
            out[:t.shape[0], :t.shape[1]] = t.to(self.device, torch.float32)
            return out

        return EmbeddingPair(pad(params[0]), pad(params[1]))

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

    # -- training --------------------------------------------------------------------

    def _with_metrics(self, max_steps: int) -> bool:
        """Whether the next chunk runs the full-metrics step: only if a heartbeat may
        sample it (``max_steps`` bounds the steps it advances)."""
        return (self.global_step + max_steps - self._last_log_step
                >= self.config.heartbeat_every_steps)

    def _chunk_stream(self, sentences: Sequence[np.ndarray], total_words: float,
                      train_words: float) -> Iterator[dict]:
        """Numpy chunk assembly: K-stacked pair batches, masked-dummy padding, the
        alpha schedule and the resume skip."""
        cfg = self.config
        K = cfg.steps_per_dispatch
        start_iter = self.state.iteration
        skip_batches = self.state.batches_done if not self.state.finished else 0
        for k in range(start_iter, cfg.num_iterations + 1):
            prev_words = (k - 1) * train_words
            pending: List[dict] = []
            pending_words: List[float] = []
            batches_in_iter = skip_batches if k == start_iter else 0
            to_skip = batches_in_iter

            def flush() -> dict:
                nonlocal pending, pending_words, batches_in_iter
                real = len(pending)
                while len(pending) < K:  # pad to the chunk length, masked out
                    pending.append({"centers": np.zeros_like(pending[0]["centers"]),
                                    "contexts": np.zeros_like(pending[0]["contexts"]),
                                    "real": 0})
                    pending_words.append(pending_words[-1])
                pairs = np.empty((K, 2, pending[0]["centers"].shape[0]), np.int32)
                for j, b in enumerate(pending):
                    pairs[j, 0] = b["centers"]
                    pairs[j, 1] = b["contexts"]
                reals = np.asarray([b["real"] for b in pending], np.float32)
                alphas = np.asarray([
                    alpha_schedule(float(w), total_words, cfg.learning_rate,
                                   cfg.min_alpha_factor)
                    for w in pending_words], np.float32)
                batches_in_iter += real
                chunk = dict(pairs=pairs, alphas=alphas, reals=reals, real=real,
                             iteration=k, words_processed=int(pending_words[real - 1]),
                             batches_done=batches_in_iter, real_pairs=float(reals.sum()))
                pending, pending_words = [], []
                return chunk

            for b in epoch_batches(
                    sentences, self.vocab, pairs_per_batch=cfg.pairs_per_batch,
                    window=cfg.window, subsample_ratio=cfg.subsample_ratio,
                    seed=cfg.seed, iteration=k, shuffle=cfg.shuffle):
                if to_skip:  # fast-forward already-trained batches (exact resume)
                    to_skip -= 1
                    continue
                pending_words.append(prev_words + b.words_seen)
                pending.append({"centers": b.centers, "contexts": b.contexts,
                                "real": b.num_real_pairs})
                if len(pending) == K:
                    yield flush()
            if pending:
                yield flush()

    def _run_chunk(self, chunk: dict) -> StepMetrics:
        """Train the real steps of one chunk; returns the last step's metrics."""
        cfg = self.config
        K, _, B = chunk["pairs"].shape
        pairs = torch.from_numpy(chunk["pairs"]).to(self.device).long()
        negatives = sample_negatives_hash(
            self._table_prob, self._table_alias, cfg.seed, self.global_step + 1,
            (K, cfg.negative_pool))
        pos = torch.arange(B, device=self.device)
        with_metrics = self._with_metrics(chunk["real"])
        metrics = None
        # the masked dummy steps that pad a short chunk are exact no-ops: skip them
        for k in range(chunk["real"]):
            mask = (pos < int(chunk["reals"][k])).to(torch.float32)
            metrics = fused_sgns_shared_step(
                self.params, pairs[k, 0], pairs[k, 1], mask, negatives[k],
                float(chunk["alphas"][k]), cfg.negatives, cfg.sigmoid_mode,
                with_metrics)
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
        if self.state.shard_progress is not None and not self.state.finished:
            raise ValueError("checkpoint was written by a multi-process or token-feed "
                             "run; the port resumes single-process host-feed runs only")
        train_words = expected_kept_words(
            self.vocab.counts, self.vocab.train_words_count, cfg.subsample_ratio)
        total_words = float(cfg.num_iterations * train_words + 1)
        self._last_log_time = time.perf_counter()
        self._last_log_step = self.global_step
        self._pairs_since_log = 0.0
        for chunk in self._chunk_stream(sentences, total_words, float(train_words)):
            metrics = self._run_chunk(chunk)
            self._finish_round(chunk, metrics, checkpoint_path, checkpoint_every_steps,
                               on_heartbeat)
        self.state = TrainState(
            iteration=cfg.num_iterations,
            words_processed=int(cfg.num_iterations * train_words),
            finished=True, global_step=self.global_step)
        if checkpoint_path:
            self.save_checkpoint(checkpoint_path)
        return self.params

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
            batches_done=chunk["batches_done"], global_step=self.global_step)
        ckpt_due = bool(checkpoint_path and checkpoint_every_steps
                        and self.global_step % checkpoint_every_steps < real)
        hb_due = self.global_step - self._last_log_step >= cfg.heartbeat_every_steps
        if cfg.nonfinite_policy == "halt" and hb_due and not ckpt_due:
            self._nonfinite_guard()  # checkpoint rounds are guarded by the save
        if hb_due:
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
        p = self.unpadded_params()
        save_model(path, self.vocab.words, self.vocab.counts,
                   p.syn0.cpu().numpy(), p.syn1.cpu().numpy(), self.config, self.state)
        logger.info("checkpoint saved to %s at step %d", path, self.global_step)
