"""The synchronous trainer, ported from the host-feed path of
``glint_word2vec_tpu/train/trainer.py`` (``fit``, its ``chunk`` function and, on a
mesh, ``_fit_sharded``).

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
- each chunk runs as a prologue and a body (``_run_chunk``). The prologue, a fixed
  handful of launches, copies the chunk into the trainer's fixed [K, ...] input buffers
  (``self._inputs``): the index arrays, the masks built on the device from the chunk's
  real-pair counts (the device generators' outputs on the token feeds), the chunk's
  negatives and its alphas, scaled by the recovery's lr scale on the device. The body
  (``_chunk_body``) runs the steps from those buffers, each taking its α as a device
  scalar (``alphas[k]``), with the hot-row flushes, and stacks the steps' metrics
  into one [steps, 3] tensor (loss, mean_f_pos, pairs), so that a heartbeat reads step
  ``real - 1``, as the JAX trainer reads its stacked metrics;
- on a CUDA device the body is one replay of a CUDA graph per chunk (``train/graphs``,
  the counterpart of the JAX trainer's compiled scan), captured after a warm-up and
  kept in two twins, with and without the metrics (``_with_metrics``, the JAX
  trainer's ``_dispatch_step_fn``); a short last chunk replays the same graph, padded
  with masked steps (mask 0, α 0, index 0), as the JAX trainer pads it: exact no-ops
  on finite parameters. The graphs are recaptured when the step's form, its
  stabilizers or the identity of the parameters change (a restore, a recovery, a new
  placement). On the CPU, and on the card when the private ``_eager_chunks`` is set
  (the tests' and the smoke's control fits), the body runs eagerly, and a short last
  chunk runs its real steps only; ``graph_captures`` and ``graph_replays`` count this
  fit's captures and replays, ``chunks_run`` its chunks, ``restore_captures`` the
  captures made before each of its snapshot restores, ``prologue_time`` its
  prologues' host seconds;
- chunks no heartbeat will sample run the metrics-elided step (same parameters);
- every step build (the trainer's construction, a recovery that engages
  ``max_row_norm``) logs the JAX trainer's stability advisories
  (``_stability_warnings``) and its ``logits_dtype`` warning;
- the AUTO pool is re-resolved for vocabularies past 500k words, and an AUTO
  subsample ratio is lowered out of the measured duplicate-overload region.

``host_wait_time`` counts the seconds ``fit`` waited for the next chunk (its assembly,
and its staging when the producer is on); ``dispatch_time`` the seconds spent issuing
its steps (with the copy to the card when the producer is off); ``fit_time`` the whole
fit's wall seconds, to the end of its last step on the card.

The runtime layer (``glint_word2vec_torch/obs``), as the JAX trainer runs it:

- one health probe per probing round (a heartbeat with a guard, a watchdog or telemetry
  on; checkpoint rounds are probed inside ``save_checkpoint``) feeds the non-finite
  guard, the snapshot ring and the norm watchdog, and the heartbeat's ``norms``;
- ``nonfinite_policy="rollback"`` and ``norm_watch="recover"`` arm a ring of
  ``rollback_history`` parameter snapshots on the device (seeded with the starting
  parameters; a dropped slot is reused with ``copy_``); a rollback or a recovery pops
  the newest and jumps ``global_step`` by 2^22, so the retried stretch draws fresh
  negatives from the hash lattice;
- a recovery backs the lr off (``_lr_scale``, applied to the chunk's alphas at one point
  for every feed) and engages ``max_row_norm`` at ``norm_watch_threshold``; the next
  chunk's step is then built with it (on the shared pool: ``sgns_step_shared_scatter_``
  in place of the fused kernel);
- with ``telemetry_path`` the run log gets ``run_start``, ``heartbeat``, ``watchdog``,
  ``recovery``, ``preempt`` and ``run_end`` (with the span summary), the trace goes to
  ``<telemetry_path>.trace.json``, and the flight recorder dumps
  ``<telemetry_path>.blackbox.json`` when the fit dies; ``status_port`` serves the live
  snapshot; ``profile_dir`` records a ``torch.profiler`` trace of the first
  ``profile_steps`` steps;
- with the recorder or ``checkpoint_on_preempt``, a SIGTERM during the fit dumps and
  arms ``preempt_deadline_s``; the round's end drains it through the normal guarded
  save (after a ``torch.cuda.synchronize()``), records ``preempt`` and re-raises the
  signal under the prior handler;
- the fault plan's hooks (``train/faults.py``) run at the end of every round.

On a mesh of ranks (``plan``, ``parallel/``; one rank a card), the JAX trainer's
multi-process fit:

- each rank holds its row blocks of both matrices and runs the row-sharded twin of the
  step the selection matrix picks (``ops/sgns_shard.py``: the shared pool, with
  ``duplicate_scaling`` and, with ``sync_every = k > 1``, its k-step local-SGD windows,
  each data shard on its own slice of the negative lattice; the per-pair step; CBOW
  with either pool; banded CBOW); under ``embedding_partition="cols"`` it holds its
  column blocks of every row instead and runs the column-sharded twins (the partial
  logits summed over the model axis), saves dense checkpoints (data 0 / model 0
  writes the gathered columns) and relays its parameters to row blocks for the fit's
  model (:meth:`Trainer.row_blocks`);
- with ``shard_input`` (the default) each rank feeds its 1/W of the sentence stream
  (skip-gram pairs, or CBOW's grouped examples) and one allgather a round assembles the
  identical global batch on every rank (``_sharded_chunk_stream``); without it every
  rank regenerates the whole stream and trains its data slice of each batch;
- the token-block feeds (``device_pairgen``, banded CBOW) have one data segment a data
  shard: each rank packs its own segment's blocks, one allgather a round assembles the
  global blocks under an iteration barrier, so the rounds are the one-process feed's on
  the same segments, and each rank derives its slice's pairs or windows on its card
  (``_sharded_token_stream``); with ``sharded_prefetch`` the rounds are staged one
  ahead on a thread;
- every chunk runs eagerly: no graph is captured around the steps' collectives;
- the probe gathers its per-row-block partials, so every rank's guards decide alike;
  checkpoints are row shards, every rank writing its own rows; a sharded-input
  checkpoint resumes from its ``shard_progress`` at the same world size, a token-feed
  one (per data segment) on any mesh with the same data axis, or on one process;
- with ``peer_beacon_s`` (and a checkpoint path) the ranks heartbeat liveness beacons:
  a dead peer raises ``PeerDeathError`` at the next round instead of a hang.

Differences: the steps update the parameters in place, the feed ships int32 indices
(widened to int64 on the card, where the JAX package ships uint16 below 65536 words),
the eager body runs a short last chunk's real steps only (the graph replays the padded
chunk), the one-device token feed has one data segment unless it resumes a mesh's
per-segment checkpoint (then the checkpoint's), the ranks of one data column pack the
same token segment (a rank is a device, where a JAX process may own several segments),
the ``publish`` record of a save waits for the serving tier, and a mesh must cover the
world (the JAX trainer drops to one device when the devices are too few).
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import socket
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, replace as dc_replace
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

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
from glint_word2vec_torch.obs.blackbox import FlightRecorder
from glint_word2vec_torch.obs.phases import PhaseAccumulator
from glint_word2vec_torch.obs.probe import (
    column_probe_partials, combine_partials, health_stats, sharded_probe_partials,
    stats_to_channels)
from glint_word2vec_torch.obs.sink import TelemetrySink
from glint_word2vec_torch.obs.spans import clock_anchor, default_tracer
from glint_word2vec_torch.obs.statusd import StatusServer
from glint_word2vec_torch.obs.watch import NormWatchdog
from glint_word2vec_torch.ops import cbow_banded, scatter
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_torch.ops.cbow_banded import cbow_step_banded_core
from glint_word2vec_torch.ops.pairgen import device_block_pairs, device_cbow_windows
from glint_word2vec_torch.ops.sampler import build_alias_table, sample_negatives_hash
from glint_word2vec_torch.ops.sgns import (
    EmbeddingPair, Stabilizers, alpha_schedule, cbow_step_core, cbow_step_shared_core,
    hot_flush, hot_slabs, init_embeddings, sgns_step_core, sgns_step_shared_scatter_)
from glint_word2vec_torch.ops.sgns_shard import (
    column_sum, make_sharded_banded_step, make_sharded_cbow_step,
    make_sharded_per_pair_step, make_sharded_sgns_step)
from glint_word2vec_torch.parallel import distributed
from glint_word2vec_torch.parallel.mesh import (
    MODEL_AXIS, LocalShards, MeshPlan, cols_to_rows, gather_cols, make_mesh,
    pad_dim_to_lanes, pad_vocab_for_sharding)
from glint_word2vec_torch.train import faults
from glint_word2vec_torch.train.checkpoint import TrainState, save_model, save_model_sharded
from glint_word2vec_torch.train.faults import NonFiniteParamsError, NormBlowupError
from glint_word2vec_torch.train.graphs import ChunkGraphs
from glint_word2vec_torch.train.syncsites import SyncSites

logger = logging.getLogger("glint_word2vec_torch")

# the step forms without a shared pool: the advisories skip the pool channel there, and
# their steps compute the metrics in every chunk (no elided twin, as in the JAX trainer)
_POOLLESS_FORMS = ("per_pair", "cbow_per_example", "sharded_per_pair",
                   "sharded_cbow_per_example")
# the input buffers that gate a step's updates: all zero, a step is a padded no-op
_GATES = ("mask", "ctx_mask", "center", "token")


def _is_banded(cfg: Word2VecConfig) -> bool:
    return bool(cfg.cbow and cfg.cbow_update == "banded")


def segment_base_rows(bases: dict, n: int) -> dict:
    """The per-row hashrng bases of a one-device token chunk of several segments: its
    ``sub_bases`` and ``win_bases`` (lists of one int a segment) as [n, Sd] int64 arrays
    for its n step rows, which ride the chunk's arrays through the staging path."""
    return {k: np.tile(np.asarray(bases[k], np.int64), (n, 1))
            for k in ("sub_bases", "win_bases")}


def _world_spans_hosts() -> bool:
    """Whether the ranks of this world run on more than one host: one allgather of
    each rank's host name over the world (a collective every rank calls)."""
    if not distributed.is_multiprocess():
        return False
    name = socket.gethostname().encode()[:255]
    got = distributed.allgather({"host": np.frombuffer(name.ljust(256, b"\0"),
                                                       np.uint8)})
    return len({bytes(h) for h in got["host"]}) > 1


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


class _one_ahead_iter:
    """Run a generator on a background thread exactly one item ahead of the consumer,
    under an explicit ticket: after delivering item r the producer does not start item
    r + 1 until the consumer calls ``ack()`` for r (the JAX package's).

    The sharded token feed's staging (``config.sharded_prefetch``): producing a round
    launches the next round's allgather, and consuming one launches the steps' and the
    bookkeeping's collectives. Every rank must issue the collectives of a process
    group in one order, so the ticket serialises the two threads into one order,
    [gather r+1, round r's steps and bookkeeping, gather r+2, ...], the same on every
    rank because both sides decide from gathered values only. What overlaps is the
    host work: the round's decode and assembly and its copy to the card run while the
    previous round trains.

    An exception of the generator is raised at the consumer's ``next()``; ``close()``
    unblocks and joins the producer, which closes the generator."""

    _DONE = object()

    def __init__(self, gen: Iterator):
        self._out: "queue.Queue" = queue.Queue(maxsize=1)
        self._ack: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()

        def put_checked(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def wait_ack() -> bool:
            while not self._stop.is_set():
                try:
                    self._ack.get(timeout=0.1)
                    return True
                except queue.Empty:
                    continue
            return False

        def run():
            try:
                first = True
                while True:
                    # the ticket gates the production of item r + 1 (before the
                    # generator resumes), so its launches follow the consumer's
                    # round-r launches on every rank
                    if not first and not wait_ack():
                        return
                    first = False
                    try:
                        item = next(gen)
                    except StopIteration:
                        put_checked(self._DONE)
                        return
                    if not put_checked(item):
                        return
            except BaseException as e:  # relayed to the consumer
                put_checked(e)
            finally:
                gen.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="glint-round-stager")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._out.get()
        if item is self._DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def ack(self) -> None:
        self._ack.put(None)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._out.get_nowait()
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
    """One heartbeat, the JAX package's fields: ``alpha`` is the effective lr (the
    schedule's alpha times the ``lr_scale`` the chunk was dispatched under), ``norms``
    the probe's channels when it ran that round, ``phases`` the phase histograms of the
    window when attribution is on; ``sync_every`` and ``merge_round`` carry their
    one-device values."""

    words: int
    alpha: float
    loss: float
    mean_f_pos: float
    pairs_per_sec: float
    global_step: int = -1
    host_wait_s: float = 0.0       # host wait since the previous heartbeat
    dispatch_s: float = 0.0        # dispatch time since the previous heartbeat
    norms: Optional[dict] = None
    recoveries: int = 0            # recoveries performed so far this fit
    lr_scale: float = 1.0
    phases: Optional[dict] = None
    sync_every: int = 1
    merge_round: int = -1


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
        plan: Optional[MeshPlan] = None,
    ):
        """``feed_backend``: the skip-gram pair generator, "native", "numpy" or
        "auto" (native when it is built, as the JAX package chooses); CBOW has only
        the numpy generator, and ``device_pairgen`` and banded CBOW only "device" (the
        token-block feed, which "auto" resolves to). The resolved choice is
        ``self.feed_backend``.

        ``plan``: a (data, model) mesh of ranks (``parallel/mesh.make_mesh``); None
        builds the config's (``num_data_shards`` x ``num_model_shards``, or
        ``mesh_shape``) when it is larger than 1x1 or the world has more than one
        rank. On a mesh larger than 1x1 (``self.plan``; None on one device) this
        rank holds its row blocks of both matrices and runs the row-sharded steps
        (``ops/sgns_shard.py``). ``params`` are then full matrices, carved to this
        rank's rows, or a :class:`..parallel.mesh.LocalShards` taken as they are."""
        self.device = resolve_device(device)
        self.config = config
        self.vocab = vocab
        self.feed_backend = self._resolve_feed(feed_backend)
        self._resolve_vocab_scaled_pool()
        config = self.config
        self.plan = self._resolve_plan(plan)
        self.padded_vocab = pad_vocab_for_sharding(
            vocab.size, self.plan.num_model if self.plan is not None else 1)
        self.padded_dim = pad_dim_to_lanes(config.vector_size, config.pad_vector_to_lanes)
        # the column layout (the reference's partial-dot scheme): this rank holds its
        # column blocks [Vp, Dp / num_model] of every row, not row blocks
        self._cols = self.plan is not None and config.embedding_partition == "cols"
        if self._cols and self.padded_dim % self.plan.num_model:
            raise ValueError(
                f"embedding_partition='cols' needs the padded vector dim "
                f"{self.padded_dim} divisible by num_model={self.plan.num_model}")
        self.table = build_alias_table(vocab.counts, config.sample_power)
        # graftlint: disable=R6 -- one placement at construction, before any chunk is fed; the staging path is the per-chunk feed's
        self._table_prob = torch.from_numpy(self.table.prob).to(self.device)
        # graftlint: disable=R6 -- one placement at construction, before any chunk is fed; the staging path is the per-chunk feed's
        self._table_alias = torch.from_numpy(self.table.alias.astype(np.int64)).to(
            self.device)
        self.param_dtype = getattr(torch, config.param_dtype)
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.logits_dtype = getattr(torch, config.logits_dtype)
        # a sharded-input mesh fit: each rank feeds its 1/W of the sentence stream,
        # and the global batch is W contiguous segments (_sharded_chunk_stream)
        self._feed_segments = 1
        if self.plan is not None and config.shard_input and not (
                config.device_pairgen or _is_banded(config)):
            n = distributed.world_size()
            if config.pairs_per_batch % n:
                raise ValueError(
                    f"shard_input=True needs pairs_per_batch divisible by the "
                    f"process count ({config.pairs_per_batch} % {n} != 0)")
            self._feed_segments = n
        if params is None:
            gen = torch.Generator().manual_seed(config.seed & 0xFFFFFFFFFFFFFFFF)
            params = init_embeddings(self.padded_vocab, config.vector_size, gen,
                                     self.param_dtype)
        self.params = self._place_params(params)
        self.state = train_state or TrainState()
        # the token-block feed's data segments (the JAX trainer's plan.num_data): the
        # mesh's data axis, each rank deriving its slice from its own segment; on one
        # device 1, or a per-segment checkpoint's count (an elastic resume of a mesh's
        # token feed on one process)
        self._token_segments = self._resolve_token_segments()
        # additive metadata keys merged into every save this trainer makes (periodic,
        # final, preempt); the continual runner parks its vocab_lineage chain here
        self.extra_checkpoint_meta: dict = {}
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
            # core slots per segment block = examples per segment per step
            self._init_token_block_feed(
                self.config.pairs_per_batch // self._token_segments
                + 2 * self._block_halo)
        # from the config, then trainer state (a recovery may engage max_row_norm);
        # all zero runs no stabilizer op
        self._stabilizers = Stabilizers(max_row_norm=self.config.max_row_norm,
                                        update_clip=self.config.update_clip,
                                        row_l2=self.config.row_l2)
        # cross-step hot rows: K clamped to the real vocabulary (the padding rows are
        # never touched), flushed every hot_flush_every steps (0: once per chunk)
        self._hot_rows = int(min(self.config.hot_rows, vocab.size))
        self._hot_flush = self.config.hot_flush_every or self.config.steps_per_dispatch
        self._slabs = (hot_slabs(self._hot_rows, self.padded_dim, self.param_dtype,
                                 self.device) if self._hot_rows else None)
        self._announce_step()
        # the chunk's fixed [K, ...] input buffers (the prologue fills them, the body and
        # its graphs read them), the CUDA graphs of the body, and the private switch that
        # runs the body eagerly on the card (the tests' and the smoke's control fits)
        self._inputs: dict = {}
        self._graphs: Optional[ChunkGraphs] = None
        # the loop's declared host-sync and transfer sites (train/syncsites.py)
        self.sync_sites = SyncSites()
        self._eager_chunks = False
        self.prologue_time = 0.0
        self.chunks_run = 0  # this fit's chunks
        self.fit_time = 0.0  # the last fit's wall seconds, to the card's last step
        self.restore_captures: List[int] = []  # graph_captures at each of its restores
        # resume continues the (seed, counter) negative lattice where it left off
        self.global_step = self.state.global_step
        self.pairs_trained = 0.0  # real (unmasked) pairs trained over this trainer
        self.heartbeats: "deque[HeartbeatRecord]" = deque(maxlen=config.heartbeat_ring)
        self.dropped_pairs = 0  # device_pairgen: pairs past the B slots, this trainer
        self.host_wait_time = 0.0
        self.dispatch_time = 0.0
        self._init_runtime()

    def _init_runtime(self) -> None:
        """The runtime layer's state: the snapshot ring (filled only under
        ``rollback``/``recover``), the recovery's lr scale (it outlives a fit; the
        budgets reset per fit), and the observers, each None or disabled when its knob
        is off."""
        cfg = self.config
        self._snapshot_ring: "deque" = deque(maxlen=cfg.rollback_history)
        self._spare_params: List[EmbeddingPair] = []  # slots to copy_ a snapshot into
        self.rollbacks_performed = 0
        self.recoveries_performed = 0
        self._lr_scale = 1.0
        self._probed: Optional[dict] = None  # this round's probe, until its end
        self._last_probe_channels: Optional[dict] = None
        self.norm_watchdog = NormWatchdog(cfg.norm_watch, cfg.norm_watch_threshold,
                                          cfg.norm_watch_max, cfg.norm_watch_frac)
        self._tracer = default_tracer()
        self._telemetry = (TelemetrySink(cfg.telemetry_path,
                                         rotate_bytes=cfg.telemetry_rotate_bytes)
                           if cfg.telemetry_path else None)
        self._blackbox = (FlightRecorder(cfg.telemetry_path + ".blackbox.json",
                                         cfg.blackbox_ring)
                          if self._telemetry is not None else None)
        observing = self._telemetry is not None or cfg.status_port > 0
        self._phases = PhaseAccumulator(enabled=observing)
        # armed (or disarmed) here, not at fit: the feed iterators are built first
        self._tracer.configure(enabled=observing)
        self._tracer.attach_phases(self._phases if observing else None)
        self._statusd: Optional[StatusServer] = None  # fit-scoped
        self._prev_sigterm = None
        self._sigterm_installed = False
        self._profiler = None
        self._run_id = ""
        self._run_ended = True
        self._preempt_deadline: Optional[float] = None
        self._preempt_signum = 0
        self._active_checkpoint_path: Optional[str] = None
        self._beacons = None  # a mesh fit's liveness board, fit-scoped
        self._shard_clock = 0.0  # the sharded feed's global word clock

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

    def _resolve_plan(self, plan: Optional[MeshPlan]) -> Optional[MeshPlan]:
        """The mesh this trainer runs on, or None for one device. A mesh must cover
        the world (``make_mesh`` raises otherwise: no fallback to fewer devices); the
        JAX trainer's refusals on a mesh (hot_rows, a replicated token feed) raise its
        classes and messages."""
        cfg = self.config
        if plan is None:
            nd, nm = cfg.mesh_size
            if nd * nm == 1 and not distributed.is_multiprocess():
                return None
            plan = make_mesh(nd, nm)
        elif not isinstance(plan, MeshPlan):
            raise TypeError(f"plan must be a glint_word2vec_torch MeshPlan "
                            f"(parallel.mesh.make_mesh), got {type(plan).__name__}")
        if plan.size == 1:
            return None
        if cfg.embedding_partition == "cols" and cfg.sharded_checkpoint:
            raise ValueError(
                "embedding_partition='cols' is experimental and single-host only: "
                "row-shards checkpoints need each process to own whole rows "
                "(design rationale: PERF.md §7); use 'rows'")
        if cfg.embedding_partition == "cols" and _world_spans_hosts():
            # the JAX trainer's process_count() > 1: there one process drives every
            # device of its host, here one rank drives one card, so a world of ranks
            # on one host is the counterpart of one JAX process
            raise ValueError(
                "embedding_partition='cols' is experimental and single-host only: "
                "multi-process runs need each process to own whole rows "
                "(design rationale: PERF.md §7); use 'rows'")
        where = f"a {plan.num_data}x{plan.num_model} mesh"
        if cfg.hot_rows:
            # the JAX trainer's runtime twin of the config's multi-shard refusal
            raise ValueError(
                "hot_rows is the single-chip step restructuring "
                "(PERF.md §11) and the mesh plan has "
                f"{plan.size} devices; use a single-device plan or hot_rows=0")
        if (cfg.device_pairgen or _is_banded(cfg)) and not cfg.shard_input:
            feature = "device_pairgen" if cfg.device_pairgen else "cbow_update='banded'"
            raise ValueError(
                f"{feature} with multiple processes requires "
                "shard_input=True (each process packs token blocks for "
                "its own data segments; a replicated token feed would "
                "have every process regenerate everything)")
        if cfg.pairs_per_batch % plan.num_data:
            raise ValueError(
                f"the row-sharded step (step_lowering={cfg.step_lowering!r}: the port "
                f"runs the owner-local schedule for both) splits the batch over the "
                f"data axis with static shapes: pairs_per_batch={cfg.pairs_per_batch} "
                f"must be divisible by num_data={plan.num_data}")
        if self.device.type == "cuda":
            logger.info("%s: each chunk's steps run eagerly; the chunk's CUDA graph is "
                        "not captured around collectives (ROADMAP.md queue A9b)", where)
        return plan

    def _resolve_token_segments(self) -> int:
        """The token feed's data segments: the mesh's data axis; on one device the
        entries of a per-segment token-feed checkpoint (``shard_progress`` without a
        ``batches_done``, as a mesh writes it), else 1."""
        if self.plan is not None:
            return self.plan.num_data
        st = self.state
        if (st.shard_progress is not None and not st.finished
                and st.shard_feed == "tokens" and st.batches_done == 0
                and (self.config.device_pairgen or _is_banded(self.config))):
            return len(st.shard_progress)
        return 1

    @property
    def _row_offset(self) -> int:
        """The global index of this rank's first row (0 on one device and under the
        column layout)."""
        if self.plan is None or self._cols:
            return 0
        return self.plan.rows(self.padded_vocab)[0]

    def _place_params(self, params) -> EmbeddingPair:
        """Copy (numpy or torch) parameters into zero-padded tensors of
        ``param_dtype`` on the device (a float32 source is rounded to bf16 once): the
        whole [Vp, Dp] matrices on one device, this rank's [Vs, Dp] row blocks on a
        mesh, or its [Vp, Dc] column blocks under the column layout (carved from full
        matrices, or :class:`LocalShards` as they are); the trainer owns and updates
        its copy, each block a contiguous tensor of its own."""
        lo, hi = (self.plan.rows(self.padded_vocab)
                  if self.plan is not None and not self._cols
                  else (0, self.padded_vocab))
        clo, chi = (self.plan.cols(self.padded_dim) if self._cols
                    else (0, self.padded_dim))
        local = isinstance(params, LocalShards)

        def pad(a) -> torch.Tensor:
            t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
            rows = hi - lo if local else self.padded_vocab
            width = chi - clo if local else self.padded_dim
            if t.dim() != 2 or t.shape[0] > rows or t.shape[1] > width:
                raise ValueError(f"parameter shape {tuple(t.shape)} does not fit the "
                                 f"padded geometry ({rows}, {width})")
            if not local:
                t = t[lo:hi, clo:chi]
            out = torch.zeros((hi - lo, chi - clo), dtype=self.param_dtype,
                              device=self.device)
            out[:t.shape[0], :t.shape[1]] = t.to(self.device, self.param_dtype)
            return out

        return EmbeddingPair(pad(params[0]), pad(params[1]))

    def _announce_step(self) -> None:
        """The JAX trainer's warnings at every step build: the ``logits_dtype`` one,
        then the stability advisories (without the pool channel on the per-pair and
        per-example paths, as there)."""
        self._warn_logits_dtype()
        self._stability_warnings(check_pool=self._step_form() not in _POOLLESS_FORMS)

    def _stability_warnings(self, check_pool: bool = True) -> None:
        """The JAX trainer's advisories on the two per-step row-overload channels
        (EVAL.md), with its thresholds and messages:

        - POOL load ``B·n/P``: every pool row absorbs the negative gradient of all B
          pairs scaled by n/P. Past 300 with more than 500k words the large-vocabulary
          advisory (a measured finite norm blowup there) takes precedence over the
          generic warning past 2000;
        - DUPLICATE load ``B·max_word_share`` (``_duplicate_load``) past 300: a
          frequent word's occurrences scatter-add summed updates; and the compounding
          band (pool load past 1000 with duplicate load past 150), where the channels
          compound on frequent rows over long runs.

        ``check_pool=False`` on the per-pair and per-example paths (no pool). Silent
        under ``duplicate_scaling``, whose mean updates bound both channels."""
        cfg = self.config
        if cfg.duplicate_scaling:
            return
        pool_load = (cfg.pairs_per_batch * cfg.negatives / cfg.negative_pool
                     if check_pool and cfg.negative_pool > 0 else 0.0)
        if pool_load > 300 and self.vocab.size > self._LARGE_VOCAB_BOUNDARY:
            logger.warning(
                "negative-pool load %.0f with a %d-word vocabulary: large-vocab "
                "long runs measured a finite norm blowup in this region "
                "(EVAL.md round-5 ladder — purity collapse without NaN at load "
                "640; load 160 fixed that collapse and tames norm growth on "
                "longer runs); consider negative_pool >= %d (an AUTO pool "
                "scales itself to load <= 160 past 500k vocab — this one was "
                "set explicitly), or the stabilizer/watchdog knobs "
                "(max_row_norm, norm_watch='recover' — docs/robustness.md)",
                pool_load, self.vocab.size,
                128 * (-(-cfg.pairs_per_batch * cfg.negatives // (160 * 128))))
        elif pool_load > 2000:
            logger.warning(
                "pairs_per_batch*negatives/negative_pool = %.0f > 2000: pool-row "
                "updates this large can diverge at default learning rates — scale "
                "negative_pool with the batch (e.g. %d) to keep the load ~1300 "
                "(EVAL.md)", pool_load,
                max(64, int(cfg.pairs_per_batch * cfg.negatives / 1300)))
        dup_load = self._duplicate_load(cfg.subsample_ratio)
        if dup_load > 300:
            logger.warning(
                "expected duplicates of the most frequent word per %d-pair batch "
                "= %.0f > 300: summed scatter updates this dense can diverge — "
                "set subsample_ratio (~1e-4, recommended) or "
                "duplicate_scaling=True, or shrink pairs_per_batch (EVAL.md)",
                cfg.pairs_per_batch, dup_load)
        elif pool_load > 1000 and dup_load > 150:
            logger.warning(
                "pool load %.0f and top-word duplicate load %.0f are each below "
                "their individual divergence thresholds but compound on frequent "
                "rows over long runs (measured NaN at 60M words, EVAL.md) — for "
                "long runs grow negative_pool (load <= ~600) or shrink "
                "pairs_per_batch", pool_load, dup_load)

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
        if cfg.pairs_per_batch % self._token_segments:
            feature = "device_pairgen" if cfg.device_pairgen else "cbow_update='banded'"
            raise ValueError(
                f"{feature} needs pairs_per_batch divisible by the data-"
                f"parallel degree ({cfg.pairs_per_batch} % {self._token_segments} != 0)")
        keep = keep_probabilities(self.vocab.counts, self.vocab.train_words_count,
                                  cfg.subsample_ratio).astype(np.float32)
        self._keep_host = keep
        kp = np.zeros(self.padded_vocab, np.float32)
        kp[:self.vocab.size] = keep
        # graftlint: disable=R6 -- one placement when the token feed is set up (construction or a duplicate-channel resolve), before any chunk is fed
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
        T = int(np.ceil(0.93 * cfg.pairs_per_batch / self._token_segments
                        / _pairs_per_kept_token(cfg.window)))
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
                    # the device copies of the step scalars ride with the index arrays
                    arrays.update(alphas=alphas, reals=reals)
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

    def _device_seg_blocks(self, sentences: Sequence[np.ndarray], k: int, s: int = 0,
                           workers: Optional[int] = None) -> Iterator[tuple]:
        """[T]-token blocks of data segment s, iteration k, for the device pair
        generator (the segment holds sentences s, s + Sd, ... of the
        ``self._token_segments`` segments, shuffled per (seed, k, s): deterministic and
        independent of the process that packs it), subsampled on
        the host (the feed's hashrng draws on raw ordinals, vectorised over ~1M-token
        slabs fanned over ``workers`` threads, so the stream is the same at any worker
        count), so the wire carries only kept tokens and the lr clock is exact. The
        kept stream is cut at T boundaries: a sentence straddling a cut loses its
        cross-cut windows, as the reference's maxSentenceLength chunking does. Yields
        (tokens int32 [T], start bits uint8 [ceil(T/8)], n_valid, kept-ordinal base,
        kept count). Banded CBOW (``self._block_halo > 0``) cuts the same kept stream
        with a ±halo overlap instead (``pack_halo_token_blocks``), and the count is the
        block's new core tokens."""
        cfg = self.config
        workers = cfg.producer_workers if workers is None else workers
        T = self._tokens_per_step
        keep = self._keep_host
        order = np.arange(s, len(sentences), self._token_segments)
        if cfg.shuffle:
            stream_rng(cfg.seed, k, s).shuffle(order)
        sub_base = stream_base(cfg.seed, STREAM_SUBSAMPLE, k, s)

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

    def _device_step_rows(self, sentences: Sequence[np.ndarray], k: int, segs,
                          skips=None, counts=None) -> Iterator[tuple]:
        """One entry a step row over the data segments ``segs``, stacked across them:
        (tokens int32 [n, T], start bits uint8 [n, ceil(T/8)], n_valid int64 [n],
        ordinal bases int64 [n, 2] (low, high 32 bits), expected kept tokens). A segment
        that is exhausted before the others rides as zero blocks (n_valid 0); the stream
        ends when every segment is. ``skips`` (a resume): each segment's blocks to
        fast-forward first, −1 for a segment that already finished this iteration.
        ``counts``: updated in place with each segment's consumed blocks, skips
        included (the per-segment positions a checkpoint records). The JAX trainer's
        ``_device_step_rows``; its segments run one after another here, each with the
        slab workers."""
        segs = list(segs)
        T = self._tokens_per_step
        nbytes = (T + 7) // 8
        iters = []
        for i, s in enumerate(segs):
            skip = 0 if skips is None else skips[i]
            if skip < 0:
                iters.append(iter(()))
                continue
            it = self._device_seg_blocks(sentences, k, s)
            for consumed in range(skip):
                if next(it, None) is None:
                    # a shorter stream than the checkpoint's position means another
                    # corpus: training on would train the wrong data with wrong books
                    raise ValueError(
                        f"device-feed resume: segment {s} iteration {k} has only "
                        f"{consumed} blocks but the checkpoint recorded {skip} — the "
                        "corpus does not match the checkpoint")
            iters.append(it)
            if counts is not None:
                counts[i] += max(skip, 0)
        while True:
            rows = []
            exp_kept = 0.0
            exhausted = 0
            for i, it in enumerate(iters):
                blk = next(it, None)
                if blk is None:
                    exhausted += 1
                    rows.append((np.zeros(T, np.int32), np.zeros(nbytes, np.uint8), 0, 0,
                                 0.0))
                else:
                    rows.append(blk)
                    exp_kept += blk[4]
                    if counts is not None:
                        counts[i] += 1
            if exhausted == len(iters):
                return
            yield (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
                   np.asarray([r[2] for r in rows], np.int64),
                   np.asarray([[r[3] & 0xFFFFFFFF, r[3] >> 32] for r in rows], np.int64),
                   exp_kept)

    def _device_seg_resume_state(self) -> List[List[int]]:
        """The token feed's per-segment resume positions, ``[[iteration, blocks]]`` in
        segment order: a fresh run (or a finished state) starts every segment at
        (iteration, 0); a checkpoint's ``shard_progress`` is checked against this
        feed's segments. Entries are per data segment, not per rank, so any mesh with
        the same data axis, and one process, resume them (the JAX trainer's checks and
        messages)."""
        Sd = self._token_segments
        st = self.state
        if st.shard_progress is None or st.finished:
            if st.batches_done and not st.finished and distributed.is_multiprocess():
                raise ValueError(
                    "checkpoint was written mid-iteration by a pre-elastic "
                    "device-feed run (no per-segment positions); resume it "
                    "single-process (or from an iteration boundary)")
            return [[st.iteration, 0] for _ in range(Sd)]
        if st.shard_feed != "tokens":
            raise ValueError(
                "checkpoint shard_progress indexes the host-feed pair streams "
                f"(shard_feed={st.shard_feed!r}); resume it with "
                "device_pairgen=False — token positions are a different stream")
        if len(st.shard_progress) != Sd:
            raise ValueError(
                f"checkpoint shard_progress has {len(st.shard_progress)} "
                f"entries but the mesh data degree is {Sd}; device-feed "
                "positions are per data segment — resume on a mesh with the "
                "same data degree")
        return [[int(a), int(b)] for a, b in st.shard_progress]

    def _token_rate(self) -> float:
        """Pairs (banded CBOW: examples) a kept token trains, the heartbeats'
        analytic estimate."""
        return (_cbow_examples_per_kept_token(self.config.window) if self._banded_cbow
                else _pairs_per_kept_token(self.config.window))

    def _token_chunk_stream(self, sentences: Sequence[np.ndarray], total_words: float,
                            train_words: float) -> Iterator[dict]:
        """The one-process token feed's chunks (the JAX trainer's ``_fit_device_feed``):
        up to K step rows of ``self._token_segments`` segment blocks each ([n, Sd, T]
        tokens, [n, Sd, ...] start bits, valid counts and ordinal bases), their alphas
        on the words clock (advanced by each row's kept or new core tokens), and the
        analytic pair (or CBOW example) estimate the heartbeats read (the exact count
        stays on the device until the end). A checkpoint with a step-row count
        (``batches_done``, this feed's own) skips that many rows, rebuilding the clock
        exactly; one with per-segment positions only (a mesh's) fast-forwards each
        segment, the clock rebuilt from the saved word count (exact to < 1 word). Every
        chunk records each segment's position (``shard_progress``). No torch call, so
        it may run on the producer thread."""
        cfg = self.config
        K, Sd = cfg.steps_per_dispatch, self._token_segments
        st = self.state
        seg_state = (self._device_seg_resume_state()
                     if st.shard_progress is not None and not st.finished
                     and st.batches_done == 0 else None)
        start_iter = min(it for it, _ in seg_state) if seg_state else st.iteration
        skip_steps = st.batches_done if not (st.finished or seg_state) else 0
        rate = self._token_rate()

        def chunks() -> Iterator[dict]:
            for k in range(start_iter, cfg.num_iterations + 1):
                prev_words = (k - 1) * train_words
                if seg_state:
                    skips = [b if it == k else (-1 if it > k else 0)
                             for it, b in seg_state]
                    clock = (max(0.0, float(st.words_processed) - prev_words)
                             if k == st.iteration else 0.0)
                    steps_in_iter = max([b for it, b in seg_state if it == k], default=0)
                    to_skip = 0
                else:
                    skips, clock = None, 0.0
                    steps_in_iter = to_skip = skip_steps if k == start_iter else 0
                counts = [0] * Sd
                pending: List[tuple] = []

                def flush() -> dict:
                    nonlocal pending, steps_in_iter
                    real = len(pending)
                    arrays = {name: np.stack([p[i] for p in pending])
                              for i, name in enumerate(("tokens", "starts", "nvalid",
                                                        "obase"))}
                    alphas = np.asarray([
                        alpha_schedule(p[5], total_words, cfg.learning_rate,
                                       cfg.min_alpha_factor)
                        for p in pending], np.float32)
                    arrays["alphas"] = alphas
                    bases = self._segment_bases(k)
                    if Sd > 1:
                        arrays.update(segment_base_rows(bases, real))
                    steps_in_iter += real
                    sprog = [list(seg_state[i]) if skips and skips[i] < 0
                             else [k, counts[i]] for i in range(Sd)]
                    chunk = dict(
                        arrays=arrays, alphas=alphas, real=real, iteration=k,
                        words_processed=int(pending[-1][5]),
                        # after a per-segment resume the joined rows are offset from
                        # the row stream, so the positions are per segment only
                        batches_done=0 if seg_state else steps_in_iter,
                        real_pairs=sum(p[4] for p in pending) * rate,
                        shard_progress=sprog, shard_feed="tokens", **bases)
                    pending = []
                    return chunk

                for row in self._device_step_rows(sentences, k, range(Sd), skips=skips,
                                                  counts=counts):
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

    def _segment_bases(self, k: int) -> dict:
        """Iteration k's hashrng bases of every token segment: ``sub_bases`` and
        ``win_bases``, lists of ``self._token_segments`` ints."""
        seed, Sd = self.config.seed, self._token_segments
        return dict(sub_bases=[int(stream_base(seed, STREAM_SUBSAMPLE, k, s))
                               for s in range(Sd)],
                    win_bases=[int(stream_base(seed, STREAM_WINDOW, k, s))
                               for s in range(Sd)])

    def _stage(self, chunks: Iterator[dict]) -> Iterator[dict]:
        """Send each chunk's arrays to the card from the producer thread: a copy into
        pinned host memory, non-blocking copies on a stream of their own, and an event
        recorded after them (``chunk["staged"]``), in a ``stage_put`` span. The pinned
        tensors ride with the chunk, so they outlive their copies. Only copies are
        enqueued here."""
        stream = torch.cuda.Stream(device=self.device)
        for chunk in chunks:
            with self._tracer.span("stage_put"), self.sync_sites("stage"):
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
        """The chunk's arrays on the device: the index arrays widened to int64, the
        step scalars (alphas, real-pair counts) float32. A staged chunk's tensors were
        allocated on the copy stream: the consumer's stream waits for their copies, and
        ``record_stream`` keeps the allocator from reusing them before the consumer's
        work on them is done (only the prologue reads them, on that stream). On the
        calling thread they go to the card through pinned memory (the caching host
        allocator keeps each block until its copy has run) with non-blocking copies."""
        done = chunk.get("staged")
        if done is None:
            cuda = self.device.type == "cuda"
            with self.sync_sites("stage"):
                arrays = {name: (torch.from_numpy(a).pin_memory().to(self.device,
                                                                     non_blocking=True)
                                 if cuda else torch.from_numpy(a))
                          for name, a in chunk["arrays"].items()}
        else:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in chunk["arrays"].values():
                t.record_stream(stream)
            arrays = chunk["arrays"]
        return {name: t if t.is_floating_point() else t.long()
                for name, t in arrays.items()}

    def _step_form(self) -> str:
        """The step this trainer runs, by the JAX trainer's single-device selection
        matrix: ``cbow_banded``, ``cbow_shared``, ``cbow_per_example``,
        ``shared_fused`` (the fused kernel), ``shared_scatter`` (the shared pool with a
        stabilizer, ``duplicate_scaling`` or the hot rows, none of which the kernel has,
        as the JAX package's pallas step has none) or ``per_pair``. Read from the
        trainer's state: a recovery may engage ``max_row_norm`` (``self._stabilizers``),
        which moves the shared pool to its scatter form. On a mesh the same matrix picks
        the row-sharded twin (``ops/sgns_shard.py``): ``sharded_banded``,
        ``sharded_cbow_shared``, ``sharded_cbow_per_example``, ``sharded_shared`` (the
        shared pool, every chain option) or ``sharded_per_pair``."""
        cfg = self.config
        if self.plan is not None:
            if self._banded_cbow:
                return "sharded_banded"
            if cfg.cbow:
                return ("sharded_cbow_shared" if cfg.negative_pool > 0
                        else "sharded_cbow_per_example")
            return "sharded_shared" if cfg.negative_pool > 0 else "sharded_per_pair"
        if self._banded_cbow:
            return "cbow_banded"
        if cfg.cbow:
            return "cbow_shared" if cfg.negative_pool > 0 else "cbow_per_example"
        if cfg.negative_pool > 0:
            if self._stabilizers.enabled or cfg.duplicate_scaling or self._slabs is not None:
                return "shared_scatter"
            return "shared_fused"
        return "per_pair"

    def _step_fn(self) -> Callable:
        """The step of :meth:`_step_form`, ``step(batch, negatives, alpha,
        with_metrics)``, over one row of the chunk's input buffers; ``alpha`` is a
        one-element float32 tensor on the device. Built for every chunk body from the
        trainer's state: ``self.params`` (a restore swaps the pair) and
        ``self._stabilizers``. The hot slabs ride in ``self._slabs``; the body flushes
        them."""
        cfg = self.config
        p, n, mode = self.params, cfg.negatives, cfg.sigmoid_mode
        stab, dup = self._stabilizers, cfg.duplicate_scaling
        cd, ld, slabs = self.compute_dtype, self.logits_dtype, self._slabs
        chain = dict(fused=cfg.fused_logits, bf16_chain=cfg.bf16_chain)
        form = self._step_form()
        if form.startswith("sharded"):
            plan, cols = self.plan, self._cols
            if form == "sharded_shared":
                # with sync_every > 1 its k-step window (the body feeds it k rows of
                # the buffers at a time)
                steps = {wm: make_sharded_sgns_step(
                    plan, n, mode, cd, ld, wm, stab, sync_every=cfg.sync_every,
                    duplicate_scaling=dup, cols=cols, **chain) for wm in (False, True)}
            elif form == "sharded_per_pair":
                one = make_sharded_per_pair_step(plan, mode, cd, stab,
                                                 duplicate_scaling=dup, cols=cols,
                                                 **chain)
                steps = {False: one, True: one}
            elif form == "sharded_banded":
                steps = {wm: make_sharded_banded_step(plan, n, cfg.window, mode, cd, ld,
                                                      wm, stab, cols=cols)
                         for wm in (False, True)}
            else:
                shared = form == "sharded_cbow_shared"
                steps = {wm: make_sharded_cbow_step(
                    plan, n, shared, mode, cd, ld, wm, stab, duplicate_scaling=dup,
                    cols=cols) for wm in (False, True)}
            return lambda b, neg, alpha, wm: steps[wm](p, b, neg, alpha)
        if form == "cbow_banded":
            return lambda b, neg, alpha, wm: cbow_step_banded_core(
                p, b["tokens"], b["left"], b["right"], b["center"], b["token"], neg,
                alpha, n, cfg.window, mode, wm, stabilizers=stab, compute_dtype=cd,
                logits_dtype=ld)
        if form == "cbow_shared":
            return lambda b, neg, alpha, wm: cbow_step_shared_core(
                p, b["centers"], b["contexts"], b["ctx_mask"], b["mask"], neg, alpha, n,
                mode, wm, stabilizers=stab, compute_dtype=cd, logits_dtype=ld)
        if form == "cbow_per_example":
            return lambda b, neg, alpha, wm: cbow_step_core(
                p, b["centers"], b["contexts"], b["ctx_mask"], b["mask"], neg, alpha,
                mode, duplicate_scaling=dup, stabilizers=stab, compute_dtype=cd)
        if form == "shared_scatter":
            return lambda b, neg, alpha, wm: sgns_step_shared_scatter_(
                p, b["centers"], b["contexts"], b["mask"], neg, alpha, n, mode, wm,
                duplicate_scaling=dup, stabilizers=stab, compute_dtype=cd,
                logits_dtype=ld, hot_slabs=slabs, **chain)
        if form == "shared_fused":
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

    def _token_rows(self, arrays: dict, chunk: dict) -> tuple:
        """The chunk's [n, Sd, ...] token arrays as the rows this device expands: on a
        mesh its own data segment's ([n, ...], this segment's hashrng bases as ints);
        on one device every segment's, flattened to [n·Sd, ...] (with one segment the
        bases are ints, with several each row's, from the chunk's
        :func:`segment_base_rows` arrays, staged with the rest)."""
        if self.plan is not None:
            d = self.plan.data_index
            rows = {name: arrays[name][:, d] for name in ("tokens", "starts", "nvalid",
                                                           "obase")}
            return rows, chunk["sub_bases"][d], chunk["win_bases"][d]
        rows = {name: arrays[name].reshape(-1, *arrays[name].shape[2:])
                for name in ("tokens", "starts", "nvalid", "obase")}
        if self._token_segments == 1:
            return rows, chunk["sub_bases"][0], chunk["win_bases"][0]
        return rows, arrays["sub_bases"].reshape(-1), arrays["win_bases"].reshape(-1)

    def _device_pairs(self, arrays: dict, chunk: dict) -> dict:
        """The chunk's pairs from its token blocks, in one batched call of the device
        generator, ``pairs_per_batch / Sd`` slots a segment block ([n, B] on one
        device; this rank's data slice [n, B / num_data] on a mesh); the exact pair and
        drop counts accumulate on the device."""
        cfg = self.config
        rows, sub, win = self._token_rows(arrays, chunk)
        obase = rows["obase"]
        n = arrays["tokens"].shape[0]
        pairs = device_block_pairs(
            rows["tokens"], rows["starts"], rows["nvalid"], obase[:, 0], obase[:, 1],
            self._keep_prob_dev, sub, win, cfg.window,
            cfg.pairs_per_batch // self._token_segments, presubsampled=True)
        self._exact_pairs += pairs.mask.sum(dim=1).long().sum()  # each row <= B, exact
        self._dropped += pairs.dropped_pairs.sum()
        return {"centers": pairs.centers.reshape(n, -1),
                "contexts": pairs.contexts.reshape(n, -1),
                "mask": pairs.mask.reshape(n, -1)}

    def _put(self, name: str, value: torch.Tensor) -> None:
        """Copy ``value`` ([n, ...], n <= K) into the fixed input buffer ``name`` ([K,
        ...], made at the first chunk), zeroing rows n..K-1: a short chunk's padded
        steps carry index 0, mask 0 and α 0."""
        K = self.config.steps_per_dispatch
        buf = self._inputs.get(name)
        shape = (K, *value.shape[1:])
        if buf is None or tuple(buf.shape) != shape or buf.dtype != value.dtype:
            buf = self._inputs[name] = torch.zeros(shape, dtype=value.dtype,
                                                   device=self.device)
        n = value.shape[0]
        buf[:n].copy_(value)
        if n < K:
            buf[n:].zero_()

    def _prologue(self, chunk: dict) -> None:
        """The chunk's eager part: wait for its staged copies, run the device pair or
        window generator (its hashrng bases are host ints), draw its negatives (the
        hash PRNG's counter, ``global_step + 1``, is a host int: K rows, also for a
        short chunk), build the masks on the device from the chunk's real-pair counts
        (a CBOW batch's context masks from its context counts), scale the alphas by the
        recovery's lr scale (float32 on the device: the one point every feed goes
        through; the producer's array is not changed), and copy all of it into the
        fixed input buffers. No blocking copy and no read of a device value."""
        cfg = self.config
        K = cfg.steps_per_dispatch
        arrays = self._device_arrays(chunk)
        alphas = arrays.pop("alphas")
        if self._lr_scale != 1.0:
            alphas = alphas * self._lr_scale
        vals = {"alphas": alphas}
        if self._banded_cbow:
            # one step is the row's segment blocks end to end (the JAX chunk's [Sd·T]
            # flattening: the windows stay inside their block); on a mesh this rank's
            # own block
            rows, _, win = self._token_rows(arrays, chunk)
            n = arrays["tokens"].shape[0]
            obase = rows["obase"]
            band = device_cbow_windows(
                rows["tokens"], rows["starts"], rows["nvalid"], obase[:, 0], obase[:, 1],
                win, cfg.window, self._block_halo)
            self._exact_pairs += ((band.center > 0) & (band.left + band.right > 0)).sum()
            vals.update({name: v.reshape(n, -1) for name, v in (
                ("tokens", rows["tokens"]), ("left", band.left), ("right", band.right),
                ("center", band.center), ("token", band.token))})
            shape: tuple = (K, cfg.negative_pool)
        else:
            if cfg.device_pairgen:
                vals.update(self._device_pairs(arrays, chunk))
            else:
                B = arrays["centers"].shape[1]
                # [K] real counts, or [K, S] on the sharded feed: the batch is S
                # segments, each prefix-masked by its own count
                reals = arrays["reals"]
                reals = reals[:, None] if reals.dim() == 1 else reals
                pos = torch.arange(B // reals.shape[1], device=self.device)
                mask = (pos < reals[:, :, None]).to(torch.float32).view(-1, B)
                vals.update(centers=arrays["centers"], contexts=arrays["contexts"],
                            mask=mask)
                if cfg.cbow:
                    C = arrays["contexts"].shape[2]
                    vals["ctx_mask"] = (torch.arange(C, device=self.device)
                                        < arrays["nctx"][..., None]).to(torch.float32)
            B = cfg.pairs_per_batch
            shape = ((K, B, cfg.negatives) if cfg.negative_pool == 0
                     else (K, cfg.negative_pool))
            if self.plan is not None and cfg.sync_every > 1:
                # local SGD: each data shard its own disjoint [K, P] lattice slice
                shape = (K, self.plan.num_data * cfg.negative_pool)
        vals["negatives"] = sample_negatives_hash(
            self._table_prob, self._table_alias, cfg.seed, self.global_step + 1, shape)
        if self.plan is not None:
            # every rank holds the global chunk; this rank trains its data slice (the
            # token feeds derived it from the rank's own segment already)
            carve = ([] if cfg.device_pairgen or self._banded_cbow
                     else ["centers", "contexts", "mask"] + (["ctx_mask"] if cfg.cbow
                                                             else []))
            # per-example negatives [K, B, n]: the data slice of the one-device draw;
            # local SGD: each data shard its own lattice slice
            carve += ["negatives"] if cfg.sync_every > 1 or cfg.negative_pool == 0 else []
            vals.update(distributed.put_global(
                self.plan, {name: vals[name] for name in carve}, self.plan.batch_stacked))
        for name, v in vals.items():
            self._put(name, v)

    def _chunk_body(self, steps: int, with_metrics: bool) -> torch.Tensor:
        """The first ``steps`` steps of the chunk in the input buffers, with the
        hot-row flushes (every ``hot_flush_every`` steps and after the last); returns
        their metrics stacked as [steps, 3] (loss, mean_f_pos, pairs). Reads only the
        buffers and the trainer's tensors, and never a device value on the host, so
        that it can be captured."""
        ins = self._inputs
        step = self._step_fn()
        names = [name for name in ins if name not in ("negatives", "alphas")]
        out = []
        k_win = self.config.sync_every if self.plan is not None else 1
        if k_win > 1:
            # local-SGD windows of k steps, each ending merged; a short chunk's last
            # window runs its padded rows too (mask 0, alpha 0: exact no-ops, and
            # the merge of a zero delta), so every chunk ends on a merge
            for w in range(-(-steps // k_win)):
                sl = slice(w * k_win, (w + 1) * k_win)
                m = step({name: ins[name][sl] for name in names}, ins["negatives"][sl],
                         ins["alphas"][sl], with_metrics)
                out.append(torch.stack(tuple(m), dim=1))
            return torch.cat(out)[:steps]
        for k in range(steps):
            batch = {name: ins[name][k] for name in names}
            out.extend(step(batch, ins["negatives"][k], ins["alphas"][k], with_metrics))
            if (k + 1) % self._hot_flush == 0:
                self._flush_hot()
        if steps % self._hot_flush:
            self._flush_hot()
        return torch.stack(out).view(steps, 3)

    def _graph_key(self, with_metrics: bool) -> tuple:
        """``(base, with_metrics)``: everything a captured chunk body bakes in. The
        base is the step form, K, the stabilizers, the hot-row cadence, the dtypes, the
        banded step's endpoint form, and the identity (address, shape, dtype) of the
        parameters, the hot slabs and the input buffers; a restore (the snapshot's
        tensors become the live pair), a recovery that engages ``max_row_norm`` and a
        new placement of the parameters each change it."""
        def ident(t: torch.Tensor) -> tuple:
            return t.data_ptr(), tuple(t.shape), t.dtype

        form = self._step_form()
        base = (form, self.config.steps_per_dispatch, tuple(self._stabilizers),
                self._hot_flush, self.param_dtype, self.compute_dtype, self.logits_dtype,
                cbow_banded.CUDA_ENDPOINT if form == "cbow_banded" else None,
                tuple(ident(t) for t in self.params),
                None if self._slabs is None else tuple(ident(t) for t in self._slabs),
                tuple((name, *ident(t)) for name, t in sorted(self._inputs.items())))
        return base, bool(with_metrics)

    @property
    def graph_captures(self) -> int:
        """Chunk-body graphs captured since this fit began (0 off the card)."""
        return self._graphs.captures if self._graphs is not None else 0

    @property
    def graph_replays(self) -> int:
        """Chunk-body graph replays since this fit began: one per chunk on the card."""
        return self._graphs.replays if self._graphs is not None else 0

    def _run_chunk(self, chunk: dict) -> torch.Tensor:
        """Train the steps of one chunk: the prologue, then the body, as one replay of
        its captured graph on the card (K steps, a short chunk padded) or eagerly (the
        chunk's real steps) on the CPU or with ``_eager_chunks``. Returns the body's
        [steps, 3] metrics. On the card that is the graph's output, which the next
        replay overwrites: read it (as the heartbeat does) or clone it before the next
        chunk. The hot slabs are zero at the chunk's start and at its end."""
        self.chunks_run += 1
        t0 = time.perf_counter()
        self._prologue(chunk)
        self.prologue_time += time.perf_counter() - t0
        with_metrics = (self._with_metrics(chunk["real"])
                        or self._step_form() in _POOLLESS_FORMS)
        if self.device.type != "cuda" or self._eager_chunks or self.plan is not None:
            # on a mesh the steps' collectives stay outside any graph (gloo cannot be
            # captured): the body runs eagerly, and no graph is ever captured there
            return self._chunk_body(chunk["real"], with_metrics)
        if self._graphs is None:
            self._graphs = ChunkGraphs(self.device, self.sync_sites)
        K = self.config.steps_per_dispatch
        return self._graphs.run(
            self._graph_key(with_metrics), lambda: self._chunk_body(K, with_metrics),
            [self._inputs[name] for name in _GATES if name in self._inputs])

    def fit(
        self,
        sentences: Sequence[np.ndarray],
        checkpoint_path: Optional[str] = None,
        checkpoint_every_steps: Optional[int] = None,
        on_heartbeat: Optional[Callable[[HeartbeatRecord], None]] = None,
        corpus_words: Optional[int] = None,
    ) -> EmbeddingPair:
        """Run the remaining iterations over encoded sentences (int32 index arrays,
        OOV-filtered and chunked). Resumes from ``self.state``. A fit that raises
        records ``run_end`` with status "error" and dumps the flight recorder before
        the exception propagates.

        ``corpus_words``: the raw token count of ``sentences`` where it differs from
        what the vocabulary's counts imply (a continual increment feeds the corpus
        tail while ``vocab.counts`` carries the merged history): the learning-rate
        clock then anneals over the fed corpus, scaled by the same expected
        subsample-keep ratio, on every feed. None: the corpus is the vocabulary's
        source."""
        cfg = self.config
        t_fit = time.perf_counter()
        self._check_resume_position()
        # the SIGTERM hook drains its emergency save here
        self._active_checkpoint_path = checkpoint_path
        train_words = expected_kept_words(
            self.vocab.counts, self.vocab.train_words_count, cfg.subsample_ratio)
        if corpus_words is not None:
            # the fed corpus's expected kept words per iteration: the vocabulary-wide
            # keep ratio applied to the fed token count
            train_words = (train_words / max(float(self.vocab.train_words_count), 1.0)
                           * float(corpus_words))
        total_words = float(cfg.num_iterations * train_words + 1)
        token_feed = cfg.device_pairgen or self._banded_cbow
        # the feeds whose rounds run in lockstep on every rank (their allgathers on the
        # calling thread, or the token feed's one-ahead stager)
        sharded = self._feed_segments > 1 or (token_feed and self.plan is not None)
        if token_feed:
            self._exact_pairs = torch.zeros((), dtype=torch.int64, device=self.device)
            self._dropped = torch.zeros((), dtype=torch.int64, device=self.device)
            est_total = 0.0
            stream = (self._sharded_token_stream if self.plan is not None
                      else self._token_chunk_stream)
            chunks = stream(sentences, total_words, float(train_words))
        elif sharded:
            # the rounds' allgathers run here, on the calling thread, in lockstep on
            # every rank; only the local feed runs on the producer thread
            chunks = self._sharded_chunk_stream(sentences, total_words)
        else:
            chunks = self._chunk_stream(sentences, total_words, float(train_words))
        if not sharded:
            # each next() of the assembly is a "producer" span, on the thread that
            # runs it
            chunks = self._tracer.wrap_iter("producer", chunks)
        if cfg.prefetch_chunks > 0 and not sharded:
            if self.device.type == "cuda":
                chunks = self._stage(chunks)
            chunks = _threaded_iter(chunks, cfg.prefetch_chunks)
        self._start_run_bookkeeping()
        self._beacons = self._start_peer_beacons(checkpoint_path)
        ack = getattr(chunks, "ack", None)  # the one-ahead stager's ticket
        try:
            try:
                while True:
                    t0 = time.perf_counter()
                    chunk = next(chunks, None)
                    wait = time.perf_counter() - t0
                    self.host_wait_time += wait
                    self._phases.add("producer_wait", wait)
                    if chunk is None:
                        break
                    t0 = time.perf_counter()
                    if cfg.feed_consistency_check and distributed.is_multiprocess():
                        self._assert_feed_consistent(chunk)
                    with self._tracer.span("dispatch"):
                        metrics = self._run_chunk(chunk)
                    self.dispatch_time += time.perf_counter() - t0
                    if token_feed:
                        est_total += chunk["real_pairs"]
                    self._finish_round(chunk, metrics, checkpoint_path,
                                       checkpoint_every_steps, on_heartbeat)
                    if ack is not None:
                        ack()  # the round's launches are done: release the next
            except RuntimeError as e:
                self._raise_if_peer_died(e)
                raise
            finally:
                self._stop_profiler()
                chunks.close()
                if self._beacons is not None:
                    self._beacons.stop()
                    self._beacons = None
            with self.sync_sites("index_check", blocking=True):
                scatter.check_errors()
            if token_feed:
                self._settle_device_pairgen_books(est_total)
            self.state = TrainState(
                iteration=cfg.num_iterations,
                words_processed=int(self._shard_clock if self._feed_segments > 1
                                    else cfg.num_iterations * train_words),
                finished=True, global_step=self.global_step)
            if checkpoint_path:
                self.save_checkpoint(checkpoint_path)
            if self.device.type == "cuda":
                with self.sync_sites("fit_end", blocking=True):
                    # the fit's time holds its last steps
                    torch.cuda.synchronize(self.device)
            self.fit_time = time.perf_counter() - t_fit
        except BaseException:
            self._abort_run()
            raise
        self._end_run("ok")
        return self.params

    def _check_resume_position(self) -> None:
        """Refuse a checkpoint whose recorded position indexes another feed's stream.
        A token-feed checkpoint (device pairs or banded CBOW) carries its position
        twice: ``batches_done`` (the step rows of this process's stream, what this
        trainer skips, as the JAX package's single-process device feed does) and
        ``shard_progress`` (per data segment); one without ``batches_done`` needs the
        per-segment resume. A sharded-input fit resumes from ``shard_progress``, one
        position a rank, at the same world size (the JAX package's checks and
        messages)."""
        st, cfg = self.state, self.config
        token_feed = cfg.device_pairgen or self._banded_cbow
        if token_feed and self.plan is not None:
            self._device_seg_resume_state()  # the mesh token feed's checks
            return
        if self._feed_segments > 1:
            sp = st.shard_progress
            if sp is not None:
                if st.shard_feed not in (None, "pairs"):
                    raise ValueError(
                        "checkpoint shard_progress indexes the device-feed token "
                        f"streams (shard_feed={st.shard_feed!r}); resume it with "
                        "device_pairgen=True — pair-batch positions are a different "
                        "stream")
                if len(sp) != self._feed_segments:
                    raise ValueError(
                        f"checkpoint shard_progress has {len(sp)} entries but this run "
                        f"has {self._feed_segments} processes; resume sharded-input "
                        "runs with the same process count")
            elif st.batches_done and not st.finished:
                raise ValueError(
                    "checkpoint was written mid-iteration by a replicated-feed run; it "
                    "cannot be resumed exactly with shard_input=True — resume with "
                    "shard_input=False (or from an iteration-boundary checkpoint)")
            return
        if st.shard_progress is None or st.finished:
            return
        if token_feed:
            if st.shard_feed != "tokens":
                raise ValueError(
                    "checkpoint was written by a host-feed sharded-input run (its "
                    "positions index per-process pair streams); resume it with the "
                    "same process count and device_pairgen=False")
            if st.batches_done == 0:
                self._device_seg_resume_state()  # the per-segment resume's checks
            return
        if st.shard_feed == "tokens":
            raise ValueError(
                "checkpoint was written by a token-block-feed run (its positions index "
                "per-segment token streams); resume it with the same feed — "
                "device_pairgen=True, or cbow_update='banded' if it was a banded-CBOW "
                "run")
        raise ValueError(
            "checkpoint was written by a sharded-input multi-process run "
            f"({len(st.shard_progress)} shards); resume it with the same process "
            "count and shard_input=True, not on the replicated feed")

    def _sharded_chunk_stream(self, sentences: Sequence[np.ndarray],
                              total_words: float) -> Iterator[dict]:
        """The sharded-input feed (the JAX trainer's ``_fit_sharded``), one round a
        chunk, every rank in lockstep:

        1. each rank pulls its next local chunk, K batches of B/W pairs from
           ``epoch_batches(shard=rank, num_shards=W)`` (CBOW: B/W examples, their
           grouped centers, contexts and context counts, from ``epoch_batches_cbow``),
           off its producer thread; an exhausted rank substitutes a zero chunk;
        2. ONE allgather (``parallel/distributed.allgather``) ships every
           rank's pairs, real counts, word-clock deltas, alive flag and stream
           position to every rank (after the peer beacons' check);
        3. every rank assembles the identical global batch ([K, B]: W contiguous
           segments, each prefix-masked by its own count), the global word clock from
           the summed deltas, and identical alphas;
        4. the stream ends when every alive flag is zero: an exhausted rank keeps
           dispatching fully masked segments until then.

        ``TrainState.shard_progress`` records every rank's position (``batches_done``
        is 0: no single count means anything across ranks)."""
        cfg = self.config
        K = cfg.steps_per_dispatch
        S = self._feed_segments
        pid = distributed.rank()
        B = cfg.pairs_per_batch
        b_local = B // S
        st = self.state
        start_iter = st.iteration
        skip = st.batches_done if not st.finished else 0
        if st.shard_progress is not None:
            start_iter, skip = (int(x) for x in st.shard_progress[pid])
        C = 2 * cfg.window

        def empty_feed() -> dict:
            """The local chunk's arrays, zeroed: the fill target and an exhausted
            rank's offer."""
            if cfg.cbow:
                return {"centers": np.zeros((K, b_local), np.int32),
                        "contexts": np.zeros((K, b_local, C), np.int32),
                        "nctx": np.zeros((K, b_local), np.int32)}
            return {"centers": np.zeros((K, b_local), np.int32),
                    "contexts": np.zeros((K, b_local), np.int32)}

        def local_stream() -> Iterator[dict]:
            for k in range(start_iter, cfg.num_iterations + 1):
                pending: List[tuple] = []
                prev_ws = 0
                batches_in_iter = skip if k == start_iter else 0
                to_skip = batches_in_iter

                def flush() -> dict:
                    nonlocal pending, batches_in_iter
                    real = len(pending)
                    batches_in_iter += real
                    arrays = empty_feed()
                    reals = np.zeros(K, np.int32)
                    deltas = np.zeros(K, np.int64)
                    for j, (batch, r, d) in enumerate(pending):
                        for name, a in batch.items():
                            arrays[name][j] = a
                        reals[j], deltas[j] = r, d
                    pending = []
                    return dict(arrays=arrays, reals=reals, deltas=deltas, iteration=k,
                                batches_done=batches_in_iter)

                common = dict(pairs_per_batch=b_local, window=cfg.window,
                              subsample_ratio=cfg.subsample_ratio, seed=cfg.seed,
                              iteration=k, shuffle=cfg.shuffle,
                              producer_workers=cfg.producer_workers, shard=pid,
                              num_shards=S)
                stream = (epoch_batches_cbow(sentences, self.vocab, **common) if cfg.cbow
                          else epoch_batches(sentences, self.vocab,
                                             backend=self.feed_backend, **common))
                for b in stream:
                    ws = b.words_seen
                    if to_skip:  # exact resume: fast-forward already-trained batches
                        to_skip -= 1
                        prev_ws = ws
                        continue
                    if cfg.cbow:
                        pending.append(({"centers": b.centers, "contexts": b.contexts,
                                         "nctx": b.n_ctx}, b.num_real, ws - prev_ws))
                    else:
                        pending.append(({"centers": b.centers, "contexts": b.contexts},
                                        b.num_real_pairs, ws - prev_ws))
                    prev_ws = ws
                    if len(pending) == K:
                        yield flush()
                if pending:
                    yield flush()

        local_chunks = self._tracer.wrap_iter("producer", local_stream())
        if cfg.prefetch_chunks > 0:
            local_chunks = _threaded_iter(local_chunks, cfg.prefetch_chunks)
        clock = float(st.words_processed)
        self._shard_clock = clock
        cur_iter, cur_batches = start_iter, skip
        exhausted = False
        zero = dict(arrays=empty_feed(), reals=np.zeros(K, np.int32),
                    deltas=np.zeros(K, np.int64))
        try:
            while True:
                local = None if exhausted else next(local_chunks, None)
                if local is None:
                    exhausted = True
                    local = zero
                else:
                    cur_iter, cur_batches = local["iteration"], local["batches_done"]
                if self._beacons is not None:
                    # a dead peer never reaches its allgather: entering ours would
                    # hang; the check turns that into a clean abort
                    self._beacons.check_or_raise()
                with self._tracer.span("allgather"):
                    g = distributed.allgather({
                        **local["arrays"], "reals": local["reals"],
                        "deltas": local["deltas"],
                        "alive": np.asarray([0 if exhausted else 1], np.int32),
                        "prog": np.asarray([cur_iter, cur_batches], np.int64)})
                if int(g["alive"].sum()) == 0:
                    return
                reals_all = g["reals"]                                   # [S, K]
                real = int((reals_all > 0).any(axis=0).sum())
                clocks = clock + np.cumsum(g["deltas"].sum(axis=0))
                clock = self._shard_clock = float(clocks[-1])
                if real == 0:
                    continue  # no step this round on any rank (lockstep holds)
                alphas = np.asarray([
                    alpha_schedule(float(w), total_words, cfg.learning_rate,
                                   cfg.min_alpha_factor) for w in clocks], np.float32)
                # [S, K, b(, C)] -> [K, S, b(, C)] -> [K, B(, C)]: segment s of every
                # batch is rank s's slice, matching the per-segment prefix masks
                arrays = {name: np.ascontiguousarray(
                    np.swapaxes(g[name], 0, 1).reshape(K, B, *g[name].shape[3:]))
                    for name in zero["arrays"]}
                arrays.update(alphas=alphas, reals=np.ascontiguousarray(
                    reals_all.T.astype(np.float32)))
                yield dict(arrays=arrays, alphas=alphas, real=real,
                           iteration=int(g["prog"][:, 0].min()),
                           words_processed=int(clock), batches_done=0,
                           real_pairs=float(reals_all.sum()),
                           shard_progress=[[int(a), int(b_)] for a, b_ in g["prog"]],
                           shard_feed="pairs")
        finally:
            closer = getattr(local_chunks, "close", None)
            if closer is not None:
                closer()

    def _sharded_token_stream(self, sentences: Sequence[np.ndarray], total_words: float,
                              train_words: float):
        """The token feed on a mesh (the JAX trainer's ``_fit_device_feed_sharded``),
        one round a chunk, every rank in lockstep:

        1. each rank packs the token blocks of its own data segment only (the ranks of
           one data column pack the same deterministic stream): K step rows a local
           chunk, padded, with each row's kept tokens and the segment's position after
           it; an exhausted rank offers zeros;
        2. ONE allgather a round ships every rank's tokens, start bits, ordinal bases,
           valid counts, kept counts, alive flag and positions; rank (s, model 0)
           speaks for segment s;
        3. the ITERATION BARRIER: a round trains the lowest iteration any live segment
           offers, and a segment already in a later iteration rides as zero blocks
           and keeps its chunk for a later round, so the rounds are the one-process
           device feed's rows (``_token_chunk_stream``) on the same segments, bit for
           bit;
        4. alphas follow the one-process convention: the iteration's base plus the
           within-iteration kept cumsum, from gathered values only;
        5. ``shard_progress`` records each segment's last trained position (a held
           chunk was not trained), so N ranks resume on any mesh with the same data
           axis, or on one process.

        With ``sharded_prefetch`` (and ``prefetch_chunks > 0``) the rounds run on a
        thread one round ahead under the ticket handshake (:class:`_one_ahead_iter`),
        the next round's allgather launched (``distributed.allgather_start``) before
        this one is handed over, and on the card each round's copy staged as
        :meth:`_stage` does; the consumer acks each round after its bookkeeping.
        Without it the rounds run on the calling thread. Each rank's device work takes
        its own segment of the assembled feed (:meth:`_prologue`)."""
        cfg = self.config
        K, Sd, T = cfg.steps_per_dispatch, self._token_segments, self._tokens_per_step
        nb = (T + 7) // 8
        plan = self.plan
        d = plan.data_index
        owners = [s * plan.num_model for s in range(Sd)]
        seg_state = [self._device_seg_resume_state()[d]]
        rate = self._token_rate()
        staged = bool(cfg.sharded_prefetch and cfg.prefetch_chunks > 0)
        st = self.state

        def local_stream() -> Iterator[dict]:
            for k in range(seg_state[0][0], cfg.num_iterations + 1):
                it, blocks = seg_state[0]
                skips = [blocks if it == k else (-1 if it > k else 0)]
                counts = [0]
                pending: List[tuple] = []

                def flush() -> dict:
                    nonlocal pending
                    real = len(pending)
                    out = dict(tokens=np.zeros((K, T), np.int32),
                               starts=np.zeros((K, nb), np.uint8),
                               nvalid=np.zeros(K, np.int64),
                               obase=np.zeros((K, 2), np.int64),
                               kept=np.zeros(K, np.float32))
                    for j, row in enumerate(pending):
                        out["tokens"][j], out["starts"][j] = row[0][0], row[1][0]
                        out["nvalid"][j], out["obase"][j] = row[2][0], row[3][0]
                        out["kept"][j] = row[4]
                    out.update(iteration=k, real=real, sprog=np.asarray(
                        seg_state[0] if skips[0] < 0 else [k, counts[0]], np.int64))
                    pending = []
                    return out

                for row in self._device_step_rows(sentences, k, [d], skips=skips,
                                                  counts=counts):
                    pending.append(row)
                    if len(pending) == K:
                        yield flush()
                if pending:
                    yield flush()

        local = self._tracer.wrap_iter("producer", local_stream())
        if cfg.prefetch_chunks > 0:
            local = _threaded_iter(local, cfg.prefetch_chunks)

        def rounds() -> Iterator[dict]:
            cur_sprog = np.asarray(seg_state[0], np.int64)   # last consumed position
            round_iter = st.iteration
            iter_kept = max(0.0, float(st.words_processed)
                            - (round_iter - 1) * train_words)
            held, exhausted = None, False
            zero = dict(tokens=np.zeros((K, T), np.int32),
                        starts=np.zeros((K, nb), np.uint8), nvalid=np.zeros(K, np.int64),
                        obase=np.zeros((K, 2), np.int64), kept=np.zeros(K, np.float32))

            def start_gather():
                """Collect this rank's next offer and launch its allgather."""
                nonlocal held, exhausted
                if held is None and not exhausted:
                    t0 = time.perf_counter()
                    held = next(local, None)
                    if not staged:
                        wait = time.perf_counter() - t0
                        self.host_wait_time += wait
                        self._phases.add("producer_wait", wait)
                    exhausted = held is None
                offer = held if held is not None else dict(
                    zero, iteration=int(cur_sprog[0]), sprog=cur_sprog, real=0)
                return distributed.allgather_start({
                    **{name: offer[name] for name in zero},
                    "real": np.asarray([offer["real"]], np.int32),
                    "iter": np.asarray([offer["iteration"]], np.int64),
                    "sprog": np.asarray(offer["sprog"], np.int64),
                    "alive": np.asarray([0 if exhausted else 1], np.int32),
                    "prog": cur_sprog})

            try:
                pending = start_gather()
                while True:
                    if self._beacons is not None:
                        # a dead peer never reaches its allgather: turn the wait into
                        # a clean abort
                        self._beacons.check_or_raise()
                    with self._tracer.span("allgather"):
                        g = {k_: v[owners] for k_, v in
                             distributed.allgather_fetch(pending).items()}   # [Sd, ...]
                    alive = g["alive"][:, 0] > 0
                    if not alive.any():
                        return
                    round_it = int(g["iter"][alive, 0].min())
                    use = alive & (g["iter"][:, 0] == round_it)              # [Sd]
                    if round_it != round_iter:
                        round_iter, iter_kept = round_it, 0.0

                    def seg_axis(a):  # [Sd, K, ...] of the used segments -> [K, Sd, ...]
                        keep = use.reshape((Sd,) + (1,) * (a.ndim - 1)).astype(a.dtype)
                        return np.ascontiguousarray(np.swapaxes(a * keep, 0, 1))

                    arrays = {name: seg_axis(g[name])
                              for name in ("tokens", "starts", "nvalid", "obase")}
                    kept_step = (g["kept"].astype(np.float64)
                                 * use[:, None]).sum(axis=0)                 # [K]
                    clocks = ((round_it - 1) * train_words + iter_kept
                              + np.cumsum(kept_step))
                    iter_kept += float(kept_step.sum())
                    alphas = np.asarray([
                        alpha_schedule(float(w), total_words, cfg.learning_rate,
                                       cfg.min_alpha_factor) for w in clocks], np.float32)
                    arrays["alphas"] = alphas
                    # used segments pad only their iteration's last chunk, so their
                    # real rows are prefixes and the longest is the round's
                    real = int(g["real"][use, 0].max())
                    if use[d] and held is not None:
                        cur_sprog, held = np.asarray(held["sprog"], np.int64), None
                    # a segment's position: its offer's if it trained this round, else
                    # the last one it trained
                    prog = [[int(a), int(b)] for s in range(Sd)
                            for a, b in [g["sprog"][s] if use[s] else g["prog"][s]]]
                    chunk = dict(
                        arrays=arrays, alphas=alphas, real=real, iteration=round_it,
                        words_processed=int(clocks[max(real - 1, 0)]), batches_done=0,
                        real_pairs=float(kept_step.sum()) * rate, shard_progress=prog,
                        shard_feed="tokens", **self._segment_bases(round_it))
                    if staged:
                        # the next round's gather is launched before this round is
                        # handed over: it precedes this round's steps on every rank
                        pending = start_gather()
                        yield chunk
                    else:
                        yield chunk
                        pending = start_gather()
            finally:
                closer = getattr(local, "close", None)
                if closer is not None:
                    closer()

        out = rounds()
        if staged:
            if self.device.type == "cuda":
                out = self._stage(out)
            out = _one_ahead_iter(out)
        return out

    def _assert_feed_consistent(self, chunk: dict) -> None:
        """The SPMD divergence detector (``config.feed_consistency_check``): every rank
        fingerprints the round's assembled global feed (its host arrays, in name
        order) and one allgather compares the fingerprints. Identical step inputs on
        every rank are what keeps the replicas and the row blocks consistent; a
        mismatch (a nondeterministic host pipeline, clock drift, a corrupted transport)
        would otherwise show only as silent divergence."""
        host = chunk.get("pinned") or chunk["arrays"]
        h = 0
        for name in sorted(host):
            a = host[name]
            a = a.numpy() if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)
            h = zlib.crc32(a.tobytes(), h)
        if self._beacons is not None:
            self._beacons.check_or_raise()
        fps = distributed.allgather({"fp": np.asarray([h], np.int64)})["fp"][:, 0]
        if not (fps == fps[0]).all():
            raise RuntimeError(
                "SPMD feed divergence: per-process fingerprints of the "
                f"assembled global batch differ ({[int(f) for f in fps]}) — "
                "host pipelines produced different feeds (nondeterministic "
                "input ordering or clock drift); training would silently "
                "diverge from here")

    def _start_peer_beacons(self, checkpoint_path: Optional[str]):
        """Arm the liveness beacons of a multi-process fit (``train/supervisor.py``
        ``BeaconBoard``): each rank heartbeats a small file in ``beacons/`` beside the
        checkpoint path, and the check before every round's allgather turns a dead
        peer into a :class:`PeerDeathError` instead of a hang (the board's writer
        thread hard-exits a rank that is already wedged in a collective). None when
        ``peer_beacon_s`` is 0, on one device, or without a checkpoint path to anchor
        the directory to."""
        if (self.config.peer_beacon_s <= 0 or not checkpoint_path
                or not distributed.is_multiprocess()):
            return None
        from glint_word2vec_torch.train.supervisor import BeaconBoard
        board = BeaconBoard(
            os.path.join(os.path.dirname(os.path.abspath(checkpoint_path)), "beacons"),
            process_index=distributed.rank(), num_processes=distributed.world_size(),
            interval_s=self.config.peer_beacon_s)
        return board.start()

    def _raise_if_peer_died(self, err: BaseException) -> None:
        """After a collective failed (a peer's socket closed mid-round): raise
        :class:`PeerDeathError` from ``err`` once the board sees a peer's beacon go
        stale, waiting up to twice the staleness horizon; return (the caller re-raises
        ``err``) when beacons are off or every peer stays alive."""
        board = getattr(self, "_beacons", None)
        if board is None:
            return
        from glint_word2vec_torch.train.supervisor import PeerDeathError
        deadline = time.monotonic() + 2 * board.stale_after
        while time.monotonic() < deadline:
            dead = board.stale_peers(board.stale_after)
            if dead:
                raise PeerDeathError(
                    f"peer process(es) {dead} stopped heartbeating their liveness "
                    f"beacon (> {board.stale_after:.1f}s stale) while this rank was in "
                    f"a collective ({type(err).__name__}: {err})") from err
            time.sleep(board.interval_s / 2)

    def _settle_device_pairgen_books(self, est_total: float) -> None:
        """End of a device-feed run: the heartbeats ran on the analytic pair estimate;
        settle the books against the exact trained and dropped totals, read from the
        device once."""
        books = torch.stack([self._exact_pairs, self._dropped])
        if self.plan is not None and self.plan.num_data > 1:
            # each data rank counted its own segment's
            distributed.COLLECTIVES.all_reduce(books, self.plan.data_group, "data")
        with self.sync_sites("fit_end", blocking=True):
            exact = float(books[0])
            dropped = int(books[1])
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

    def _finish_round(self, chunk: dict, metrics: torch.Tensor,
                      checkpoint_path: Optional[str],
                      checkpoint_every_steps: Optional[int],
                      on_heartbeat: Optional[Callable[[HeartbeatRecord], None]]) -> None:
        """After a chunk's dispatch, the JAX trainer's order: progress counters, the
        flight recorder's dispatch record, the fault hooks, the profiler window, one
        health probe on a probing round (feeding the non-finite guard, the snapshot
        ring and the norm watchdog), the heartbeat (the loss and mean_f_pos of the
        chunk's last real step, row ``real - 1`` of ``metrics``, read before the next
        chunk's replay overwrites them), a periodic checkpoint, and the drain of an
        armed preemption deadline. The fault hooks change the parameters in place, so
        the captured graphs stay valid."""
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
        # the scale this chunk ran under: a recovery below changes the next chunk's
        lr_scale_at_dispatch = self._lr_scale
        if self._blackbox is not None:
            self._blackbox.note_dispatch(self.global_step, real,
                                         self.dispatch_time - self._bb_disp_mark,
                                         self.host_wait_time - self._bb_wait_mark)
            self._bb_disp_mark, self._bb_wait_mark = self.dispatch_time, self.host_wait_time

        if faults.take_nan_injection(self.global_step):
            self.params.syn0[0, 0] = float("nan")
        scale = faults.take_scale_injection(self.global_step)
        if scale:
            for m in self.params:
                m.mul_(scale)
        faults.crash_at_step(self.global_step)
        faults.maybe_stall(self.global_step)

        if (self._profiler is not None and cfg.profile_steps
                and self.global_step - self._profile_start_step >= cfg.profile_steps):
            self._stop_profiler()

        ckpt_due = bool(checkpoint_path and checkpoint_every_steps
                        and self.global_step % checkpoint_every_steps < real)
        hb_due = self.global_step - self._last_log_step >= cfg.heartbeat_every_steps
        channels: Optional[dict] = None
        if hb_due and (cfg.nonfinite_policy != "none" or cfg.norm_watch != "off"
                       or self._telemetry is not None):
            channels = self._health_stats()
        self._probed = channels
        if cfg.nonfinite_policy != "none" and hb_due and not ckpt_due:
            self._nonfinite_guard(channels)  # checkpoint rounds: inside the save
        elif channels is not None and channels["finite"] and cfg.nonfinite_policy == "none":
            self._maybe_snapshot(channels)  # the recovery ladder's ring
        if channels is not None and channels["finite"]:
            # a non-finite carry is the guard's (inf rows trip every norm channel)
            self._watchdog_check(channels)

        if hb_due:
            with self.sync_sites("index_check", blocking=True):
                scatter.check_errors()
            now = time.perf_counter()
            pps = self._pairs_since_log / max(now - self._last_log_time, 1e-9)
            self._pairs_since_log = 0.0
            with self._tracer.span("device_block"), \
                    self.sync_sites("heartbeat", blocking=True):
                loss, fpos = metrics[real - 1, :2].double().cpu().tolist()
            phases_window = None
            if self._phases.enabled:
                phases_window = self._phases.delta(self._last_hb_phases) or None
                self._last_hb_phases = self._phases.raw_snapshot()
            rec = HeartbeatRecord(
                words=self.state.words_processed,
                alpha=float(chunk["alphas"][real - 1]) * lr_scale_at_dispatch,
                loss=loss, mean_f_pos=fpos, pairs_per_sec=pps,
                global_step=self.global_step,
                host_wait_s=self.host_wait_time - self._last_hb_host_wait,
                dispatch_s=self.dispatch_time - self._last_hb_dispatch,
                norms=channels, recoveries=self.recoveries_performed,
                lr_scale=lr_scale_at_dispatch, phases=phases_window,
                sync_every=int(cfg.sync_every), merge_round=-1)
            self._last_hb_host_wait = self.host_wait_time
            self._last_hb_dispatch = self.dispatch_time
            self.heartbeats.append(rec)
            logger.info("wordCount = %d, alpha = %.6f, loss = %.4f, fPlus = %.4f, "
                        "pairs/s = %.0f", rec.words, rec.alpha, rec.loss,
                        rec.mean_f_pos, rec.pairs_per_sec)
            if self._telemetry is not None:
                self._emit(
                    "heartbeat", step=rec.global_step, words=rec.words, alpha=rec.alpha,
                    loss=rec.loss, mean_f_pos=rec.mean_f_pos,
                    pairs_per_sec=round(rec.pairs_per_sec, 3),
                    host_wait_s=round(rec.host_wait_s, 6),
                    dispatch_s=round(rec.dispatch_s, 6),
                    recoveries=int(rec.recoveries),
                    lr_scale=round(float(rec.lr_scale), 9),
                    **({"norms": channels} if channels is not None else {}),
                    **({"phases": phases_window} if phases_window else {}))
            if on_heartbeat is not None:
                on_heartbeat(rec)
            self._last_log_time, self._last_log_step = now, self.global_step

        if ckpt_due:
            self.save_checkpoint(checkpoint_path)  # shares this round's probe
        if self._preempt_deadline is not None:
            self._preempt_exit(checkpoint_path)  # never returns
        self._probed = None

    # -- the runtime layer -------------------------------------------------------------

    @property
    def _needs_snapshot_ring(self) -> bool:
        """Whether a consumer of the snapshot ring is on: the non-finite rollback or
        the watchdog's recovery ladder."""
        return (self.config.nonfinite_policy == "rollback"
                or self.config.norm_watch == "recover")

    # the rollback re-seed: the negatives are a pure function of (seed, global step),
    # so a jump far past any step a run reaches gives the retried stretch a fresh
    # sample path; repeated rollbacks jump again, so paths never overlap
    _ROLLBACK_STEP_JUMP = 1 << 22

    def _start_run_bookkeeping(self) -> None:
        """Per-fit state: the budgets, the ring's seed, the timers, the profiler, the
        observers (tracer cleared, phases, flight recorder, status endpoint, SIGTERM
        hook) and the ``run_start`` record."""
        cfg = self.config
        self.rollbacks_performed = 0  # per-fit budgets
        self.recoveries_performed = 0
        if self._needs_snapshot_ring and not self._snapshot_ring:
            # a restore point even for a blowup inside the first heartbeat window
            self._push_snapshot()
        self.host_wait_time = 0.0
        self.dispatch_time = 0.0
        self.prologue_time = 0.0
        self.chunks_run = 0
        self.restore_captures = []
        if self._graphs is not None:
            self._graphs.reset_counts()
        self._last_log_time = time.perf_counter()
        self._last_log_step = self.global_step
        self._pairs_since_log = 0.0
        self._last_hb_host_wait = 0.0
        self._last_hb_dispatch = 0.0
        self._bb_wait_mark = 0.0
        self._bb_disp_mark = 0.0
        self._run_ended = False
        self._probed = None
        self._preempt_deadline = None
        self._preempt_signum = 0
        self._last_save_step = int(self.global_step)
        self._run_id = f"{os.getpid()}-{int(time.time())}-{self.global_step}"
        self._profile_start_step = self.global_step
        if cfg.profile_dir:
            self._start_profiler()
        observing = self._telemetry is not None or cfg.status_port > 0
        self._tracer.configure(enabled=observing)
        self._phases.clear()
        self._tracer.attach_phases(self._phases if observing else None)
        self._last_hb_phases = self._phases.raw_snapshot()
        if self._blackbox is not None:
            self._blackbox.begin_run(self._run_id)
        self._install_run_signals()
        if cfg.status_port and self._statusd is None:
            self._statusd = StatusServer(cfg.status_port, self.status_snapshot).start()
        if self._telemetry is not None:
            self._tracer.clear()
            self._emit(
                "run_start", run_id=self._run_id, vocab_size=self.vocab.size,
                **clock_anchor(), mesh=[1, 1],
                config={k: getattr(cfg, k) for k in (
                    "vector_size", "learning_rate", "pairs_per_batch", "negatives",
                    "negative_pool", "subsample_ratio", "param_dtype", "compute_dtype",
                    "logits_dtype", "cbow", "step_lowering", "device_pairgen",
                    "nonfinite_policy", "norm_watch", "norm_watch_threshold",
                    "norm_watch_max", "norm_watch_frac", "heartbeat_every_steps",
                    "max_row_norm", "update_clip", "row_l2", "recover_lr_backoff",
                    "max_recoveries")})

    def _start_profiler(self) -> None:
        """``torch.profiler`` over the fit (the card's activity too on CUDA), stopped
        after ``profile_steps`` steps or at the fit's end."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.config.profile_dir, exist_ok=True)
        self._profiler = profile(activities=acts)
        self._profiler.start()
        logger.info("torch.profiler trace -> %s", self.config.profile_dir)

    def _stop_profiler(self) -> None:
        """Stop the profiler and write its Chrome trace into ``profile_dir`` as
        ``trace-<run_id>.json``."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        prof.stop()
        path = os.path.join(self.config.profile_dir, f"trace-{self._run_id}.json")
        prof.export_chrome_trace(path)
        logger.info("torch.profiler window closed after %d steps: %s",
                    self.global_step - self._profile_start_step, path)

    def _health_stats(self) -> dict:
        """Run the health probe (obs/probe.py) and return its channel dict, with
        ``update_mag`` (the change of the mean norms since the previous probe). On the
        card the queued steps drain first, in a ``device_block`` span, so the
        ``health_probe`` span times the probe and its one fetch."""
        with self.sync_sites("probe", blocking=True):
            if self.device.type == "cuda":
                with self._tracer.span("device_block"):
                    torch.cuda.synchronize(self.device)
            with self._tracer.span("health_probe"):
                if self.plan is not None:
                    channels = stats_to_channels(self._mesh_health_stats())
                else:
                    channels = stats_to_channels(health_stats(
                        self.params, self.vocab.size, self.config.norm_watch_threshold))
        prev = self._last_probe_channels
        if prev is not None:
            channels["update_mag"] = round(
                abs(channels["syn0"]["mean_norm"] - prev["syn0"]["mean_norm"])
                + abs(channels["syn1"]["mean_norm"] - prev["syn1"]["mean_norm"]), 9)
        self._last_probe_channels = channels
        return channels

    def _mesh_health_stats(self):
        """The probe on a mesh: each rank's partials of its row blocks, gathered over
        the world in one collective; every rank folds the row blocks of data replica 0
        from the same bytes, so every rank's guard and watchdog see the same
        channels."""
        if self._cols:
            # whole-row norms: the squared norms of this rank's columns summed over the
            # model axis, the same on every rank, so no gather is needed
            sq = column_sum(self.plan)
            parts = column_probe_partials(self.params, self.vocab.size,
                                          self.config.norm_watch_threshold, sq)
            return combine_partials(parts[None].cpu().numpy(), self.vocab.size)
        parts = sharded_probe_partials(self.params, self._row_offset, self.vocab.size,
                                       self.config.norm_watch_threshold)
        group = None if parts.device.type == "cuda" else distributed.host_group()
        parts = distributed.COLLECTIVES.all_gather(parts[None], group).cpu().numpy()
        replica0 = [r for r in range(parts.shape[0]) if r // self.plan.num_model == 0]
        return combine_partials(parts[replica0], self.vocab.size)

    def _copy_params(self) -> EmbeddingPair:
        """A copy of the live parameters on their device, into a spare slot (one the
        ring dropped or a restore freed) when there is one: a snapshot allocates only
        until the ring is full."""
        with self.sync_sites("snapshot"):
            if self._spare_params:
                slot = self._spare_params.pop()
                slot.syn0.copy_(self.params.syn0)
                slot.syn1.copy_(self.params.syn1)
                return slot
            return EmbeddingPair(self.params.syn0.clone(), self.params.syn1.clone())

    def _push_snapshot(self) -> None:
        if len(self._snapshot_ring) == self._snapshot_ring.maxlen:
            self._spare_params.append(self._snapshot_ring.popleft()[0])
        self._snapshot_ring.append((self._copy_params(), self.global_step))

    def _nonfinite_diagnostic(self) -> str:
        with self.sync_sites("diagnostic", blocking=True):
            bad0 = int((~torch.isfinite(self.params.syn0)).sum())
            bad1 = int((~torch.isfinite(self.params.syn1)).sum())
        return (
            f"non-finite parameters at global step {self.global_step}: {bad0} entries "
            f"in syn0, {bad1} in syn1 (of {self.padded_vocab}x{self.padded_dim} each). "
            f"Likely causes, in measured order (EVAL.md): pool-row overload (grow "
            f"negative_pool), duplicate-overload (lower subsample_ratio ~1e-4 or set "
            f"duplicate_scaling=True), or learning rate too high for "
            f"{self.config.param_dtype}. Set nonfinite_policy='rollback' to "
            f"auto-recover from the last good snapshot instead of halting")

    def _nonfinite_guard(self, channels: Optional[dict] = None) -> None:
        """The non-finite guard on the probe's ``finite`` bit (``channels``: this
        round's probe, or None to probe now). A finite state is snapshotted (when a
        consumer needs the ring); a non-finite one raises under ``halt`` and, under
        ``rollback``, pops and restores the newest snapshot and jumps the negative
        lattice, until ``max_rollbacks`` is spent or the ring is empty."""
        cfg = self.config
        if channels is None:
            channels = self._health_stats()
        if channels["finite"]:
            self._maybe_snapshot(channels)
            return
        if cfg.nonfinite_policy == "halt":
            raise NonFiniteParamsError(self._nonfinite_diagnostic())
        if not self._snapshot_ring:
            if self.rollbacks_performed:
                raise NonFiniteParamsError(
                    f"rollback ring exhausted after {self.rollbacks_performed} "
                    f"rollback(s) — repeated divergence consumed every good snapshot; "
                    f"this needs a config change, not retries. "
                    + self._nonfinite_diagnostic())
            raise NonFiniteParamsError(
                self._nonfinite_diagnostic()
                + " (rollback requested but no good snapshot was taken yet — blowup "
                  "before the first probe)")
        if self.rollbacks_performed >= cfg.max_rollbacks:
            raise NonFiniteParamsError(
                f"giving up after {self.rollbacks_performed} rollbacks — the run keeps "
                f"diverging; this needs a config change, not retries. "
                + self._nonfinite_diagnostic())
        snap_step, old_step = self._restore_snapshot()
        self.rollbacks_performed += 1
        logger.warning(
            "non-finite params at step %d: rolled back to the snapshot from step %d "
            "and re-seeded the negative-sample lattice (counter -> %d; rollback %d/%d)",
            old_step, snap_step, self.global_step, self.rollbacks_performed,
            cfg.max_rollbacks)

    def _restore_snapshot(self) -> Tuple[int, int]:
        """Pop the newest ring entry and make it the live parameters (the blown pair
        becomes a spare slot), then jump ``global_step`` to
        ``max(global_step, snapshot step) + 2^22``. Popping makes the older entries
        reachable: a retry that blows up again steps further back. The one owner for
        both consumers; the next chunk recaptures its graphs (the live pair is another
        tensor now, and the graph key holds its address). Returns (snapshot step, step
        before the restore)."""
        self.restore_captures.append(self.graph_captures)
        params, snap_step = self._snapshot_ring.pop()
        self._spare_params.append(self.params)
        self.params = params
        old_step = self.global_step
        self.global_step = max(self.global_step, snap_step) + self._ROLLBACK_STEP_JUMP
        self.state = dc_replace(self.state, global_step=self.global_step)
        return int(snap_step), old_step

    def _maybe_snapshot(self, channels: dict) -> None:
        """Append the live parameters to the ring when a consumer needs it and the
        probed state is worth restoring: finite, and not one the watchdog would
        flag."""
        if not self._needs_snapshot_ring or not channels["finite"]:
            return
        if self.norm_watchdog.policy != "off" and self.norm_watchdog.would_fire(channels):
            return
        self._push_snapshot()

    def _watchdog_check(self, channels: dict) -> None:
        """Feed one probe to the watchdog and record a firing (under ``halt`` before
        the raise); under ``recover`` a firing runs the recovery."""
        try:
            reason = self.norm_watchdog.check(channels, self.global_step)
        except NormBlowupError:
            if self._telemetry is not None:
                self._emit("watchdog", step=self.global_step, policy="halt",
                           reason=self.norm_watchdog.last_reason or "",
                           channels=channels)
            raise
        if reason and self._telemetry is not None:
            self._emit("watchdog", step=self.global_step, policy=self.config.norm_watch,
                       reason=reason, channels=channels)
        if reason and self.config.norm_watch == "recover":
            self._perform_recovery(reason, channels)

    def _perform_recovery(self, reason: str, channels: dict) -> None:
        """The recovery ladder, once per firing probe under ``norm_watch="recover"``:
        the ``recovery`` record first (before any state changes), then the rollback
        and the lattice jump, then ``lr_scale *= recover_lr_backoff``, then
        ``max_row_norm`` engaged at ``norm_watch_threshold`` if it was off (the next
        chunk's step is built with it). Past ``max_recoveries``, or with the ring
        empty, it records ``halt`` and raises :class:`NormBlowupError`."""
        cfg = self.config

        def emit(action: str, snap_step: int, lr_scale: float, clamp: float) -> None:
            if self._telemetry is not None:
                self._emit(
                    "recovery", step=self.global_step, action=action, reason=reason,
                    snapshot_step=snap_step,
                    recoveries_performed=self.recoveries_performed
                    + (1 if action == "rollback" else 0),
                    max_recoveries=cfg.max_recoveries, lr_scale=round(lr_scale, 9),
                    max_row_norm=clamp, channels=channels)

        if self.recoveries_performed >= cfg.max_recoveries:
            emit("halt", -1, self._lr_scale, self._stabilizers.max_row_norm)
            raise NormBlowupError(
                f"recovery budget exhausted after {self.recoveries_performed} "
                f"recoveries (max_recoveries={cfg.max_recoveries}) — the run keeps "
                f"re-entering the blowup region under lr_scale={self._lr_scale:g} and "
                f"max_row_norm={self._stabilizers.max_row_norm:g}; this needs a config "
                f"change (negative_pool/subsample_ratio/learning_rate — EVAL.md), not "
                f"more retries. Last firing: {reason}")
        if not self._snapshot_ring:
            emit("halt", -1, self._lr_scale, self._stabilizers.max_row_norm)
            raise NormBlowupError(
                f"norm_watch='recover' fired with no good snapshot left "
                f"({self.recoveries_performed} recovery(ies) already consumed the "
                f"ring) — repeated blowups before any finite healthy probe; this needs "
                f"a config change, not retries. Last firing: {reason}")
        new_scale = self._lr_scale * cfg.recover_lr_backoff
        engage_clamp = not self._stabilizers.max_row_norm
        clamp_after = (cfg.norm_watch_threshold if engage_clamp
                       else self._stabilizers.max_row_norm)
        emit("rollback", int(self._snapshot_ring[-1][1]), new_scale, clamp_after)
        snap_step, old_step = self._restore_snapshot()
        self.recoveries_performed += 1
        self._lr_scale = new_scale
        if engage_clamp:
            # the threshold the firing measured health by; the step of the next chunk
            # (Trainer._step_fn) takes the clamp: on the shared pool the scatter form,
            # captured anew (the graph key holds the stabilizers), and announced as
            # the JAX trainer announces its rebuilt step
            self._stabilizers = self._stabilizers._replace(
                max_row_norm=float(cfg.norm_watch_threshold))
            self._announce_step()
        logger.warning(
            "norm watchdog recovery %d/%d at step %d: rolled back to the snapshot from "
            "step %d, re-seeded the sample lattice (counter -> %d), lr backed off to "
            "x%g%s — firing: %s", self.recoveries_performed, cfg.max_recoveries,
            old_step, snap_step, self.global_step, self._lr_scale,
            (f", engaged max_row_norm={self._stabilizers.max_row_norm:g}"
             if engage_clamp else ""), reason)

    def _emit(self, kind: str, **fields) -> None:
        """One record to the sink and to the flight recorder's ring."""
        if self._telemetry is not None:
            self._telemetry.emit(kind, **fields)
        if self._blackbox is not None:
            self._blackbox.observe(kind, fields)

    def _install_run_signals(self) -> None:
        """Hook SIGTERM for the fit when the flight recorder or
        ``checkpoint_on_preempt`` is on (main thread only; the teardown restores the
        prior handler)."""
        if self._blackbox is None and not self.config.checkpoint_on_preempt:
            return
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)
            self._sigterm_installed = True
        except ValueError:
            self._sigterm_installed = False  # not the main thread: no hook

    def _on_sigterm(self, signum, frame) -> None:
        """Dump, and with ``checkpoint_on_preempt`` only arm the deadline: the round in
        flight finishes and ``_finish_round``'s tail drains it (the handler may have
        interrupted a dispatch or the producer's staged copy). Without it, end the run
        and re-raise the signal under the prior handler."""
        if self._blackbox is not None:
            self._blackbox.dump(FlightRecorder.signal_cause(signum),
                                extra=self._dump_context())
        if (self.config.checkpoint_on_preempt and not self._run_ended
                and self._active_checkpoint_path):
            if self._preempt_deadline is None:  # the first signal wins
                self._preempt_deadline = time.monotonic() + self.config.preempt_deadline_s
                self._preempt_signum = int(signum)
                logger.warning("SIGTERM at step %d: preemption deadline armed (%.1fs) — "
                               "finishing in-flight dispatch, then emergency checkpoint",
                               self.global_step, self.config.preempt_deadline_s)
            return
        self._end_run("error")
        os.kill(os.getpid(), signum)

    def _teardown_run_inspection(self) -> None:
        """Stop the status endpoint and restore the SIGTERM disposition (idempotent)."""
        if self._statusd is not None:
            self._statusd.stop()
            self._statusd = None
        if self._sigterm_installed:
            self._sigterm_installed = False
            signal.signal(signal.SIGTERM, self._prev_sigterm
                          if self._prev_sigterm is not None else signal.SIG_DFL)
            self._prev_sigterm = None

    def _dump_context(self) -> dict:
        return {"phases": self._phases.summary(), "spans": self._tracer.span_summary(),
                "status": self.status_snapshot()}

    def status_snapshot(self) -> dict:
        """The live gauges (``/status.json``; ``/metrics`` renders them). Reads only
        host attributes and bounded rings the trainer already fetched, never a tensor
        on the card."""
        hb = self.heartbeats[-1] if self.heartbeats else None
        return {
            "run_id": self._run_id,
            "status": "idle" if self._run_ended else "running",
            "global_step": int(self.global_step),
            "words": int(self.state.words_processed),
            "pairs_trained": float(self.pairs_trained),
            "pairs_per_sec": float(hb.pairs_per_sec) if hb else None,
            "alpha": float(hb.alpha) if hb else None,
            "lr_scale": float(self._lr_scale),
            "recoveries": int(self.recoveries_performed),
            "rollbacks": int(self.rollbacks_performed),
            "watchdog_fires": int(self.norm_watchdog.fires),
            "heartbeats": len(self.heartbeats),
            "host_wait_s_total": round(self.host_wait_time, 3),
            "dispatch_s_total": round(self.dispatch_time, 3),
            "norms": self._last_probe_channels,
            "phases": self._phases.summary(),
        }

    @property
    def last_run_stats(self) -> dict:
        """The last fit's runtime outcome (and the phase rollup when attribution is
        on)."""
        stats = {
            "watchdog_fires": int(self.norm_watchdog.fires),
            "rollbacks_performed": int(self.rollbacks_performed),
            "recoveries_performed": int(self.recoveries_performed),
            "lr_scale_final": float(self._lr_scale),
            "engaged_max_row_norm": float(self._stabilizers.max_row_norm),
            "engaged_update_clip": float(self._stabilizers.update_clip),
            "engaged_row_l2": float(self._stabilizers.row_l2),
        }
        phases = self._phases.summary()
        if phases:
            stats["phases"] = phases
        return stats

    def _end_run(self, status: str) -> None:
        """The run's end (once per fit): tear down the endpoint and the hook, record
        ``run_end`` with the span summary, and export the trace to
        ``<telemetry_path>.trace.json``."""
        self._teardown_run_inspection()
        if self._run_ended:
            return
        self._run_ended = True
        if self._telemetry is not None:
            self._emit(
                "run_end", run_id=self._run_id, status=status,
                steps=int(self.global_step), pairs_trained=float(self.pairs_trained),
                host_wait_s_total=round(self.host_wait_time, 3),
                dispatch_s_total=round(self.dispatch_time, 3),
                watchdog_fires=int(self.norm_watchdog.fires),
                rollbacks=int(self.rollbacks_performed),
                recoveries=int(self.recoveries_performed),
                lr_scale=round(float(self._lr_scale), 9),
                phases=self._phases.summary(), spans=self._tracer.span_summary())
            try:
                self.export_trace(self.config.telemetry_path + ".trace.json")
            except OSError as e:  # never mask the training exception being unwound
                logger.warning("trace export failed: %s", e)

    def export_trace(self, path: str) -> int:
        """Write the collected host spans as Chrome-trace JSON; returns the event
        count."""
        return self._tracer.export_chrome_trace(path)

    def _abort_run(self) -> None:
        """In the fit's ``except BaseException`` clause: ``run_end`` with status
        "error", then the flight recorder's dump (whose ring then holds run_end)."""
        import sys

        exc = sys.exc_info()[1]
        self._end_run("error")
        if self._blackbox is not None:
            self._blackbox.dump(
                FlightRecorder.exception_cause(exc) if exc is not None else None,
                extra=self._dump_context())

    def _preempt_exit(self, checkpoint_path: Optional[str]) -> None:
        """The deferred half of a preemption: within the deadline, synchronise the card
        and save through the normal guarded save (never a torn or unguarded save: the
        atomic swap keeps the previous checkpoint on any failure); record ``preempt``,
        ``run_end`` with status "preempted", dump, and re-raise the signal under the
        restored handler. Never returns."""
        signum = self._preempt_signum or signal.SIGTERM
        remaining = self._preempt_deadline - time.monotonic()
        steps_since_save = int(self.global_step) - int(self._last_save_step)
        saved = False
        if checkpoint_path and steps_since_save == 0:
            saved = True  # this round's periodic save already holds this step
        elif checkpoint_path and remaining > 0:
            try:
                if self.device.type == "cuda":
                    with self.sync_sites("checkpoint", blocking=True):
                        torch.cuda.synchronize(self.device)
                self.save_checkpoint(checkpoint_path)
                saved = True
            except BaseException as e:  # the guard refusing, or the disk dying
                logger.warning("emergency checkpoint failed (%s); falling back to "
                               "blackbox-only exit", e)
        else:
            logger.warning("preempt deadline missed by %.1fs — blackbox-only exit",
                           max(-remaining, 0.0))
        self._emit("preempt", step=int(self.global_step), saved=saved,
                   checkpoint=checkpoint_path or "",
                   deadline_s=float(self.config.preempt_deadline_s),
                   steps_since_save=0 if saved else steps_since_save)
        self._end_run("preempted")
        if self._blackbox is not None:
            self._blackbox.dump(FlightRecorder.signal_cause(signum),
                                extra=self._dump_context())
        os.kill(os.getpid(), signum)

    # -- export / persistence ----------------------------------------------------------

    def unpadded_params(self) -> EmbeddingPair:
        """The real [V, D] parameters on one device. On a mesh a rank holds only its
        rows: save them (:meth:`save_checkpoint`, row shards) or ask for the gather
        (:meth:`gather_params`)."""
        if self.plan is not None:
            raise RuntimeError(
                "this trainer holds one rank's row blocks of a mesh; save them as a "
                "row-shards checkpoint (save_checkpoint) or gather them explicitly "
                "(gather_params)")
        V, D = self.vocab.size, self.config.vector_size
        return EmbeddingPair(self.params.syn0[:V, :D], self.params.syn1[:V, :D])

    def gather_params(self) -> EmbeddingPair:
        """The explicit gather of a mesh's blocks: every rank of the model axis
        contributes its rows (its columns, under the column layout; one all_gather a
        matrix) and every rank returns the real [V, D] parameters on its device. On one
        device, :meth:`unpadded_params`."""
        if self.plan is None:
            return self.unpadded_params()
        V, D = self.vocab.size, self.config.vector_size
        out = []
        for m in self.params:
            if self._cols:
                full = gather_cols(m, self.plan)
            elif self.plan.num_model > 1:
                full = distributed.COLLECTIVES.all_gather(m, self.plan.model_group,
                                                          MODEL_AXIS)
            else:
                full = m
            out.append(full[:V, :D])
        return EmbeddingPair(*out)

    def row_blocks(self) -> EmbeddingPair:
        """This rank's padded row blocks [Vs, Dp] of both matrices: the parameters as
        they are under the row layout; under the column layout, relaid from the column
        blocks by one model-axis all_to_all a matrix (a collective every rank calls),
        the layout a mesh fit's model is placed on, as the JAX estimator places its
        model on ``plan.embedding``."""
        if not self._cols:
            return self.params
        return EmbeddingPair(*(cols_to_rows(m, self.plan) for m in self.params))

    def save_checkpoint(self, path: str) -> None:
        """The guarded save: under a policy other than "none" the non-finite guard runs
        first (on this round's probe when ``_finish_round`` took one), so ``halt``
        never replaces a good checkpoint with NaNs and ``rollback`` saves the restored
        snapshot. Hot-row slabs are flushed at every chunk's end, so a save never sees
        a pending slab."""
        if self.config.nonfinite_policy != "none":
            self._nonfinite_guard(self._probed)
        if self._cols:
            self._save_dense_from_cols(path)
            return
        if self.plan is not None or self.config.sharded_checkpoint:
            # row shards: every rank writes its own rows, no gather
            with self.sync_sites("checkpoint", blocking=True):
                save_model_sharded(
                    path, self.vocab.words, self.vocab.counts, self.params.syn0,
                    self.params.syn1, self.config, self.state, plan=self.plan,
                    vocab_size=self.vocab.size, vector_size=self.config.vector_size,
                    extra_metadata=self.extra_checkpoint_meta or None)
            self._after_save(path)
            return
        p = self.unpadded_params()  # dense saves are float32 (bf16 widens exactly)
        with self.sync_sites("checkpoint", blocking=True):
            syn0, syn1 = p.syn0.float().cpu().numpy(), p.syn1.float().cpu().numpy()
        save_model(path, self.vocab.words, self.vocab.counts, syn0, syn1,
                   self.config, self.state,
                   extra_metadata=self.extra_checkpoint_meta or None)
        self._after_save(path)

    def _save_dense_from_cols(self, path: str) -> None:
        """A column mesh's save: the dense format, as the JAX package's column fit
        writes (its ``sharded_checkpoint`` is False: no rank owns whole rows). Every
        rank calls it: one all_gather of each matrix's columns over the model axis,
        then the rank at data 0, model 0 writes, and a barrier over the world holds
        every rank until the save has landed."""
        host = distributed.host_group()
        with self.sync_sites("checkpoint", blocking=True):
            full = self.gather_params()
            if self.plan.rank == 0:
                syn0 = full.syn0.float().cpu().numpy()
                syn1 = full.syn1.float().cpu().numpy()
        del full
        try:
            if self.plan.rank == 0:
                save_model(path, self.vocab.words, self.vocab.counts, syn0, syn1,
                           self.config, self.state,
                           extra_metadata=self.extra_checkpoint_meta or None)
        finally:
            distributed.COLLECTIVES.barrier(host)
        self._after_save(path)

    def _after_save(self, path: str) -> None:
        logger.info("checkpoint saved to %s at step %d", path, self.global_step)
        self._last_save_step = int(self.global_step)
        if self._telemetry is not None or self._blackbox is not None:
            # the publish record: joins a save to the reloads it caused
            from glint_word2vec_torch.obs.trace import emit_publish
            emit_publish(self._emit, path, self.global_step)
