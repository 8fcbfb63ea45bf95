"""The continual runner, ported from ``glint_word2vec_tpu/continual/loop.py``: watch the
corpus -> extend the vocabulary -> incremental fit -> atomic publish.

One :class:`ContinualRunner` owns a (checkpoint path, corpus stream, work dir) triple.
Each :meth:`ContinualRunner.run_once` cycle:

1. polls the append-only stream (:mod:`.stream`) for unconsumed segments; none: idle;
2. counts the tail's words and migrates the checkpoint through
   :func:`.extend.extend_checkpoint`, an atomic in-place publish, so a watching
   ``EmbeddingService`` hot-reloads the grown model before the fit starts (below
   ``continual_min_new_words`` the counts still merge);
3. encodes only the new tail under the (grown) vocabulary; consumed segments' caches
   stay valid through the lineage chain (``continual_replay_segments`` replays some);
4. fits the increment on ``device``: the checkpoint's parameters load onto the card,
   the learning rate re-warms through the trainer's dispatch-time ``_lr_scale`` (read
   in each chunk's prologue, outside the CUDA graph; the published config keeps its
   base ``learning_rate``) and decays over the increment's own words
   (``fit(corpus_words=)``), the hash-PRNG lattice continues from the checkpoint's
   ``global_step``, and every save carries the lineage chain;
5. marks the tail consumed only after the fit, so a SIGTERM mid-increment leaves a
   resumable published checkpoint and an unconsumed cursor.

One blocking loop, no thread: run it as its own process
(``python -m glint_word2vec_torch.continual_run``) beside the serving replicas. Each
increment builds a new :class:`..train.trainer.Trainer` (its CUDA graphs are its own,
captured at its V); nothing catches a kernel's failure.

On a mesh (``plan``, one rank a card) every rank runs the same runner. Rank 0 decides
and writes alone (the poll, the checkpoint's recovery and extension, the cursor, the
first encode of a segment, the telemetry) and hands its decisions to the others
(``parallel/distributed.COLLECTIVES.broadcast_object``); the ranks then read what it
wrote, each streams its rows of a row-shards checkpoint
(``load_params_into_plan``), and every rank fits and saves its own rows.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.continual import extend as _extend
from glint_word2vec_torch.continual.stream import (
    ConcatCorpus,
    CorpusStream,
    StreamCursor,
    encode_delta,
    encode_segment,
    segment_fingerprint,
)
from glint_word2vec_torch.data.corpus import vocab_fingerprint
from glint_word2vec_torch.data.vocab import Vocabulary, count_words, merge_counts
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.models.word2vec import refuse_plan
from glint_word2vec_torch.parallel import distributed
from glint_word2vec_torch.parallel.mesh import pad_dim_to_lanes, pad_vocab_for_sharding
from glint_word2vec_torch.train.checkpoint import (
    TrainState,
    load_latest_valid,
    load_model,
    load_model_header,
    load_params_into_plan,
    verify_checkpoint,
)

logger = logging.getLogger("glint_word2vec_torch")


class ContinualRunner:
    """Drives continual train -> publish cycles over an append-only corpus.

    ``checkpoint_path`` is the publish path serving replicas watch; ``corpus_dir`` the
    segment directory; ``work_dir`` holds the cursor and the per-segment encode caches.
    ``config_overrides`` replace checkpoint-config fields for every increment.
    ``telemetry_path`` opens a sink for the ``continual_*`` and ``publish`` records.
    Fits and loads run on ``device`` (the card unless ``"cpu"``). ``plan``: a mesh of
    ranks (``parallel.mesh.make_mesh``) every rank of which runs this runner alike, or
    None for one device."""

    def __init__(
        self,
        checkpoint_path: str,
        corpus_dir: str,
        work_dir: str,
        plan=None,
        config_overrides: Optional[Dict[str, Any]] = None,
        checkpoint_every_steps: Optional[int] = None,
        telemetry_path: str = "",
        device="cuda",
    ):
        refuse_plan(plan)
        self.plan = plan if plan is not None and plan.size > 1 else None
        self._lead = self.plan is None or self.plan.rank == 0
        self.device = resolve_device(device)
        self.checkpoint_path = checkpoint_path
        self.stream = CorpusStream(corpus_dir)
        self.work_dir = work_dir
        self.config_overrides = dict(config_overrides or {})
        self.checkpoint_every_steps = checkpoint_every_steps
        self.increments = 0
        self._sink = None
        if telemetry_path and self._lead:
            from glint_word2vec_torch.obs.sink import TelemetrySink
            self._sink = TelemetrySink(telemetry_path)
        os.makedirs(work_dir, exist_ok=True)
        self.cursor = StreamCursor(work_dir)

    # -- helpers -------------------------------------------------------------------

    def _shared(self, fn):
        """``fn()`` run by rank 0 alone, its result handed to every rank of the mesh
        (on one device, just ``fn()``)."""
        out = fn() if self._lead else None
        if self.plan is not None:
            out = distributed.COLLECTIVES.broadcast_object(out, distributed.host_group())
        return out

    def _lead_first(self, fn):
        """``fn()`` on rank 0, then, once it is done, on the other ranks (which reuse
        what it wrote: the encode caches)."""
        out = fn() if self._lead else None
        if self.plan is not None:
            distributed.COLLECTIVES.barrier(distributed.host_group())
            if not self._lead:
                out = fn()
        return out

    def _save_cursor(self) -> None:
        if self._lead:
            self.cursor.save()

    def _emit(self, kind: str, **fields) -> None:
        if self._sink is not None:
            self._sink.emit(kind, **fields)

    def _emit_publish(self, trainer) -> None:
        """The increment's final save as a ``publish`` record keyed by the publish
        signature the serving watcher compares (obs/trace.emit_publish)."""
        if self._sink is not None:
            from glint_word2vec_torch.obs.trace import emit_publish
            emit_publish(self._sink.emit, self.checkpoint_path, int(trainer.global_step),
                         publisher="continual")

    def _cache_dir(self) -> str:
        return os.path.join(self.work_dir, "encode-cache")

    def _recovered_checkpoint(self) -> str:
        """The publish path, healed if the last save died mid-swap (the writer, this
        runner, is not saving concurrently)."""
        try:
            verify_checkpoint(self.checkpoint_path)
            return self.checkpoint_path
        except (FileNotFoundError, ValueError):
            recovered = load_latest_valid(
                os.path.dirname(os.path.abspath(self.checkpoint_path)) or ".",
                reclaim=True)
            if recovered != self.checkpoint_path:
                logger.warning("recovered checkpoint at %s (expected %s)", recovered,
                               self.checkpoint_path)
            return recovered

    def _load_config(self, header: Dict[str, Any]) -> Word2VecConfig:
        cfg: Word2VecConfig = header["config"]
        if self.config_overrides:
            cfg = cfg.replace(**self.config_overrides)
        return cfg

    def _load_params(self, path: str, header: Dict[str, Any], cfg) -> tuple:
        """The checkpoint's matrices on the runner's device (a dense f32 matrix streams
        to the card as it is read and hashed); on a mesh, this rank's rows of a
        row-shards checkpoint, streamed."""
        if self.plan is not None and header["layout"] == "row-shards":
            nm = self.plan.num_model
            shards = load_params_into_plan(
                path, self.plan, pad_vocab_for_sharding(len(header["words"]), nm),
                pad_dim_to_lanes(cfg.vector_size, cfg.pad_vector_to_lanes),
                io_workers=cfg.io_workers, device=self.device)
            if shards.syn1 is None:
                raise ValueError("checkpoint has no syn1; cannot train an increment")
            return shards
        data = load_model(path, header=header, io_workers=cfg.io_workers,
                          device=self.device)
        if data["syn1"] is None:
            raise ValueError("checkpoint has no syn1; cannot train an increment")
        return data["syn0"], data["syn1"]

    # -- bootstrap -----------------------------------------------------------------

    def ensure_base(self) -> Dict[str, Any]:
        """Without a checkpoint, fit a base model over every segment in the stream
        and publish it; with one, do nothing."""
        if self._shared(lambda: os.path.exists(
                os.path.join(self.checkpoint_path, "metadata.json"))):
            return {"action": "none"}
        from glint_word2vec_torch.train.trainer import Trainer
        names = self._shared(lambda: self.cursor.new_segments(self.stream))
        if not names:
            raise FileNotFoundError(
                f"no checkpoint at {self.checkpoint_path!r} and no corpus segments "
                f"under {self.stream.directory!r} to bootstrap from")
        cfg = Word2VecConfig(**self.config_overrides)
        counter = merge_counts(count_words(self.stream.corpus(n)) for n in names)
        vocab = Vocabulary.from_counter(counter, cfg.min_count)
        parts = self._lead_first(lambda: [
            encode_segment(self.stream, n, vocab, self._cache_dir(),
                           cfg.max_sentence_length) for n in names])
        t0 = time.perf_counter()
        trainer = Trainer(cfg, vocab, device=self.device, plan=self.plan)
        trainer.fit(ConcatCorpus(parts), checkpoint_path=self.checkpoint_path,
                    checkpoint_every_steps=self.checkpoint_every_steps)
        vfp = vocab_fingerprint(vocab)
        for name, enc in zip(names, parts):
            self.cursor.mark_consumed(name, segment_fingerprint(self.stream.path(name)),
                                      vfp, enc.meta)
        self._save_cursor()
        report = {"action": "base", "segments": len(names), "vocab_size": vocab.size,
                  "train_seconds": round(time.perf_counter() - t0, 3)}
        self._emit("continual_increment", increment=0, segments=len(names),
                   vocab_size=vocab.size, new_words=vocab.size,
                   words=int(vocab.train_words_count),
                   train_seconds=report["train_seconds"])
        self._emit_publish(trainer)
        return report

    # -- one cycle -----------------------------------------------------------------

    def run_once(self) -> Dict[str, Any]:
        """One poll -> extend -> fit -> publish cycle. Returns a report (``action``
        "idle" or "increment"); an increment's also holds the seconds of each stage
        (``seconds``) and what its trainer did (``trainer``: global steps, pairs, the
        fit's, feed waits' and dispatch's seconds, chunks, graph captures and
        replays)."""
        new_names = self._shared(lambda: self.cursor.new_segments(self.stream))
        if not new_names:
            return {"action": "idle", "segments": 0}
        ck = self._shared(self._recovered_checkpoint)
        header = load_model_header(ck)
        cfg = self._load_config(header)
        seconds = {"count": 0.0, "extend": 0.0}

        # 1. count the tail: only segments whose counts are not merged yet (a crashed
        # increment retries its fit without counting the tail twice)
        count_names = self.cursor.uncounted(new_names)
        grew = False
        report = {"new_words": 0}
        if count_names:
            def count_and_extend():
                t0 = time.perf_counter()
                tail_counts = merge_counts(count_words(self.stream.corpus(n))
                                           for n in count_names)
                seconds["count"] = time.perf_counter() - t0
                # 2. migrate, on every increment with fresh counts: growth or a counts
                # merge (the fingerprint changes either way, and the link keeps old
                # caches valid). Publish #1: a watcher reloads the grown model now. The
                # tail's fingerprint rides the link, so a retry whose attempt died
                # between this publish and the cursor save below sees the merge
                # already applied.
                tail_fp = "+".join(f"{n}={segment_fingerprint(self.stream.path(n))}"
                                   for n in count_names)
                return _extend.extend_checkpoint(
                    ck, tail_counts, out_path=self.checkpoint_path,
                    min_count=cfg.min_count, min_new_words=cfg.continual_min_new_words,
                    tail_fingerprint=tail_fp)

            t0 = time.perf_counter()
            report = self._shared(count_and_extend)
            t0 += seconds["count"]
            ck = report["path"]
            grew = report["new_words"] > 0
            header = load_model_header(ck)
            cfg = self._load_config(header)
            for name in count_names:
                self.cursor.mark_counted(name, segment_fingerprint(self.stream.path(name)))
            self._save_cursor()
            seconds["extend"] = time.perf_counter() - t0
            if grew:
                self._emit("continual_extend", old_vocab_size=report["old_vocab_size"],
                           new_vocab_size=report["new_vocab_size"],
                           new_words=report["new_words"])
        vocab = Vocabulary.from_words_and_counts(header["words"], header["counts"])
        lineage = list(header.get("vocab_lineage") or [])
        allowed = _extend.lineage_fingerprints(lineage)

        # 3. delta encode: only the tail is new work
        t0 = time.perf_counter()
        enc = self._lead_first(lambda: encode_delta(
            self.stream, self.cursor, vocab, self._cache_dir(),
            max_sentence_length=cfg.max_sentence_length, lineage=allowed,
            replay_segments=cfg.continual_replay_segments, names=new_names))
        seconds["encode"] = time.perf_counter() - t0

        # 4. the incremental fit: lr re-warmed through the dispatch-time scale (a
        # config rewrite would compound across increments, since every publish carries
        # the config), the PRNG lattice continued from the checkpoint's global_step
        from glint_word2vec_torch.train.trainer import Trainer
        t0 = time.perf_counter()
        params = self._load_params(ck, header, cfg)
        seconds["load"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inc_cfg = cfg.replace(num_iterations=cfg.continual_iterations)
        step0 = int(header["train_state"].global_step)
        trainer = Trainer(inc_cfg, vocab, params=params,
                          train_state=TrainState(global_step=step0), device=self.device,
                          plan=self.plan)
        del params
        if cfg.continual_lr_rewarm != 1.0:
            trainer._lr_scale = cfg.continual_lr_rewarm
        trainer.extra_checkpoint_meta = {"vocab_lineage": lineage}
        seconds["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # corpus_words: the lr clock anneals over the increment's corpus, not the
        # merged history the vocabulary's counts imply
        trainer.fit(enc["corpus"], checkpoint_path=self.checkpoint_path,
                    checkpoint_every_steps=self.checkpoint_every_steps,
                    corpus_words=enc["corpus"].total_tokens)
        seconds["fit"] = time.perf_counter() - t0
        train_seconds = round(seconds["setup"] + seconds["fit"], 3)

        # 5. consume the tail, only now: a crash above retries cleanly
        vfp = vocab_fingerprint(vocab)
        for name in enc["new"]:
            self.cursor.mark_consumed(name, segment_fingerprint(self.stream.path(name)),
                                      vfp, enc["encoded"][name].meta)
        self._save_cursor()
        self.increments += 1
        words = sum(int(enc["encoded"][n].total_tokens) for n in enc["new"])
        self._emit("continual_increment", increment=self.increments,
                   segments=len(enc["new"]), vocab_size=vocab.size,
                   new_words=report["new_words"], words=words,
                   train_seconds=train_seconds)
        self._emit_publish(trainer)
        return {
            "action": "increment",
            "increment": self.increments,
            "segments": len(enc["new"]),
            "replayed": len(enc["replayed"]),
            "grew": grew,
            "new_words": report["new_words"],
            "vocab_size": vocab.size,
            "words": words,
            "lineage_depth": len(lineage),
            "train_seconds": train_seconds,
            "seconds": seconds,
            "trainer": {"global_step_start": step0,
                        "global_step": int(trainer.global_step),
                        "pairs_trained": float(trainer.pairs_trained),
                        "fit_s": trainer.fit_time, "host_wait_s": trainer.host_wait_time,
                        "dispatch_s": trainer.dispatch_time,
                        "prologue_s": trainer.prologue_time, "chunks": trainer.chunks_run,
                        "graph_captures": trainer.graph_captures,
                        "graph_replays": trainer.graph_replays},
        }

    # -- the loop ------------------------------------------------------------------

    def run_forever(self, max_increments: Optional[int] = None,
                    max_idle_polls: Optional[int] = None,
                    poll_s: Optional[float] = None) -> Dict[str, Any]:
        """Poll and increment until ``max_increments`` increments completed or
        ``max_idle_polls`` consecutive empty polls (both None: until killed).
        ``poll_s`` defaults to the checkpoint config's ``continual_poll_s``
        (overrides win; the dataclass default before a checkpoint exists)."""
        if poll_s is None:
            try:
                poll_s = self._load_config(
                    load_model_header(self.checkpoint_path)).continual_poll_s
            except (FileNotFoundError, ValueError):
                poll_s = Word2VecConfig(**self.config_overrides).continual_poll_s
        done, idle = 0, 0
        while True:
            report = self.run_once()
            if report["action"] == "increment":
                done += 1
                idle = 0
                logger.info("continual increment %d: %s", report["increment"], report)
                if max_increments is not None and done >= max_increments:
                    return {"increments": done, "stopped": "max_increments"}
            else:
                idle += 1
                if max_idle_polls is not None and idle >= max_idle_polls:
                    return {"increments": done, "stopped": "idle"}
                time.sleep(poll_s)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    def __enter__(self) -> "ContinualRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
