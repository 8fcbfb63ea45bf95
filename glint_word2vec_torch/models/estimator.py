"""Estimator API, ported from ``glint_word2vec_tpu/models/estimator.py``:

    model = Word2Vec(vector_size=300, window=5, device="cuda").fit(sentences)
    model = Word2Vec(vector_size=300, cbow=True, device="cuda").fit(sentences)
    model = Word2Vec(vector_size=300, device_pairgen=True).fit(sentences)
    model = Word2Vec.resume(checkpoint_path, sentences, encode_cache_dir=cache)
    model = Word2Vec(vector_size=300).fit(sentences, plan=make_mesh(2, 2))  # each rank

vocabulary -> encoded corpus (in RAM, or memory-mapped under ``encode_cache_dir``) ->
:class:`..train.trainer.Trainer` fit -> :class:`..models.word2vec.Word2VecModel`, on the
card unless ``device="cpu"``. On a mesh of ranks (``parallel/``: one process a card,
joined by ``parallel.distributed.initialize``) every rank runs the same call and ends
with a :class:`..models.word2vec.ShardedWord2VecModel` of its rows.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Optional, Sequence

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.continual.extend import lineage_fingerprints
from glint_word2vec_torch.data.corpus import EncodedCorpus, encode_corpus, vocab_fingerprint
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import Vocabulary, build_vocab
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.models.word2vec import (
    ShardedWord2VecModel, Word2VecModel, refuse_plan)
from glint_word2vec_torch.parallel import distributed
from glint_word2vec_torch.parallel.mesh import (
    make_mesh, pad_dim_to_lanes, pad_vocab_for_sharding)
from glint_word2vec_torch.train.checkpoint import (
    load_model, load_model_header, load_params_into_plan)
from glint_word2vec_torch.train.trainer import Trainer

logger = logging.getLogger("glint_word2vec_torch")


class Word2Vec:
    """Trains word2vec: skip-gram, or CBOW with ``cbow=True``, with a shared negative
    pool or, with ``negative_pool=0`` (the AUTO pool below 4096 pairs per batch), with
    the reference's negatives per pair."""

    def __init__(self, config: Optional[Word2VecConfig] = None, device="cuda",
                 **overrides):
        self.device = resolve_device(device)
        if config is None:
            config = Word2VecConfig(**overrides)
        elif overrides:
            config = config.replace(**overrides)
        self.config = config
        self.trainer: Optional[Trainer] = None
        self.last_run_stats: Optional[dict] = None  # Trainer.last_run_stats of the fit
        self.timings: Optional[dict] = None  # the last fit's seconds by stage

    def fit(
        self,
        sentences: Iterable[Sequence[str]],
        vocab: Optional[Vocabulary] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every_steps: Optional[int] = None,
        encode_cache_dir: Optional[str] = None,
        plan=None,
    ) -> Word2VecModel:
        """``sentences``: iterable of token sequences. Re-iterables (lists,
        :class:`..data.corpus.TokenFileCorpus`) are streamed twice (vocabulary pass and
        encode pass); one-shot generators are materialized first. ``vocab`` skips the
        counting pass. ``encode_cache_dir``: write the encoded corpus there and train
        from memory-mapped files (bounded host RAM); without it, encoding is in RAM.
        The fitted :class:`Trainer` stays on ``self.trainer``. With
        ``device_pairgen=True`` the trainer feeds token blocks and the device expands
        them into pairs. ``plan``: a (data, model) mesh of ranks
        (``parallel.mesh.make_mesh``), or None for the config's (one device unless it
        names a larger one); on a mesh every rank calls ``fit`` alike and gets a
        :class:`ShardedWord2VecModel` of its rows. The runtime outcome (watchdog firings, rollbacks, recoveries, the
        final lr scale and engaged stabilizers) is ``self.last_run_stats``; the seconds of
        its stages (``vocab_s``: the counting pass, or 0 with ``vocab``; ``encode_s``;
        ``setup_s``: the trainer's construction; ``train_s``: its fit) are
        ``self.timings``."""
        refuse_plan(plan)
        cfg = self.config
        t0 = time.perf_counter()
        if iter(sentences) is sentences:
            sentences = list(sentences)
        if vocab is None:
            vocab = build_vocab(sentences, cfg.min_count, workers=cfg.io_workers)
        logger.info("vocabSize = %d, trainWordsCount = %d",
                    vocab.size, vocab.train_words_count)
        t1 = time.perf_counter()
        if encode_cache_dir is not None:
            encoded = encode_corpus(sentences, vocab, encode_cache_dir,
                                    cfg.max_sentence_length)
        else:
            encoded = encode_sentences(sentences, vocab, cfg.max_sentence_length)
        t2 = time.perf_counter()
        self.trainer = Trainer(cfg, vocab, device=self.device, plan=plan)
        t3 = time.perf_counter()
        self.trainer.fit(encoded, checkpoint_path=checkpoint_path,
                         checkpoint_every_steps=checkpoint_every_steps)
        self.timings = {"vocab_s": t1 - t0, "encode_s": t2 - t1, "setup_s": t3 - t2,
                        "train_s": time.perf_counter() - t3}
        self.last_run_stats = self.trainer.last_run_stats
        return _fitted_model(self.trainer, self.device)

    @staticmethod
    def resume(
        checkpoint_path: str,
        sentences: Iterable[Sequence[str]],
        checkpoint_every_steps: Optional[int] = None,
        encode_cache_dir: Optional[str] = None,
        allow_unstable: Optional[bool] = None,
        config_overrides: Optional[dict] = None,
        device="cuda",
        plan=None,
    ) -> Word2VecModel:
        """Resume an interrupted run from a mid-training checkpoint of either package.
        Resume is exact-step: the checkpoint records the batch stream's position
        (``TrainState.batches_done``), so the interrupted iteration's trained batches
        are skipped, not replayed.

        ``sentences`` may be token sequences or an :class:`EncodedCorpus`. If
        ``encode_cache_dir`` already holds an encoded corpus, it is reused when its
        vocabulary fingerprint is the checkpoint's or an ancestor's in the checkpoint's
        ``vocab_lineage`` chain (continual training), and refused otherwise; an empty
        ``encode_cache_dir`` is filled from ``sentences``. The resumed run's saves keep
        the chain. ``allow_unstable`` and
        ``config_overrides`` replace fields of the checkpoint's config (which pins the
        resolved subsample ratio) for the resumed run; a knob that changes the batch
        stream shifts what the recorded position means. A dense or row-shards
        checkpoint loads onto the one device; its reads use the resumed config's
        ``io_workers``. ``plan`` (or a resumed config that names a mesh): every rank
        resumes alike; a row-shards checkpoint streams each rank's rows onto it, even
        from another mesh (elastic resume), a dense one is carved (its columns, under
        the column layout)."""
        refuse_plan(plan)
        device = resolve_device(device)
        header = load_model_header(checkpoint_path)
        cfg: Word2VecConfig = header["config"]
        if config_overrides:
            cfg = cfg.replace(**config_overrides)
        if allow_unstable is not None:
            cfg = cfg.replace(allow_unstable=allow_unstable)
        state = header["train_state"]
        vocab = Vocabulary.from_words_and_counts(header["words"], header["counts"])
        if plan is None and (cfg.mesh_size[0] * cfg.mesh_size[1] > 1
                             or distributed.is_multiprocess()):
            plan = make_mesh(*cfg.mesh_size)
        if (plan is not None and plan.size > 1 and header["layout"] == "row-shards"
                and cfg.embedding_partition == "rows"):
            params = load_params_into_plan(
                checkpoint_path, plan, pad_vocab_for_sharding(vocab.size, plan.num_model),
                pad_dim_to_lanes(cfg.vector_size, cfg.pad_vector_to_lanes),
                io_workers=cfg.io_workers)
        else:
            data = load_model(checkpoint_path, header=header, io_workers=cfg.io_workers)
            params = (data["syn0"], data["syn1"])
        if params[1] is None:
            raise ValueError("checkpoint has no syn1; cannot resume training")
        if isinstance(sentences, EncodedCorpus):
            encoded = sentences
        elif encode_cache_dir is not None:
            if os.path.exists(os.path.join(encode_cache_dir, "meta.json")):
                encoded = EncodedCorpus(encode_cache_dir)
                want = vocab_fingerprint(vocab)
                got = encoded.meta.get("vocab_fingerprint")
                # a checkpoint grown by continual.extend keeps every ancestor
                # vocabulary's ids valid (identity prefix): a cache encoded under any
                # of them is reused as it is
                allowed = set(lineage_fingerprints(header["vocab_lineage"]))
                allowed.add(want)
                if got not in allowed:
                    raise ValueError(
                        f"encode_cache_dir {encode_cache_dir!r} was encoded under a "
                        f"different vocabulary (fingerprint {got} != the checkpoint's "
                        f"{want}, and it is not an ancestor in the checkpoint's lineage "
                        "chain); its ids would map to the wrong words. Point resume at "
                        "the cache of the interrupted run, or at an empty directory; or, "
                        "if the corpus drifted (new words, shifted frequencies), migrate "
                        "the checkpoint first with "
                        "glint_word2vec_torch.continual.extend.extend_checkpoint instead "
                        "of retraining from scratch")
            else:
                encoded = encode_corpus(sentences, vocab, encode_cache_dir,
                                        cfg.max_sentence_length)
        else:
            if iter(sentences) is sentences:
                sentences = list(sentences)
            encoded = encode_sentences(sentences, vocab, cfg.max_sentence_length)
        trainer = Trainer(cfg, vocab, params=params, train_state=state, device=device,
                          plan=plan)
        if header["vocab_lineage"]:
            # the resumed run's saves keep the chain
            trainer.extra_checkpoint_meta = {"vocab_lineage": header["vocab_lineage"]}
        if not state.finished:
            # the cadence is a fit() argument, not stored in the checkpoint
            trainer.fit(encoded, checkpoint_path=checkpoint_path,
                        checkpoint_every_steps=checkpoint_every_steps)
        return _fitted_model(trainer, device)


def _fitted_model(trainer: Trainer, device):
    """The model a fit leaves: dense on one device, this rank's rows on a mesh. A
    column fit's model is relaid to row blocks (one model-axis all_to_all a matrix),
    as the JAX estimator places its model on ``plan.embedding`` whatever the fit's
    layout: the model ops serve row blocks."""
    if trainer.plan is not None:
        return ShardedWord2VecModel(trainer.vocab, trainer.row_blocks(), trainer.config,
                                    trainer.state, trainer.plan, device)
    out = trainer.unpadded_params()
    return Word2VecModel(vocab=trainer.vocab, syn0=out.syn0, syn1=out.syn1,
                         config=trainer.config, train_state=trainer.state, device=device)
