"""Estimator API, ported from ``glint_word2vec_tpu/models/estimator.py``:

    model = Word2Vec(vector_size=300, window=5, device="cuda").fit(sentences)
    model = Word2Vec(vector_size=300, cbow=True, device="cuda").fit(sentences)
    model = Word2Vec(vector_size=300, device_pairgen=True).fit(sentences)
    model = Word2Vec.resume(checkpoint_path, sentences, encode_cache_dir=cache)

vocabulary -> encoded corpus (in RAM, or memory-mapped under ``encode_cache_dir``) ->
:class:`..train.trainer.Trainer` fit -> :class:`..models.word2vec.Word2VecModel`, on the
card unless ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Optional, Sequence

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.corpus import EncodedCorpus, encode_corpus, vocab_fingerprint
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import Vocabulary, build_vocab
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.models.word2vec import Word2VecModel, refuse_plan
from glint_word2vec_torch.train.checkpoint import load_model, load_model_header
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
        them into pairs. ``plan`` (a multi-device mesh) is refused: the port trains on
        one device. The runtime outcome (watchdog firings, rollbacks, recoveries, the
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
        self.trainer = Trainer(cfg, vocab, device=self.device)
        t3 = time.perf_counter()
        self.trainer.fit(encoded, checkpoint_path=checkpoint_path,
                         checkpoint_every_steps=checkpoint_every_steps)
        self.timings = {"vocab_s": t1 - t0, "encode_s": t2 - t1, "setup_s": t3 - t2,
                        "train_s": time.perf_counter() - t3}
        self.last_run_stats = self.trainer.last_run_stats
        params = self.trainer.unpadded_params()
        return Word2VecModel(vocab=vocab, syn0=params.syn0, syn1=params.syn1,
                             config=self.trainer.config,
                             train_state=self.trainer.state, device=self.device)

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
        vocabulary fingerprint is the checkpoint's and refused otherwise; an empty
        ``encode_cache_dir`` is filled from ``sentences``. ``allow_unstable`` and
        ``config_overrides`` replace fields of the checkpoint's config (which pins the
        resolved subsample ratio) for the resumed run; a knob that changes the batch
        stream shifts what the recorded position means. A dense or row-shards
        checkpoint loads onto the one device; its reads use the resumed config's
        ``io_workers``."""
        refuse_plan(plan)
        device = resolve_device(device)
        header = load_model_header(checkpoint_path)
        if header["vocab_lineage"]:
            raise NotImplementedError(
                f"checkpoint {checkpoint_path!r} carries a vocab_lineage chain (a "
                "vocabulary grown by continual training); continual training is not "
                "ported to glint_word2vec_torch yet (ROADMAP.md queue A8)")
        cfg: Word2VecConfig = header["config"]
        if config_overrides:
            cfg = cfg.replace(**config_overrides)
        if allow_unstable is not None:
            cfg = cfg.replace(allow_unstable=allow_unstable)
        state = header["train_state"]
        vocab = Vocabulary.from_words_and_counts(header["words"], header["counts"])
        data = load_model(checkpoint_path, header=header, io_workers=cfg.io_workers)
        if data["syn1"] is None:
            raise ValueError("checkpoint has no syn1; cannot resume training")
        if isinstance(sentences, EncodedCorpus):
            encoded = sentences
        elif encode_cache_dir is not None:
            if os.path.exists(os.path.join(encode_cache_dir, "meta.json")):
                encoded = EncodedCorpus(encode_cache_dir)
                want = vocab_fingerprint(vocab)
                got = encoded.meta.get("vocab_fingerprint")
                if got != want:
                    raise ValueError(
                        f"encode_cache_dir {encode_cache_dir!r} was encoded under a "
                        f"different vocabulary (fingerprint {got} != the checkpoint's "
                        f"{want}); its ids would map to the wrong words. Point resume "
                        "at the cache of the interrupted run, or at an empty directory")
            else:
                encoded = encode_corpus(sentences, vocab, encode_cache_dir,
                                        cfg.max_sentence_length)
        else:
            if iter(sentences) is sentences:
                sentences = list(sentences)
            encoded = encode_sentences(sentences, vocab, cfg.max_sentence_length)
        trainer = Trainer(cfg, vocab, params=(data["syn0"], data["syn1"]),
                          train_state=state, device=device)
        if not state.finished:
            # the cadence is a fit() argument, not stored in the checkpoint
            trainer.fit(encoded, checkpoint_path=checkpoint_path,
                        checkpoint_every_steps=checkpoint_every_steps)
        out = trainer.unpadded_params()
        return Word2VecModel(vocab=vocab, syn0=out.syn0, syn1=out.syn1,
                             config=trainer.config, train_state=trainer.state,
                             device=device)
