"""Estimator API, ported from ``glint_word2vec_tpu/models/estimator.py``:

    model = Word2Vec(vector_size=300, window=5, device="cuda").fit(sentences)
    model = Word2Vec(vector_size=300, cbow=True, device="cuda").fit(sentences)

vocabulary -> encoded corpus -> :class:`..train.trainer.Trainer` fit ->
:class:`..models.word2vec.Word2VecModel`, on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional, Sequence

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import Vocabulary, build_vocab
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.models.word2vec import Word2VecModel
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

    def fit(
        self,
        sentences: Iterable[Sequence[str]],
        vocab: Optional[Vocabulary] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every_steps: Optional[int] = None,
    ) -> Word2VecModel:
        """``sentences``: iterable of token sequences (one-shot generators are
        materialized, since they are read twice). ``vocab`` skips the counting pass.
        The fitted :class:`Trainer` stays on ``self.trainer``."""
        cfg = self.config
        if iter(sentences) is sentences:
            sentences = list(sentences)
        if vocab is None:
            vocab = build_vocab(sentences, cfg.min_count)
        logger.info("vocabSize = %d, trainWordsCount = %d",
                    vocab.size, vocab.train_words_count)
        encoded = encode_sentences(sentences, vocab, cfg.max_sentence_length)
        self.trainer = Trainer(cfg, vocab, device=self.device)
        self.trainer.fit(encoded, checkpoint_path=checkpoint_path,
                         checkpoint_every_steps=checkpoint_every_steps)
        params = self.trainer.unpadded_params()
        return Word2VecModel(vocab=vocab, syn0=params.syn0, syn1=params.syn1,
                             config=self.trainer.config,
                             train_state=self.trainer.state, device=self.device)
