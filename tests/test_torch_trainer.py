"""A small multi-chunk fit in both packages from the same injected parameters: the
step count, pair count, heartbeat cadence and alpha trace must be identical, the losses
and parameters equal to f32 tolerance.

Tolerance: atol 1e-5 on parameters and rtol 1e-4 on heartbeat losses. Each step
differs between the packages by f32 reassociation only (tests/test_torch_sgns.py),
and ~30 steps of SGD compound those differences without amplifying them at this
learning rate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair
from glint_word2vec_tpu.train.trainer import Trainer as JTrainer


def _corpus(seed=4, n_words=300, n_sent=160, length=20):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    return [[words[j] for j in rng.choice(n_words, size=length, p=p)]
            for _ in range(n_sent)]


@pytest.mark.parametrize("mode", ["exact", "clipped"])
def test_fit_matches_jax_trainer(mode):
    sents = _corpus()
    knobs = dict(vector_size=100, pairs_per_batch=512, negative_pool=64, window=5,
                 steps_per_dispatch=4, heartbeat_every_steps=3, num_iterations=2,
                 subsample_ratio=1e-3, allow_unstable=True, learning_rate=0.025,
                 seed=7, min_count=1, sigmoid_mode=mode)
    jvocab = j_build_vocab(sents, 1)
    tvocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, tvocab)
    rng = np.random.default_rng(0)
    syn0 = rng.uniform(-0.005, 0.005, (tvocab.size, 100)).astype(np.float32)
    syn1 = rng.normal(0, 0.01, (tvocab.size, 100)).astype(np.float32)

    jt = JTrainer(JConfig(**knobs), jvocab,
                  params=JPair(jnp.asarray(syn0), jnp.asarray(syn1)))
    jt.fit(enc)
    tt = TTrainer(TConfig(**knobs), tvocab, params=(syn0, syn1), device="cpu")
    tt.fit(enc)

    assert tt.global_step == jt.global_step >= 12  # >= 3 chunks of 4 steps
    assert tt.pairs_trained == jt.pairs_trained
    assert tt.state.to_dict() == {k: v for k, v in jt.state.__dict__.items()}
    jh, th = list(jt.heartbeats), list(tt.heartbeats)
    assert len(jh) == len(th) >= 3
    for a, b in zip(jh, th):
        assert (a.global_step, a.words, a.alpha) == (b.global_step, b.words, b.alpha)
        np.testing.assert_allclose(b.loss, a.loss, rtol=1e-4)
        np.testing.assert_allclose(b.mean_f_pos, a.mean_f_pos, rtol=1e-4, atol=1e-6)
    jp, tp = jt.unpadded_params(), tt.unpadded_params()
    np.testing.assert_allclose(tp.syn0.numpy(), np.asarray(jp.syn0), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tp.syn1.numpy(), np.asarray(jp.syn1), atol=1e-5, rtol=0)
    assert np.abs(tp.syn0.numpy() - syn0).max() > 1e-3  # training moved the params
    assert tt.padded_dim == 128 and not tt.params.syn0[:, 100:].any()


def test_vocab_scaled_auto_pool_matches():
    """The AUTO pool of a > 500k-word vocabulary re-resolves to load <= 160."""
    words = [f"w{i}" for i in range(600_000)]
    counts = (1e8 / np.arange(1, 600_001)).astype(np.int64) + 5
    from glint_word2vec_torch.data.vocab import Vocabulary as TV
    from glint_word2vec_tpu.data.vocab import Vocabulary as JV
    cfg = dict(pairs_per_batch=8192, negatives=5, vector_size=8)
    jt = JTrainer(JConfig(**cfg), JV.from_words_and_counts(words, counts))
    tt = TTrainer(TConfig(**cfg), TV.from_words_and_counts(words, counts), device="cpu")
    assert tt.config.negative_pool == jt.config.negative_pool == 256
    assert tt.config.subsample_ratio == jt.config.subsample_ratio


def test_resume_from_mid_run_checkpoint_is_exact(tmp_path):
    """A fit that saves every 4 steps, resumed from a mid-run checkpoint with its
    TrainState, lands on the uninterrupted run's parameters bit for bit (the CPU
    step is deterministic, and the feed and the negative lattice are pure functions
    of (seed, iteration, position, step))."""
    from glint_word2vec_torch.train.checkpoint import load_model

    sents = _corpus(seed=8, n_sent=80)
    knobs = dict(vector_size=16, pairs_per_batch=512, negative_pool=64,
                 steps_per_dispatch=4, num_iterations=2, subsample_ratio=1e-3,
                 allow_unstable=True, seed=3, min_count=1)
    vocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, vocab)
    rng = np.random.default_rng(1)
    init = (rng.uniform(-0.03, 0.03, (vocab.size, 16)).astype(np.float32),
            np.zeros((vocab.size, 16), np.float32))
    full = TTrainer(TConfig(**knobs), vocab, params=init, device="cpu")
    full.fit(enc)

    first = TTrainer(TConfig(**knobs), vocab, params=init, device="cpu")
    ck = str(tmp_path / "ck")
    saved = []
    real_save = first.save_checkpoint

    def save_once(path):  # keep the first periodic checkpoint: the "crash" point
        if not saved:
            real_save(path)
            saved.append(first.global_step)

    first.save_checkpoint = save_once
    first.fit(enc, checkpoint_path=ck, checkpoint_every_steps=4)
    assert saved == [4]
    data = load_model(ck)
    assert data["train_state"].global_step == 4 and not data["train_state"].finished
    resumed = TTrainer(TConfig(**knobs), vocab, params=(data["syn0"], data["syn1"]),
                       train_state=data["train_state"], device="cpu")
    resumed.fit(enc)
    assert resumed.global_step == full.global_step
    assert torch.equal(resumed.params.syn0, full.params.syn0)
    assert torch.equal(resumed.params.syn1, full.params.syn1)
