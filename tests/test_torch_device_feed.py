"""The port's device feed (``device_pairgen=True``: host-subsampled token blocks that the
device expands into pairs) against the JAX package's, on the same corpus and initial
parameters: the block stream bit for bit at 1 and 4 producer workers, the fits' step
count, pairs trained, overflow drops and state exactly, parameters within 1e-5 (f32
reassociation between the packages' steps, as in tests/test_torch_trainer.py), the
producer thread leaving CPU parameters bit-identical, exact resume, and the four
config refusals with the JAX package's messages."""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import Word2Vec as TWord2Vec
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.train import trainer as ttrainer
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data import pipeline as jpipeline
from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair
from glint_word2vec_tpu.train.trainer import Trainer as JTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


PARAM_ATOL = 1e-5


def _corpus(seed=4, n_words=300, n_sent=160, length=20):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    return [[words[j] for j in rng.choice(n_words, size=length, p=p)]
            for _ in range(n_sent)]


def _knobs(**kw):
    base = dict(vector_size=64, pairs_per_batch=512, window=5, steps_per_dispatch=4,
                heartbeat_every_steps=3, num_iterations=2, subsample_ratio=1e-3,
                allow_unstable=True, learning_rate=0.025, seed=7, min_count=1,
                device_pairgen=True)
    base.update(kw)
    return base


def _init(V, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.005, 0.005, (V, D)).astype(np.float32),
            rng.normal(0, 0.01, (V, D)).astype(np.float32))


def _jax_dropped(caplog) -> int:
    """The JAX trainer reports its overflow drops only in its log."""
    for rec in caplog.records:
        m = re.search(r"dropped ([0-9]+) pairs|: ([0-9]+) overflow pairs dropped",
                      rec.getMessage())
        if m:
            return int(m.group(1) or m.group(2))
    return 0


@pytest.mark.parametrize("workers", [1, 4])
def test_seg_blocks_match_jax(workers, monkeypatch):
    """The block stream (tokens, start bits, n_valid, ordinal base, kept count) over
    several slabs equals the JAX trainer's at 1 and 4 producer workers."""
    sents = _corpus(seed=3, n_sent=400)
    vocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, vocab)
    orig_j, orig_t = jpipeline.iter_sentence_slabs, ttrainer.iter_sentence_slabs
    monkeypatch.setattr(jpipeline, "iter_sentence_slabs",
                        lambda s, o, block_words=0: orig_j(s, o, 700))
    monkeypatch.setattr(ttrainer, "iter_sentence_slabs",
                        lambda s, o, block_words=0: orig_t(s, o, 700))
    knobs = _knobs(tokens_per_step=300)
    jt = JTrainer(JConfig(**knobs), j_build_vocab(sents, 1))
    tt = TTrainer(TConfig(**knobs), vocab, device="cpu")
    for k in (1, 2):
        want = list(jt._device_seg_blocks(enc, k, 0, workers=1))
        got = list(tt._device_seg_blocks(enc, k, workers=workers))
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0].astype(np.int32))
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2:] == w[2:]


@pytest.mark.parametrize("pool,extra", [
    (8, {}),
    (0, {}),
    (8, {"tokens_per_step": 200}),   # overflow: pairs past B are dropped and counted
], ids=["pool8", "pool0", "pool8-overflow"])
def test_fit_matches_jax_device_feed(pool, extra, caplog):
    sents = _corpus()
    knobs = _knobs(negative_pool=pool, **extra)
    tvocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, tvocab)
    syn0, syn1 = _init(tvocab.size, 64)
    with caplog.at_level(logging.INFO, logger="glint_word2vec_tpu"):
        jt = JTrainer(JConfig(**knobs), j_build_vocab(sents, 1),
                      params=JPair(jnp.asarray(syn0), jnp.asarray(syn1)))
        jt.fit(enc)
    tt = TTrainer(TConfig(**knobs), tvocab, params=(syn0, syn1), device="cpu")
    tt.fit(enc)
    assert tt.feed_backend == "device"
    assert tt._tokens_per_step == jt._tokens_per_step
    assert tt.global_step == jt.global_step >= 10
    assert tt.pairs_trained == jt.pairs_trained > 0
    assert tt.dropped_pairs == _jax_dropped(caplog)
    if extra:
        assert tt.dropped_pairs > 0
    assert tt.state.to_dict() == {k: v for k, v in jt.state.__dict__.items()}
    jh, th = list(jt.heartbeats), list(tt.heartbeats)
    assert len(jh) == len(th) >= 2
    for a, b in zip(jh, th):
        assert (a.global_step, a.words, a.alpha) == (b.global_step, b.words, b.alpha)
        np.testing.assert_allclose(b.loss, a.loss, rtol=1e-4)
    jp, tp = jt.unpadded_params(), tt.unpadded_params()
    np.testing.assert_allclose(tp.syn0.numpy(), np.asarray(jp.syn0), atol=PARAM_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tp.syn1.numpy(), np.asarray(jp.syn1), atol=PARAM_ATOL,
                               rtol=0)
    assert np.abs(tp.syn0.numpy() - syn0).max() > 1e-3


def test_prefetch_leaves_params_bit_identical():
    sents = _corpus(seed=6)
    vocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, vocab)
    syn0, syn1 = _init(vocab.size, 64, seed=1)
    out = []
    for prefetch in (0, 8):
        tt = TTrainer(TConfig(**_knobs(negative_pool=8, prefetch_chunks=prefetch)),
                      vocab, params=(syn0, syn1), device="cpu")
        tt.fit(enc)
        out.append((tt.unpadded_params(), tt.global_step, tt.pairs_trained))
    assert out[0][1:] == out[1][1:]
    assert torch.equal(out[0][0].syn0, out[1][0].syn0)
    assert torch.equal(out[0][0].syn1, out[1][0].syn1)


def test_resume_is_deterministic(tmp_path):
    """Interrupted at a heartbeat after a periodic checkpoint, then resumed through
    Word2Vec.resume: the same parameters as the run that was not interrupted, and the
    checkpoint resumes the same way in the JAX package."""
    sents = _corpus(seed=8, n_sent=200)
    knobs = _knobs(negative_pool=8, prefetch_chunks=0, steps_per_dispatch=2)
    vocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, vocab)
    full = TTrainer(TConfig(**knobs), vocab, device="cpu")
    full.fit(enc)
    ref = full.unpadded_params().syn0.numpy()

    ckpt = str(tmp_path / "ck")
    part = TTrainer(TConfig(**knobs).replace(heartbeat_every_steps=6), vocab,
                    device="cpu")
    calls = {"n": 0}

    def boom(_rec):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        part.fit(enc, checkpoint_path=ckpt, checkpoint_every_steps=6, on_heartbeat=boom)
    from glint_word2vec_torch.train.checkpoint import load_model_header
    st = load_model_header(ckpt)["train_state"]
    assert not st.finished and st.batches_done > 0 and st.shard_feed == "tokens"
    assert st.shard_progress == [[st.iteration, st.batches_done]]
    resumed = TWord2Vec.resume(ckpt, sents, device="cpu")
    np.testing.assert_array_equal(resumed.syn0.numpy(), ref)

    from glint_word2vec_tpu.models.estimator import Word2Vec as JWord2Vec
    jres = JWord2Vec.resume(ckpt, sents)
    np.testing.assert_allclose(np.asarray(jres.syn0)[:, :64], ref, atol=PARAM_ATOL,
                               rtol=0)


def test_per_segment_positions_are_refused(tmp_path):
    """A checkpoint that carries only per-segment positions resumes through the
    per-segment fast-forward (a mesh's token feed writes them); positions past the
    corpus's stream are refused with the JAX trainer's message, and within it the fit
    resumes from them."""
    sents = _corpus(seed=9, n_sent=40)
    vocab = t_build_vocab(sents, 1)
    from glint_word2vec_torch.train.checkpoint import TrainState
    st = TrainState(iteration=1, words_processed=10, global_step=4, batches_done=0,
                    shard_progress=[[1, 10_000]], shard_feed="tokens")
    tt = TTrainer(TConfig(**_knobs(negative_pool=8)), vocab, train_state=st,
                  device="cpu")
    with pytest.raises(ValueError, match="segment 0 iteration 1 has only .* blocks but "
                                         "the checkpoint recorded 10000"):
        tt.fit(encode_sentences(sents, vocab))
    st = TrainState(iteration=1, words_processed=10, global_step=4, batches_done=0,
                    shard_progress=[[1, 1]], shard_feed="tokens")
    tt = TTrainer(TConfig(**_knobs(negative_pool=8)), vocab, train_state=st,
                  device="cpu")
    tt.fit(encode_sentences(sents, vocab))
    assert tt.state.finished and tt.global_step > 4


@pytest.mark.parametrize("kw", [
    {"cbow": True, "negative_pool": 8},
    {"use_pallas": True, "negative_pool": 8},
    {"window": 1},
    {"tokens_per_step": 1 << 21, "window": 5},
], ids=["cbow", "use_pallas", "window1", "2^24"])
def test_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as je:
        JConfig(device_pairgen=True, **kw)
    with pytest.raises(ValueError) as te:
        TConfig(device_pairgen=True, **kw)
    assert str(te.value) == str(je.value)
    # just inside the bound both accept
    if "tokens_per_step" in kw:
        T = ((1 << 24) - 1) // 9
        TConfig(device_pairgen=True, tokens_per_step=T, window=5)
        JConfig(device_pairgen=True, tokens_per_step=T, window=5)


def test_device_pairgen_is_accepted_and_tokens_per_step_sized_as_jax():
    sents = _corpus(n_sent=20)
    for kw in ({}, {"window": 3, "pairs_per_batch": 8192}, {"tokens_per_step": 777}):
        knobs = _knobs(negative_pool=8, **kw)
        tt = TTrainer(TConfig(**knobs), t_build_vocab(sents, 1), device="cpu")
        jt = JTrainer(JConfig(**knobs), j_build_vocab(sents, 1))
        assert tt._tokens_per_step == jt._tokens_per_step
        np.testing.assert_array_equal(tt._keep_prob_dev.numpy(),
                                      np.asarray(jt._keep_prob_dev))
