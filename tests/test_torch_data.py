"""The port's host data plane against the JAX package's: vocabulary, encoding, keep
probabilities and the pair stream must be integer-identical (the JAX side runs its
numpy pair generator)."""

import numpy as np
import pytest

from glint_word2vec_torch.data import pipeline as tp
from glint_word2vec_torch.data import vocab as tv
from glint_word2vec_tpu.data import pipeline as jp
from glint_word2vec_tpu.data import vocab as jv


def _corpus(seed=0, n_sent=400, n_words=600, max_len=40):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    p /= p.sum()
    return [[words[j] for j in rng.choice(n_words, size=rng.integers(1, max_len), p=p)]
            for _ in range(n_sent)]


@pytest.mark.parametrize("min_count", [1, 3])
def test_vocab_identical(min_count):
    sents = _corpus()
    a = jv.build_vocab(sents, min_count)
    b = tv.build_vocab(sents, min_count)
    assert a.words == b.words
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.train_words_count == b.train_words_count
    assert a.index == b.index


def test_encode_and_keep_identical():
    sents = _corpus(seed=1)
    vocab_j = jv.build_vocab(sents, 2)
    vocab_t = tv.build_vocab(sents, 2)
    ej = jp.encode_sentences(sents, vocab_j, max_sentence_length=7)
    et = tp.encode_sentences(sents, vocab_t, max_sentence_length=7)
    assert len(ej) == len(et)
    for x, y in zip(ej, et):
        np.testing.assert_array_equal(x, y)
    for ratio in (0.0, 1e-3, 1e-2):
        np.testing.assert_array_equal(
            jp.keep_probabilities(vocab_j.counts, vocab_j.train_words_count, ratio),
            tp.keep_probabilities(vocab_t.counts, vocab_t.train_words_count, ratio))
        assert (jp.expected_kept_words(vocab_j.counts, vocab_j.train_words_count, ratio)
                == tp.expected_kept_words(vocab_t.counts, vocab_t.train_words_count,
                                          ratio))


@pytest.mark.parametrize("shuffle,legacy,ratio,block_words,batch", [
    (True, True, 1e-3, 1_000_000, 256),     # default feed, masked tail
    (False, True, 0.0, 97, 128),            # many slabs, no subsampling
    (True, False, 1e-2, 500, 300),          # symmetric window, odd batch
])
def test_pair_stream_identical(shuffle, legacy, ratio, block_words, batch):
    sents = _corpus(seed=2)
    vocab_j = jv.build_vocab(sents, 1)
    vocab_t = tv.build_vocab(sents, 1)
    enc = jp.encode_sentences(sents, vocab_j)
    common = dict(pairs_per_batch=batch, window=5, subsample_ratio=ratio, seed=11,
                  iteration=2, shuffle=shuffle, legacy_asymmetric_window=legacy,
                  block_words=block_words)
    bj = list(jp.epoch_batches(enc, vocab_j, backend="numpy", **common))
    bt = list(tp.epoch_batches(enc, vocab_t, **common))
    assert len(bj) == len(bt) > 2
    for x, y in zip(bj, bt):
        np.testing.assert_array_equal(x.centers, y.centers)
        np.testing.assert_array_equal(x.contexts, y.contexts)
        np.testing.assert_array_equal(x.mask, y.mask)
        assert x.words_seen == y.words_seen
        assert x.num_real_pairs == y.num_real_pairs
    assert bt[-1].num_real_pairs < batch  # the masked tail is covered
    assert bt[-1].mask[bt[-1].num_real_pairs:].sum() == 0


def test_stream_rng_and_slabs_identical():
    order = np.arange(50)
    sents = [np.arange(i % 7 + 1, dtype=np.int32) for i in range(50)]
    a = [[s.tolist() for s in slab] for slab in jp.iter_sentence_slabs(sents, order, 9)]
    b = [[s.tolist() for s in slab] for slab in tp.iter_sentence_slabs(sents, order, 9)]
    assert a == b
    for seed in (0, -5, 2 ** 63 + 3):
        np.testing.assert_array_equal(jp.stream_rng(seed, 3, 1).integers(0, 1 << 30, 8),
                                      tp.stream_rng(seed, 3, 1).integers(0, 1 << 30, 8))
