"""The port's CBOW feed and in-place CBOW steps against the JAX package's.

The feed must be integer-identical (centers, contexts, n_ctx, mask, words_seen). The
steps run at f32 from the same inputs; tolerance atol 1e-5 on parameters and rtol 1e-5
on the loss: the two packages reassociate the f32 context means, the logit products
and the duplicate-row scatter sums differently, and the hottest Zipf row here takes
~150 summed updates of magnitude ~0.3, which reordering moves by up to
150 · 0.3 · 2^-24 ≈ 3e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import interop
from glint_word2vec_torch.data import pipeline as tp
from glint_word2vec_torch.data import vocab as tv
from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_tpu.data import pipeline as jp
from glint_word2vec_tpu.data import vocab as jv
from glint_word2vec_tpu.ops import sgns as jsgns


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


ATOL = 1e-5
LOSS_RTOL = 1e-5
N_NEG = 5


def _inputs(seed, Dreal=128, V=1024, D=128, B=512, window=3, P=64, masked=29,
            per_example=True):
    """Zipf-duplicated centers, contexts and negatives, left-packed context windows of
    random length (some empty: has_ctx = 0), negatives equal to their center, a masked
    tail. Params are big enough that logits pass +-6."""
    rng = np.random.default_rng(seed)
    C = 2 * window
    syn0 = np.zeros((V, D), np.float32)
    syn1 = np.zeros((V, D), np.float32)
    syn0[:, :Dreal] = rng.normal(0, 0.5, (V, Dreal))
    syn1[:, :Dreal] = rng.normal(0, 0.5, (V, Dreal))
    centers = (rng.zipf(1.3, B) - 1) % V
    nctx = rng.integers(0, C + 1, B)
    nctx[:25] = 0                                     # rows with no context
    contexts = np.where(np.arange(C)[None, :] < nctx[:, None],
                        (rng.zipf(1.3, (B, C)) - 1) % V, 0)
    ctx_mask = (np.arange(C)[None, :] < nctx[:, None]).astype(np.float32)
    if per_example:
        negatives = (rng.zipf(1.3, (B, N_NEG)) - 1) % V
        negatives[30:70, 1] = centers[30:70]
    else:
        negatives = (rng.zipf(1.3, P) - 1) % V
        negatives[:8] = centers[30:38]
    mask = np.ones(B, np.float32)
    mask[-masked:] = 0.0
    centers[-masked:] = 0
    contexts[-masked:] = 0
    ctx_mask[-masked:] = 0.0
    return (syn0, syn1, centers.astype(np.int32), contexts.astype(np.int32), ctx_mask,
            mask, negatives.astype(np.int32))


def _torch_args(inp):
    syn0, syn1, c, ctx, cm, m, neg = inp
    return (interop.params_from_numpy(syn0, syn1, device="cpu"), torch.from_numpy(c).long(),
            torch.from_numpy(ctx).long(), torch.from_numpy(cm), torch.from_numpy(m),
            torch.from_numpy(neg).long())


def _jax_args(inp):
    syn0, syn1, c, ctx, cm, m, neg = inp
    return (jsgns.EmbeddingPair(jnp.asarray(syn0), jnp.asarray(syn1)), jnp.asarray(c),
            jnp.asarray(ctx), jnp.asarray(cm), jnp.asarray(m), jnp.asarray(neg))


def _check(params, tm, jparams, jm, with_metrics, inp, Dreal):
    np.testing.assert_allclose(params.syn0.numpy(), np.asarray(jparams.syn0),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(params.syn1.numpy(), np.asarray(jparams.syn1),
                               atol=ATOL, rtol=0)
    assert float(tm.pairs) == float(jm.pairs)
    if with_metrics:
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm.mean_f_pos), float(jm.mean_f_pos),
                                   rtol=LOSS_RTOL, atol=1e-6)
    else:
        assert float(tm.loss) == 0.0 and float(tm.mean_f_pos) == 0.0
    assert not params.syn0[:, Dreal:].any() and not params.syn1[:, Dreal:].any()
    assert np.abs(params.syn0.numpy() - inp[0]).max() > 1e-3  # contexts moved


@pytest.mark.parametrize("mode", ["exact", "clipped"])
@pytest.mark.parametrize("Dreal", [128, 100])
def test_cbow_step_core_matches_jax(mode, Dreal):
    inp = _inputs(seed=Dreal, Dreal=Dreal)
    jparams, jm = jsgns.cbow_step_core(*_jax_args(inp), jnp.float32(0.025), mode)
    params, *rest = _torch_args(inp)
    tm = tsgns.cbow_step_core(params, *rest, 0.025, mode)
    # the has_ctx = 0 rows and the masked tail (whose ctx_mask is zero) are not pairs
    assert float(tm.pairs) == float((inp[4].sum(1) > 0).sum())
    _check(params, tm, jparams, jm, True, inp, Dreal)


@pytest.mark.parametrize("mode", ["exact", "clipped"])
@pytest.mark.parametrize("with_metrics", [True, False])
@pytest.mark.parametrize("Dreal", [128, 100])
def test_cbow_step_shared_core_matches_jax(mode, with_metrics, Dreal):
    inp = _inputs(seed=Dreal + 7, Dreal=Dreal, per_example=False)
    jparams, jm = jsgns.cbow_step_shared_core(
        *_jax_args(inp), jnp.float32(0.025), N_NEG, mode, with_metrics=with_metrics)
    params, *rest = _torch_args(inp)
    tm = tsgns.cbow_step_shared_core(params, *rest, 0.025, N_NEG, mode, with_metrics)
    _check(params, tm, jparams, jm, with_metrics, inp, Dreal)


def test_cbow_rows_without_context_train_nothing():
    """An example with no context (or masked) leaves its center's syn1 row and its
    negatives' rows as they were, in both packages."""
    inp = list(_inputs(seed=5))
    inp[3] = np.zeros_like(inp[3])           # no context anywhere
    inp[4] = np.zeros_like(inp[4])
    params, *rest = _torch_args(inp)
    tm = tsgns.cbow_step_core(params, *rest, 0.025)
    assert float(tm.pairs) == 0.0 and float(tm.loss) == 0.0
    assert np.array_equal(params.syn0.numpy(), inp[0])
    assert np.array_equal(params.syn1.numpy(), inp[1])


def _corpus(seed=3, n_sent=300, n_words=500, max_len=40):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    p /= p.sum()
    return [[words[j] for j in rng.choice(n_words, size=rng.integers(1, max_len), p=p)]
            for _ in range(n_sent)]


@pytest.mark.parametrize("shuffle,legacy,ratio,block_words,batch,window", [
    (True, True, 1e-3, 1_000_000, 256, 5),   # default feed, masked tail
    (False, True, 0.0, 97, 128, 3),          # many slabs, no subsampling
    (True, False, 1e-2, 500, 300, 4),        # symmetric window, odd batch
])
def test_cbow_stream_identical(shuffle, legacy, ratio, block_words, batch, window):
    sents = _corpus()
    vocab_j = jv.build_vocab(sents, 1)
    vocab_t = tv.build_vocab(sents, 1)
    enc = jp.encode_sentences(sents, vocab_j)
    common = dict(pairs_per_batch=batch, window=window, subsample_ratio=ratio, seed=11,
                  iteration=2, shuffle=shuffle, legacy_asymmetric_window=legacy,
                  block_words=block_words)
    bj = list(jp.epoch_batches_cbow(enc, vocab_j, **common))
    bt = list(tp.epoch_batches_cbow(enc, vocab_t, **common))
    assert len(bj) == len(bt) > 2
    for x, y in zip(bj, bt):
        np.testing.assert_array_equal(x.centers, y.centers)
        np.testing.assert_array_equal(x.contexts, y.contexts)
        np.testing.assert_array_equal(x.n_ctx, y.n_ctx)
        np.testing.assert_array_equal(x.mask, y.mask)
        np.testing.assert_array_equal(x.ctx_mask, y.ctx_mask)
        assert (x.words_seen, x.num_real) == (y.words_seen, y.num_real)
    assert bt[-1].num_real < batch and bt[-1].mask[bt[-1].num_real:].sum() == 0
    assert (bt[0].n_ctx > 0).all() and bt[0].n_ctx.max() <= 2 * window


@pytest.mark.parametrize("legacy", [True, False])
def test_dynamic_window_cbow_identical(legacy):
    sent = np.arange(17, dtype=np.int32) * 3
    a = jp.dynamic_window_cbow(sent, 4, np.random.default_rng(9), legacy)
    b = tp.dynamic_window_cbow(sent, 4, np.random.default_rng(9), legacy)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
