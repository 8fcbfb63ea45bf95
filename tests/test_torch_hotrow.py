"""Cross-step hot rows (``hot_rows`` / ``hot_flush_every``) in the PyTorch port.

The first K rows of each matrix (the most frequent words) take their updates in f32
slabs carried across the steps of a chunk: gathers add the pending deltas back, the
scatters split at K, and ``hot_flush`` adds the slab to the rows. In float64 that is the
classic step up to reassociation, so the port is held to a NumPy float64 oracle at
1e-12, as ``tests/test_fused_hotrow.py`` holds the JAX package's helpers; the trainer
with hot rows to the classic trainer within 2e-6 on every skip-gram feed.
"""

import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


NEG = 3
ALPHA = 0.05
F64 = torch.float64


def _sig(x):
    return 0.5 * (1.0 + np.tanh(0.5 * x))


def _np_shared_step(syn0, syn1, centers, contexts, mask, negs, alpha, n):
    """Plain-NumPy float64 shared-pool step (tests/test_fused_hotrow.py's oracle)."""
    e_in, e_pos, Z = syn0[centers], syn1[contexts], syn1[negs]
    P = negs.shape[0]
    f_pos = (e_in * e_pos).sum(-1)
    f_neg = e_in @ Z.T
    valid = (negs[None, :] != contexts[:, None]) * mask[:, None]
    g_pos = (1.0 - _sig(f_pos)) * alpha * mask
    g_neg = -_sig(f_neg) * alpha * valid * (n / P)
    s0, s1 = syn0.copy(), syn1.copy()
    np.add.at(s0, centers, g_pos[:, None] * e_pos + g_neg @ Z)
    np.add.at(s1, contexts, g_pos[:, None] * e_in)
    np.add.at(s1, negs, g_neg.T @ e_in)
    return s0, s1


def _np_per_pair_step(syn0, syn1, centers, contexts, mask, negs, alpha):
    """Plain-NumPy float64 per-pair step."""
    e_in, e_pos, e_neg = syn0[centers], syn1[contexts], syn1[negs]
    f_pos = (e_in * e_pos).sum(-1)
    f_neg = np.einsum("bd,bnd->bn", e_in, e_neg)
    valid = (negs != contexts[:, None]) * mask[:, None]
    g_pos = (1.0 - _sig(f_pos)) * alpha * mask
    g_neg = -_sig(f_neg) * alpha * valid
    s0, s1 = syn0.copy(), syn1.copy()
    np.add.at(s0, centers, g_pos[:, None] * e_pos + np.einsum("bn,bnd->bd", g_neg, e_neg))
    np.add.at(s1, contexts, g_pos[:, None] * e_in)
    np.add.at(s1, negs.reshape(-1), (g_neg[..., None] * e_in[:, None, :]).reshape(-1, e_in.shape[1]))
    return s0, s1


def _inputs(seed=0, V=60, D=12, B=24, P=8):
    """tests/test_fused_hotrow.py's draw: duplicates on hot rows, a masked tail on real
    rows, a pool entry equal to a context, duplicate pool entries."""
    rng = np.random.default_rng(seed)
    syn0 = rng.normal(0, 0.5, (V, D))
    syn1 = rng.normal(0, 0.5, (V, D))
    centers = rng.integers(0, V, B)
    contexts = rng.integers(0, V, B)
    centers[3] = centers[4] = 2
    contexts[5] = contexts[6] = 1
    mask = (np.arange(B) < B - 4).astype(np.float64)
    centers[B - 1], contexts[B - 1] = 0, 1
    negs = rng.integers(0, V, P)
    negs[0] = contexts[0]
    negs[1] = negs[2]
    return syn0, syn1, centers, contexts, mask, negs


def _index_add(mat, idx, upd, live):
    """The float64 scatter of the tests: live rows only."""
    keep = live != 0
    return mat.index_add_(0, idx[keep], upd[keep])


def _t(*arrays):
    """Tensors of copies: the in-place steps must not write into the inputs."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _slabs(k, d):
    return tsgns.hot_slabs(k, d, F64, "cpu")


def _shared(params, c, x, m, ng, slabs=None):
    return tsgns.sgns_step_shared_scatter_(
        params, c, x, m, ng, ALPHA, NEG, "exact", True, _index_add, hot_slabs=slabs)


def _flush(params, slabs):
    tsgns.hot_flush(params.syn0, slabs[0])
    tsgns.hot_flush(params.syn1, slabs[1])


@pytest.mark.parametrize("k", [3, 4, 16, 60])  # 3: the duplicated center 2; 60: all
def test_hot_single_step_matches_oracle_f64(k):
    """One step into the slabs, then the flush, is the classic step."""
    syn0, syn1, c, x, m, ng = _inputs()
    want0, want1 = _np_shared_step(syn0, syn1, c, x, m, ng, ALPHA, NEG)
    base = tsgns.EmbeddingPair(*_t(syn0, syn1))
    mb = _shared(base, *_t(c, x, m, ng))
    hot = tsgns.EmbeddingPair(*_t(syn0, syn1))
    slabs = _slabs(k, syn0.shape[1])
    mh = _shared(hot, *_t(c, x, m, ng), slabs=slabs)
    assert slabs[0].abs().sum() > 0  # the hot rows really went through the slab
    _flush(hot, slabs)
    np.testing.assert_allclose(hot.syn0.numpy(), want0, atol=1e-12, rtol=0)
    np.testing.assert_allclose(hot.syn1.numpy(), want1, atol=1e-12, rtol=0)
    np.testing.assert_allclose(base.syn0.numpy(), want0, atol=1e-12, rtol=0)
    # the metrics read the delta-corrected gathers: exact
    assert abs(float(mh.loss) - float(mb.loss)) < 1e-12
    assert not slabs[0].any() and not slabs[1].any()  # the flush zeroes the slabs


def test_hot_multi_step_accumulation_matches_stepwise_f64():
    """Four steps with the slabs carried and ONE flush at the end reproduce four
    classic steps: every gather saw its row's pending deltas."""
    syn0, syn1, *_ = _inputs()
    ref0, ref1 = syn0.copy(), syn1.copy()
    hot = tsgns.EmbeddingPair(*_t(syn0, syn1))
    slabs = _slabs(16, syn0.shape[1])
    for step in range(4):
        rng = np.random.default_rng(100 + step)
        c, x, ng = rng.integers(0, 60, 24), rng.integers(0, 60, 24), rng.integers(0, 60, 8)
        m = np.ones(24)
        ref0, ref1 = _np_shared_step(ref0, ref1, c, x, m, ng, ALPHA, NEG)
        _shared(hot, *_t(c, x, m, ng), slabs=slabs)
    _flush(hot, slabs)
    np.testing.assert_allclose(hot.syn0.numpy(), ref0, atol=1e-12, rtol=0)
    np.testing.assert_allclose(hot.syn1.numpy(), ref1, atol=1e-12, rtol=0)


def test_hot_fully_masked_batch_is_noop():
    """A padding batch (mask all zero, index 0 a hot row) leaves parameters and slabs
    exactly as they were, through step and flush."""
    syn0, syn1, c, x, _, ng = _inputs()
    hot = tsgns.EmbeddingPair(*_t(syn0, syn1))
    slabs = _slabs(16, syn0.shape[1])
    _shared(hot, *_t(c, x, np.zeros(c.shape[0]), ng), slabs=slabs)
    # the pool rows take zero-coefficient updates: exact values are required
    assert not slabs[0].any()
    _flush(hot, slabs)
    np.testing.assert_array_equal(hot.syn0.numpy(), syn0)
    np.testing.assert_array_equal(hot.syn1.numpy(), syn1)


@pytest.mark.parametrize("fused", [False, True])
def test_perpair_hot_matches_oracle_f64(fused):
    syn0, syn1, c, x, m, _ = _inputs()
    rng = np.random.default_rng(9)
    pn = rng.integers(0, 60, (c.shape[0], NEG))
    pn[:, 0] = 1                          # hot negatives with duplicates
    want0, want1 = _np_per_pair_step(syn0, syn1, c, x, m, pn, ALPHA)
    hot = tsgns.EmbeddingPair(*_t(syn0, syn1))
    slabs = _slabs(16, syn0.shape[1])
    tsgns.sgns_step_core(hot, *_t(c, x, m, pn), ALPHA, "exact", _index_add,
                         hot_slabs=slabs, fused=fused)
    _flush(hot, slabs)
    np.testing.assert_allclose(hot.syn0.numpy(), want0, atol=1e-12, rtol=0)
    np.testing.assert_allclose(hot.syn1.numpy(), want1, atol=1e-12, rtol=0)


def test_hot_gather_reads_pending_deltas():
    mat = torch.arange(12.0, dtype=F64).reshape(6, 2)
    slab = torch.tensor([[1.0, 2.0], [3.0, 4.0]], dtype=F64)
    got = tsgns.hot_gather(mat, slab, torch.tensor([[1, 5], [0, 1]]), torch.float32)
    want = torch.tensor([[[5.0, 7.0], [10.0, 11.0]], [[1.0, 3.0], [5.0, 7.0]]])
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_hot_flush_rounds_a_bf16_prefix_once():
    """bf16 parameters take an f32 slab; the flush adds it in f32 and rounds once."""
    mat = torch.ones((3, 4), dtype=torch.bfloat16)
    s0, _ = tsgns.hot_slabs(2, 4, torch.bfloat16, "cpu")
    assert s0.dtype == torch.float32
    s0 += 1000 * torch.tensor(1e-3, dtype=torch.bfloat16).float()  # 1000 small updates
    tsgns.hot_flush(mat, s0)
    assert mat[:2].eq(2.0).all() and mat[2].eq(1.0).all() and not s0.any()


# -- the trainer ------------------------------------------------------------------------


def _toy():
    rng = np.random.default_rng(0)
    V = 80
    words = [f"w{i}" for i in range(V)]
    vocab = Vocabulary.from_words_and_counts(
        words, np.sort(rng.integers(5, 100, V))[::-1].copy())
    sents = [[f"w{i}" for i in rng.integers(0, V, 12)] for _ in range(80)]
    return vocab, encode_sentences(sents, vocab, 1000)


def _fit(vocab, enc, **kw):
    cfg = Word2VecConfig(vector_size=16, min_count=1, pairs_per_batch=32,
                         num_iterations=1, window=2, steps_per_dispatch=4,
                         prefetch_chunks=0, seed=3, **kw)
    t = Trainer(cfg, vocab, device="cpu")
    t.fit(enc)
    return t


@pytest.mark.parametrize("feed,pool,extra", [
    ("host", 16, {}), ("host", 16, {"hot_flush_every": 2}), ("device", 16, {}),
    ("host", 0, {}), ("device", 0, {})],
    ids=["shared", "shared-flush2", "shared-devpairs", "per_pair", "per_pair-devpairs"])
def test_trainer_hot_rows_close_to_classic(feed, pool, extra):
    """tests/test_fused_hotrow.py's trainer check: every feed and pool, within 2e-6."""
    vocab, enc = _toy()
    kw = dict(negative_pool=pool, device_pairgen=feed == "device")
    base = _fit(vocab, enc, **kw)
    hot = _fit(vocab, enc, hot_rows=8, **kw, **extra)
    assert hot.global_step == base.global_step > 4
    np.testing.assert_allclose(hot.params.syn0.numpy(), base.params.syn0.numpy(),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(hot.params.syn1.numpy(), base.params.syn1.numpy(),
                               atol=2e-6, rtol=0)
    assert not hot._slabs[0].any() and not hot._slabs[1].any()  # flushed at the end


def test_trainer_hot_rows_clamped_to_vocab():
    vocab, enc = _toy()
    t = _fit(vocab, enc, negative_pool=16, hot_rows=10_000)
    assert t._hot_rows == vocab.size and t._slabs[0].shape[0] == vocab.size
    assert np.isfinite(t.params.syn0.numpy()).all()


def test_trainer_flushes_on_the_configured_cadence(monkeypatch):
    """Four-step chunks with hot_flush_every=2: two flushes per chunk, one at the end
    of a short last chunk; checkpoints and heartbeats see flushed parameters."""
    vocab, enc = _toy()
    calls = []
    orig = Trainer._flush_hot
    monkeypatch.setattr(Trainer, "_flush_hot",
                        lambda self: (calls.append(self.global_step), orig(self)))
    t = _fit(vocab, enc, negative_pool=16, hot_rows=8, hot_flush_every=2)
    steps = t.global_step
    assert len(calls) == steps // 2 + steps % 2


def test_trainer_bf16_hot_rows_fit():
    """bf16 parameters with f32 slabs train (the JAX suite's bf16 smoke fit)."""
    vocab, enc = _toy()
    t = _fit(vocab, enc, negative_pool=16, param_dtype="bfloat16",
             compute_dtype="bfloat16", logits_dtype="bfloat16", fused_logits=True,
             bf16_chain=True, hot_rows=8)
    assert t.params.syn0.dtype == torch.bfloat16 and t._slabs[0].dtype == torch.float32
    s0 = t.params.syn0.float().numpy()
    assert np.isfinite(s0).all() and np.abs(s0).sum() > 0
