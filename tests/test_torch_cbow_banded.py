"""The port's banded CBOW (``ops/cbow_banded.py``, ``ops/pairgen.device_cbow_windows``,
``data/pipeline.pack_halo_token_blocks`` and the trainer's halo feed) against the JAX
package's, and against the port's own scatter CBOW step.

Integer outputs (blocks, window extents) are held bit for bit. The port's float64 step
(torch with a float64 ``index_add_`` as the scatter) equals the port's scatter CBOW step
to 1e-12, where a dropped or doubled context link or an off-by-one interval end is far
above the tolerance (tests/test_torch_stabilizers.py holds both to NumPy float64
oracles). Against the JAX step under ``jax.enable_x64(True)`` the tolerance is
``JAX_F64_ATOL``: the JAX step rounds f_pos to float32 and takes its sigmoid there even
in float64 (``.astype(jnp.float32)``), and XLA's and torch's float32 sigmoids differ by
one ulp on ~0.4% of inputs, so the two meet only to float32 rounding of the positive
coefficient. Float32 steps to atol 1e-5 (the packages reassociate the prefix sums and
the products). Fits: equal steps, examples and state, parameters within 1e-5, as in
tests/test_torch_device_feed.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import Word2Vec as TWord2Vec
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data import pipeline as tpipe
from glint_word2vec_torch.data.hashrng import (
    STREAM_SUBSAMPLE, STREAM_WINDOW, hash_u01_at, stream_base)
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.ops import cbow_banded as tband
from glint_word2vec_torch.ops import pairgen as tpg
from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_torch.ops.scatter import scatter_add_rows_reference
from glint_word2vec_torch.train import trainer as ttrainer
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data import pipeline as jpipe
from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
from glint_word2vec_tpu.ops import cbow_banded as jband
from glint_word2vec_tpu.ops import pairgen as jpg
from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair
from glint_word2vec_tpu.train.trainer import Trainer as JTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


SEED, IT, SHARD = 7, 1, 0
F64_TOL = 1e-12
# the JAX float64 step's float32 f_pos (module docstring); the JAX suite holds its own
# step to its float64 oracle at this tolerance (tests/test_stabilizers.py)
JAX_F64_ATOL = 3e-8
F32_ATOL = 1e-5
PARAM_ATOL = 1e-5


def _kept_stream(rng, vocab, n_sentences, max_len, subsample=0.0):
    """A random corpus reduced to its kept-token stream as the trainer's packer does it:
    hash subsampling on raw ordinals, start flags on the kept stream."""
    lens = rng.integers(1, max_len, n_sentences)
    toks = rng.integers(0, vocab, lens.sum()).astype(np.int32)
    sids = np.repeat(np.arange(n_sentences), lens)
    if subsample > 0:
        keep = np.minimum(0.2 + 0.8 * rng.random(vocab), 1.0).astype(np.float32)
        u = hash_u01_at(stream_base(SEED, STREAM_SUBSAMPLE, IT, SHARD),
                        np.arange(toks.shape[0], dtype=np.uint64))
        m = u <= keep[toks]
        toks, sids = toks[m], sids[m]
    starts = np.empty(toks.shape[0], bool)
    if toks.shape[0]:
        starts[0] = True
        starts[1:] = sids[1:] != sids[:-1]
    return toks, starts


def _host_windows(ktoks, starts, window):
    """(left, right) of every kept position, from the host feed's window draw on the
    kept stream (keep 1, kept ordinals): what the device derivation must equal."""
    lens = np.diff(np.concatenate([np.flatnonzero(starts), [ktoks.shape[0]]]))
    toks2, left, total, _ = tpipe._subsample_and_window(
        ktoks, lens.astype(np.int64), np.ones(int(ktoks.max()) + 1, np.float32), window,
        SEED, IT, SHARD, 0, True)
    np.testing.assert_array_equal(toks2, ktoks)
    return left.astype(np.int64), (total - left).astype(np.int64)


def _win_base():
    return int(stream_base(SEED, STREAM_WINDOW, IT, SHARD))


def _blocks(ktoks, starts, T, W):
    """The port's halo blocks and, per block, the port's window geometry."""
    out = []
    for tb, bits, nv, ob, nc in tpipe.pack_halo_token_blocks([(ktoks, starts)], T, W):
        band = tpg.device_cbow_windows(
            torch.from_numpy(tb).long(), torch.from_numpy(bits), nv, ob & 0xFFFFFFFF,
            ob >> 32, _win_base(), W, W)
        out.append((torch.from_numpy(tb).long(), band, nc))
    return out


def _params(rng, V, D, dtype):
    return (rng.normal(0, 0.1, (V, D)).astype(dtype),
            rng.normal(0, 0.05, (V, D)).astype(dtype))


def _tpair(syn0, syn1):
    return tsgns.EmbeddingPair(torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy()))


def _scatter_cbow(params, ktoks, left, right, sel, negatives, alpha, n, W):
    """The port's scatter CBOW step over the stream positions ``sel`` (float64
    index_add_ as its scatter)."""
    C = 2 * W
    ctx = np.zeros((len(sel), C), np.int64)
    ctxm = np.zeros((len(sel), C))
    for i, b in enumerate(sel):
        idx = list(range(b - left[b], b)) + list(range(b + 1, b + right[b] + 1))
        ctx[i, :len(idx)] = ktoks[idx]
        ctxm[i, :len(idx)] = 1.0
    dt = params.syn0.dtype
    return tsgns.cbow_step_shared_core(
        params, torch.from_numpy(ktoks[sel].astype(np.int64)), torch.from_numpy(ctx),
        torch.from_numpy(ctxm).to(dt), torch.ones(len(sel), dtype=dt), negatives, alpha,
        n, "exact", True, scatter_add_rows_reference)


# -- building blocks ------------------------------------------------------------------


@pytest.mark.parametrize("T,D", [(1, 3), (127, 8), (128, 8), (300, 7), (1000, 5)])
def test_cumsum_rows_matches_jax_and_numpy(T, D):
    x = np.random.default_rng(T).normal(size=(T, D))
    want = np.cumsum(x, axis=0)
    got = tband.cumsum_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    x32 = x.astype(np.float32)
    np.testing.assert_allclose(tband.cumsum_rows(torch.from_numpy(x32)).numpy(),
                               np.asarray(jband.cumsum_rows(jnp.asarray(x32))),
                               rtol=1e-5, atol=1e-5)
    for chunk in (1, 7, 64, 128, 2000):   # the card's two-level form
        np.testing.assert_allclose(
            tband._cumsum_rows_chunked(torch.from_numpy(x), chunk).numpy(), want,
            rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("subsample", [0.0, 0.5])
@pytest.mark.parametrize("T,H,slab", [(20, 4, 1000), (20, 4, 7), (33, 5, 13), (12, 5, 3)])
def test_halo_blocks_match_jax_and_cover_every_token_once(subsample, T, H, slab):
    """Bit-identical to the JAX packer when the stream comes in many slabs, every kept
    token a core slot of exactly one block, ordinal bases H before each core."""
    ktoks, starts = _kept_stream(np.random.default_rng(T + H), 50, 40, 14, subsample)
    slabs = [(ktoks[i:i + slab], starts[i:i + slab])
             for i in range(0, ktoks.shape[0], slab)]
    got = list(tpipe.pack_halo_token_blocks(iter(slabs), T, H))
    want = list(jpipe.pack_halo_token_blocks(iter(slabs), T, H, np.int32))
    assert len(got) == len(want) > 2
    covered = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]
        tb, _, nv, ob, nc = g
        np.testing.assert_array_equal(tb[H:H + nc], ktoks[covered:covered + nc])
        assert nc <= T - 2 * H and nv <= T
        assert ob == (covered - H) & 0xFFFFFFFFFFFFFFFF
        covered += nc
    assert covered == ktoks.shape[0]


def test_halo_blocks_edges():
    """A stream shorter than one block still emits its cores; an empty one nothing;
    bad geometry is refused as in the JAX package."""
    ktoks, starts = _kept_stream(np.random.default_rng(1), 50, 5, 12)
    short = list(tpipe.pack_halo_token_blocks([(ktoks[:3], starts[:3])], 20, 4))
    assert sum(b[4] for b in short) == 3 and len(short) == 1
    assert list(tpipe.pack_halo_token_blocks([], 20, 4)) == []
    for T, H in ((8, 4), (20, 0)):
        with pytest.raises(ValueError):
            list(tpipe.pack_halo_token_blocks([(ktoks, starts)], T, H))


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("W,T", [(4, 21), (3, 40), (6, 13)])
def test_device_windows_bit_identical_to_jax(W, T, legacy):
    """Every block's (left, right, center, token), block 0's wrapped −halo base
    included, against the JAX function; the [K, T] batch against K single calls."""
    ktoks, starts = _kept_stream(np.random.default_rng(W * T), 60, 40, 14)
    blocks = list(tpipe.pack_halo_token_blocks([(ktoks, starts)], T, W))
    assert blocks[0][3] >> 32 == 0xFFFFFFFF   # the wrapped base of block 0
    wb = _win_base()
    rows = []
    for tb, bits, nv, ob, _ in blocks:
        jb = jpg.device_cbow_windows(
            jnp.asarray(tb), jnp.asarray(bits), jnp.int32(nv),
            jnp.uint32(ob & 0xFFFFFFFF), jnp.uint32(ob >> 32), jnp.uint32(wb),
            window=W, halo=W, legacy_asymmetric_window=legacy)
        tb_ = tpg.device_cbow_windows(
            torch.from_numpy(tb).long(), torch.from_numpy(bits), nv, ob & 0xFFFFFFFF,
            ob >> 32, wb, W, W, legacy)
        for name, a, b in zip(tb_._fields, tb_, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        rows.append(tb_)
    K = len(blocks)
    batched = tpg.device_cbow_windows(
        torch.from_numpy(np.stack([b[0] for b in blocks])).long(),
        torch.from_numpy(np.stack([b[1] for b in blocks])),
        torch.tensor([b[2] for b in blocks]),
        torch.tensor([b[3] & 0xFFFFFFFF for b in blocks]),
        torch.tensor([b[3] >> 32 for b in blocks]), wb, W, W, legacy)
    for k in range(K):
        for a, b in zip(batched, rows[k]):
            assert torch.equal(a[k], b)


def test_device_windows_match_host_across_blocks():
    """The core slots' extents, windows crossing the cuts into the halo included,
    equal the host feed's sentence-clamped extents on the whole kept stream."""
    W = 4
    ktoks, starts = _kept_stream(np.random.default_rng(2), 60, 40, 14)
    left_h, right_h = _host_windows(ktoks, starts, W)
    covered = 0
    for _, band, nc in _blocks(ktoks, starts, 3 * W + 9, W):
        core = slice(W, W + nc)
        np.testing.assert_array_equal(band.left[core].numpy(),
                                      left_h[covered:covered + nc])
        np.testing.assert_array_equal(band.right[core].numpy(),
                                      right_h[covered:covered + nc])
        assert band.center[core].all() and band.center[:W].sum() == 0
        assert band.center[W + nc:].sum() == 0
        covered += nc
    assert covered == ktoks.shape[0]


# -- the step -------------------------------------------------------------------------


def _band_case(seed, V=120, D=16, P=32, W=3, subsample=0.0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    ktoks, starts = _kept_stream(rng, V, 40, 15, subsample)
    syn0, syn1 = _params(rng, V, D, dtype)
    negs = rng.integers(0, V, P)
    return ktoks, starts, syn0, syn1, negs


def _jax_banded(syn0, syn1, tb, band, negs, alpha, n, W, dtype, **kw):
    p, m = jband.cbow_step_banded_core(
        JPair(jnp.asarray(syn0), jnp.asarray(syn1)), jnp.asarray(tb.numpy(), jnp.int32),
        jnp.asarray(band.left.numpy(), jnp.int32),
        jnp.asarray(band.right.numpy(), jnp.int32), jnp.asarray(band.center.numpy()),
        jnp.asarray(band.token.numpy()), jnp.asarray(negs, jnp.int32),
        jnp.asarray(alpha, dtype), n, W, "exact", dtype, dtype, **kw)
    return np.asarray(p.syn0), np.asarray(p.syn1), m


@pytest.mark.parametrize("with_metrics", [True, False])
@pytest.mark.parametrize("subsample", [0.0, 0.3])
@pytest.mark.parametrize("mode", ["exact", "clipped"])
def test_banded_step_matches_jax_float64(subsample, with_metrics, mode):
    ktoks, starts, syn0, syn1, negs = _band_case(3, subsample=subsample)
    W, n, alpha = 3, 4, 0.05
    ((tb, band, _),) = _blocks(ktoks, starts, ktoks.shape[0] + 2 * W + 5, W)
    with jax.enable_x64(True):
        jp, jm = jband.cbow_step_banded_core(
            JPair(jnp.asarray(syn0), jnp.asarray(syn1)), jnp.asarray(tb.numpy()),
            jnp.asarray(band.left.numpy()), jnp.asarray(band.right.numpy()),
            jnp.asarray(band.center.numpy(), jnp.float64),
            jnp.asarray(band.token.numpy(), jnp.float64), jnp.asarray(negs),
            jnp.float64(alpha), n, W, mode, jnp.float64, jnp.float64, with_metrics)
        j0, j1 = np.asarray(jp.syn0), np.asarray(jp.syn1)
        jloss, jpairs = float(jm.loss), float(jm.pairs)
    params = _tpair(syn0, syn1)
    tm = tband.cbow_step_banded_core(
        params, tb, band.left, band.right, band.center.double(), band.token.double(),
        torch.from_numpy(negs), alpha, n, W, mode, with_metrics,
        scatter_add_rows_reference)
    np.testing.assert_allclose(params.syn0.numpy(), j0, rtol=0, atol=JAX_F64_ATOL)
    np.testing.assert_allclose(params.syn1.numpy(), j1, rtol=0, atol=JAX_F64_ATOL)
    assert float(tm.pairs) == jpairs > 20
    np.testing.assert_allclose(float(tm.loss), jloss, rtol=1e-6, atol=0)
    assert np.abs(params.syn0.numpy() - syn0).max() > 1e-4


@pytest.mark.parametrize("subsample", [0.0, 0.3])
def test_banded_step_matches_jax_float32(subsample):
    ktoks, starts, syn0, syn1, negs = _band_case(4, subsample=subsample,
                                                 dtype=np.float32)
    W, n, alpha = 3, 4, 0.05
    ((tb, band, _),) = _blocks(ktoks, starts, ktoks.shape[0] + 2 * W + 5, W)
    j0, j1, jm = _jax_banded(syn0, syn1, tb, band, negs, alpha, n, W, jnp.float32)
    params = _tpair(syn0, syn1)
    tm = tband.cbow_step_banded_core(params, tb, band.left, band.right, band.center,
                                     band.token, torch.from_numpy(negs), alpha, n, W)
    np.testing.assert_allclose(params.syn0.numpy(), j0, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(params.syn1.numpy(), j1, rtol=0, atol=F32_ATOL)
    assert float(tm.pairs) == float(jm.pairs)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)


@pytest.mark.parametrize("subsample", [0.0, 0.3])
def test_banded_equals_port_scatter_cbow_float64(subsample):
    """Single block (sentences and a padded tail in one step), then sequential blocks
    whose windows cross every cut: the banded step equals the port's scatter CBOW step
    on the same examples to 1e-12."""
    ktoks, starts, syn0, syn1, negs = _band_case(3, subsample=subsample)
    W, n, alpha = 3, 4, 0.05
    negs_t = torch.from_numpy(negs)
    left_h, right_h = _host_windows(ktoks, starts, W)
    live = np.flatnonzero(left_h + right_h > 0)
    assert live.size > 20
    ((tb, band, _),) = _blocks(ktoks, starts, ktoks.shape[0] + 2 * W + 5, W)
    p_band = _tpair(syn0, syn1)
    m_band = tband.cbow_step_banded_core(
        p_band, tb, band.left, band.right, band.center.double(), band.token.double(),
        negs_t, alpha, n, W, "exact", True, scatter_add_rows_reference)
    p_ref = _tpair(syn0, syn1)
    m_ref = _scatter_cbow(p_ref, ktoks, left_h, right_h, live, negs_t, alpha, n, W)
    for a, b in zip(p_band, p_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(float(m_band.loss), float(m_ref.loss), rtol=1e-12)
    assert float(m_band.pairs) == float(m_ref.pairs) == live.size

    p_cur, p_refc, covered = _tpair(syn0, syn1), _tpair(syn0, syn1), 0
    blocks = _blocks(ktoks, starts, 4 * W + 6, W)
    assert len(blocks) > 5
    for tb, band, nc in blocks:
        tband.cbow_step_banded_core(
            p_cur, tb, band.left, band.right, band.center.double(), band.token.double(),
            negs_t, alpha, n, W, "exact", True, scatter_add_rows_reference)
        sel = live[(live >= covered) & (live < covered + nc)]
        covered += nc
        if sel.size:
            _scatter_cbow(p_refc, ktoks, left_h, right_h, sel, negs_t, alpha, n, W)
    for a, b in zip(p_cur, p_refc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5 * F64_TOL)


@pytest.mark.parametrize("W", [2, 3, 5, 17])
def test_endpoint_forms_equal_float64(W):
    """The shifted adds and the 2T-row scatter give the same difference array (the
    scatter form with and without skipping dead rows), and the step the same update
    through either."""
    ktoks, starts, syn0, syn1, negs = _band_case(W, V=100, D=8, P=16, W=W)
    ((tb, band, _),) = _blocks(ktoks, starts, ktoks.shape[0] + 2 * W + 1, W)
    g = torch.from_numpy(np.random.default_rng(W).normal(size=(tb.shape[0], 8)))
    live = band.center * ((band.left + band.right) > 0).double()
    g = g * live[:, None]
    shift = tband._band_endpoint_delta(g, band.left, band.right, W, "shift")
    scat = tband._band_endpoint_delta(g, band.left, band.right, W, "scatter",
                                      scatter_add_rows_reference)
    scat_live = tband._band_endpoint_delta(g, band.left, band.right, W, "scatter",
                                           lambda m, i, u, lv: m.index_add_(
                                               0, i[lv > 0], u[lv > 0]), live)
    np.testing.assert_allclose(shift.numpy(), scat.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(scat_live.numpy(), scat.numpy(), rtol=0, atol=1e-13)
    out = []
    for form in ("shift", "scatter"):
        p = _tpair(syn0, syn1)
        tband.cbow_step_banded_core(
            p, tb, band.left, band.right, band.center.double(), band.token.double(),
            torch.from_numpy(negs), 0.05, 3, W, "exact", True, scatter_add_rows_reference,
            endpoint=form)
        out.append(p)
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=F64_TOL)
    with pytest.raises(ValueError, match="endpoint"):
        tband.cbow_step_banded_core(out[0], tb, band.left, band.right, band.center,
                                    band.token, torch.from_numpy(negs), 0.05, 3, W,
                                    endpoint="bogus")


@pytest.mark.parametrize("endpoint", ["auto", "scatter"])
def test_banded_metrics_elided_twin_bit_identical(endpoint):
    ktoks, starts, syn0, syn1, negs = _band_case(5, V=80, D=8, P=16, dtype=np.float32)
    W = 3
    ((tb, band, _),) = _blocks(ktoks, starts, ktoks.shape[0] + 2 * W + 3, W)
    runs = []
    for wm in (True, False):
        p = _tpair(syn0, syn1)
        m = tband.cbow_step_banded_core(p, tb, band.left, band.right, band.center,
                                        band.token, torch.from_numpy(negs), 0.05, 3, W,
                                        "exact", wm, endpoint=endpoint)
        runs.append((p, m))
    (pf, mf), (pq, mq) = runs
    assert torch.equal(pf.syn0, pq.syn0) and torch.equal(pf.syn1, pq.syn1)
    assert float(mq.loss) == 0.0 and float(mq.mean_f_pos) == 0.0
    assert float(mq.pairs) == float(mf.pairs) > 0


def test_banded_padded_block_is_a_noop():
    """An all-padding block (n_valid 0) leaves the parameters bit for bit, with the
    stabilizers on too."""
    _, _, syn0, syn1, negs = _band_case(6, dtype=np.float32)
    T, W = 30, 3
    band = tpg.device_cbow_windows(torch.zeros(T, dtype=torch.int64),
                                   torch.zeros(4, dtype=torch.uint8), 0, 0, 0,
                                   _win_base(), W, W)
    for stab in (None, tsgns.Stabilizers(max_row_norm=0.01, update_clip=0.01,
                                         row_l2=0.5)):
        p = _tpair(syn0, syn1)
        m = tband.cbow_step_banded_core(p, torch.zeros(T, dtype=torch.int64), band.left,
                                        band.right, band.center, band.token,
                                        torch.from_numpy(negs), 0.05, 3, W,
                                        stabilizers=stab)
        assert np.array_equal(p.syn0.numpy(), syn0)
        assert np.array_equal(p.syn1.numpy(), syn1)
        assert float(m.pairs) == 0.0


# -- the trainer ----------------------------------------------------------------------


def _corpus(seed=4, n_words=300, n_sent=160, length=20):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    return [[words[j] for j in rng.choice(n_words, size=length, p=p)]
            for _ in range(n_sent)]


def _knobs(**kw):
    base = dict(vector_size=64, pairs_per_batch=256, window=3, steps_per_dispatch=4,
                heartbeat_every_steps=3, num_iterations=2, subsample_ratio=1e-3,
                allow_unstable=True, learning_rate=0.025, seed=7, min_count=1,
                cbow=True, cbow_update="banded", negative_pool=16)
    base.update(kw)
    return base


def _init(V, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.005, 0.005, (V, D)).astype(np.float32),
            rng.normal(0, 0.01, (V, D)).astype(np.float32))


def _fit_pair(knobs, sents, seed=0):
    tvocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, tvocab)
    syn0, syn1 = _init(tvocab.size, knobs["vector_size"], seed)
    jt = JTrainer(JConfig(**knobs), j_build_vocab(sents, 1),
                  params=JPair(jnp.asarray(syn0), jnp.asarray(syn1)))
    jt.fit(enc)
    tt = TTrainer(TConfig(**knobs), tvocab, params=(syn0, syn1), device="cpu")
    tt.fit(enc)
    return jt, tt, syn0


def _check_fits(jt, tt, syn0):
    assert tt.feed_backend == "device"
    assert tt._tokens_per_step == jt._tokens_per_step
    assert tt.global_step == jt.global_step >= 8
    assert tt.pairs_trained == jt.pairs_trained > 0
    assert tt.dropped_pairs == 0
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


@pytest.mark.parametrize("extra", [
    {},
    {"subsample_ratio": 0.0, "window": 5},
    {"pairs_per_batch": 100, "negative_pool": 8, "shuffle": False},
    {"max_row_norm": 0.05, "update_clip": 0.01, "row_l2": 1e-2},
], ids=["default", "window5-nosub", "small-blocks", "stabilizers"])
def test_banded_fit_matches_jax(extra):
    jt, tt, syn0 = _fit_pair(_knobs(**extra), _corpus())
    _check_fits(jt, tt, syn0)


@pytest.mark.parametrize("workers", [1, 4])
def test_halo_seg_blocks_match_jax(workers, monkeypatch):
    """The trainer's halo block stream over several slabs equals the JAX trainer's at
    1 and 4 producer workers."""
    sents = _corpus(seed=3, n_sent=400)
    vocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, vocab)
    orig_j = jpipe.iter_sentence_slabs
    orig_t = ttrainer.iter_sentence_slabs
    monkeypatch.setattr(jpipe, "iter_sentence_slabs",
                        lambda s, o, block_words=0: orig_j(s, o, 700))
    monkeypatch.setattr(ttrainer, "iter_sentence_slabs",
                        lambda s, o, block_words=0: orig_t(s, o, 700))
    knobs = _knobs()
    jt = JTrainer(JConfig(**knobs), j_build_vocab(sents, 1))
    tt = TTrainer(TConfig(**knobs), vocab, device="cpu")
    assert tt._tokens_per_step == 256 + 2 * 3 == jt._tokens_per_step
    for k in (1, 2):
        want = list(jt._device_seg_blocks(enc, k, 0, workers=1))
        got = list(tt._device_seg_blocks(enc, k, workers=workers))
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0].astype(np.int32))
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2:] == w[2:]


def test_banded_resume_is_deterministic(tmp_path):
    """Interrupted at a heartbeat after a periodic checkpoint, then resumed through
    Word2Vec.resume by batches_done: the parameters of the run that was not
    interrupted; the checkpoint resumes in the JAX package too."""
    sents = _corpus(seed=8, n_sent=200)
    knobs = _knobs(prefetch_chunks=0, steps_per_dispatch=2, num_iterations=2)
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
    resumed = TWord2Vec.resume(ckpt, sents, device="cpu")
    np.testing.assert_array_equal(resumed.syn0.numpy(), ref)
    assert resumed.config.cbow_update == "banded"

    from glint_word2vec_tpu.models.estimator import Word2Vec as JWord2Vec
    jres = JWord2Vec.resume(ckpt, sents)
    np.testing.assert_allclose(np.asarray(jres.syn0)[:, :64], ref, atol=PARAM_ATOL,
                               rtol=0)


def test_banded_cross_feed_resume_is_refused(tmp_path):
    """A banded (token-feed) checkpoint does not resume on the scatter CBOW's pair
    feed, with the JAX package's reason."""
    sents = _corpus(seed=9, n_sent=60)
    vocab = t_build_vocab(sents, 1)
    from glint_word2vec_torch.train.checkpoint import TrainState
    st = TrainState(iteration=1, words_processed=10, global_step=4, batches_done=2,
                    shard_progress=[[1, 2]], shard_feed="tokens")
    tt = TTrainer(TConfig(**_knobs(cbow_update="scatter")), vocab, train_state=st,
                  device="cpu")
    with pytest.raises(ValueError, match="cbow_update='banded'"):
        tt.fit(encode_sentences(sents, vocab))


def test_banded_feed_is_the_token_blocks():
    sents = _corpus(n_sent=20)
    vocab = t_build_vocab(sents, 1)
    assert TTrainer(TConfig(**_knobs()), vocab, device="cpu").feed_backend == "device"
    with pytest.raises(ValueError, match="token blocks"):
        TTrainer(TConfig(**_knobs()), vocab, device="cpu", feed_backend="native")


def test_estimator_trains_banded_and_clusters():
    """Word2Vec(cbow=True, cbow_update="banded", device="cpu") through the public
    estimator: two topics of three words each separate."""
    rng = np.random.default_rng(0)
    topics = (["a", "b", "c"], ["x", "y", "z"])
    sents = [[t[j] for j in rng.integers(0, 3, 12)] for _ in range(400)
             for t in topics]
    est = TWord2Vec(vector_size=16, cbow=True, cbow_update="banded", negative_pool=4,
                    pairs_per_batch=128, learning_rate=0.05, window=3, min_count=1,
                    num_iterations=8, subsample_ratio=0.0, seed=1, device="cpu")
    model = est.fit(sents)
    assert est.trainer._banded_cbow and est.trainer.feed_backend == "device"
    v = {w: model.transform(w) for w in "abcxyz"}

    def cos(p, q):
        return float(np.dot(v[p], v[q]) / np.linalg.norm(v[p]) / np.linalg.norm(v[q]))
    within = np.mean([cos("a", "b"), cos("b", "c"), cos("x", "y"), cos("y", "z")])
    across = np.mean([cos("a", "x"), cos("b", "y"), cos("c", "z")])
    assert within > across + 0.3, (within, across)
