"""The trainer's dispatch unit: each chunk as a prologue and a body of K steps, the body
captured as a CUDA graph on the card (train/graphs.py).

On the CPU (no graphs there, the body runs eagerly):

- the prologue + body split, with α a device scalar sliced from the chunk's [K] alphas
  and the masks built from the chunk's real counts on the device, trains bit for bit as
  the per-step loop it replaced (a Python float α per step, the mask from the host's
  count), on every step form, in f32 and bf16, with the stabilizers, duplicate scaling
  and the hot rows, and under a recovery's lr scale;
- padded steps are exact no-ops: a short chunk padded to K trains as its real steps
  alone, and a chunk whose gates (masks, banded center and token slots) are all zero,
  the graphs' warm-up, leaves the parameters and the hot slabs as they were;
- a multi-chunk fit whose chunks end short meets the JAX trainer's fit on the same
  inputs at tests/test_torch_trainer.py's tolerance (atol 1e-5 on parameters, rtol 1e-4
  on the heartbeat losses, which are the JAX trainer's ``loss_k[real - 1]``), eagerly
  and with the padded body the graphs replay;
- the graph key changes at a restore, at a recovery that engages ``max_row_norm`` and
  at a new placement of the parameters;
- the stability advisories fire as in the JAX package, with the same messages.

On the card (``cuda``): a graph fit of each of chip_smoke.py's fits against its eager
control (1e-4 absolute on f32 parameters and 1e-4 relative on the loss; the bf16 fits
by ops/bf16_check.py's limits), the kernels' launches counted through replays, one
replay per chunk, and recaptures after a rollback and a recovery. They run on the card
with ``python -m pytest -m cuda tests/test_torch_graph.py`` (tests/conftest.py loads
there as here).
"""

import importlib.util
import itertools
import logging
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import Vocabulary as TVocabulary
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.ops import bf16_check
from glint_word2vec_torch.ops import scatter as tscatter
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_torch.ops.pairgen import device_cbow_windows
from glint_word2vec_torch.ops.sampler import sample_negatives_hash
from glint_word2vec_torch.train import trainer as ttrainer
from glint_word2vec_torch.train.trainer import Trainer as TTrainer

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", logits_dtype="bfloat16")
# stabilizers that engage at these parameters (rows of norm ~0.4, updates ~1e-3)
STAB = dict(max_row_norm=0.45, update_clip=2e-3, row_l2=1e-2)
BASE = dict(vector_size=16, pairs_per_batch=96, window=3, steps_per_dispatch=4,
            heartbeat_every_steps=1, num_iterations=1, subsample_ratio=1e-3,
            allow_unstable=True, learning_rate=0.05, seed=5, min_count=1,
            prefetch_chunks=0)
FORMS = {
    "shared_fused": dict(negative_pool=16),
    "shared_fused_bf16_chain": dict(negative_pool=16, fused_logits=True, bf16_chain=True,
                                    **BF16),
    "shared_clipped": dict(negative_pool=16, sigmoid_mode="clipped"),
    "shared_scatter_stab": dict(negative_pool=16, **STAB),
    "shared_scatter_dup": dict(negative_pool=16, duplicate_scaling=True),
    "shared_scatter_hot": dict(negative_pool=16, hot_rows=8, hot_flush_every=2),
    "shared_scatter_hot_bf16": dict(negative_pool=16, hot_rows=8, **BF16),
    "shared_devpairs": dict(negative_pool=16, device_pairgen=True),
    "per_pair": dict(negative_pool=0),
    "per_pair_stab_dup": dict(negative_pool=0, duplicate_scaling=True, **STAB),
    "per_pair_hot_bf16": dict(negative_pool=0, hot_rows=8, fused_logits=True, **BF16),
    "per_pair_devpairs": dict(negative_pool=0, device_pairgen=True),
    "cbow_shared": dict(cbow=True, negative_pool=16),
    "cbow_shared_stab_bf16": dict(cbow=True, negative_pool=16, **STAB, **BF16),
    "cbow_per_example": dict(cbow=True, negative_pool=0),
    "cbow_per_example_dup_stab": dict(cbow=True, negative_pool=0,
                                      duplicate_scaling=True, **STAB),
    "cbow_banded": dict(cbow=True, cbow_update="banded", negative_pool=16),
    "cbow_banded_stab": dict(cbow=True, cbow_update="banded", negative_pool=16, **STAB),
    "cbow_banded_bf16": dict(cbow=True, cbow_update="banded", negative_pool=16, **BF16),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors are tiny: one intra-op thread runs them faster than a pool, and a
    pool oversubscribes the cores when pytest runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sents(seed=3, n_words=120, n_sent=160, length=16):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    return [[words[j] for j in rng.choice(n_words, size=length, p=p)]
            for _ in range(n_sent)]


def _trainers(knobs, n=2, sents=None):
    """``n`` CPU trainers of one config from the same injected parameters (N(0, 0.1),
    float32 from a numpy seed), armed as ``fit`` arms them, and the encoded corpus."""
    sents = sents or _sents()
    vocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, vocab)
    rng = np.random.default_rng(11)
    syn0 = rng.normal(0, 0.1, (vocab.size, BASE["vector_size"])).astype(np.float32)
    syn1 = rng.normal(0, 0.1, (vocab.size, BASE["vector_size"])).astype(np.float32)
    cfg = TConfig(**{**BASE, **knobs})
    out = []
    for _ in range(n):
        t = TTrainer(cfg, vocab, params=(syn0, syn1), device="cpu")
        t._last_log_step = t.global_step
        t._exact_pairs = torch.zeros((), dtype=torch.int64)
        t._dropped = torch.zeros((), dtype=torch.int64)
        out.append(t)
    return out, enc


def _chunks(t, enc, n=2):
    """The first ``n`` chunks of the trainer's feed (the token-block feed on the device
    feed and banded CBOW)."""
    total = float(sum(s.shape[0] for s in enc)) + 1.0
    stream = (t._token_chunk_stream if t.feed_backend == "device" else t._chunk_stream)
    return list(itertools.islice(stream(enc, total, total), n))


def _reference_chunk(t, chunk):
    """The per-step loop the trainer ran before the split: the index arrays widened on
    the device, a Python float α per step (the chunk's alphas times the lr scale in
    float32), each pair step's mask from the host's real count and each CBOW context
    mask from the context counts, the hot slabs flushed on the cadence. Returns the
    last real step's metrics."""
    cfg = t.config
    arrays = {n: torch.from_numpy(a).long() for n, a in chunk["arrays"].items()
              if n not in ("alphas", "reals")}
    alphas = (chunk["alphas"] if t._lr_scale == 1.0
              else chunk["alphas"] * np.float32(t._lr_scale))
    K, real = cfg.steps_per_dispatch, chunk["real"]
    step = t._step_fn()
    if t._banded_cbow:
        # the token feed's [n, segments, ...] arrays: one device runs one segment
        arrays = {n: a[:, 0] for n, a in arrays.items()}
        obase = arrays["obase"]
        band = device_cbow_windows(
            arrays["tokens"], arrays["starts"], arrays["nvalid"], obase[:, 0],
            obase[:, 1], chunk["win_bases"][0], cfg.window, t._block_halo)
        negatives = sample_negatives_hash(t._table_prob, t._table_alias, cfg.seed,
                                          t.global_step + 1, (K, cfg.negative_pool))
        for k in range(real):
            metrics = step({"tokens": arrays["tokens"][k], "left": band.left[k],
                            "right": band.right[k], "center": band.center[k],
                            "token": band.token[k]}, negatives[k], float(alphas[k]), True)
        return metrics
    if cfg.device_pairgen:
        arrays = t._device_pairs(arrays, chunk)
    B = arrays["centers"].shape[1]
    shape = ((K, B, cfg.negatives) if cfg.negative_pool == 0 else (K, cfg.negative_pool))
    negatives = sample_negatives_hash(t._table_prob, t._table_alias, cfg.seed,
                                      t.global_step + 1, shape)
    pos = torch.arange(B)
    for k in range(real):
        batch = {name: a[k] for name, a in arrays.items()}
        if "mask" not in batch:
            batch["mask"] = (pos < int(chunk["reals"][k])).to(torch.float32)
        if cfg.cbow:
            C = batch["contexts"].shape[1]
            batch["ctx_mask"] = (torch.arange(C)[None, :]
                                 < batch.pop("nctx")[:, None]).to(torch.float32)
        metrics = step(batch, negatives[k], float(alphas[k]), True)
        if (k + 1) % t._hot_flush == 0:
            t._flush_hot()
    if real % t._hot_flush:
        t._flush_hot()
    return metrics


def _state(t):
    return list(t.params) + (list(t._slabs) if t._slabs is not None else [])


def _bits(t):
    """Every parameter and slab element as raw bits (a NaN-safe bitwise equality)."""
    return [x.contiguous().view(-1).view(torch.uint8).clone() for x in _state(t)]


@pytest.mark.parametrize("form", list(FORMS))
def test_split_matches_the_per_step_loop(form):
    """Two chunks through the prologue + body and through the old per-step loop, the
    second under a recovery's lr scale of 0.7: the same parameters and slabs bit for
    bit, and the body's row ``real - 1`` equal to the loop's last metrics."""
    (a, b), enc = _trainers(FORMS[form])
    start = _bits(a)
    for i, chunk in enumerate(_chunks(a, enc)):
        if i:
            a._lr_scale = b._lr_scale = 0.7
        got = a._run_chunk(chunk)
        want = _reference_chunk(b, chunk)
        real = chunk["real"]
        assert got.shape == (real, 3)
        assert torch.equal(got[real - 1], torch.stack(list(want)).to(got.dtype))
        assert all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b)))
        a.global_step += real
        b.global_step += real
    assert not all(torch.equal(x, y) for x, y in zip(start, _bits(a)))  # it trained
    if a._slabs is not None:
        assert not any(bool(s.any()) for s in a._slabs)  # flushed at the chunk's end


@pytest.mark.parametrize("form", list(FORMS))
def test_padded_steps_are_exact_noops(form):
    """A chunk cut to 2 real steps: the body padded to K trains exactly as its 2 steps
    alone (parameters, slabs and the real steps' metrics bit for bit), and a full chunk
    with every gate at zero (the graphs' warm-up) changes nothing."""
    (a, b, c), enc = _trainers(FORMS[form], n=3)
    chunk = _chunks(a, enc, 1)[0]
    K = a.config.steps_per_dispatch
    assert chunk["real"] >= 3
    short = dict(chunk, real=2, arrays={n: x[:2] for n, x in chunk["arrays"].items()})
    short["alphas"] = chunk["alphas"][:2]
    if "reals" in chunk:
        short["reals"] = chunk["reals"][:2]
    a._prologue(short)
    b._prologue(short)
    got_real = a._chunk_body(2, True)
    got_padded = b._chunk_body(K, True)
    assert all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b)))
    assert torch.equal(got_real, got_padded[:2])
    assert float(got_padded[2:, 2].abs().sum()) == 0.0  # the padded steps train no pair
    before = _bits(c)
    c._prologue(chunk)
    for name in ttrainer._GATES:
        if name in c._inputs:
            c._inputs[name].zero_()
    c._chunk_body(K, True)
    assert all(torch.equal(x, y) for x, y in zip(before, _bits(c)))


def _jax_fit(knobs, sents, syn0, syn1):
    import jax.numpy as jnp

    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
    from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair
    from glint_word2vec_tpu.train.trainer import Trainer as JTrainer

    jt = JTrainer(JConfig(**knobs), j_build_vocab(sents, 1),
                  params=JPair(jnp.asarray(syn0), jnp.asarray(syn1)))
    jt.fit(encode_sentences(sents, t_build_vocab(sents, 1)))
    return jt


def _padded_run_chunk(self, chunk):
    """The graphs' semantics on the CPU: the body always runs K steps, a short chunk
    padded with the prologue's masked steps."""
    self._prologue(chunk)
    with_metrics = (self._with_metrics(chunk["real"])
                    or self._step_form() in ttrainer._POOLLESS_FORMS)
    return self._chunk_body(self.config.steps_per_dispatch, with_metrics)


_SHORT_FITS = {
    "shared": dict(negative_pool=32),
    "per_pair": dict(negative_pool=0),
    "cbow_shared": dict(cbow=True, negative_pool=32),
    "cbow_banded": dict(cbow=True, cbow_update="banded", negative_pool=32),
}


@pytest.mark.parametrize("form", list(_SHORT_FITS))
def test_short_last_chunks_meet_the_jax_trainer(form, monkeypatch):
    """Two iterations whose chunks end short (K=4), a heartbeat at every chunk: the
    eager fit and the padded one (what a graph replays) both meet the JAX trainer's fit
    on the same inputs: steps, pairs and the alpha trace equal, the heartbeat losses
    (step ``real - 1`` of each chunk) within rtol 1e-4, parameters within atol 1e-5."""
    sents = _sents(seed=8, n_words=200, n_sent=90, length=18)
    knobs = dict(vector_size=32, pairs_per_batch=256, window=4, steps_per_dispatch=4,
                 heartbeat_every_steps=1, num_iterations=2, subsample_ratio=1e-3,
                 allow_unstable=True, learning_rate=0.025, seed=9, min_count=1,
                 **_SHORT_FITS[form])
    vocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, vocab)
    rng = np.random.default_rng(4)
    syn0 = rng.uniform(-0.005, 0.005, (vocab.size, 32)).astype(np.float32)
    syn1 = rng.normal(0, 0.01, (vocab.size, 32)).astype(np.float32)
    jt = _jax_fit(knobs, sents, syn0, syn1)
    jp = jt.unpadded_params()
    for padded in (False, True):
        if padded:
            monkeypatch.setattr(TTrainer, "_run_chunk", _padded_run_chunk)
        tt = TTrainer(TConfig(**knobs), vocab, params=(syn0, syn1), device="cpu")
        reals = []
        real_finish = tt._finish_round
        tt._finish_round = lambda chunk, *a: (reals.append(chunk["real"]),
                                              real_finish(chunk, *a))[1]
        tt.fit(enc)
        assert any(r < 4 for r in reals), reals  # some chunk ran short
        assert tt.global_step == jt.global_step and tt.pairs_trained == jt.pairs_trained
        jh, th = list(jt.heartbeats), list(tt.heartbeats)
        assert len(jh) == len(th) == len(reals)
        for x, y in zip(jh, th):
            assert (x.global_step, x.words, x.alpha) == (y.global_step, y.words, y.alpha)
            np.testing.assert_allclose(y.loss, x.loss, rtol=1e-4)
        tp = tt.unpadded_params()
        np.testing.assert_allclose(tp.syn0.numpy(), np.asarray(jp.syn0), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tp.syn1.numpy(), np.asarray(jp.syn1), atol=1e-5,
                                   rtol=0)


def test_graph_key_changes_where_the_graphs_must_be_recaptured():
    """The key function alone (no GPU): stable while nothing changes; the elided twin
    differs only in ``with_metrics``; a new key after a restore of a snapshot, after a
    recovery that engages max_row_norm (the shared step's scatter form), and after a
    new placement of the parameters."""
    knobs = dict(negative_pool=16, norm_watch="recover", norm_watch_threshold=100.0)
    (t,), enc = _trainers(knobs, n=1)
    t._run_chunk(_chunks(t, enc, 1)[0])
    key = t._graph_key(True)
    assert key == t._graph_key(True)
    assert t._graph_key(False) == (key[0], False)
    assert key[0][0] == "shared_fused"

    t._push_snapshot()
    t._restore_snapshot()
    after_restore = t._graph_key(True)
    assert after_restore[0] != key[0] and after_restore[0][0] == "shared_fused"

    t._push_snapshot()
    t._perform_recovery("test firing", {"syn0": {}, "syn1": {}})
    after_recovery = t._graph_key(True)
    assert after_recovery[0] != after_restore[0]
    assert after_recovery[0][0] == "shared_scatter"
    assert after_recovery[0][2] == (100.0, 0.0, 0.0)

    t.params = t._place_params(tuple(m.clone() for m in t.params))
    assert t._graph_key(True)[0] != after_recovery[0]


# ---- the stability advisories (the JAX package's test_stability_warnings_fire) ------

def _zipf_vocab(cls):
    counts = np.maximum(2_000_000 / (np.arange(5000) + 10.0) ** 1.05, 5).astype(int)
    return cls.from_words_and_counts([f"w{i}" for i in range(5000)], counts)


def _port_warnings(caplog, **kw):
    cfg = TConfig(vector_size=16, min_count=1, **kw)
    with caplog.at_level(logging.WARNING, logger="glint_word2vec_torch"):
        caplog.clear()
        TTrainer(cfg, _zipf_vocab(TVocabulary), device="cpu")
    return [r.getMessage() for r in caplog.records if r.name == "glint_word2vec_torch"]


ADVISORY_CONFIGS = {  # the JAX test's four configs and its quiet one
    "pool": dict(pairs_per_batch=65536, negatives=5, negative_pool=64,
                 subsample_ratio=1e-4),
    "duplicates": dict(pairs_per_batch=65536, negatives=5, negative_pool=1024,
                       subsample_ratio=0.0, allow_unstable=True),
    "compound": dict(pairs_per_batch=65536, negatives=5, negative_pool=256,
                     subsample_ratio=1e-4),
    "duplicates_per_pair": dict(pairs_per_batch=65536, negatives=5, negative_pool=0,
                                subsample_ratio=0.0, allow_unstable=True),
    "quiet": dict(pairs_per_batch=16384, negatives=5, negative_pool=64,
                  subsample_ratio=1e-4),
}


def test_stability_warnings_fire(caplog):
    """The port's trainer warns on the three measured divergence regimes, as the JAX
    package's does (tests/test_estimator.py::test_stability_warnings_fire)."""
    assert any("pool" in m for m in _port_warnings(caplog, **ADVISORY_CONFIGS["pool"]))
    assert any("duplicates" in m for m in _port_warnings(
        caplog, **ADVISORY_CONFIGS["duplicates"]))
    msgs = _port_warnings(caplog, **ADVISORY_CONFIGS["compound"])
    assert any("compound" in m for m in msgs), msgs
    assert any("duplicates" in m for m in _port_warnings(
        caplog, **ADVISORY_CONFIGS["duplicates_per_pair"]))
    assert not _port_warnings(caplog, **ADVISORY_CONFIGS["quiet"])


@pytest.mark.parametrize("name", list(ADVISORY_CONFIGS))
def test_stability_warnings_match_the_jax_trainer(caplog, name):
    """The same config gives the same warning messages, in the same order, from both
    packages' trainers."""
    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    from glint_word2vec_tpu.data.vocab import Vocabulary as JVocabulary
    from glint_word2vec_tpu.train.trainer import Trainer as JTrainer

    kw = ADVISORY_CONFIGS[name]
    with caplog.at_level(logging.WARNING, logger="glint_word2vec_tpu"):
        caplog.clear()
        JTrainer(JConfig(vector_size=16, min_count=1, **kw), _zipf_vocab(JVocabulary))
    jax_msgs = [r.getMessage() for r in caplog.records if r.name == "glint_word2vec_tpu"]
    assert _port_warnings(caplog, **kw) == jax_msgs


def test_recovery_announces_the_rebuilt_step(caplog):
    """A recovery that engages max_row_norm rebuilds the step, and the advisories fire
    again, as the JAX trainer's rebuild announces it."""
    (t,), enc = _trainers(dict(negative_pool=16, norm_watch="recover",
                               pairs_per_batch=4096, subsample_ratio=0.0), n=1)
    t._push_snapshot()
    with caplog.at_level(logging.WARNING, logger="glint_word2vec_torch"):
        caplog.clear()
        t._perform_recovery("test firing", {"syn0": {}, "syn1": {}})
    msgs = [r.getMessage() for r in caplog.records]
    assert any("duplicates" in m for m in msgs), msgs
    assert any("recovery 1/" in m for m in msgs)


# ---- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_corpus(V=5000, n_tokens=200_000):
    rng = np.random.default_rng(2)
    counts = (1e7 / np.arange(1, V + 1)).astype(np.int64) + 1
    vocab = TVocabulary.from_words_and_counts([f"w{i}" for i in range(V)], counts)
    ids = rng.choice(V, size=n_tokens, p=counts / counts.sum())
    return vocab, encode_sentences([[f"w{i}" for i in ids[j:j + 40]]
                                    for j in range(0, ids.size, 40)], vocab)


def _card_fit(cuda, vocab, enc, knobs, eager, syn0, syn1):
    """One fit on the card from injected parameters: graphs, or the eager control.
    Returns the trainer and its kernel launches (fused, scatter)."""
    cfg = TConfig(**{**dict(vector_size=64, pairs_per_batch=4096, negative_pool=128,
                            min_count=1, heartbeat_every_steps=16,
                            subsample_ratio=1e-4, seed=3, allow_unstable=True,
                            hot_rows=0), **knobs})
    tr = TTrainer(cfg, vocab, params=(syn0, syn1), device=cuda)
    tr._eager_chunks = eager
    fused_sgns_shared_step.launches = tscatter.scatter_add_rows_.launches = 0
    tr.fit(enc)
    torch.cuda.synchronize()
    return tr, (fused_sgns_shared_step.launches, tscatter.scatter_add_rows_.launches)


def _small_knobs(knobs):
    """chip_smoke.py's fit knobs at the test's size: the hot rows cut to 64 (of 5000
    words), the bench's dispatch kept."""
    out = dict(knobs)
    if out.get("hot_rows"):
        out["hot_rows"] = 64
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", [f[0] for f in _smoke().FITS])
def test_graph_fit_matches_its_eager_control(cuda, name):
    """Each of chip_smoke.py's fits at V=5000, D=64, B=4096: the graph fit against its
    eager control from the same parameters. f32: parameters within 1e-4, heartbeat
    losses within 1e-4 relative; bf16: the parameter deltas by ops/bf16_check's limits
    (at most 2% of the touched elements differ, 0.2% by more than one bf16 ulp) and
    the losses within its LOSS_RTOL. One replay per chunk; launches per step run on
    the card equal in both (the graph fit runs K steps per replay and per capture's
    warm-up, the eager one its real steps)."""
    knobs = _small_knobs(dict(dict((f[0], f[1]) for f in _smoke().FITS)[name]))
    vocab, enc = _card_corpus()
    rng = np.random.default_rng(6)
    syn0 = rng.normal(0, 0.1, (vocab.size, 64)).astype(np.float32)
    syn1 = rng.normal(0, 0.1, (vocab.size, 64)).astype(np.float32)
    g, g_launch = _card_fit(cuda, vocab, enc, knobs, False, syn0, syn1)
    e, e_launch = _card_fit(cuda, vocab, enc, knobs, True, syn0, syn1)
    K = g.config.steps_per_dispatch
    assert g.chunks_run == e.chunks_run >= 2
    assert g.graph_replays == g.chunks_run and e.graph_replays == 0
    assert 1 <= g.graph_captures <= 2
    assert g.global_step == e.global_step and g.pairs_trained == e.pairs_trained
    ran = K * (g.graph_replays + g.graph_captures)
    for n_g, n_e in zip(g_launch, e_launch):
        assert n_e % e.global_step == 0
        assert n_g == n_e // e.global_step * ran
    assert any(g_launch)
    hg, he = list(g.heartbeats), list(e.heartbeats)
    assert len(hg) == len(he) >= 1
    if g.params.syn0.dtype == torch.bfloat16:
        base = g._place_params((syn0, syn1))
        for pg, pe, p0 in zip(g.params, e.params, base):
            agree = bf16_check.update_agreement(pg.float() - p0.float(),
                                                pe.float() - p0.float(),
                                                bf16_check.bf16_ulp(pe))
            assert bf16_check.passes(agree), agree
        for x, y in zip(hg, he):
            assert math.isclose(x.loss, y.loss, rel_tol=bf16_check.LOSS_RTOL)
    else:
        for pg, pe in zip(g.params, e.params):
            assert float((pg - pe).abs().max()) <= 1e-4
        for x, y in zip(hg, he):
            assert math.isclose(x.loss, y.loss, rel_tol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("plan,knobs", [
    ({"nan_at_step": 40}, {"nonfinite_policy": "rollback"}),
    ({"scale_params_at_step": 40}, {"norm_watch": "recover"}),
])
def test_graphs_are_recaptured_after_a_restore(cuda, plan, knobs):
    """A rollback and a recovery each restore a snapshot: the next chunk captures anew
    (the recovery's in the shared step's scatter form), every chunk is one replay, and
    the fit ends finite."""
    from glint_word2vec_torch.train import faults

    vocab, enc = _card_corpus()
    rng = np.random.default_rng(6)
    syn0 = rng.uniform(-0.005, 0.005, (vocab.size, 64)).astype(np.float32)
    syn1 = np.zeros((vocab.size, 64), np.float32)
    faults.configure(**plan)
    try:
        tr, launches = _card_fit(cuda, vocab, enc, knobs, False, syn0, syn1)
    finally:
        faults.reset()
    assert len(tr.restore_captures) == 1 and tr.restore_captures[0] >= 1
    assert tr.graph_captures > tr.restore_captures[0]
    assert tr.graph_replays == tr.chunks_run
    assert all(bool(torch.isfinite(m).all()) for m in tr.params)
    if "norm_watch" in knobs:
        assert tr._step_form() == "shared_scatter" and launches[1] > 0
