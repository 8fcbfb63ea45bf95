"""bf16 parameters, compute and logits, and the fused and bf16 logit chains, in the
PyTorch port against the JAX package.

The rule of the port: a step's updates to one row are summed in f32 and rounded into
the bf16 row ONCE (``ops/scatter``). The JAX package's ``.at[].add`` on a bf16 matrix
rounds after every add on the CPU, so where a row repeats within a step the two
packages differ by design; ``test_bf16_accumulation_divergence`` shows it outright.
So the bf16 steps are held to the JAX functions on inputs where no row repeats within
a step (within 2 bf16 ulps of the value plus 2^-7 of the matrix's largest update, the
loss within 1e-2 relative: the packages round the same values at the same places, and
differ only by the order of f32 sums and by one ulp where XLA's and torch's elementwise
bf16 ops round differently, which a cancelling sum of terms shows at the terms' scale),
and to a NumPy oracle of
the port's rule where rows repeat. The restructured chains (``fused_logits``,
``bf16_chain``) equal the classic chain in float64 at 1e-12, and the JAX functions in
float32 at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.ops import cbow_banded as jband
from glint_word2vec_tpu.ops import sgns as jsgns
from glint_word2vec_torch import interop
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.ops import bf16_check
from glint_word2vec_torch.ops import cbow_banded as tband
from glint_word2vec_torch.ops import scatter as tscatter
from glint_word2vec_torch.ops import sgns as tsgns


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


BF = torch.bfloat16
ALPHA, NEG = 0.05, 3


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 value (ties to even), as float32, in NumPy."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits), floored at the smallest normal's."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _within_ulps(got, want, n=2):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) <= n * _ulp(want)


# -- the accumulation rule ---------------------------------------------------------------


def test_bf16_accumulation_divergence():
    """1000 updates of bf16(1e-3) to one bf16 row of 1.0. The exact sum is 1.99945...;
    the port (f32 sum, one rounding) gives 2.0, JAX's .at[].add on the CPU rounds after
    every add and leaves the row at 1.0. The port is held to its rule's oracle; JAX's
    value is recorded beside it, not held."""
    n, u = 1000, 1e-3
    upd = np.full((n, 4), u, np.float32)
    mat = np.ones((3, 4), np.float32)
    idx = np.ones(n, np.int64)
    jax_value = float(np.asarray(
        jnp.asarray(mat, jnp.bfloat16).at[idx].add(jnp.asarray(upd, jnp.bfloat16))
        .astype(jnp.float32))[1, 0])
    port = tscatter.scatter_add_rows_(torch.from_numpy(mat).to(BF), torch.from_numpy(idx),
                                      torch.from_numpy(upd).to(BF), torch.ones(n))
    ub = _bf16_round(upd[0, 0])
    oracle = float(_bf16_round(np.float32(1.0) + np.float32(n) * ub))
    exact = 1.0 + n * float(ub)
    assert abs(exact - 1.99945068359375) < 1e-12
    assert (jax_value, oracle) == (1.0, 2.0)  # the divergence, as measured
    assert float(port[1, 0]) == oracle and port[[0, 2]].eq(1.0).all()


def _np_rule(before: np.ndarray, idx: np.ndarray, upd: np.ndarray,
             live: np.ndarray) -> np.ndarray:
    """The port's rule in NumPy: each row's live updates summed in f32 (slot order),
    added to the row, rounded to bf16 once."""
    keep = live != 0
    acc = np.zeros_like(before, np.float32)
    np.add.at(acc, idx[keep], upd[keep].astype(np.float32))
    out = before.copy()
    rows = np.unique(idx[keep])
    out[rows] = _bf16_round(before[rows] + acc[rows])
    return out


@pytest.mark.parametrize("D", [8, 7])
def test_bf16_scatter_plain_matches_oracle(D):
    rng = np.random.default_rng(D)
    V, N = 50, 600
    before = _bf16_round(rng.normal(0, 0.5, (V, D)).astype(np.float32))
    idx = ((rng.zipf(1.3, N) - 1) % V).astype(np.int64)
    live = (rng.random(N) > 0.2).astype(np.float32)
    upd = _bf16_round(rng.normal(0, 1e-2, (N, D)).astype(np.float32))
    want = _np_rule(before, idx, upd, live)
    got = tscatter.scatter_add_rows_(torch.from_numpy(before).to(BF),
                                     torch.from_numpy(idx), torch.from_numpy(upd).to(BF),
                                     torch.from_numpy(live))
    g = got.float().numpy()
    assert _within_ulps(g, want, 1).all()
    assert (g == want).mean() > 0.99  # the f32 sums differ only in order
    assert (rng.zipf(1.3, 1) > 0).all() and np.bincount(idx).max() > 50  # hot rows


# -- the restructured chains in float64 and float32 ----------------------------------------


def _inputs(seed=0, V=60, D=12, B=24, P=8):
    rng = np.random.default_rng(seed)
    syn0 = rng.normal(0, 0.5, (V, D))
    syn1 = rng.normal(0, 0.5, (V, D))
    c = rng.integers(0, V, B)
    x = rng.integers(0, V, B)
    c[3] = c[4] = 2
    x[5] = x[6] = 1
    mask = (np.arange(B) < B - 4).astype(np.float64)
    negs = rng.integers(0, V, P)
    negs[0] = x[0]
    negs[1] = negs[2]
    pn = rng.integers(0, V, (B, NEG))
    pn[0, 0] = x[0]
    return syn0, syn1, c, x, mask, negs, pn


def _index_add(mat, idx, upd, live):
    keep = live != 0
    return mat.index_add_(0, idx[keep], upd[keep])


def _pair(*arrays, dtype=None):
    ts = [torch.from_numpy(np.array(a)) for a in arrays]
    return tsgns.EmbeddingPair(*(t.to(dtype) if dtype else t for t in ts))


CHAINS = [dict(fused=True), dict(bf16_chain=True), dict(fused=True, bf16_chain=True)]


@pytest.mark.parametrize("kw", CHAINS, ids=["fused", "chain", "fused-chain"])
@pytest.mark.parametrize("form", ["shared", "shared_scatter", "per_pair"])
def test_chains_equal_classic_f64(form, kw):
    """fused_logits and bf16_chain are the classic chain in another association:
    float64 parameters, metrics and (per-pair) validity at 1e-12."""
    syn0, syn1, c, x, m, negs, pn = _inputs()
    t = [torch.from_numpy(a) for a in (c, x, m)]

    def run(**k):
        p = _pair(syn0, syn1)
        if form == "shared":
            p, met = tsgns.sgns_step_shared_core(p, *t, torch.from_numpy(negs), ALPHA, NEG,
                                                 **k)
        elif form == "shared_scatter":
            met = tsgns.sgns_step_shared_scatter_(p, *t, torch.from_numpy(negs), ALPHA,
                                                  NEG, "exact", True, _index_add, **k)
        else:
            met = tsgns.sgns_step_core(p, *t, torch.from_numpy(pn), ALPHA, "exact",
                                       _index_add, **k)
        return p, met

    base, mb = run()
    got, mg = run(**kw)
    for a, b_ in zip(got, base):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-12, rtol=0)
    assert abs(float(mg.loss) - float(mb.loss)) < 1e-12
    assert float(mg.pairs) == float(mb.pairs)


@pytest.mark.parametrize("kw", CHAINS, ids=["fused", "chain", "fused-chain"])
@pytest.mark.parametrize("form", ["shared", "per_pair"])
def test_chains_match_jax_f32(form, kw):
    syn0, syn1, c, x, m, negs, pn = _inputs(seed=3)
    s0, s1 = syn0.astype(np.float32), syn1.astype(np.float32)
    jp = jsgns.EmbeddingPair(jnp.asarray(s0), jnp.asarray(s1))
    args = (jnp.asarray(c, jnp.int32), jnp.asarray(x, jnp.int32),
            jnp.asarray(m, jnp.float32))
    tt = [torch.from_numpy(c), torch.from_numpy(x), torch.from_numpy(m.astype(np.float32))]
    p = _pair(s0, s1)
    if form == "shared":
        (j0, j1), jm = jsgns.sgns_step_shared_core(
            jp, *args, jnp.asarray(negs, jnp.int32), jnp.float32(ALPHA), NEG, "exact",
            jnp.float32, False, jnp.float32, True, **kw)
        p, tm = tsgns.sgns_step_shared_core(p, *tt, torch.from_numpy(negs), ALPHA, NEG,
                                            compute_dtype=torch.float32,
                                            logits_dtype=torch.float32, **kw)
    else:
        (j0, j1), jm = jsgns.sgns_step_core(
            jp, *args, jnp.asarray(pn, jnp.int32), jnp.float32(ALPHA), "exact",
            jnp.float32, False, **kw)
        tm = tsgns.sgns_step_core(p, *tt, torch.from_numpy(pn), ALPHA,
                                  compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(p.syn0.numpy(), np.asarray(j0), atol=1e-6, rtol=0)
    np.testing.assert_allclose(p.syn1.numpy(), np.asarray(j1), atol=1e-6, rtol=0)
    assert abs(float(tm.loss) - float(jm.loss)) < 1e-5 * abs(float(jm.loss))


# -- every step in bf16 against the JAX functions -------------------------------------------


def _distinct_draw(seed, V=4096, D=16, B=24, P=8, n=NEG, C=6):
    """Indices with no repeated row within a matrix's updates of one step: distinct
    centers (syn0), distinct contexts, negatives and pool (syn1); for CBOW distinct
    context slots (syn0) and centers with negatives (syn1). Parameters bf16-valued."""
    rng = np.random.default_rng(seed)
    syn0 = _bf16_round(rng.normal(0, 0.5, (V, D)).astype(np.float32))
    syn1 = _bf16_round(rng.normal(0, 0.5, (V, D)).astype(np.float32))
    perm = rng.permutation(V)
    c, x = perm[:B], perm[B:2 * B]
    pool = perm[2 * B:2 * B + P]
    pn = perm[2 * B + P:2 * B + P + B * n].reshape(B, n)
    ctx = perm[2 * B + P + B * n:2 * B + P + B * n + B * C].reshape(B, C)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    nctx = rng.integers(1, C + 1, B)
    ctx_mask = (np.arange(C)[None, :] < nctx[:, None]).astype(np.float32)
    return syn0, syn1, c, x, pool, pn, ctx, ctx_mask, mask


def _jpair(s0, s1):
    return jsgns.EmbeddingPair(jnp.asarray(s0, jnp.bfloat16), jnp.asarray(s1, jnp.bfloat16))


def _ji(a):
    return jnp.asarray(a, jnp.int32)


def _run_both(form, d, chain):
    """One bf16 step of ``form`` in both packages from the same bf16 values; returns
    ((port syn0, syn1, loss), (JAX syn0, syn1, loss)) as float32/float."""
    syn0, syn1, c, x, pool, pn, ctx, ctx_mask, mask = d
    a = jnp.float32(ALPHA)
    bf, jb = BF, jnp.bfloat16
    p = _pair(syn0, syn1, dtype=bf)
    T = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    kw = dict(fused=chain, bf16_chain=chain)
    if form == "per_pair":
        (j0, j1), jm = jsgns.sgns_step_core(_jpair(syn0, syn1), _ji(c), _ji(x),
                                            jnp.asarray(mask), _ji(pn), a, "exact", jb,
                                            False, **kw)
        tm = tsgns.sgns_step_core(p, T(c), T(x), T(mask), T(pn), ALPHA,
                                  compute_dtype=bf, **kw)
    elif form in ("shared", "shared_scatter"):
        (j0, j1), jm = jsgns.sgns_step_shared_core(
            _jpair(syn0, syn1), _ji(c), _ji(x), jnp.asarray(mask), _ji(pool), a, NEG,
            "exact", jb, False, jb, True, **kw)
        if form == "shared":
            p, tm = tsgns.sgns_step_shared_core(p, T(c), T(x), T(mask), T(pool), ALPHA,
                                                NEG, compute_dtype=bf, logits_dtype=bf,
                                                **kw)
        else:
            tm = tsgns.sgns_step_shared_scatter_(p, T(c), T(x), T(mask), T(pool), ALPHA,
                                                 NEG, compute_dtype=bf, logits_dtype=bf,
                                                 **kw)
    elif form == "cbow":
        (j0, j1), jm = jsgns.cbow_step_core(
            _jpair(syn0, syn1), _ji(c), _ji(ctx), jnp.asarray(ctx_mask),
            jnp.asarray(mask), _ji(pn), a, "exact", jb)
        tm = tsgns.cbow_step_core(p, T(c), T(ctx), T(ctx_mask), T(mask), T(pn), ALPHA,
                                  compute_dtype=bf)
    elif form == "cbow_shared":
        (j0, j1), jm = jsgns.cbow_step_shared_core(
            _jpair(syn0, syn1), _ji(c), _ji(ctx), jnp.asarray(ctx_mask),
            jnp.asarray(mask), _ji(pool), a, NEG, "exact", jb, jb)
        tm = tsgns.cbow_step_shared_core(p, T(c), T(ctx), T(ctx_mask), T(mask), T(pool),
                                         ALPHA, NEG, compute_dtype=bf, logits_dtype=bf)
    else:  # banded: one sentence of distinct tokens
        rng = np.random.default_rng(5)
        tokens = np.concatenate([c, x])
        Tn, W = tokens.shape[0], 3
        t = np.arange(Tn)
        left = rng.integers(0, np.minimum(t, W - 1) + 1)
        right = rng.integers(0, np.minimum(Tn - 1 - t, W - 1) + 1)
        cmask = np.ones(Tn, np.float32)
        cmask[-2:] = 0.0
        tmask = np.ones(Tn, np.float32)
        (j0, j1), jm = jband.cbow_step_banded_core(
            _jpair(syn0, syn1), _ji(tokens), _ji(left), _ji(right), jnp.asarray(cmask),
            jnp.asarray(tmask), _ji(pool), a, NEG, W, "exact", jb, jb)
        tm = tband.cbow_step_banded_core(p, T(tokens), T(left), T(right), T(cmask),
                                         T(tmask), T(pool), ALPHA, NEG, W,
                                         compute_dtype=bf, logits_dtype=bf)
    f = lambda v: np.asarray(jnp.asarray(v).astype(jnp.float32))  # noqa: E731
    return ((p.syn0.float().numpy(), p.syn1.float().numpy(), float(tm.loss)),
            (f(j0), f(j1), float(jm.loss)))


FORMS = ["per_pair", "shared", "shared_scatter", "cbow", "cbow_shared", "banded"]


@pytest.mark.parametrize("chain", [False, True], ids=["classic", "fused-chain"])
@pytest.mark.parametrize("form", FORMS)
def test_bf16_step_matches_jax_without_repeated_rows(form, chain):
    if chain and form.startswith(("cbow", "banded")):
        pytest.skip("fused_logits and bf16_chain are skip-gram chains (refused on CBOW)")
    d = _distinct_draw(FORMS.index(form))
    (t0, t1, tl), (j0, j1, jl) = _run_both(form, d, chain)
    for got, want, before in ((t0, j0, d[0]), (t1, j1, d[1])):
        step = np.abs(want - before).max()
        assert step > 0  # the step moved the matrix
        # 2 ulps of the value, and 2^-7 of the matrix's largest update: an update that
        # sums bf16 terms may cancel, and a term's one-ulp difference (XLA's and torch's
        # bf16 sigmoids round apart on some inputs) then shows at the terms' scale
        tol = 2 * _ulp(want) + 2.0 ** -7 * step
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    assert abs(tl - jl) <= 1e-2 * abs(jl)


class _Recorder:
    """A CPU scatter that records each call's rows before it, then applies the port's
    plain scatter."""

    def __init__(self):
        self.calls = []

    def __call__(self, mat, idx, upd, live):
        self.calls.append((mat.float().numpy().copy(), idx.numpy().copy(),
                           upd.float().numpy().copy(), live.numpy().copy()))
        out = tscatter.scatter_add_rows_(mat, idx, upd, live)
        self.calls[-1] += (mat.float().numpy().copy(),)
        return out


@pytest.mark.parametrize("form", ["per_pair", "shared_scatter", "cbow", "cbow_shared"])
def test_bf16_step_with_repeated_rows_follows_the_rule(form):
    """Zipf draws repeat rows within a step: every scatter of the bf16 step equals the
    NumPy oracle of the port's rule (f32 sum, one rounding) on the rows it was given, to
    1 ulp (the oracle sums in slot order, index_add_ in its own)."""
    rng = np.random.default_rng(11)
    V, D, B, P, C = 40, 16, 64, 8, 6
    syn0 = _bf16_round(rng.normal(0, 0.5, (V, D)).astype(np.float32))
    syn1 = _bf16_round(rng.normal(0, 0.5, (V, D)).astype(np.float32))
    z = lambda *s: torch.from_numpy((rng.zipf(1.2, s) - 1) % V)  # noqa: E731
    c, x, pool, pn, ctx = z(B), z(B), z(P), z(B, NEG), z(B, C)
    mask = torch.ones(B)
    ctx_mask = torch.ones(B, C)
    p = _pair(syn0, syn1, dtype=BF)
    rec = _Recorder()
    if form == "per_pair":
        tsgns.sgns_step_core(p, c, x, mask, pn, ALPHA, "exact", rec, compute_dtype=BF)
    elif form == "shared_scatter":
        tsgns.sgns_step_shared_scatter_(p, c, x, mask, pool, ALPHA, NEG, "exact", True, rec,
                                        compute_dtype=BF, logits_dtype=BF)
    elif form == "cbow":
        tsgns.cbow_step_core(p, c, ctx, ctx_mask, mask, pn, ALPHA, "exact", rec,
                             compute_dtype=BF)
    else:
        tsgns.cbow_step_shared_core(p, c, ctx, ctx_mask, mask, pool, ALPHA, NEG, "exact",
                                    True, rec, compute_dtype=BF, logits_dtype=BF)
    assert len(rec.calls) == 2
    for before, idx, upd, live, after in rec.calls:
        assert np.bincount(idx[live != 0]).max() > 3  # rows really repeat
        assert (_bf16_round(upd) == upd).all()  # updates arrive rounded to bf16
        assert _within_ulps(after, _np_rule(before, idx, upd, live), 1).all()


def test_stabilizers_keep_their_norms_in_f32_on_bf16():
    """The stabilizers' norm and scale math runs in f32 on bf16 rows, as the JAX
    package's: the clipped rows and the clamped rows match its functions to 1 ulp."""
    rng = np.random.default_rng(2)
    rows = _bf16_round(rng.normal(0, 2.0, (32, 16)).astype(np.float32))
    assert tsgns._stab_dtype(BF) == torch.float32
    got = tsgns.clip_update_rows(torch.from_numpy(rows).to(BF), 1.5).float().numpy()
    want = np.asarray(jsgns.clip_update_rows(jnp.asarray(rows, jnp.bfloat16), 1.5)
                      .astype(jnp.float32))
    assert _within_ulps(got, want, 1).all()
    assert np.linalg.norm(got, axis=1).max() <= 1.5 * (1 + 2 ** -7) * 1.01
    stab = tsgns.Stabilizers(max_row_norm=3.0, row_l2=1e-2)
    idx = np.array([0, 3, 3, 7, 40])
    mat = torch.from_numpy(rows).to(BF)
    tsgns.stabilize_rows_(mat, torch.from_numpy(idx), ALPHA, stab, torch.tensor(1.0))
    jm = jsgns.stabilize_rows(jnp.asarray(rows, jnp.bfloat16), jnp.asarray(idx, jnp.int32),
                              jnp.float32(ALPHA), jsgns.Stabilizers(3.0, 0.0, 1e-2),
                              jnp.float32(1.0))
    assert _within_ulps(mat.float().numpy(), np.asarray(jm.astype(jnp.float32)), 1).all()


# -- config, trainer, interop, checkpoints -------------------------------------------------


REFUSED = [  # tests/test_fused_hotrow.py's refusal matrix, with the dtype checks
    dict(hot_rows=4, cbow=True),
    dict(hot_rows=4, use_pallas=True),
    dict(hot_rows=4, step_lowering="shard_map"),
    dict(hot_rows=4, embedding_partition="cols"),
    dict(hot_rows=4, duplicate_scaling=True),
    dict(hot_rows=4, max_row_norm=10.0),
    dict(hot_rows=4, update_clip=0.5),
    dict(hot_rows=4, row_l2=1e-4),
    dict(hot_rows=4, norm_watch="recover"),
    dict(hot_rows=4, num_model_shards=2),
    dict(hot_rows=4, num_data_shards=2),
    dict(hot_rows=4, mesh_shape=(2, 4)),
    dict(hot_rows=4, hot_flush_every=3, steps_per_dispatch=16),
    dict(hot_rows=4, hot_flush_every=32, steps_per_dispatch=16),
    dict(hot_rows=-1),
    dict(hot_flush_every=-1),
    dict(fused_logits=True, cbow=True),
    dict(fused_logits=True, use_pallas=True),
    dict(fused_logits=True, duplicate_scaling=True),
    dict(bf16_chain=True),
    dict(bf16_chain=True, cbow=True, compute_dtype="bfloat16"),
    dict(bf16_chain=True, use_pallas=True, compute_dtype="bfloat16"),
    dict(bf16_chain=True, compute_dtype="bfloat16", negative_pool=512),
    dict(param_dtype="float16"),
    dict(compute_dtype="bf16"),
    dict(logits_dtype="float64"),
]


@pytest.mark.parametrize("kw", REFUSED, ids=lambda kw: "-".join(f"{k}={v}"
                                                                for k, v in kw.items()))
def test_config_refuses_what_jax_refuses(kw):
    """Each refused combination raises the same class in both packages, with the
    same message."""
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError) as te:
        TConfig(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(hot_rows=4096), dict(hot_rows=4096, hot_flush_every=16),
    dict(fused_logits=True),
    dict(bf16_chain=True, compute_dtype="bfloat16", logits_dtype="bfloat16"),
    dict(bf16_chain=True, compute_dtype="bfloat16", negative_pool=0),
    dict(param_dtype="bfloat16", compute_dtype="bfloat16", logits_dtype="bfloat16",
         fused_logits=True, bf16_chain=True, hot_rows=4096),
    dict(param_dtype="bfloat16", cbow=True, cbow_update="banded",
         compute_dtype="bfloat16", logits_dtype="bfloat16"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_legal_combinations_construct(kw):
    t, j = TConfig(**kw), JConfig(**kw)
    assert t.negative_pool == j.negative_pool
    back = TConfig.from_dict(t.to_dict())
    assert all(getattr(back, k) == v for k, v in kw.items())
    assert t.replace(seed=5).hot_rows == kw.get("hot_rows", 0)


def test_use_pallas_stays_refused_by_name():
    with pytest.raises(NotImplementedError, match="use_pallas"):
        TConfig(use_pallas=True)


def test_init_embeddings_takes_a_dtype():
    p = tsgns.init_embeddings(10, 8, torch.Generator().manual_seed(0), BF)
    q = tsgns.init_embeddings(10, 8, torch.Generator().manual_seed(0))
    assert p.syn0.dtype == p.syn1.dtype == BF
    assert torch.equal(p.syn0, q.syn0.to(BF)) and not p.syn1.any()


def test_logits_dtype_warning(caplog):
    """The JAX trainer's warning: logits_dtype applies to the shared-pool paths only."""
    from glint_word2vec_torch.data.vocab import Vocabulary
    from glint_word2vec_torch.train.trainer import Trainer

    vocab = Vocabulary.from_words_and_counts(["a", "b", "c"], [5, 4, 3])
    with caplog.at_level("WARNING", logger="glint_word2vec_torch"):
        Trainer(TConfig(vector_size=8, pairs_per_batch=64, logits_dtype="bfloat16"),
                vocab, device="cpu")
    assert "only applies to the shared-pool" in caplog.text
    caplog.clear()
    with caplog.at_level("WARNING", logger="glint_word2vec_torch"):
        Trainer(TConfig(vector_size=8, pairs_per_batch=8192, logits_dtype="bfloat16"),
                vocab, device="cpu")
    assert "only applies" not in caplog.text


def test_interop_carries_bf16_bits():
    """A JAX bf16 array widened to float32 reaches the port and goes back unchanged."""
    rng = np.random.default_rng(4)
    j = jnp.asarray(rng.normal(0, 0.3, (9, 5)), jnp.bfloat16)
    wide = np.asarray(j, np.float32)
    p = interop.params_from_numpy(wide, wide, device="cpu", padded_vocab=12,
                                  padded_dim=8, dtype=BF)
    assert p.syn0.dtype == BF and not p.syn0[9:].any() and not p.syn0[:, 5:].any()
    back, _ = interop.params_to_numpy(p)
    np.testing.assert_array_equal(back[:9, :5], wide)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(back[:9, :5], jnp.bfloat16)
                                             .astype(jnp.float32)), wide)


def _toy(V=80, seed=0):
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import Vocabulary
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(V)]
    vocab = Vocabulary.from_words_and_counts(
        words, np.sort(rng.integers(5, 100, V))[::-1].copy())
    sents = [[f"w{i}" for i in rng.integers(0, V, 12)] for _ in range(80)]
    return vocab, sents, encode_sentences(sents, vocab, 1000)


BF16_KNOBS = dict(param_dtype="bfloat16", compute_dtype="bfloat16",
                  logits_dtype="bfloat16")


def test_bf16_dense_checkpoint_round_trips_both_packages(tmp_path):
    """A port bf16 fit saves float32 (bf16 widened); the JAX package loads it and
    resumes in bf16 with the same bits, and the port loads a JAX bf16 save and starts
    its bf16 trainer from the same bits."""
    from glint_word2vec_torch.train import checkpoint as tck
    from glint_word2vec_torch.train.trainer import Trainer
    from glint_word2vec_tpu.train import checkpoint as jck
    from glint_word2vec_tpu.train.trainer import Trainer as JTrainer
    from glint_word2vec_tpu.parallel.mesh import make_mesh

    vocab, _, enc = _toy()
    cfg = dict(vector_size=16, min_count=1, pairs_per_batch=32, window=2,
               steps_per_dispatch=4, prefetch_chunks=0, seed=3, negative_pool=16,
               **BF16_KNOBS)
    t = Trainer(TConfig(**cfg), vocab, device="cpu")
    t.fit(enc)
    t.save_checkpoint(str(tmp_path / "port"))
    data = jck.load_model(str(tmp_path / "port"))
    assert data["syn0"].dtype == np.float32
    np.testing.assert_array_equal(data["syn0"], t.unpadded_params().syn0.float().numpy())
    # the JAX estimator's resume casts the dense f32 checkpoint to param_dtype
    jt = JTrainer(JConfig(**cfg), vocab, plan=make_mesh(1, 1),
                  params=jsgns.EmbeddingPair(jnp.asarray(data["syn0"], jnp.bfloat16),
                                             jnp.asarray(data["syn1"], jnp.bfloat16)))
    assert jt.params.syn0.dtype == jnp.bfloat16
    V, D = vocab.size, 16
    np.testing.assert_array_equal(
        np.asarray(jt.params.syn0.astype(jnp.float32))[:V, :D], data["syn0"])
    jt.fit(enc)
    jck.save_model(str(tmp_path / "jax"), vocab.words, vocab.counts,
                   np.asarray(jt.params.syn0.astype(jnp.float32))[:V, :D],
                   np.asarray(jt.params.syn1.astype(jnp.float32))[:V, :D],
                   jt.config, jt.state)
    back = tck.load_model(str(tmp_path / "jax"))
    t2 = Trainer(TConfig(**cfg), vocab, params=(back["syn0"], back["syn1"]), device="cpu")
    np.testing.assert_array_equal(t2.unpadded_params().syn0.float().numpy(),
                                  np.asarray(jt.params.syn0.astype(jnp.float32))[:V, :D])


def test_bf16_toy_fit_separates_topics():
    """README's 2-topic corpus through a bf16 per-pair fit with the fused chain, the
    bf16 chain and the hot rows, on the CPU: within-topic cosines ~0.99, across ~0.07
    (the float32 fit: 0.99 and 0.06)."""
    from glint_word2vec_torch import Word2Vec

    topics = (["a", "b", "c"], ["x", "y", "z"])
    rng = np.random.default_rng(0)
    sents = [[t[j] for j in rng.integers(0, 3, 12)] for _ in range(400) for t in topics]
    est = Word2Vec(vector_size=16, pairs_per_batch=128, learning_rate=0.01, min_count=1,
                   num_iterations=8, subsample_ratio=0.0, fused_logits=True,
                   bf16_chain=True, hot_rows=4, device="cpu", **BF16_KNOBS)
    m = est.fit(sents)
    assert est.trainer.params.syn0.dtype == BF and est.trainer._hot_rows == 4
    v = {w: m.transform(w) for w in "abcxyz"}
    cos = lambda p, q: float(np.dot(v[p], v[q]) / np.linalg.norm(v[p]) /  # noqa: E731
                             np.linalg.norm(v[q]))
    within = min(cos("a", "b"), cos("a", "c"), cos("x", "y"), cos("x", "z"))
    across = max(cos("a", "x"), cos("b", "y"), cos("c", "z"))
    assert within > 0.9 and across < 0.3, (within, across)


def test_bf16_semantic_gates_toy_corpus(toy_corpus_path):
    """tests/test_integration_toy.py's bf16 gates on the reference toy corpus."""
    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.data.vocab import read_corpus

    fit = dict(vector_size=100, learning_rate=0.025, window=5, negatives=5, min_count=5,
               pairs_per_batch=256, seed=1, subsample_ratio=3e-3, num_iterations=4)
    m = Word2Vec(**fit, param_dtype="bfloat16", compute_dtype="bfloat16",
                 device="cpu").fit(list(read_corpus(toy_corpus_path)))
    syns = dict(m.find_synonyms("österreich", 10))
    assert "wien" in syns and syns["wien"] > 0.9
    vecs = m.transform_sentences([["österreich"], ["deutschland"], ["wien"], ["berlin"]])
    res = dict(m.find_synonyms(vecs[2] - vecs[0] + vecs[1], 10))
    assert "berlin" in res and res["berlin"] > 0.9


# -- the update limit of ops/bf16_check (the card's check of the fused kernel) -----------


def test_bf16_check_ulp_is_the_bf16_spacing():
    x = torch.tensor([1.0, 1.5, 0.75, -3.0, 2.0 ** -20, 0.0])
    want = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -8, 2.0 ** -6, 2.0 ** -27, 0.0],
                        dtype=torch.float64)
    assert torch.equal(bf16_check.bf16_ulp(x), want)
    v = torch.from_numpy(np.random.default_rng(0).normal(0, 3, 1000)).to(BF)
    u = bf16_check.bf16_ulp(v)
    up = v.double() + u * torch.sign(v.double())  # one step away from zero: on the grid
    assert torch.equal(up.to(BF).double(), up)
    assert torch.equal((v.double() + u / 8).to(BF), v)


@pytest.mark.parametrize("form", list(bf16_check.FORMS))
def test_bf16_check_update_limit_tells_bf16_from_f32_compute(form):
    """Limit 2 of ``ops/bf16_check`` on the plain step's update rows, on the CPU: the
    rows of the form's dtypes pass against themselves, and the same rows computed in
    f32 (the control's arithmetic) and rounded to bf16 break the limit."""
    rng = np.random.default_rng(5)
    V, D, B, P = 4096, 64, 512, 64
    pd, cd, ld, fz, ch = bf16_check.FORMS[form]
    pd, cd, ld = (getattr(torch, t) for t in (pd, cd, ld))
    p0, p1 = (torch.from_numpy(rng.normal(0, 0.35, (V, D)).astype(np.float32)).to(pd)
              for _ in range(2))
    c, x = (torch.from_numpy((rng.zipf(1.1, B) - 1) % V) for _ in range(2))
    neg = torch.from_numpy((rng.zipf(1.1, P) - 1) % V)
    mask = torch.ones(B)
    mask[-20:] = 0.0
    live = mask > 0

    def rows(compute, logits):
        d_in, d_pos, d_Z, _ = tsgns._shared_pool_updates(
            p0, p1, c, x, mask, neg, ALPHA, NEG, "exact", torch.matmul, False, None,
            compute, logits, fz, ch)
        return torch.cat([d_in[live], d_pos[live], d_Z]).to(BF)

    plain = rows(cd, ld)
    unit = bf16_check.bf16_ulp(plain)
    same = bf16_check.update_agreement(plain, plain, unit)
    assert same["compared"] > 0.9 * plain.numel() and same["differ_share"] == 0.0
    assert bf16_check.passes(same)
    control = bf16_check.update_agreement(rows(torch.float32, torch.float32), plain, unit)
    assert not bf16_check.passes(control)
    assert control["differ_share"] > 10 * bf16_check.DIFFER_SHARE, control
