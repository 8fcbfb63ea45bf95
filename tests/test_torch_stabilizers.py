"""The port's in-step stabilizers (``max_row_norm``, ``update_clip``, ``row_l2``) and
``duplicate_scaling`` on every single-device step, against NumPy float64 oracles and the
JAX package's functions, and through the trainer, the estimator and the config.

Float64: each step meets its NumPy oracle (the shared-pool one is the JAX suite's own,
tests/test_stabilizers.py) to 1e-12, on inputs with 300x-blown rows that the clamp
must catch, masked slots pointing at blown rows (the sentinel gating must keep them out
of the touched set) and a blown row no slot touches (bit for bit unchanged). Against the
JAX functions under ``jax.enable_x64(True)`` the tolerance is ``JAX_F64_ATOL``, and the
JAX function is held to the same oracle within it: the JAX steps round f_pos (and the
per-example f_neg) to float32 and take the sigmoid coefficients there even in float64
(``.astype(jnp.float32)``), so each coefficient carries an absolute error up to
α·2^-24 (``1 − σ`` cancels in float32 near σ = 1), which rows of up to ~600 (the blown
ones) over a few occurrences carry into the parameters; the port keeps float64
throughout. Fits: float32, parameters within 1e-5 of the JAX trainer's
(tests/test_torch_device_feed.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import Word2Vec as TWord2Vec
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.ops import cbow_banded as tband
from glint_word2vec_torch.ops import pairgen as tpg
from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_torch.ops.scatter import scatter_add_rows_reference
from glint_word2vec_torch.train import trainer as ttrainer
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data.hashrng import STREAM_WINDOW, stream_base
from glint_word2vec_tpu.data.pipeline import pack_halo_token_blocks as j_pack_halo
from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
from glint_word2vec_tpu.ops import cbow_banded as jband
from glint_word2vec_tpu.ops import sgns as jsgns
from glint_word2vec_tpu.train.trainer import Trainer as JTrainer
from test_stabilizers import _np_shared_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


ORACLE_TOL = 1e-12
JAX_F64_ATOL = 2e-6   # α·2^-24 · |row| ~600 · a few occurrences (module docstring)
PARAM_ATOL = 1e-5
N_NEG = 3
ALPHA = 0.05
V, D, B, P, C, W = 60, 12, 24, 8, 6, 3
BLOWN0, BLOWN1, UNTOUCHED = 40, 41, V - 2

STABS = [
    tsgns.Stabilizers(),                                        # all off
    tsgns.Stabilizers(max_row_norm=5.0),                        # clamp only
    tsgns.Stabilizers(update_clip=0.05),                        # clip only
    tsgns.Stabilizers(row_l2=1e-3),                             # decay only
    tsgns.Stabilizers(max_row_norm=5.0, update_clip=0.05, row_l2=1e-3),
    tsgns.Stabilizers(max_row_norm=1e6),                        # present, no row hit
]
STAB_IDS = ["off", "clamp", "clip", "decay", "all", "clamp-nohit"]
STEPS = ["per_pair", "shared", "shared_scatter", "cbow", "cbow_shared", "banded"]


# -- NumPy float64 oracles -----------------------------------------------------------


def _sig(x):
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def _clip(d, clip):
    if not clip:
        return d
    nrm = np.linalg.norm(d, axis=-1, keepdims=True)
    return d * np.minimum(1.0, clip / np.maximum(nrm, 1e-30))


def _post(mats_idx, alpha, stab):
    for mat, idx in mats_idx:
        idx = np.unique(idx)
        rows = mat[idx]
        scale = np.ones(len(idx))
        if stab.row_l2:
            scale = scale * (1.0 - alpha * stab.row_l2)
        if stab.max_row_norm:
            nrm = np.linalg.norm(rows, axis=-1) * scale
            scale = scale * np.minimum(1.0, stab.max_row_norm / np.maximum(nrm, 1e-30))
        mat[idx] = rows * scale[:, None]


def _np_per_pair(syn0, syn1, c, x, mask, negs, alpha, stab, dup=False):
    e_in, e_pos, e_neg = syn0[c], syn1[x], syn1[negs]
    nv = (negs != x[:, None]) * mask[:, None]
    g_pos = (1.0 - _sig((e_in * e_pos).sum(-1))) * alpha * mask
    g_neg = -_sig(np.einsum("bd,bnd->bn", e_in, e_neg)) * alpha * nv
    gpi = gpo = g_pos
    gni = gno = g_neg
    if dup:
        cnt0 = np.bincount(c, mask, V)
        cnt1 = np.bincount(x, mask, V) + np.bincount(negs.ravel(), nv.ravel(), V)
        gpi, gni = g_pos / np.maximum(cnt0[c], 1), g_neg / np.maximum(cnt0[c], 1)[:, None]
        gpo, gno = g_pos / np.maximum(cnt1[x], 1), g_neg / np.maximum(cnt1[negs], 1)
    d_in = _clip(gpi[:, None] * e_pos + np.einsum("bn,bnd->bd", gni, e_neg),
                 stab.update_clip)
    d_pos = _clip(gpo[:, None] * e_in, stab.update_clip)
    d_neg = _clip(gno[..., None] * e_in[:, None, :], stab.update_clip)
    s0, s1 = syn0.copy(), syn1.copy()
    np.add.at(s0, c, d_in)
    np.add.at(s1, x, d_pos)
    np.add.at(s1, negs.ravel(), d_neg.reshape(-1, syn0.shape[1]))
    if stab.post_pass and mask.sum() > 0:
        live = mask > 0
        _post([(s0, c[live]), (s1, np.concatenate([x[live], negs[live].ravel()]))],
              alpha, stab)
    return s0, s1


def _np_cbow(syn0, syn1, c, ctx, cm, mask, negs, alpha, stab, pool, dup=False,
             syn0_touched=None, enable=None):
    """Scatter CBOW (per-example negatives [B, n], or a pool [P] with ``pool``);
    ``syn0_touched`` replaces the live context slots as syn0's touched set (banded)."""
    cnt = cm.sum(1)
    ctx_n = np.maximum(cnt, 1)
    hidden = (syn0[ctx] * cm[..., None]).sum(1) / ctx_n[:, None]
    has = (cnt > 0).astype(float)
    live = mask * has
    e_out = syn1[c]
    g_pos = (1.0 - _sig((hidden * e_out).sum(-1))) * alpha * live
    if pool:
        Z = syn1[negs]
        nv = (negs[None, :] != c[:, None]) * mask[:, None]
        g_neg = -_sig(hidden @ Z.T) * alpha * nv * has[:, None] * (N_NEG / len(negs))
        d_hidden = g_pos[:, None] * e_out + g_neg @ Z
    else:
        e_neg = syn1[negs]
        nv = (negs != c[:, None]) * mask[:, None]
        g_neg = -_sig(np.einsum("bd,bnd->bn", hidden, e_neg)) * alpha * nv * has[:, None]
        d_hidden = g_pos[:, None] * e_out + np.einsum("bn,bnd->bd", g_neg, e_neg)
    ctx_scale, gpo, gno = np.ones(ctx.shape), g_pos, g_neg
    if dup:
        lctx = cm * live[:, None]
        cnt0 = np.bincount(ctx.ravel(), lctx.ravel(), V)
        cnt1 = np.bincount(c, live, V) + np.bincount(negs.ravel(),
                                                     (nv * has[:, None]).ravel(), V)
        ctx_scale = 1.0 / np.maximum(cnt0[ctx], 1)
        gpo, gno = g_pos / np.maximum(cnt1[c], 1), g_neg / np.maximum(cnt1[negs], 1)
    d_hidden = _clip(d_hidden, stab.update_clip)
    d_out = _clip(gpo[:, None] * hidden, stab.update_clip)
    d_ctx = (d_hidden / ctx_n[:, None])[:, None, :] * cm[..., None] * ctx_scale[..., None]
    s0, s1 = syn0.copy(), syn1.copy()
    np.add.at(s0, ctx.ravel(), d_ctx.reshape(-1, syn0.shape[1]))
    np.add.at(s1, c, d_out)
    if pool:
        np.add.at(s1, negs, g_neg.T @ hidden)
    else:
        d_neg = _clip(gno[..., None] * hidden[:, None, :], stab.update_clip)
        np.add.at(s1, negs.ravel(), d_neg.reshape(-1, syn0.shape[1]))
    on = mask.sum() > 0 if enable is None else enable
    if stab.post_pass and on:
        t0 = ctx[(cm * live[:, None]) > 0] if syn0_touched is None else syn0_touched
        t1 = np.concatenate([c[live > 0], negs if pool else negs[mask > 0].ravel()])
        _post([(s0, t0), (s1, t1)], alpha, stab)
    return s0, s1


# -- inputs ---------------------------------------------------------------------------


def _inputs(step, seed=0):
    """Parameters with blown rows (BLOWN0 in syn0 and BLOWN1 in syn1, touched; UNTOUCHED
    in syn0, touched by nothing), a batch whose masked tail points at the blown rows,
    and each step's own index layout."""
    rng = np.random.default_rng(seed)
    syn0 = rng.normal(0, 0.5, (V, D))
    syn1 = rng.normal(0, 0.5, (V, D))
    syn0[BLOWN0] *= 300.0
    syn1[BLOWN1] *= 300.0
    syn0[UNTOUCHED] *= 500.0
    mask = (np.arange(B) < B - 4).astype(np.float64)
    c = rng.integers(0, 38, B)
    inp = dict(syn0=syn0, syn1=syn1, mask=mask)
    if step == "banded":
        lens = rng.integers(1, 9, 12)
        toks = rng.integers(0, 38, lens.sum())
        toks[3] = BLOWN0
        starts = np.zeros(toks.shape[0], bool)
        starts[np.concatenate([[0], np.cumsum(lens)[:-1]])] = True
        T = toks.shape[0] + 2 * W + 4
        ((tb, bits, nv, ob, _),) = list(j_pack_halo([(toks, starts)], T, W, np.int32))
        band = tpg.device_cbow_windows(
            torch.from_numpy(tb).long(), torch.from_numpy(bits), nv, ob & 0xFFFFFFFF,
            ob >> 32, int(stream_base(7, STREAM_WINDOW, 1, 0)), W, W)
        negs = rng.integers(0, 38, P)
        negs[0] = BLOWN1
        inp.update(tokens=tb.astype(np.int64), band=band, negs=negs)
        return inp
    if step in ("per_pair", "shared", "shared_scatter"):
        x = rng.integers(0, 38, B)
        c[0], x[1] = BLOWN0, BLOWN1
        c[B - 1], x[B - 1] = BLOWN0, BLOWN1       # masked slots at the blown rows
        negs = (rng.integers(0, 38, (B, N_NEG)) if step == "per_pair"
                else rng.integers(0, 38, P))
        if step == "per_pair":
            negs[2, 0] = x[2]                     # a negative equal to its context
            negs[B - 2] = UNTOUCHED - 1           # a masked pair's negatives
        else:
            negs[0] = x[3]
        inp.update(c=c, x=x, negs=negs)
        return inp
    nctx = rng.integers(0, C + 1, B)
    nctx[:3] = 0                                  # examples without context
    cm = (np.arange(C)[None, :] < nctx[:, None]).astype(np.float64)
    ctx = np.where(cm > 0, rng.integers(0, 38, (B, C)), 0)
    ctx[5, 0], cm[5, 0] = BLOWN0, 1.0
    c[6] = BLOWN1
    cm[B - 4:] = 0.0                              # the masked tail: no live context
    ctx[B - 1, 0] = BLOWN0
    c[B - 1] = BLOWN1
    negs = (rng.integers(0, 38, (B, N_NEG)) if step == "cbow"
            else rng.integers(0, 38, P))
    inp.update(c=c, ctx=ctx, cm=cm, negs=negs)
    return inp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_port(step, inp, stab, dup=False, dtype=torch.float64, scatter=None):
    """The port's step on ``inp``; returns (syn0, syn1) as numpy and the metrics."""
    scatter = scatter or scatter_add_rows_reference
    p = tsgns.EmbeddingPair(_t(inp["syn0"]).to(dtype).clone(),
                            _t(inp["syn1"]).to(dtype).clone())
    mask = _t(inp["mask"]).to(dtype)
    negs = _t(inp["negs"])
    kw = dict(stabilizers=stab)
    if step == "per_pair":
        m = tsgns.sgns_step_core(p, _t(inp["c"]), _t(inp["x"]), mask, negs, ALPHA,
                                 "exact", scatter, duplicate_scaling=dup, **kw)
    elif step == "shared":
        p, m = tsgns.sgns_step_shared_core(p, _t(inp["c"]), _t(inp["x"]), mask, negs,
                                           ALPHA, N_NEG, duplicate_scaling=dup, **kw)
    elif step == "shared_scatter":
        m = tsgns.sgns_step_shared_scatter_(p, _t(inp["c"]), _t(inp["x"]), mask, negs,
                                            ALPHA, N_NEG, "exact", True, scatter,
                                            duplicate_scaling=dup, **kw)
    elif step == "cbow":
        m = tsgns.cbow_step_core(p, _t(inp["c"]), _t(inp["ctx"]), _t(inp["cm"]).to(dtype),
                                 mask, negs, ALPHA, "exact", scatter,
                                 duplicate_scaling=dup, **kw)
    elif step == "cbow_shared":
        m = tsgns.cbow_step_shared_core(p, _t(inp["c"]), _t(inp["ctx"]),
                                        _t(inp["cm"]).to(dtype), mask, negs, ALPHA, N_NEG,
                                        "exact", True, scatter, **kw)
    else:
        band = inp["band"]
        m = tband.cbow_step_banded_core(
            p, _t(inp["tokens"]), band.left, band.right, band.center.to(dtype),
            band.token.to(dtype), negs, ALPHA, N_NEG, W, "exact", True, scatter,
            endpoint="scatter", **kw)
    return p.syn0.numpy(), p.syn1.numpy(), m


def _banded_examples(inp):
    """The banded block as the scatter CBOW's example set: each live slot's context
    interval as a left-packed window."""
    band, tb = inp["band"], inp["tokens"]
    left, right = band.left.numpy(), band.right.numpy()
    live = np.flatnonzero((band.center.numpy() > 0) & (left + right > 0))
    ctx = np.zeros((live.size, 2 * W), np.int64)
    cm = np.zeros((live.size, 2 * W))
    for i, b in enumerate(live):
        idx = list(range(b - left[b], b)) + list(range(b + 1, b + right[b] + 1))
        ctx[i, :len(idx)] = tb[idx]
        cm[i, :len(idx)] = 1.0
    return tb[live], ctx, cm, live


def _run_oracle(step, inp, stab, dup=False):
    s0, s1 = inp["syn0"], inp["syn1"]
    if step == "per_pair":
        return _np_per_pair(s0, s1, inp["c"], inp["x"], inp["mask"], inp["negs"], ALPHA,
                            stab, dup)
    if step in ("shared", "shared_scatter"):
        if dup:
            pytest.skip("the shared-pool oracle has no duplicate scaling (the JAX "
                        "function holds it)")
        return _np_shared_step(s0, s1, inp["c"], inp["x"], inp["mask"], inp["negs"],
                               ALPHA, N_NEG, stab)
    if step in ("cbow", "cbow_shared"):
        return _np_cbow(s0, s1, inp["c"], inp["ctx"], inp["cm"], inp["mask"],
                        inp["negs"], ALPHA, stab, step == "cbow_shared", dup)
    centers, ctx, cm, _ = _banded_examples(inp)
    valid = inp["band"].token.numpy() > 0
    return _np_cbow(s0, s1, centers, ctx, cm, np.ones(centers.size), inp["negs"], ALPHA,
                    stab, True, syn0_touched=inp["tokens"][valid], enable=valid.any())


def _run_jax(step, inp, stab, dup=False):
    f64 = jnp.float64
    stab_j = jsgns.Stabilizers(*stab) if stab.enabled else None
    with jax.enable_x64(True):
        p = jsgns.EmbeddingPair(jnp.asarray(inp["syn0"]), jnp.asarray(inp["syn1"]))
        mask, negs, a = jnp.asarray(inp["mask"]), jnp.asarray(inp["negs"]), f64(ALPHA)
        if step == "per_pair":
            out, _ = jsgns.sgns_step_core(p, jnp.asarray(inp["c"]), jnp.asarray(inp["x"]),
                                          mask, negs, a, "exact", f64, dup,
                                          stabilizers=stab_j)
        elif step in ("shared", "shared_scatter"):
            out, _ = jsgns.sgns_step_shared_core(
                p, jnp.asarray(inp["c"]), jnp.asarray(inp["x"]), mask, negs, a, N_NEG,
                "exact", f64, dup, f64, True, stabilizers=stab_j)
        elif step == "cbow":
            out, _ = jsgns.cbow_step_core(p, jnp.asarray(inp["c"]), jnp.asarray(inp["ctx"]),
                                          jnp.asarray(inp["cm"]), mask, negs, a, "exact",
                                          f64, dup, stabilizers=stab_j)
        elif step == "cbow_shared":
            out, _ = jsgns.cbow_step_shared_core(
                p, jnp.asarray(inp["c"]), jnp.asarray(inp["ctx"]), jnp.asarray(inp["cm"]),
                mask, negs, a, N_NEG, "exact", f64, f64, True, stabilizers=stab_j)
        else:
            band = inp["band"]
            out, _ = jband.cbow_step_banded_core(
                p, jnp.asarray(inp["tokens"]), jnp.asarray(band.left.numpy()),
                jnp.asarray(band.right.numpy()), jnp.asarray(band.center.numpy(), f64),
                jnp.asarray(band.token.numpy(), f64), negs, a, N_NEG, W, "exact", f64,
                f64, True, stabilizers=stab_j)
        return np.asarray(out.syn0), np.asarray(out.syn1)


# -- the steps against the oracles and the JAX functions -------------------------------


@pytest.mark.parametrize("stab", STABS, ids=STAB_IDS)
@pytest.mark.parametrize("step", STEPS)
def test_step_matches_numpy_oracle_f64(step, stab):
    inp = _inputs(step)
    got0, got1, _ = _run_port(step, inp, stab if stab.enabled else None)
    ref0, ref1 = _run_oracle(step, inp, stab)
    np.testing.assert_allclose(got0, ref0, rtol=ORACLE_TOL, atol=ORACLE_TOL)
    np.testing.assert_allclose(got1, ref1, rtol=ORACLE_TOL, atol=ORACLE_TOL)
    # the blown row no slot touches is bit for bit unchanged: no dense pass
    assert np.array_equal(got0[UNTOUCHED], inp["syn0"][UNTOUCHED])
    if stab.max_row_norm:
        norms = np.linalg.norm(got0, axis=1)
        assert norms[BLOWN0] <= stab.max_row_norm * (1 + 1e-9)


@pytest.mark.parametrize("stab", STABS, ids=STAB_IDS)
@pytest.mark.parametrize("step", STEPS)
def test_step_matches_jax_f64(step, stab):
    inp = _inputs(step, seed=1)
    got0, got1, _ = _run_port(step, inp, stab if stab.enabled else None)
    ref0, ref1 = _run_jax(step, inp, stab)
    np.testing.assert_allclose(got0, ref0, rtol=0, atol=JAX_F64_ATOL)
    np.testing.assert_allclose(got1, ref1, rtol=0, atol=JAX_F64_ATOL)
    o0, o1 = _run_oracle(step, inp, stab)   # the JAX function meets the oracle too
    np.testing.assert_allclose(ref0, o0, rtol=0, atol=JAX_F64_ATOL)
    np.testing.assert_allclose(ref1, o1, rtol=0, atol=JAX_F64_ATOL)


@pytest.mark.parametrize("stab", [STABS[0], STABS[4]], ids=["off", "all"])
@pytest.mark.parametrize("step", ["per_pair", "shared", "shared_scatter", "cbow"])
def test_duplicate_scaling_matches_jax_and_oracle(step, stab):
    """Duplicate scaling (alone and with every stabilizer) on the three steps that have
    it, the shared one in both of its forms."""
    inp = _inputs(step, seed=2)
    stab_arg = stab if stab.enabled else None
    got0, got1, _ = _run_port(step, inp, stab_arg, dup=True)
    plain0, _, _ = _run_port(step, inp, stab_arg, dup=False)
    assert np.abs(got0 - plain0).max() > 1e-6  # the scaling moved something
    ref0, ref1 = _run_jax(step, inp, stab, dup=True)
    np.testing.assert_allclose(got0, ref0, rtol=0, atol=JAX_F64_ATOL)
    np.testing.assert_allclose(got1, ref1, rtol=0, atol=JAX_F64_ATOL)
    if step not in ("shared", "shared_scatter"):
        o0, o1 = _run_oracle(step, inp, stab, dup=True)
        np.testing.assert_allclose(got0, o0, rtol=ORACLE_TOL, atol=ORACLE_TOL)
        np.testing.assert_allclose(got1, o1, rtol=ORACLE_TOL, atol=ORACLE_TOL)


@pytest.mark.parametrize("step", STEPS)
def test_knobs_off_are_bit_identical(step):
    """stabilizers=None, all-zero Stabilizers and duplicate_scaling=False run exactly the
    ops of the call without them: float32 parameters and metrics equal bit for bit."""
    inp = _inputs(step, seed=3)
    runs = [_run_port(step, inp, s, dtype=torch.float32)
            for s in (None, tsgns.Stabilizers())]
    for a, b in zip(runs[0], runs[1]):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("step", STEPS)
def test_all_masked_batch_is_a_noop(step):
    """A padded batch (every slot masked) leaves the parameters bit for bit with every
    stabilizer and duplicate scaling on: the post pass's enable pins each scale to 1."""
    inp = _inputs(step, seed=4)
    inp["mask"] = np.zeros(B)
    if step in ("cbow", "cbow_shared"):
        inp["cm"] = np.zeros_like(inp["cm"])
    if step == "banded":
        T = inp["tokens"].shape[0]
        inp["band"] = tpg.device_cbow_windows(
            torch.zeros(T, dtype=torch.int64), torch.zeros((T + 7) // 8,
                                                           dtype=torch.uint8),
            0, 0, 0, 5, W, W)
    stab = tsgns.Stabilizers(max_row_norm=0.5, update_clip=0.01, row_l2=0.5)
    dup = step in ("per_pair", "shared", "shared_scatter", "cbow")
    got0, got1, m = _run_port(step, inp, stab, dup=dup, dtype=torch.float32)
    assert np.array_equal(got0, inp["syn0"].astype(np.float32))
    assert np.array_equal(got1, inp["syn1"].astype(np.float32))
    assert float(m.pairs) == 0.0


@pytest.mark.parametrize("case", ["mixed", "duplicates", "all-sentinel", "disabled"])
def test_sentinel_slots_touch_no_other_row(case):
    """stabilize_rows_ writes exactly the rows the JAX pass writes (its sentinel slots
    drop); a call with every slot a sentinel, or enable 0, changes nothing."""
    rng = np.random.default_rng(5)
    mat = rng.normal(0, 3.0, (V, D))
    idx = rng.integers(0, V, 20)
    gate = (rng.random(20) < 0.6).astype(np.float64)
    idx[gate == 0] = 0 if case != "mixed" else idx[gate == 0]
    enable = 1.0
    if case == "duplicates":
        idx[:10] = idx[10:]
    elif case == "all-sentinel":
        gate[:] = 0.0
    elif case == "disabled":
        enable = 0.0
    stab = tsgns.Stabilizers(max_row_norm=2.0, row_l2=0.1)
    got = torch.from_numpy(mat.copy())
    tsgns.stabilize_rows_(got, tsgns._mask_sentinel(_t(idx), _t(gate), V), 0.05, stab,
                          torch.tensor(enable))
    with jax.enable_x64(True):
        want = np.asarray(jsgns.stabilize_rows(
            jnp.asarray(mat), jsgns._mask_sentinel(jnp.asarray(idx), jnp.asarray(gate), V),
            jnp.float64(0.05), jsgns.Stabilizers(2.0, 0.0, 0.1), jnp.float64(enable)))
    np.testing.assert_allclose(got.numpy(), want, rtol=ORACLE_TOL, atol=ORACLE_TOL)
    changed = np.flatnonzero((got.numpy() != mat).any(1))
    touched = np.unique(idx[gate > 0]) if enable and gate.any() else np.empty(0, int)
    assert set(changed) <= set(touched)
    if case in ("all-sentinel", "disabled"):
        assert np.array_equal(got.numpy(), mat)
    else:
        assert changed.size > 3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_clip_update_rows_matches_jax(dtype):
    rng = np.random.default_rng(6)
    d = (rng.normal(0, 1, (40, D)) * rng.choice([0.0, 1e-3, 1.0, 50.0], (40, 1))
         ).astype(dtype)
    got = tsgns.clip_update_rows(torch.from_numpy(d), 0.25).numpy()
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jsgns.clip_update_rows(jnp.asarray(d), 0.25))
    np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == np.float32 else 1e-14,
                               atol=0)
    short = np.linalg.norm(d.astype(np.float64), axis=1) <= 0.25
    assert np.array_equal(got[short], d[short])   # short rows pass bit for bit
    assert (np.linalg.norm(got.astype(np.float64), axis=1) <= 0.25 * (1 + 1e-6)).all()
    assert tsgns.clip_update_rows(torch.from_numpy(d), 0.0) is not None


def test_update_clip_bounds_single_pair_delta():
    """No duplicates, clamp and decay off: ||new_row − old_row|| <= clip, at an absurd
    learning rate, on the in-place scatter form of the shared step."""
    rng = np.random.default_rng(1)
    syn0 = torch.from_numpy(rng.normal(0, 5.0, (20, 8)).astype(np.float32))
    syn1 = torch.from_numpy(rng.normal(0, 5.0, (20, 8)).astype(np.float32))
    p = tsgns.EmbeddingPair(syn0.clone(), syn1.clone())
    tsgns.sgns_step_shared_scatter_(p, torch.tensor([3]), torch.tensor([7]),
                                    torch.ones(1), torch.tensor([11, 12]), 5.0, 3,
                                    stabilizers=tsgns.Stabilizers(update_clip=0.25))
    assert float((p.syn0[3] - syn0[3]).norm()) <= 0.25 * (1 + 1e-5)
    assert float((p.syn1[7] - syn1[7]).norm()) <= 0.25 * (1 + 1e-5)


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
                negative_pool=16)
    base.update(kw)
    return base


STAB_KNOBS = dict(max_row_norm=0.05, update_clip=0.01, row_l2=1e-2)


@pytest.mark.parametrize("extra", [
    dict(STAB_KNOBS),
    dict(STAB_KNOBS, negative_pool=0),
    dict(STAB_KNOBS, cbow=True),
    dict(STAB_KNOBS, cbow=True, negative_pool=0),
    dict(duplicate_scaling=True),
    dict(duplicate_scaling=True, negative_pool=0),
    dict(duplicate_scaling=True, cbow=True, negative_pool=0),
    dict(STAB_KNOBS, duplicate_scaling=True, negative_pool=0),
], ids=["shared-stab", "per_pair-stab", "cbow-stab", "cbow_per_example-stab",
        "shared-dup", "per_pair-dup", "cbow_per_example-dup", "per_pair-stab-dup"])
def test_fit_matches_jax(extra):
    sents = _corpus()
    knobs = _knobs(**extra)
    tvocab = t_build_vocab(sents, 1)
    enc = encode_sentences(sents, tvocab)
    rng = np.random.default_rng(0)
    syn0 = rng.uniform(-0.005, 0.005, (tvocab.size, 64)).astype(np.float32)
    syn1 = rng.normal(0, 0.01, (tvocab.size, 64)).astype(np.float32)
    jt = JTrainer(JConfig(**knobs), j_build_vocab(sents, 1),
                  params=jsgns.EmbeddingPair(jnp.asarray(syn0), jnp.asarray(syn1)))
    jt.fit(enc)
    tt = TTrainer(TConfig(**knobs), tvocab, params=(syn0, syn1), device="cpu")
    tt.fit(enc)
    assert tt.global_step == jt.global_step >= 8
    assert tt.pairs_trained == jt.pairs_trained > 0
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


@pytest.mark.parametrize("knobs,fused", [
    ({}, True), (STAB_KNOBS, False), ({"update_clip": 0.1}, False),
    ({"duplicate_scaling": True}, False),
], ids=["default", "stabilizers", "clip-only", "duplicate_scaling"])
def test_shared_pool_step_selection(knobs, fused, monkeypatch):
    """The shared-pool skip-gram step is the fused kernel's wrapper unless a stabilizer
    or duplicate scaling is on; then the in-place scatter form (selected by config, the
    JAX package's matrix, not as a fallback)."""
    calls = {"fused": 0, "scatter": 0}
    orig_f, orig_s = ttrainer.fused_sgns_shared_step, ttrainer.sgns_step_shared_scatter_

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ttrainer, "fused_sgns_shared_step", count("fused", orig_f))
    monkeypatch.setattr(ttrainer, "sgns_step_shared_scatter_", count("scatter", orig_s))
    sents = _corpus(n_sent=40)
    vocab = t_build_vocab(sents, 1)
    tt = TTrainer(TConfig(**_knobs(**knobs)), vocab, device="cpu")
    tt.fit(encode_sentences(sents, vocab))
    assert tt.global_step > 0
    assert calls == ({"fused": tt.global_step, "scatter": 0} if fused
                     else {"fused": 0, "scatter": tt.global_step})
    assert tt._stabilizers.enabled == any(k != "duplicate_scaling" for k in knobs)


# -- config, estimator, checkpoints ---------------------------------------------------


REFUSED = [
    dict(cbow_update="banded"),
    dict(cbow=True, cbow_update="banded", duplicate_scaling=True),
    dict(cbow=True, cbow_update="banded", negative_pool=0),
    dict(cbow=True, cbow_update="banded", use_pallas=True),
    dict(cbow=True, cbow_update="banded", tokens_per_step=64),
    dict(cbow=True, cbow_update="banded", window=1),
    dict(cbow=True, duplicate_scaling=True, negative_pool=256),
    dict(use_pallas=True, duplicate_scaling=True),
    dict(use_pallas=True, max_row_norm=1.0),
    dict(use_pallas=True, update_clip=1.0),
    dict(use_pallas=True, row_l2=1e-3),
    dict(use_pallas=True, cbow=True),
    dict(max_row_norm=-1.0),
    dict(update_clip=-0.5),
    dict(row_l2=1.0),
    dict(row_l2=-1e-3),
    # hot_rows and fused_logits are ported: their refusals beside the stabilizers and
    # duplicate scaling are the JAX package's
    dict(hot_rows=8, max_row_norm=1.0),
    dict(fused_logits=True, duplicate_scaling=True),
    dict(hot_rows=8, duplicate_scaling=True),
]


@pytest.mark.parametrize("kw", REFUSED, ids=lambda kw: "-".join(f"{k}={v}"
                                                                for k, v in kw.items()))
def test_refusal_matrix_matches_jax(kw):
    """Every combination of the new knobs that the JAX config refuses is refused here at
    construction with the same class and message, checkpoint readers included."""
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError) as te:
        TConfig(**kw)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError):
        TConfig(**kw, check_ported=False)


@pytest.mark.parametrize("kw,knob", [
    (dict(step_lowering="shard_map", cbow=True), "step_lowering"),
    (dict(step_lowering="shard_map", negative_pool=0), "step_lowering"),
    (dict(step_lowering="shard_map", duplicate_scaling=True), "step_lowering"),
    (dict(step_lowering="shard_map", embedding_partition="cols"), "step_lowering"),
])
def test_unported_partners_stay_refused_by_name(kw, knob):
    """Combinations with the shard_map lowering (ported since the mesh step) are refused
    through that knob with the JAX config's class and message."""
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError, match=knob) as te:
        TConfig(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(cbow=True, cbow_update="banded"),
    dict(max_row_norm=5.0, update_clip=0.05, row_l2=1e-3),
    dict(duplicate_scaling=True),
    dict(cbow=True, duplicate_scaling=True),
    dict(cbow=True, cbow_update="banded", max_row_norm=5.0),
], ids=["banded", "stabilizers", "dup", "cbow-dup", "banded-stab"])
def test_new_knobs_are_accepted_and_resolve_as_jax(kw):
    for ppb in (256, 8192):
        t, j = TConfig(pairs_per_batch=ppb, **kw), JConfig(pairs_per_batch=ppb, **kw)
        assert t.negative_pool == j.negative_pool
        assert t.to_dict() == j.to_dict()
        assert TConfig.from_dict(j.to_dict(auto_markers=False)).to_dict() == \
            JConfig.from_dict(j.to_dict(auto_markers=False)).to_dict()


@pytest.mark.parametrize("extra", [
    dict(cbow=True, cbow_update="banded", negative_pool=16),
    dict(STAB_KNOBS, negative_pool=16),
], ids=["banded", "stabilized"])
def test_jax_checkpoint_loads_checked_and_resumes(extra, tmp_path):
    """A checkpoint written mid-run by the JAX trainer with banded CBOW or the
    stabilizers loads with check_ported=True, and the port's resume ends at the JAX
    package's uninterrupted fit."""
    from glint_word2vec_torch.train.checkpoint import load_model_header
    sents = _corpus(seed=8, n_sent=120)
    knobs = _knobs(steps_per_dispatch=2, heartbeat_every_steps=4, prefetch_chunks=0,
                   **extra)
    vocab = j_build_vocab(sents, 1)
    enc = encode_sentences(sents, t_build_vocab(sents, 1))
    full = JTrainer(JConfig(**knobs), vocab)
    full.fit(enc)
    calls = {"n": 0}

    def boom(_rec):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise KeyboardInterrupt

    ck = str(tmp_path / "jck")
    with pytest.raises(KeyboardInterrupt):
        JTrainer(JConfig(**knobs), vocab).fit(
            enc, checkpoint_path=ck, checkpoint_every_steps=4, on_heartbeat=boom)
    header = load_model_header(ck)
    assert not header["train_state"].finished
    cfg = TConfig.from_dict(header["config"].to_dict(), check_ported=True)
    for k, v in extra.items():
        assert getattr(cfg, k) == v
    model = TWord2Vec.resume(ck, sents, device="cpu")
    assert model.train_state.global_step == full.global_step
    np.testing.assert_allclose(model.syn0.numpy(),
                               np.asarray(full.unpadded_params().syn0),
                               atol=PARAM_ATOL, rtol=0)


def test_estimator_passes_the_knobs_through(tmp_path):
    """Word2Vec(...) and Word2Vec.resume carry the stabilizers and duplicate scaling to
    the trainer with no code of their own."""
    sents = _corpus(seed=2, n_sent=60)
    est = TWord2Vec(device="cpu", **_knobs(num_iterations=1, **STAB_KNOBS))
    est.fit(sents, checkpoint_path=str(tmp_path / "ck"))
    assert est.trainer._stabilizers == tsgns.Stabilizers(**STAB_KNOBS)
    model = TWord2Vec.resume(str(tmp_path / "ck"), sents, device="cpu",
                             config_overrides={"num_iterations": 2,
                                               "duplicate_scaling": True})
    assert model.config.duplicate_scaling and model.config.max_row_norm == 0.05
    assert model.train_state.finished
