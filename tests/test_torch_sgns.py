"""The port's plain shared-pool step (and the fused wrapper's CPU path) against the
JAX package's ``sgns_step_shared_core`` and, where their semantics coincide, its
Pallas kernel in interpret mode.

Tolerance: atol 1e-5 on parameters and rtol 1e-5 on the loss. The two packages
reassociate the f32 products and the duplicate-row scatter sums differently. The
Zipf-hottest row takes ~130 summed updates of magnitude ~0.4 per step (params of scale
0.5, so that logits pass +-6), and reordering such a sum moves it by up to
~130 · 0.4 · 1.2e-7 (f32 epsilon) = 6e-6; the largest difference measured here was
6.7e-6 on that row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glint_word2vec_torch import interop
from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_tpu.ops import sgns as jsgns
from glint_word2vec_tpu.ops.pallas.sgns_kernel import make_pallas_sgns_step

ATOL = 1e-5
LOSS_RTOL = 1e-5
N_NEG = 5


def _inputs(seed, V=1024, D=128, Dreal=128, B=512, P=64, masked=37, distinct=False):
    """Zipf-duplicated centers/contexts/pool (or distinct ones), pool entries equal
    to some contexts, a masked zero-index tail, params big enough that some logits
    pass +-6 (so the clipped sigmoid saturates)."""
    rng = np.random.default_rng(seed)
    syn0 = np.zeros((V, D), np.float32)
    syn1 = np.zeros((V, D), np.float32)
    syn0[:, :Dreal] = rng.normal(0, 0.5, (V, Dreal))
    syn1[:, :Dreal] = rng.normal(0, 0.5, (V, Dreal))
    if distinct:
        centers = rng.permutation(V)[:B]
        contexts = rng.permutation(V)[:B]
    else:
        centers = (rng.zipf(1.3, B) - 1) % V
        contexts = (rng.zipf(1.3, B) - 1) % V
    negatives = (rng.zipf(1.3, P) - 1) % V
    negatives[:8] = contexts[:8]
    mask = np.ones(B, np.float32)
    if masked:
        mask[-masked:] = 0.0
        centers[-masked:] = 0
        contexts[-masked:] = 0
    return (syn0, syn1, centers.astype(np.int32), contexts.astype(np.int32), mask,
            negatives.astype(np.int32))


def _jax_step(inp, alpha, mode, with_metrics):
    syn0, syn1, c, x, m, neg = inp
    params, met = jsgns.sgns_step_shared_core(
        jsgns.EmbeddingPair(jnp.asarray(syn0), jnp.asarray(syn1)), jnp.asarray(c),
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(neg), jnp.float32(alpha), N_NEG,
        mode, with_metrics=with_metrics)
    return np.asarray(params.syn0), np.asarray(params.syn1), met


def _torch_args(inp):
    syn0, syn1, c, x, m, neg = inp
    return (interop.params_from_numpy(syn0, syn1), torch.from_numpy(c).long(),
            torch.from_numpy(x).long(), torch.from_numpy(m), torch.from_numpy(neg).long())


def _close_metrics(tm, jm, with_metrics):
    assert float(tm.pairs) == float(jm.pairs)
    if with_metrics:
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm.mean_f_pos), float(jm.mean_f_pos),
                                   rtol=LOSS_RTOL, atol=1e-6)
    else:
        assert float(tm.loss) == 0.0 and float(tm.mean_f_pos) == 0.0


@pytest.mark.parametrize("mode", ["exact", "clipped"])
@pytest.mark.parametrize("with_metrics", [True, False])
@pytest.mark.parametrize("Dreal", [128, 100])  # 100: lane-padded to 128, zero columns
def test_plain_step_matches_jax(mode, with_metrics, Dreal):
    inp = _inputs(seed=Dreal, Dreal=Dreal)
    alpha = 0.025
    j0, j1, jm = _jax_step(inp, alpha, mode, with_metrics)
    params, c, x, m, neg = _torch_args(inp)
    new, tm = tsgns.sgns_step_shared_core(params, c, x, m, neg, alpha, N_NEG, mode,
                                          with_metrics)
    np.testing.assert_allclose(new.syn0.numpy(), j0, atol=ATOL, rtol=0)
    np.testing.assert_allclose(new.syn1.numpy(), j1, atol=ATOL, rtol=0)
    _close_metrics(tm, jm, with_metrics)
    # padded columns stay exactly zero
    assert not new.syn0[:, Dreal:].any() and not new.syn1[:, Dreal:].any()
    # the step really moved the duplicated rows
    assert np.abs(new.syn0.numpy() - inp[0]).max() > 1e-3


@pytest.mark.parametrize("mode", ["exact", "clipped"])
def test_fused_wrapper_cpu_path_is_plain_in_place(mode):
    inp = _inputs(seed=5)
    params, c, x, m, neg = _torch_args(inp)
    want, wm = tsgns.sgns_step_shared_core(params, c, x, m, neg, 0.02, N_NEG, mode)
    before = fused_sgns_shared_step.launches
    got = fused_sgns_shared_step(params, c, x, m, neg, 0.02, N_NEG, mode)
    assert fused_sgns_shared_step.launches == before  # no kernel on the CPU
    assert torch.equal(params.syn0, want.syn0) and torch.equal(params.syn1, want.syn1)
    assert float(got.loss) == float(wm.loss)


def test_fused_wrapper_checks_inputs():
    params, c, x, m, neg = _torch_args(_inputs(seed=6))
    with pytest.raises(TypeError):
        fused_sgns_shared_step(params, c.int(), x, m, neg, 0.02, N_NEG)
    with pytest.raises(ValueError):
        fused_sgns_shared_step(params, c[:-1], x, m, neg, 0.02, N_NEG)
    with pytest.raises(ValueError):
        fused_sgns_shared_step(params, c, x, m, neg[:0], 0.02, N_NEG)


@pytest.mark.parametrize("mode", ["exact", "clipped"])
def test_plain_step_matches_pallas_kernel_interpret(mode):
    """Distinct centers and distinct contexts: the Pallas kernel's in-tile
    last-wins writes then coincide with the sum semantics the port implements."""
    inp = _inputs(seed=9, V=512, B=128, P=64, masked=0, distinct=True)
    syn0, syn1, c, x, m, neg = inp
    inner = make_pallas_sgns_step(N_NEG, 64, mode, jnp.float32, tile=64, interpret=True)
    jparams, jm = inner(jsgns.EmbeddingPair(jnp.asarray(syn0), jnp.asarray(syn1)),
                        {"centers": jnp.asarray(c), "contexts": jnp.asarray(x),
                         "mask": jnp.asarray(m)}, jnp.asarray(neg), jnp.float32(0.03))
    params, tc, tx, tmask, tneg = _torch_args(inp)
    new, tm = tsgns.sgns_step_shared_core(params, tc, tx, tmask, tneg, 0.03, N_NEG, mode)
    np.testing.assert_allclose(new.syn0.numpy(), np.asarray(jparams.syn0), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(new.syn1.numpy(), np.asarray(jparams.syn1), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=LOSS_RTOL)


def test_alpha_schedule_matches():
    for w in (0.0, 10.0, 999.0, 5000.0):
        assert tsgns.alpha_schedule(w, 1001.0, 0.025) == jsgns.alpha_schedule(
            w, 1001.0, 0.025)
