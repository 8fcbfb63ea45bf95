"""The shared-pool SGNS step in plain PyTorch, ported from
``glint_word2vec_tpu/ops/sgns.py`` (the spec of the port's CUDA kernel).

Update rule (SGD on the SGNS objective, pre-update values on both sides):

    f_pos = syn0[c]·syn1[x]          g_pos = (1 − σ(f_pos))·α·mask
    f_neg = syn0[c]·Z_pᵀ             g_neg = −σ(f_neg)·α·valid·n/P
    syn0[c]    += g_pos·syn1[x] + Σ_p g_neg_p·Z_p
    syn1[x]    += g_pos·syn0[c]
    syn1[z_p]  += Σ_b g_neg_bp·syn0[c_b]

with one pool Z = syn1[negatives] of P rows shared by the whole batch, each negative
term reweighted by n/P, and valid = (context ≠ pool id)·mask. Duplicate indices sum
(``index_add_``), as the JAX package's ``.at[].add`` does.

:func:`sgns_step_shared_core` is the plain version of the fused kernel
(``ops/fused_sgns.py``): the CPU path of the trainer, and what that kernel is held
against on the card.

The per-pair skip-gram step (:func:`sgns_step_core`) and the scatter CBOW steps
(:func:`cbow_step_core`, :func:`cbow_step_shared_core`) follow the JAX package's
functions of those names. They update the parameters IN PLACE and return only the
metrics: every gather happens before the first scatter, so each read sees the old
parameters, as in the JAX step, and no [V, D] matrix is copied. Every row scatter goes
through ``ops/scatter.scatter_add_rows_`` (the CUDA row-scatter kernel on the card, its
plain ``index_add_`` on the CPU), :data:`SCATTERS_PER_STEP` calls per step, each with the
step's mask as its ``live`` rows; the logit products are plain torch, as the JAX
package left them to XLA.

Only the default steps are ported (f32, no fused chain, no hot rows, no stabilizers,
no duplicate scaling).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

from glint_word2vec_torch.ops.scatter import scatter_add_rows_

MAX_EXP = 6.0  # the reference's sigmoid LUT clipping range
# scatter_add_rows_ calls per step of the in-place steps: one into syn0, one into syn1
SCATTERS_PER_STEP = 2

Scatter = Callable[..., torch.Tensor]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class EmbeddingPair(NamedTuple):
    """The two trainable matrices: input (syn0) and output (syn1neg) embeddings."""

    syn0: torch.Tensor  # [V, D]
    syn1: torch.Tensor  # [V, D]


class StepMetrics(NamedTuple):
    """Per-step telemetry: masked mean SGNS loss, mean positive logit, real pairs.
    Each is a 0-d float32 tensor on the step's device."""

    loss: torch.Tensor
    mean_f_pos: torch.Tensor
    pairs: torch.Tensor


def init_embeddings(vocab_size: int, vector_size: int,
                    generator: torch.Generator) -> EmbeddingPair:
    """Classic word2vec init on the CPU: syn0 ~ U(-0.5/D, 0.5/D), syn1 = 0. Draws
    come from ``generator`` (a CPU torch.Generator) and differ from the JAX package's,
    so tests that compare the packages inject parameters instead."""
    syn0 = torch.rand((vocab_size, vector_size), generator=generator,
                      dtype=torch.float32)
    syn0 = (syn0 - 0.5) / vector_size
    syn1 = torch.zeros((vocab_size, vector_size), dtype=torch.float32)
    return EmbeddingPair(syn0, syn1)


def _sigmoid(f: torch.Tensor, mode: str) -> torch.Tensor:
    """σ(f); "clipped" saturates to 1 above +6 and 0 below -6 (the reference LUT)."""
    s = torch.sigmoid(f)
    if mode == "clipped":
        s = torch.where(f > MAX_EXP, torch.ones_like(s),
                        torch.where(f < -MAX_EXP, torch.zeros_like(s), s))
    return s


def _log_sigmoid(f: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-f)


def shared_pool_coeffs(
    e_in: torch.Tensor,       # [B, D]
    e_pos: torch.Tensor,      # [B, D]
    Z: torch.Tensor,          # [P, D]
    contexts: torch.Tensor,   # int [B]
    negatives: torch.Tensor,  # int [P]
    mask: torch.Tensor,       # float32 [B]
    alpha: float,
    num_negatives: int,
    sigmoid_mode: str,
    *,
    matmul: MatMul = torch.matmul,
) -> Tuple[torch.Tensor, ...]:
    """The shared-pool logit chain: (f_pos, f_neg, neg_valid, g_pos, g_neg);
    ``matmul`` computes f_neg."""
    P = negatives.shape[0]
    f_pos = torch.sum(e_in * e_pos, dim=-1)
    f_neg = matmul(e_in, Z.T)                                        # [B, P]
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * mask
    neg_valid = (negatives[None, :] != contexts[:, None]).to(torch.float32) \
        * mask[:, None]
    g_neg = (0.0 - _sigmoid(f_neg, sigmoid_mode)) * alpha * neg_valid \
        * (num_negatives / P)
    return f_pos, f_neg, neg_valid, g_pos, g_neg


def shared_pool_loss_terms(
    f_pos: torch.Tensor, f_neg: torch.Tensor, neg_valid: torch.Tensor,
    mask: torch.Tensor, num_negatives: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-division numerators of the loss and of mean_f_pos (0-d tensors)."""
    P = f_neg.shape[-1]
    neg_term = torch.sum(_log_sigmoid(-f_neg) * neg_valid, dim=-1)
    loss_num = (-_log_sigmoid(f_pos) * mask - neg_term * (num_negatives / P)).sum()
    return loss_num, (f_pos * mask).sum()


def sgns_step_shared_core(
    params: EmbeddingPair,
    centers: torch.Tensor,    # int [B]
    contexts: torch.Tensor,   # int [B]
    mask: torch.Tensor,       # float32 [B]
    negatives: torch.Tensor,  # int [P] — pre-drawn shared pool
    alpha: Union[float, torch.Tensor],
    num_negatives: int,
    sigmoid_mode: str = "exact",
    with_metrics: bool = True,
    *,
    matmul: MatMul = torch.matmul,
) -> Tuple[EmbeddingPair, StepMetrics]:
    """One shared-pool SGNS step; returns NEW parameters (the inputs are untouched)
    and the step metrics. ``with_metrics=False`` skips the loss and mean_f_pos pass
    (both 0) and keeps ``pairs`` exact, like the JAX package's elided twin. The three
    products E·Zᵀ, G·Z and Gᵀ·E go through ``matmul``: ``ops.tf32.matmul_3xtf32``
    there emulates the fused kernel's tensor-core arithmetic."""
    syn0, syn1 = params
    centers = centers.long()
    contexts = contexts.long()
    negatives = negatives.long()
    e_in = syn0[centers]
    e_pos = syn1[contexts]
    Z = syn1[negatives]
    f_pos, f_neg, neg_valid, g_pos, g_neg = shared_pool_coeffs(
        e_in, e_pos, Z, contexts, negatives, mask, alpha, num_negatives, sigmoid_mode,
        matmul=matmul)
    d_in = g_pos[:, None] * e_pos + matmul(g_neg, Z)                 # [B, D]
    d_pos = g_pos[:, None] * e_in
    d_Z = matmul(g_neg.T, e_in)                                      # [P, D]
    new_syn0 = syn0.clone().index_add_(0, centers, d_in)
    new_syn1 = syn1.clone().index_add_(0, contexts, d_pos)
    new_syn1.index_add_(0, negatives, d_Z)
    pairs = mask.sum()
    if with_metrics:
        denom = torch.clamp(pairs, min=1.0)
        loss_num, fpos_num = shared_pool_loss_terms(
            f_pos, f_neg, neg_valid, mask, num_negatives)
        loss, mean_f_pos = loss_num / denom, fpos_num / denom
    else:
        loss = mean_f_pos = torch.zeros((), dtype=torch.float32, device=syn0.device)
    return EmbeddingPair(new_syn0, new_syn1), StepMetrics(loss, mean_f_pos, pairs)


def sgns_step_core(
    params: EmbeddingPair,
    centers: torch.Tensor,    # int64 [B]
    contexts: torch.Tensor,   # int64 [B]
    mask: torch.Tensor,       # float32 [B]
    negatives: torch.Tensor,  # int64 [B, n] — pre-drawn per pair
    alpha: float,
    sigmoid_mode: str = "exact",
    scatter: Scatter = scatter_add_rows_,
) -> StepMetrics:
    """One per-pair SGNS step (the reference's n negatives per pair), in place on
    ``params``. Negatives equal to their pair's context, and masked pairs, get zero
    gradient. ``scatter`` is the row scatter (the plain one only to hold the kernel
    against it)."""
    syn0, syn1 = params
    B, n = negatives.shape
    D = syn0.shape[1]
    neg_valid = (negatives != contexts[:, None]).to(torch.float32) * mask[:, None]
    e_in = syn0[centers]                                             # [B, D]
    e_pos = syn1[contexts]                                           # [B, D]
    e_neg = syn1[negatives]                                          # [B, n, D]
    f_pos = torch.sum(e_in * e_pos, dim=-1)
    f_neg = torch.einsum("bd,bnd->bn", e_in, e_neg)
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * mask
    g_neg = (0.0 - _sigmoid(f_neg, sigmoid_mode)) * alpha * neg_valid
    d_in = g_pos[:, None] * e_pos + torch.einsum("bn,bnd->bd", g_neg, e_neg)
    # syn1's update rows, contexts then negatives, written in place into one buffer
    upd1 = torch.empty((B * (1 + n), D), dtype=syn1.dtype, device=syn1.device)
    torch.mul(g_pos[:, None], e_in, out=upd1[:B])
    torch.mul(g_neg[..., None], e_in[:, None, :], out=upd1[B:].view(B, n, D))
    scatter(syn0, centers, d_in, mask)
    scatter(syn1, torch.cat([contexts, negatives.reshape(-1)]), upd1,
            torch.cat([mask, neg_valid.reshape(-1)]))
    denom = torch.clamp(mask.sum(), min=1.0)
    neg_loss = torch.sum(_log_sigmoid(-f_neg) * neg_valid, dim=-1)
    loss = (-_log_sigmoid(f_pos) * mask - neg_loss).sum() / denom
    return StepMetrics(loss, (f_pos * mask).sum() / denom, mask.sum())


def _cbow_hidden(syn0: torch.Tensor, contexts: torch.Tensor, ctx_mask: torch.Tensor):
    """(hidden [B, D], ctx_n [B], has_ctx [B]): the mean of the live context rows."""
    ctx_count = ctx_mask.sum(dim=-1)
    ctx_n = torch.clamp(ctx_count, min=1.0)
    hidden = torch.einsum("bc,bcd->bd", ctx_mask, syn0[contexts]) / ctx_n[:, None]
    return hidden, ctx_n, (ctx_count > 0).to(torch.float32)


def _scatter_cbow_contexts(syn0: torch.Tensor, contexts: torch.Tensor,
                           ctx_mask: torch.Tensor, mask: torch.Tensor,
                           d_hidden: torch.Tensor, ctx_n: torch.Tensor,
                           scatter: Scatter) -> None:
    """Mean convention: each live context slot gets d_hidden / |context|."""
    D = syn0.shape[1]
    d_ctx = (d_hidden / ctx_n[:, None])[:, None, :] * ctx_mask[..., None]  # [B, C, D]
    scatter(syn0, contexts.reshape(-1), d_ctx.reshape(-1, D),
            (ctx_mask * mask[:, None]).reshape(-1))


def cbow_step_core(
    params: EmbeddingPair,
    centers: torch.Tensor,    # int64 [B]
    contexts: torch.Tensor,   # int64 [B, C] — context window, left-packed
    ctx_mask: torch.Tensor,   # float32 [B, C]
    mask: torch.Tensor,       # float32 [B]
    negatives: torch.Tensor,  # int64 [B, n] — pre-drawn per example
    alpha: float,
    sigmoid_mode: str = "exact",
    scatter: Scatter = scatter_add_rows_,
) -> StepMetrics:
    """One CBOW step with per-example negatives, in place on ``params``: hidden =
    mean of the context rows of syn0, the center is the positive, and the hidden
    gradient is split equally over the context slots. Examples with no context
    (``has_ctx = 0``) train nothing and do not count in ``pairs``."""
    syn0, syn1 = params
    B, n = negatives.shape
    D = syn0.shape[1]
    neg_valid = (negatives != centers[:, None]).to(torch.float32) * mask[:, None]
    hidden, ctx_n, has_ctx = _cbow_hidden(syn0, contexts, ctx_mask)
    e_out = syn1[centers]                                            # [B, D]
    e_neg = syn1[negatives]                                          # [B, n, D]
    f_pos = torch.sum(hidden * e_out, dim=-1)
    f_neg = torch.einsum("bd,bnd->bn", hidden, e_neg)
    live = mask * has_ctx
    neg_live = neg_valid * has_ctx[:, None]
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * live
    g_neg = (0.0 - _sigmoid(f_neg, sigmoid_mode)) * alpha * neg_live
    d_hidden = g_pos[:, None] * e_out + torch.einsum("bn,bnd->bd", g_neg, e_neg)
    upd1 = torch.empty((B * (1 + n), D), dtype=syn1.dtype, device=syn1.device)
    torch.mul(g_pos[:, None], hidden, out=upd1[:B])
    torch.mul(g_neg[..., None], hidden[:, None, :], out=upd1[B:].view(B, n, D))
    _scatter_cbow_contexts(syn0, contexts, ctx_mask, mask, d_hidden, ctx_n, scatter)
    scatter(syn1, torch.cat([centers, negatives.reshape(-1)]), upd1,
            torch.cat([live, neg_live.reshape(-1)]))
    denom = torch.clamp(live.sum(), min=1.0)
    loss = (-_log_sigmoid(f_pos) * live
            - torch.sum(_log_sigmoid(-f_neg) * neg_live, dim=-1)).sum() / denom
    return StepMetrics(loss, (f_pos * live).sum() / denom, live.sum())


def cbow_step_shared_core(
    params: EmbeddingPair,
    centers: torch.Tensor,    # int64 [B]
    contexts: torch.Tensor,   # int64 [B, C]
    ctx_mask: torch.Tensor,   # float32 [B, C]
    mask: torch.Tensor,       # float32 [B]
    negatives: torch.Tensor,  # int64 [P] — pre-drawn shared pool
    alpha: float,
    num_negatives: int,
    sigmoid_mode: str = "exact",
    with_metrics: bool = True,
    scatter: Scatter = scatter_add_rows_,
) -> StepMetrics:
    """One CBOW step with a batch-shared pool of P negatives, each negative term
    reweighted by n/P, in place on ``params``: f_neg = hidden·Zᵀ and dZ = g_negᵀ·hidden.
    ``with_metrics=False`` skips the loss and mean_f_pos (both 0) and keeps ``pairs``
    exact, like the JAX package's elided twin."""
    syn0, syn1 = params
    B = centers.shape[0]
    P = negatives.shape[0]
    D = syn0.shape[1]
    neg_valid = (negatives[None, :] != centers[:, None]).to(torch.float32) \
        * mask[:, None]
    hidden, ctx_n, has_ctx = _cbow_hidden(syn0, contexts, ctx_mask)
    e_out = syn1[centers]                                            # [B, D]
    Z = syn1[negatives]                                              # [P, D]
    f_pos = torch.sum(hidden * e_out, dim=-1)
    f_neg = hidden @ Z.T                                             # [B, P]
    live = mask * has_ctx
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * live
    g_neg = ((0.0 - _sigmoid(f_neg, sigmoid_mode)) * alpha * neg_valid
             * has_ctx[:, None] * (num_negatives / P))
    d_hidden = g_pos[:, None] * e_out + g_neg @ Z
    upd1 = torch.empty((B + P, D), dtype=syn1.dtype, device=syn1.device)
    torch.mul(g_pos[:, None], hidden, out=upd1[:B])
    torch.matmul(g_neg.T, hidden, out=upd1[B:])                      # dZ [P, D]
    _scatter_cbow_contexts(syn0, contexts, ctx_mask, mask, d_hidden, ctx_n, scatter)
    scatter(syn1, torch.cat([centers, negatives]), upd1,
            torch.cat([live, torch.ones(P, dtype=live.dtype, device=live.device)]))
    if with_metrics:
        denom = torch.clamp(live.sum(), min=1.0)
        neg_term = torch.sum(_log_sigmoid(-f_neg) * neg_valid * has_ctx[:, None], dim=-1)
        loss = (-_log_sigmoid(f_pos) * live
                - neg_term * (num_negatives / P)).sum() / denom
        mean_f_pos = (f_pos * live).sum() / denom
    else:
        loss = mean_f_pos = torch.zeros((), dtype=torch.float32, device=syn0.device)
    return StepMetrics(loss, mean_f_pos, live.sum())


def alpha_schedule(
    words_processed,
    total_words: float,
    learning_rate: float,
    min_alpha_factor: float = 1e-4,
) -> float:
    """Linear lr decay with floor: ``lr·(1 − words/total)``, floored at
    ``lr·min_alpha_factor`` (the reference's schedule)."""
    alpha = learning_rate * (1.0 - words_processed / total_words)
    return max(float(alpha), learning_rate * min_alpha_factor)
