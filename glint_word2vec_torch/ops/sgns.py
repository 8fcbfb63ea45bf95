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

:func:`sgns_step_shared_scatter_` is the shared-pool skip-gram step in that in-place
scatter form: the trainer runs it instead of the fused kernel when a stabilizer or
``duplicate_scaling`` is on, as the JAX package runs its XLA step instead of the Pallas
kernel then (the kernel owns its own update math).

Stabilizers (:class:`Stabilizers`: ``update_clip`` caps each update row before the
scatter, ``row_l2`` and ``max_row_norm`` decay and clamp the touched rows after it) and
``duplicate_scaling`` (each row moves by the mean of its updates) follow the JAX
functions of the same names; with both off a step runs exactly the ops it ran before
they existed. The touched-row pass writes whole rows back with ``index_copy_``, a
scatter-*set*: the JAX package's out-of-range sentinel slots (``mode="drop"``) point at a
touched row of the same call instead, which writes the identical row, so no boolean
filter (a blocking sync on the card) is needed.

Not ported yet: bf16 storage, the fused logit chain and the hot rows.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from glint_word2vec_torch.ops.scatter import scatter_add_rows_

MAX_EXP = 6.0  # the reference's sigmoid LUT clipping range
# divide guard of the stabilizers' norm ratios (the JAX package's value): a zero row
# scales by min(1, limit/eps) = 1 instead of NaN
_STAB_EPS = 1e-30
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


class Stabilizers(NamedTuple):
    """In-step stabilizers; 0.0 turns each off, and an off knob runs no op.

    - ``max_row_norm``: after the scatter, each touched row is clamped to this L2 norm;
    - ``update_clip``: before the scatter, each pair's or example's update row is
      clamped to this L2 norm (never the shared pool's d_Z rows, as in the JAX package);
    - ``row_l2``: after the scatter, each touched row scales by (1 − α·row_l2), once
      per step whatever its multiplicity.

    Norm and scale math runs in ``promote_types(dtype, float32)``."""

    max_row_norm: float = 0.0
    update_clip: float = 0.0
    row_l2: float = 0.0

    @property
    def enabled(self) -> bool:
        return bool(self.max_row_norm or self.update_clip or self.row_l2)

    @property
    def post_pass(self) -> bool:
        """Whether the touched-row pass after the scatter (decay, clamp) runs."""
        return bool(self.max_row_norm or self.row_l2)


_OFF = Stabilizers()  # what ``stabilizers=None`` means


def _stab_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _ratio_clamped(limit: float, norm: torch.Tensor) -> torch.Tensor:
    """min(1, limit / max(norm, eps)) elementwise, the division done in the tensor's
    dtype (``limit / tensor`` would be a reciprocal and a product in torch)."""
    return torch.clamp(torch.div(torch.full_like(norm, limit),
                                 torch.clamp(norm, min=_STAB_EPS)), max=1.0)


def clip_update_rows(d: torch.Tensor, clip: float) -> torch.Tensor:
    """Rows of ``d`` ([..., D]) longer than ``clip`` in L2 rescaled to exactly
    ``clip``; shorter rows pass through bit for bit. ``clip=0`` returns ``d``."""
    if not clip:
        return d
    dp = d.to(_stab_dtype(d.dtype))
    norm = torch.sqrt(torch.sum(dp * dp, dim=-1, keepdim=True))
    return (dp * _ratio_clamped(clip, norm)).to(d.dtype)


def _decay_scalar(alpha, row_l2: float, pf: torch.dtype, device) -> Union[float, torch.Tensor]:
    """1 − α·row_l2 in ``pf``: on the host for a Python α (a tensor made from it would
    be a blocking copy to the card), on the device for a tensor α."""
    if isinstance(alpha, torch.Tensor):
        return 1.0 - alpha.to(device, pf) * row_l2
    npt = np.float64 if pf == torch.float64 else np.float32
    return float(npt(1.0) - npt(alpha) * npt(row_l2))


def _mask_sentinel(idx: torch.Tensor, gate: torch.Tensor, vs: int) -> torch.Tensor:
    """Touched-index list with gated-off slots mapped to the sentinel ``vs`` (one past
    the last row): a masked slot's placeholder index (0) must not drag a real row into
    the decay/clamp pass."""
    return torch.where(gate > 0, idx, vs)


def stabilize_rows_(mat: torch.Tensor, idx: torch.Tensor, alpha,
                    stab: Stabilizers, enable: torch.Tensor) -> torch.Tensor:
    """The touched-row pass, in place on ``mat`` [V, D]: gather the rows at ``idx``
    (int64 [N]; ``>= V`` is the sentinel of an untouched slot), scale each by
    (1 − α·row_l2), then clamp its decayed norm to ``max_row_norm``, and write the rows
    back. Every gather precedes every write, and duplicates of a row compute the same
    replacement. A sentinel slot is pointed at a touched index of the same call, so it
    writes that row's replacement too; when no slot is touched, or ``enable`` (a 0-d
    tensor) is 0, every scale is exactly 1 and the pass rewrites the rows unchanged."""
    if not stab.post_pass:
        return mat
    V = mat.shape[0]
    pf = _stab_dtype(mat.dtype)
    touched = idx < V
    first = torch.clamp(idx[torch.argmax(touched.to(torch.uint8))], max=V - 1)
    target = torch.where(touched, idx, first)
    rows = mat[target].to(pf)
    scale = torch.ones(rows.shape[0], dtype=pf, device=mat.device)
    if stab.row_l2:
        scale = scale * _decay_scalar(alpha, stab.row_l2, pf, mat.device)
    if stab.max_row_norm:
        norm = torch.sqrt(torch.sum(rows * rows, dim=-1)) * scale
        scale = scale * _ratio_clamped(stab.max_row_norm, norm)
    scale = torch.where((enable > 0) & touched.any(), scale, 1.0)
    return mat.index_copy_(0, target, (rows * scale[:, None]).to(mat.dtype))


def _counts(V: int, *pairs) -> torch.Tensor:
    """Per-row counts [V]: each (idx, weights) pair's weights summed at its indices."""
    w0 = pairs[0][1]
    cnt = torch.zeros(V, dtype=w0.dtype, device=w0.device)
    for idx, w in pairs:
        cnt.index_add_(0, idx, w.to(w0.dtype))
    return cnt


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


def _shared_pool_updates(
    syn0: torch.Tensor, syn1: torch.Tensor, centers: torch.Tensor,
    contexts: torch.Tensor, mask: torch.Tensor, negatives: torch.Tensor, alpha,
    num_negatives: int, sigmoid_mode: str, matmul: MatMul, duplicate_scaling: bool,
    stabilizers: Optional[Stabilizers],
):
    """The shared-pool step's update rows (d_in [B, D], d_pos [B, D], d_Z [P, D]) and
    the logit chain (f_pos, f_neg, neg_valid) the metrics read."""
    e_in = syn0[centers]
    e_pos = syn1[contexts]
    Z = syn1[negatives]
    f_pos, f_neg, neg_valid, g_pos, g_neg = shared_pool_coeffs(
        e_in, e_pos, Z, contexts, negatives, mask, alpha, num_negatives, sigmoid_mode,
        matmul=matmul)
    g_pos_in, g_neg_in, g_pos_out, z_scale = g_pos, g_neg, g_pos, None
    if duplicate_scaling:
        V = syn0.shape[0]
        in_scale = 1.0 / torch.clamp(_counts(V, (centers, mask))[centers], min=1.0)
        g_pos_in = g_pos * in_scale
        g_neg_in = g_neg * in_scale[:, None]
        g_pos_out = g_pos / torch.clamp(_counts(V, (contexts, mask))[contexts], min=1.0)
        # a pool row: the mean over its contributing pairs, divided by the pool slots
        # that hold the same word (their scatter-adds would otherwise sum)
        ones = torch.ones(negatives.shape[0], dtype=mask.dtype, device=mask.device)
        pool_mult = _counts(V, (negatives, ones))[negatives]
        z_scale = 1.0 / (torch.clamp(neg_valid.sum(dim=0), min=1.0) * pool_mult)
    d_in = g_pos_in[:, None] * e_pos + matmul(g_neg_in, Z)                # [B, D]
    d_pos = g_pos_out[:, None] * e_in
    d_Z = matmul(g_neg.T, e_in)                                          # [P, D]
    if z_scale is not None:
        d_Z = d_Z * z_scale[:, None]
    if (stabilizers or _OFF).update_clip:
        d_in = clip_update_rows(d_in, stabilizers.update_clip)
        d_pos = clip_update_rows(d_pos, stabilizers.update_clip)
    return d_in, d_pos, d_Z, (f_pos, f_neg, neg_valid)


def _shared_metrics(chain, mask: torch.Tensor, num_negatives: int,
                    with_metrics: bool) -> StepMetrics:
    pairs = mask.sum()
    if with_metrics:
        f_pos, f_neg, neg_valid = chain
        denom = torch.clamp(pairs, min=1.0)
        loss_num, fpos_num = shared_pool_loss_terms(
            f_pos, f_neg, neg_valid, mask, num_negatives)
        return StepMetrics(loss_num / denom, fpos_num / denom, pairs)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return StepMetrics(zero, zero, pairs)


def _shared_post_pass(syn0, syn1, centers, contexts, mask, negatives, alpha,
                      stabilizers: Optional[Stabilizers]) -> None:
    """The touched rows of a shared-pool skip-gram step: syn0 at the live centers,
    syn1 at the live contexts and the whole pool."""
    if not (stabilizers or _OFF).post_pass:
        return
    V = syn0.shape[0]
    enable = mask.sum() > 0
    stabilize_rows_(syn0, _mask_sentinel(centers, mask, V), alpha, stabilizers, enable)
    stabilize_rows_(syn1, torch.cat([_mask_sentinel(contexts, mask, V), negatives]),
                    alpha, stabilizers, enable)


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
    duplicate_scaling: bool = False,
    stabilizers: Optional[Stabilizers] = None,
) -> Tuple[EmbeddingPair, StepMetrics]:
    """One shared-pool SGNS step; returns NEW parameters (the inputs are untouched)
    and the step metrics. ``with_metrics=False`` skips the loss and mean_f_pos pass
    (both 0) and keeps ``pairs`` exact, like the JAX package's elided twin. The three
    products E·Zᵀ, G·Z and Gᵀ·E go through ``matmul``: ``ops.tf32.matmul_3xtf32``
    there emulates the fused kernel's tensor-core arithmetic. ``duplicate_scaling``
    and ``stabilizers`` as in the JAX function (the fused kernel has neither)."""
    syn0, syn1 = params
    centers = centers.long()
    contexts = contexts.long()
    negatives = negatives.long()
    d_in, d_pos, d_Z, chain = _shared_pool_updates(
        syn0, syn1, centers, contexts, mask, negatives, alpha, num_negatives,
        sigmoid_mode, matmul, duplicate_scaling, stabilizers)
    new_syn0 = syn0.clone().index_add_(0, centers, d_in)
    new_syn1 = syn1.clone().index_add_(0, contexts, d_pos)
    new_syn1.index_add_(0, negatives, d_Z)
    _shared_post_pass(new_syn0, new_syn1, centers, contexts, mask, negatives, alpha,
                      stabilizers)
    return (EmbeddingPair(new_syn0, new_syn1),
            _shared_metrics(chain, mask, num_negatives, with_metrics))


def sgns_step_shared_scatter_(
    params: EmbeddingPair,
    centers: torch.Tensor,    # int64 [B]
    contexts: torch.Tensor,   # int64 [B]
    mask: torch.Tensor,       # float32 [B]
    negatives: torch.Tensor,  # int64 [P] — pre-drawn shared pool
    alpha: Union[float, torch.Tensor],
    num_negatives: int,
    sigmoid_mode: str = "exact",
    with_metrics: bool = True,
    scatter: Scatter = scatter_add_rows_,
    *,
    duplicate_scaling: bool = False,
    stabilizers: Optional[Stabilizers] = None,
) -> StepMetrics:
    """:func:`sgns_step_shared_core` in place on ``params``, its rows scattered through
    ``scatter`` in two calls (syn0 at the centers; syn1 at the contexts, then the
    pool), the products in plain ``torch.matmul``: the trainer's shared-pool skip-gram
    step when a stabilizer or ``duplicate_scaling`` is on."""
    syn0, syn1 = params
    d_in, d_pos, d_Z, chain = _shared_pool_updates(
        syn0, syn1, centers, contexts, mask, negatives, alpha, num_negatives,
        sigmoid_mode, torch.matmul, duplicate_scaling, stabilizers)
    scatter(syn0, centers, d_in, mask)
    scatter(syn1, torch.cat([contexts, negatives]), torch.cat([d_pos, d_Z]),
            torch.cat([mask, torch.ones(negatives.shape[0], dtype=mask.dtype,
                                        device=mask.device)]))
    _shared_post_pass(syn0, syn1, centers, contexts, mask, negatives, alpha, stabilizers)
    return _shared_metrics(chain, mask, num_negatives, with_metrics)


def sgns_step_core(
    params: EmbeddingPair,
    centers: torch.Tensor,    # int64 [B]
    contexts: torch.Tensor,   # int64 [B]
    mask: torch.Tensor,       # float32 [B]
    negatives: torch.Tensor,  # int64 [B, n] — pre-drawn per pair
    alpha: float,
    sigmoid_mode: str = "exact",
    scatter: Scatter = scatter_add_rows_,
    *,
    duplicate_scaling: bool = False,
    stabilizers: Optional[Stabilizers] = None,
) -> StepMetrics:
    """One per-pair SGNS step (the reference's n negatives per pair), in place on
    ``params``. Negatives equal to their pair's context, and masked pairs, get zero
    gradient. ``scatter`` is the row scatter (the plain one only to hold the kernel
    against it). ``duplicate_scaling`` and ``stabilizers`` as in the JAX function:
    ``update_clip`` caps d_in, d_pos and every d_neg row; the touched rows are syn0's
    live centers and syn1's live contexts and their pairs' negatives."""
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
    g_pos_in, g_neg_in, g_pos_out, g_neg_out = g_pos, g_neg, g_pos, g_neg
    if duplicate_scaling:
        V = syn0.shape[0]
        cnt0 = _counts(V, (centers, mask))
        cnt1 = _counts(V, (contexts, mask), (negatives.reshape(-1), neg_valid.reshape(-1)))
        in_div = torch.clamp(cnt0[centers], min=1.0)
        g_pos_in, g_neg_in = g_pos / in_div, g_neg / in_div[:, None]
        g_pos_out = g_pos / torch.clamp(cnt1[contexts], min=1.0)
        g_neg_out = g_neg / torch.clamp(cnt1[negatives], min=1.0)
    d_in = g_pos_in[:, None] * e_pos + torch.einsum("bn,bnd->bd", g_neg_in, e_neg)
    # syn1's update rows, contexts then negatives, written in place into one buffer
    upd1 = torch.empty((B * (1 + n), D), dtype=syn1.dtype, device=syn1.device)
    torch.mul(g_pos_out[:, None], e_in, out=upd1[:B])
    torch.mul(g_neg_out[..., None], e_in[:, None, :], out=upd1[B:].view(B, n, D))
    if (stabilizers or _OFF).update_clip:
        d_in = clip_update_rows(d_in, stabilizers.update_clip)
        upd1 = clip_update_rows(upd1, stabilizers.update_clip)
    scatter(syn0, centers, d_in, mask)
    scatter(syn1, torch.cat([contexts, negatives.reshape(-1)]), upd1,
            torch.cat([mask, neg_valid.reshape(-1)]))
    if (stabilizers or _OFF).post_pass:
        V = syn0.shape[0]
        enable = mask.sum() > 0
        stabilize_rows_(syn0, _mask_sentinel(centers, mask, V), alpha, stabilizers,
                        enable)
        stabilize_rows_(syn1, torch.cat([
            _mask_sentinel(contexts, mask, V),
            _mask_sentinel(negatives, mask[:, None].expand(B, n), V).reshape(-1)]),
            alpha, stabilizers, enable)
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
                           scatter: Scatter,
                           ctx_scale: Optional[torch.Tensor] = None) -> None:
    """Mean convention: each live context slot gets d_hidden / |context| (times
    ``ctx_scale`` [B, C], duplicate scaling's per-slot factor, when given)."""
    D = syn0.shape[1]
    d_ctx = (d_hidden / ctx_n[:, None])[:, None, :] * ctx_mask[..., None]  # [B, C, D]
    if ctx_scale is not None:
        d_ctx = d_ctx * ctx_scale[..., None]
    scatter(syn0, contexts.reshape(-1), d_ctx.reshape(-1, D),
            (ctx_mask * mask[:, None]).reshape(-1))


def _cbow_post_pass(syn0, syn1, contexts, ctx_mask, mask, has_ctx, centers,
                    neg_idx: torch.Tensor, alpha,
                    stabilizers: Optional[Stabilizers]) -> None:
    """The touched rows of a scatter CBOW step: syn0 at the live context slots, syn1
    at the live centers and ``neg_idx`` (the pool, or the sentinel-gated per-example
    negatives)."""
    if not (stabilizers or _OFF).post_pass:
        return
    V = syn0.shape[0]
    enable = mask.sum() > 0
    live = mask * has_ctx
    stabilize_rows_(syn0, _mask_sentinel(contexts, ctx_mask * live[:, None],
                                         V).reshape(-1), alpha, stabilizers, enable)
    stabilize_rows_(syn1, torch.cat([_mask_sentinel(centers, live, V), neg_idx]),
                    alpha, stabilizers, enable)


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
    *,
    duplicate_scaling: bool = False,
    stabilizers: Optional[Stabilizers] = None,
) -> StepMetrics:
    """One CBOW step with per-example negatives, in place on ``params``: hidden =
    mean of the context rows of syn0, the center is the positive, and the hidden
    gradient is split equally over the context slots. Examples with no context
    (``has_ctx = 0``) train nothing and do not count in ``pairs``.
    ``duplicate_scaling`` and ``stabilizers`` as in the JAX function: ``update_clip``
    caps d_hidden (before the split over the context slots), d_out and every d_neg
    row."""
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
    g_pos_out, g_neg_out, ctx_scale = g_pos, g_neg, None
    if duplicate_scaling:
        V = syn0.shape[0]
        cnt0 = _counts(V, (contexts.reshape(-1), (ctx_mask * live[:, None]).reshape(-1)))
        cnt1 = _counts(V, (centers, live), (negatives.reshape(-1), neg_live.reshape(-1)))
        ctx_scale = 1.0 / torch.clamp(cnt0[contexts], min=1.0)
        g_pos_out = g_pos / torch.clamp(cnt1[centers], min=1.0)
        g_neg_out = g_neg / torch.clamp(cnt1[negatives], min=1.0)
    d_hidden = g_pos[:, None] * e_out + torch.einsum("bn,bnd->bd", g_neg, e_neg)
    upd1 = torch.empty((B * (1 + n), D), dtype=syn1.dtype, device=syn1.device)
    torch.mul(g_pos_out[:, None], hidden, out=upd1[:B])
    torch.mul(g_neg_out[..., None], hidden[:, None, :], out=upd1[B:].view(B, n, D))
    if (stabilizers or _OFF).update_clip:
        d_hidden = clip_update_rows(d_hidden, stabilizers.update_clip)
        upd1 = clip_update_rows(upd1, stabilizers.update_clip)
    _scatter_cbow_contexts(syn0, contexts, ctx_mask, mask, d_hidden, ctx_n, scatter,
                           ctx_scale)
    scatter(syn1, torch.cat([centers, negatives.reshape(-1)]), upd1,
            torch.cat([live, neg_live.reshape(-1)]))
    _cbow_post_pass(syn0, syn1, contexts, ctx_mask, mask, has_ctx, centers,
                    _mask_sentinel(negatives, mask[:, None].expand(B, n),
                                   syn0.shape[0]).reshape(-1), alpha, stabilizers)
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
    *,
    stabilizers: Optional[Stabilizers] = None,
) -> StepMetrics:
    """One CBOW step with a batch-shared pool of P negatives, each negative term
    reweighted by n/P, in place on ``params``: f_neg = hidden·Zᵀ and dZ = g_negᵀ·hidden.
    ``with_metrics=False`` skips the loss and mean_f_pos (both 0) and keeps ``pairs``
    exact, like the JAX package's elided twin. ``stabilizers`` as in the JAX function:
    ``update_clip`` caps d_hidden and d_out, never dZ; the touched rows are the live
    context slots, the live centers and the whole pool."""
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
    if (stabilizers or _OFF).update_clip:
        d_hidden = clip_update_rows(d_hidden, stabilizers.update_clip)
        upd1[:B] = clip_update_rows(upd1[:B], stabilizers.update_clip)
    _scatter_cbow_contexts(syn0, contexts, ctx_mask, mask, d_hidden, ctx_n, scatter)
    scatter(syn1, torch.cat([centers, negatives]), upd1,
            torch.cat([live, torch.ones(P, dtype=live.dtype, device=live.device)]))
    _cbow_post_pass(syn0, syn1, contexts, ctx_mask, mask, has_ctx, centers, negatives,
                    alpha, stabilizers)
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
