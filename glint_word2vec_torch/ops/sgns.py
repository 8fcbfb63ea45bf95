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

Precision and restructurings (the JAX functions' ``compute_dtype``, ``logits_dtype``,
``fused``, ``bf16_chain`` and ``hot_slabs``): the gathers cast to the compute dtype and
the logit chain to the logits dtype where the JAX step casts, and every update row is
cast to the parameters' dtype before its scatter. ``None`` (the default) casts nothing:
the step runs in the parameters' dtype, which the float64 tests use. On bf16 parameters
every scatter sums a row's updates in f32 and rounds the row once (``ops/scatter``),
where the JAX package's ``.at[].add`` rounds after every add on the CPU: the one
documented divergence of the bf16 steps. ``fused`` folds validity, mask and the α·n/P
scale of the negative chain into one select; ``bf16_chain`` takes the positive logit as
the f32-accumulated sum of the compute-dtype products. The hot rows
(:func:`hot_gather`, :func:`hot_scatter_add`, :func:`hot_flush`) carry the updates of
the first K rows of each matrix (the most frequent words) in f32 slabs across the
steps of a chunk; reads add the pending deltas back, so no step trains on a stale row.

α. Every step takes its learning rate as a Python float or as a one-element float32
tensor on the step's device: the trainer passes the latter, a slice of the chunk's [K]
alphas on the card, which a CUDA graph of the chunk reads at each replay (a float would
be baked into the graph). Both forms give bit-identical parameters: α enters the chains
as the same float32 value, and the two products of α with a constant that a float form
takes in float64 (the fused negative scale α·(−n/P), the decay 1 − α·row_l2 in the
stabilizers' dtype) are taken in the same precision for a tensor. No step body reads a
tensor on the host (no ``.item()``, no 0-d tensor index, no boolean-mask indexing, no
shape that depends on the data), so a chunk of steps can be captured.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from glint_word2vec_torch.ops.scatter import scatter_add_rows_, scatter_add_rows_reference

MAX_EXP = 6.0  # the reference's sigmoid LUT clipping range
# divide guard of the stabilizers' norm ratios (the JAX package's value): a zero row
# scales by min(1, limit/eps) = 1 instead of NaN
_STAB_EPS = 1e-30
# scatter_add_rows_ calls per step of the in-place steps: one into syn0, one into syn1
SCATTERS_PER_STEP = 2

Scatter = Callable[..., torch.Tensor]
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# the column layout's hook (ops/sgns_shard.py): each tensor of the list summed over the
# model axis, the list in one collective, each returned in its own dtype. The chains
# below call it on their partial dot products (and the stabilizers on their partial
# squared norms) when the rows they hold are a rank's columns; None on whole rows.
ColSum = Callable[[List[torch.Tensor]], List[torch.Tensor]]


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
    return clip_rows_together([d], clip)[0]


def clip_rows_together(ds: List[torch.Tensor], clip: float,
                       col_sum: Optional["ColSum"] = None) -> List[torch.Tensor]:
    """:func:`clip_update_rows` of each tensor of ``ds``. ``col_sum`` (the column
    layout, :data:`ColSum`): the rows hold a rank's columns, and their squared norms
    are summed over the model axis, all of ``ds``'s in one call, before the ratio."""
    if not clip:
        return ds
    dps = [d.to(_stab_dtype(d.dtype)) for d in ds]
    sq = [torch.sum(dp * dp, dim=-1, keepdim=True) for dp in dps]
    if col_sum is not None:
        sq = col_sum(sq)
    return [(dp * _ratio_clamped(clip, torch.sqrt(s))).to(d.dtype)
            for d, dp, s in zip(ds, dps, sq)]


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
    stabilize_rows_together_([(mat, idx)], alpha, stab, enable)
    return mat


def stabilize_rows_together_(parts, alpha, stab: Stabilizers, enable: torch.Tensor,
                             col_sum: Optional["ColSum"] = None) -> None:
    """:func:`stabilize_rows_` of each ``(mat, idx)`` of ``parts``. ``col_sum`` (the
    column layout): the matrices hold a rank's columns, and the touched rows' squared
    norms are summed over the model axis, every part's in one call, before the clamp
    (``row_l2``'s decay is per column and needs none)."""
    if not stab.post_pass:
        return
    work = []
    for mat, idx in parts:
        V = mat.shape[0]
        pf = _stab_dtype(mat.dtype)
        touched = idx < V
        # a one-element index, not a 0-d one: torch reads a 0-d index tensor on the
        # host (a blocking copy on the card, and no CUDA graph can capture it)
        first = torch.clamp(idx[torch.argmax(touched.to(torch.uint8)).reshape(1)],
                            max=V - 1)
        target = torch.where(touched, idx, first)
        rows = mat[target].to(pf)
        scale = torch.ones(rows.shape[0], dtype=pf, device=mat.device)
        if stab.row_l2:
            scale = scale * _decay_scalar(alpha, stab.row_l2, pf, mat.device)
        work.append((mat, touched, target, rows, scale))
    if stab.max_row_norm:
        sq = [torch.sum(rows * rows, dim=-1) for _, _, _, rows, _ in work]
        if col_sum is not None:
            sq = col_sum(sq)
        work = [(mat, touched, target, rows,
                 scale * _ratio_clamped(stab.max_row_norm, torch.sqrt(s) * scale))
                for (mat, touched, target, rows, scale), s in zip(work, sq)]
    for mat, touched, target, rows, scale in work:
        scale = torch.where((enable > 0) & touched.any(), scale, 1.0)
        mat.index_copy_(0, target, (rows * scale[:, None]).to(mat.dtype))


def _counts(V: int, *pairs) -> torch.Tensor:
    """Per-row counts [V]: each (idx, weights) pair's weights summed at its indices."""
    w0 = pairs[0][1]
    cnt = torch.zeros(V, dtype=w0.dtype, device=w0.device)
    for idx, w in pairs:
        cnt.index_add_(0, idx, w.to(w0.dtype))
    return cnt


def init_embeddings(vocab_size: int, vector_size: int, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> EmbeddingPair:
    """Classic word2vec init on the CPU: syn0 ~ U(-0.5/D, 0.5/D) drawn in float32 and
    cast to ``dtype``, syn1 = 0. Draws come from ``generator`` (a CPU torch.Generator)
    and differ from the JAX package's, so tests that compare the packages inject
    parameters instead."""
    syn0 = torch.rand((vocab_size, vector_size), generator=generator,
                      dtype=torch.float32)
    syn0 = ((syn0 - 0.5) / vector_size).to(dtype)
    syn1 = torch.zeros((vocab_size, vector_size), dtype=dtype)
    return EmbeddingPair(syn0, syn1)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """``promote_types(dtype, float32)``: the type of the positive logit and of every
    sum a narrower chain is accumulated in."""
    return torch.promote_types(dtype, torch.float32)


def _scalar(x, dtype: torch.dtype):
    """A scalar factor of a ``dtype`` chain, as the JAX step's ``jnp.asarray(x, dtype)``:
    rounded to bf16 first on a bf16 chain; a Python float is left as it is otherwise
    (torch casts it to the tensor's dtype, as the wider chains always did)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    if dtype == torch.bfloat16:
        return torch.tensor(float(x), dtype=dtype)
    return x


def _times(alpha, c: float):
    """α·c as a Python float α gives it: the product in float64, rounded once by the
    caller's cast. A tensor α (float32, as the trainer's) is widened to float64 first,
    so both forms of α give the same bits."""
    if isinstance(alpha, torch.Tensor):
        return alpha.to(torch.float64) * c
    return alpha * c


# ---- cross-step hot rows ---------------------------------------------------------------


def hot_slabs(k: int, dim: int, dtype: torch.dtype, device) -> Tuple[torch.Tensor, ...]:
    """Two zeroed pending-delta slabs [k, dim] for syn0 and syn1, in
    ``promote_types(dtype, float32)`` (the parameters' dtype or wider: accumulated in
    bf16 across steps, the slab would round away the small updates it batches)."""
    slab = torch.zeros((k, dim), dtype=_wide(dtype), device=device)
    return slab, torch.zeros_like(slab)


def hot_gather(mat: torch.Tensor, slab: torch.Tensor, idx: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """``mat[idx]`` in ``compute_dtype`` with the slab's pending deltas added back for
    ``idx < K`` (any index shape; returns ``[..., D]``)."""
    k = slab.shape[0]
    rows = mat[idx].to(compute_dtype)
    hot = idx < k
    pend = torch.where(hot[..., None], slab[torch.where(hot, idx, 0)].to(compute_dtype),
                       torch.zeros((), dtype=compute_dtype, device=mat.device))
    return rows + pend


def hot_scatter_add(mat: torch.Tensor, slab: torch.Tensor, idx: torch.Tensor,
                    upd: torch.Tensor, live: torch.Tensor, scatter: Scatter) -> None:
    """The split scatter, in place: the live updates of rows ``idx >= K`` go into
    ``mat`` (cast to its dtype), those of rows ``idx < K`` into the slab (cast to its
    dtype), through two ``scatter`` calls whose ``live`` masks split the slots. The
    slab's call points the cold slots at row 0 with live 0: the scatter writes no
    skipped slot and checks no skipped slot's index."""
    hot = idx < slab.shape[0]
    scatter(mat, idx, upd.to(mat.dtype), live * ~hot)
    scatter(slab, torch.where(hot, idx, 0), upd.to(slab.dtype), live * hot)


def hot_flush(mat: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """Apply the pending deltas, in place: ``mat[:K] += slab``, one dense block add over
    the contiguous prefix, summed in the slab's dtype and rounded into ``mat`` once;
    then zero the slab. Returns ``mat``."""
    k = slab.shape[0]
    mat[:k] = (mat[:k].to(slab.dtype) + slab).to(mat.dtype)
    slab.zero_()
    return mat


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
    e_in: torch.Tensor,       # [B, D] compute dtype
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
    logits_dtype: Optional[torch.dtype] = None,
    fused: bool = False,
    bf16_chain: bool = False,
    col_sum: Optional[ColSum] = None,
) -> Tuple[torch.Tensor, ...]:
    """The shared-pool logit chain: (f_pos, f_neg, neg_valid, g_pos, g_neg);
    ``matmul`` computes f_neg. f_neg and g_neg are in ``logits_dtype`` (default
    ``promote_types(compute, float32)``), f_pos in ``promote_types(compute, float32)``.
    ``fused``: g_neg is one select of σ(f_neg)·(α·(−n/P)) on the predicate (pool entry
    ≠ the pair's context) ∧ mask, and ``neg_valid`` is that bool predicate.
    ``bf16_chain``: f_pos is the f32-accumulated sum of the compute-dtype products.
    ``col_sum``: the rows are a rank's columns, and f_pos and f_neg (each in its own
    dtype) are summed over the model axis before the sigmoid."""
    P = negatives.shape[0]
    wide = _wide(e_in.dtype)
    ld = logits_dtype or wide
    if bf16_chain:
        f_pos = torch.sum(e_in.to(wide) * e_pos.to(wide), dim=-1)
    else:
        f_pos = torch.sum(e_in * e_pos, dim=-1).to(wide)
    f_neg = matmul(e_in, Z.T).to(ld)                                 # [B, P]
    if col_sum is not None:
        f_pos, f_neg = col_sum([f_pos, f_neg])
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * mask
    if fused:
        valid = (negatives[None, :] != contexts[:, None]) & (mask[:, None] > 0)
        neg_scale = _scalar(_times(alpha, 0.0 - num_negatives / P), ld)
        g_neg = torch.where(valid, _sigmoid(f_neg, sigmoid_mode) * neg_scale,
                            torch.zeros((), dtype=ld, device=f_neg.device))
        return f_pos, f_neg, valid, g_pos, g_neg
    neg_valid = (negatives[None, :] != contexts[:, None]).to(ld) * mask[:, None].to(ld)
    g_neg = (0.0 - _sigmoid(f_neg, sigmoid_mode)) * _scalar(alpha, ld) * neg_valid \
        * _scalar(num_negatives / P, ld)
    return f_pos, f_neg, neg_valid, g_pos, g_neg


def shared_pool_loss_terms(
    f_pos: torch.Tensor, f_neg: torch.Tensor, neg_valid: torch.Tensor,
    mask: torch.Tensor, num_negatives: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-division numerators of the loss and of mean_f_pos (0-d tensors); the
    negative term summed in ``promote_types(logits, float32)``. ``neg_valid`` is the
    float validity array or the fused chain's bool predicate."""
    P = f_neg.shape[-1]
    wide = _wide(f_neg.dtype)
    if neg_valid.dtype == torch.bool:
        neg_term = torch.sum(torch.where(neg_valid, _log_sigmoid(-f_neg),
                                         torch.zeros((), dtype=f_neg.dtype,
                                                     device=f_neg.device)),
                             dim=-1, dtype=wide)
    else:
        neg_term = torch.sum(_log_sigmoid(-f_neg) * neg_valid, dim=-1, dtype=wide)
    loss_num = (-_log_sigmoid(f_pos) * mask - neg_term * (num_negatives / P)).sum()
    return loss_num, (f_pos * mask).sum()


def _gather(mat: torch.Tensor, idx: torch.Tensor, cd: torch.dtype,
            slab: Optional[torch.Tensor]) -> torch.Tensor:
    return mat[idx].to(cd) if slab is None else hot_gather(mat, slab, idx, cd)


def _shared_pool_updates(
    syn0: torch.Tensor, syn1: torch.Tensor, centers: torch.Tensor,
    contexts: torch.Tensor, mask: torch.Tensor, negatives: torch.Tensor, alpha,
    num_negatives: int, sigmoid_mode: str, matmul: MatMul, duplicate_scaling: bool,
    stabilizers: Optional[Stabilizers], compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None, fused: bool = False,
    bf16_chain: bool = False, slabs=None,
):
    """The shared-pool step's update rows (d_in [B, D], d_pos [B, D], d_Z [P, D], in
    the compute dtype) and the logit chain (f_pos, f_neg, neg_valid) the metrics
    read."""
    cd = compute_dtype or syn0.dtype
    slab0, slab1 = slabs if slabs is not None else (None, None)
    e_in = _gather(syn0, centers, cd, slab0)
    e_pos = _gather(syn1, contexts, cd, slab1)
    Z = _gather(syn1, negatives, cd, slab1)
    return shared_pool_updates_from_rows(
        e_in, e_pos, Z, centers, contexts, mask, negatives, alpha, num_negatives,
        sigmoid_mode, matmul, stabilizers, logits_dtype, fused, bf16_chain,
        syn0.shape[0] if duplicate_scaling else 0)


def shared_pool_updates_from_rows(
    e_in: torch.Tensor, e_pos: torch.Tensor, Z: torch.Tensor, centers: torch.Tensor,
    contexts: torch.Tensor, mask: torch.Tensor, negatives: torch.Tensor, alpha,
    num_negatives: int, sigmoid_mode: str, matmul: MatMul = torch.matmul,
    stabilizers: Optional[Stabilizers] = None,
    logits_dtype: Optional[torch.dtype] = None, fused: bool = False,
    bf16_chain: bool = False, dup_vocab: int = 0,
    dup_scales: Optional[Tuple[torch.Tensor, ...]] = None,
    col_sum: Optional[ColSum] = None,
):
    """The shared-pool step's math on rows already gathered in the compute dtype
    (e_in [B, D], e_pos [B, D], Z [P, D]): the update rows d_in, d_pos, d_Z and the
    logit chain (f_pos, f_neg, neg_valid). ``dup_vocab > 0`` turns
    ``duplicate_scaling`` on over a vocabulary of that size, counting the rows in this
    batch; ``dup_scales`` turns it on with the counts taken elsewhere (the row-sharded
    step counts the global batch): the centers' scale [B] (1 / count), the contexts'
    divisor [B] and the pool rows' scale [P]. The single-device steps and the
    row-sharded step (``ops/sgns_shard.py``, whose rows are assembled across the model
    axis) run this one function, so the two cannot drift; so does the column-sharded
    step, whose rows are a rank's columns and which passes ``col_sum``
    (:data:`ColSum`)."""
    cd = e_in.dtype
    duplicate_scaling = dup_vocab > 0
    f_pos, f_neg, neg_valid, g_pos, g_neg = shared_pool_coeffs(
        e_in, e_pos, Z, contexts, negatives, mask, alpha, num_negatives, sigmoid_mode,
        matmul=matmul, logits_dtype=logits_dtype, fused=fused, bf16_chain=bf16_chain,
        col_sum=col_sum)
    g_pos_in, g_neg_in, g_pos_out, z_scale = g_pos, g_neg, g_pos, None
    if dup_scales is not None:
        in_scale, out_div, z_scale = dup_scales
        g_pos_in = g_pos * in_scale
        g_neg_in = g_neg * in_scale[:, None].to(g_neg.dtype)
        g_pos_out = g_pos / out_div
    elif duplicate_scaling:
        V = dup_vocab
        in_scale = 1.0 / torch.clamp(_counts(V, (centers, mask))[centers], min=1.0)
        g_pos_in = g_pos * in_scale
        g_neg_in = g_neg * in_scale[:, None].to(g_neg.dtype)
        g_pos_out = g_pos / torch.clamp(_counts(V, (contexts, mask))[contexts], min=1.0)
        # a pool row: the mean over its contributing pairs, divided by the pool slots
        # that hold the same word (their scatter-adds would otherwise sum)
        ones = torch.ones(negatives.shape[0], dtype=mask.dtype, device=mask.device)
        pool_mult = _counts(V, (negatives, ones))[negatives]
        z_scale = 1.0 / (torch.clamp(neg_valid.sum(dim=0, dtype=_wide(neg_valid.dtype)),
                                     min=1.0) * pool_mult)
    d_in = g_pos_in[:, None].to(cd) * e_pos + matmul(g_neg_in.to(cd), Z)  # [B, D]
    d_pos = g_pos_out[:, None].to(cd) * e_in
    d_Z = matmul(g_neg.to(cd).T, e_in)                                  # [P, D]
    if z_scale is not None:
        d_Z = d_Z * z_scale[:, None].to(cd)
    if (stabilizers or _OFF).update_clip:
        d_in, d_pos = clip_rows_together([d_in, d_pos], stabilizers.update_clip, col_sum)
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
    compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
    fused: bool = False,
    bf16_chain: bool = False,
) -> Tuple[EmbeddingPair, StepMetrics]:
    """One shared-pool SGNS step; returns NEW parameters (the inputs are untouched)
    and the step metrics. ``with_metrics=False`` skips the loss and mean_f_pos pass
    (both 0) and keeps ``pairs`` exact, like the JAX package's elided twin. The three
    products E·Zᵀ, G·Z and Gᵀ·E go through ``matmul``: ``ops.tf32.matmul_3xtf32``
    there emulates the fused kernel's tensor-core arithmetic. ``duplicate_scaling``,
    ``stabilizers`` (the fused kernel has neither), ``compute_dtype``,
    ``logits_dtype``, ``fused`` and ``bf16_chain`` as in the JAX function. On bf16
    parameters the updates of syn1 (the contexts' and the pool's) and of syn0 are each
    applied by one rounding per row (``ops/scatter.scatter_add_rows_reference``), as
    the fused kernel applies them."""
    syn0, syn1 = params
    centers = centers.long()
    contexts = contexts.long()
    negatives = negatives.long()
    d_in, d_pos, d_Z, chain = _shared_pool_updates(
        syn0, syn1, centers, contexts, mask, negatives, alpha, num_negatives,
        sigmoid_mode, matmul, duplicate_scaling, stabilizers, compute_dtype,
        logits_dtype, fused, bf16_chain)
    dtype = syn0.dtype
    new_syn0, new_syn1 = syn0.clone(), syn1.clone()
    if dtype == torch.bfloat16:
        scatter_add_rows_reference(new_syn0, centers, d_in.to(dtype))
        scatter_add_rows_reference(new_syn1, torch.cat([contexts, negatives]),
                                   torch.cat([d_pos, d_Z]).to(dtype))
    else:
        new_syn0.index_add_(0, centers, d_in.to(dtype))
        new_syn1.index_add_(0, contexts, d_pos.to(dtype))
        new_syn1.index_add_(0, negatives, d_Z.to(dtype))
    _shared_post_pass(new_syn0, new_syn1, centers, contexts, mask, negatives, alpha,
                      stabilizers)
    return (EmbeddingPair(new_syn0, new_syn1),
            _shared_metrics(chain, mask, num_negatives, with_metrics))


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=like.dtype, device=like.device)


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
    compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
    fused: bool = False,
    bf16_chain: bool = False,
    hot_slabs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> StepMetrics:
    """:func:`sgns_step_shared_core` in place on ``params``, its rows scattered through
    ``scatter`` in two calls (syn0 at the centers; syn1 at the contexts, then the
    pool), the products in plain ``torch.matmul``: the trainer's shared-pool skip-gram
    step when a stabilizer, ``duplicate_scaling`` or the hot rows are on.
    ``hot_slabs`` (syn0's and syn1's slabs, updated in place): the gathers read through
    :func:`hot_gather` and each scatter splits through :func:`hot_scatter_add` (four
    calls); the caller flushes (:func:`hot_flush`)."""
    syn0, syn1 = params
    d_in, d_pos, d_Z, chain = _shared_pool_updates(
        syn0, syn1, centers, contexts, mask, negatives, alpha, num_negatives,
        sigmoid_mode, torch.matmul, duplicate_scaling, stabilizers, compute_dtype,
        logits_dtype, fused, bf16_chain, hot_slabs)
    idx1 = torch.cat([contexts, negatives])
    upd1 = torch.cat([d_pos, d_Z])
    live1 = torch.cat([mask, _ones(negatives.shape[0], mask)])
    if hot_slabs is not None:
        hot_scatter_add(syn0, hot_slabs[0], centers, d_in, mask, scatter)
        hot_scatter_add(syn1, hot_slabs[1], idx1, upd1, live1, scatter)
    else:
        scatter(syn0, centers, d_in.to(syn0.dtype), mask)
        scatter(syn1, idx1, upd1.to(syn1.dtype), live1)
    _shared_post_pass(syn0, syn1, centers, contexts, mask, negatives, alpha, stabilizers)
    return _shared_metrics(chain, mask, num_negatives, with_metrics)


def per_pair_valid(negatives: torch.Tensor, contexts: torch.Tensor, mask: torch.Tensor,
                   fused: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg_valid, neg_live) of the per-pair chain: a negative counts where it differs
    from its pair's context on a live pair; ``fused`` keeps the predicate bool, and
    ``neg_live`` is its float32 form (the scatter's live slots)."""
    if fused:
        neg_valid = (negatives != contexts[:, None]) & (mask[:, None] > 0)
        return neg_valid, neg_valid.to(torch.float32)
    neg_valid = (negatives != contexts[:, None]).to(torch.float32) * mask[:, None]
    return neg_valid, neg_valid


def per_pair_updates_from_rows(
    e_in: torch.Tensor, e_pos: torch.Tensor, e_neg: torch.Tensor, mask: torch.Tensor,
    neg_valid: torch.Tensor, alpha, sigmoid_mode: str = "exact", *,
    dup_div: Optional[Tuple[torch.Tensor, ...]] = None,
    stabilizers: Optional[Stabilizers] = None, fused: bool = False,
    bf16_chain: bool = False, col_sum: Optional[ColSum] = None,
):
    """The per-pair step's math on rows already gathered in the compute dtype (e_in,
    e_pos [B, D], e_neg [B, n, D]): d_in [B, D], syn1's update rows [B·(1 + n), D]
    (contexts, then negatives) and the loss and mean-f_pos numerators. ``dup_div``
    (duplicate scaling): the divisors of the centers' [B], contexts' [B] and
    negatives' [B, n] updates, each row's count in the batch, at least 1. The
    single-device step and the row-sharded one (``ops/sgns_shard.py``, whose rows and
    counts come from across the mesh) run this one function, and so does the
    column-sharded one (``col_sum``: the logits are summed over the model axis)."""
    B, n, D = e_neg.shape
    cd = e_in.dtype
    wide = _wide(cd)
    if bf16_chain:
        f_pos = torch.sum(e_in.to(wide) * e_pos.to(wide), dim=-1)
        f_neg = torch.einsum("bd,bnd->bn", e_in.to(wide), e_neg.to(wide))
    else:
        f_pos = torch.sum(e_in * e_pos, dim=-1).to(wide)
        f_neg = torch.einsum("bd,bnd->bn", e_in, e_neg).to(wide)
    if col_sum is not None:
        f_pos, f_neg = col_sum([f_pos, f_neg])
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * mask
    if fused:
        g_neg = torch.where(neg_valid, _sigmoid(f_neg, sigmoid_mode) * (-alpha),
                            torch.zeros((), dtype=f_neg.dtype, device=f_neg.device))
    else:
        g_neg = (0.0 - _sigmoid(f_neg, sigmoid_mode)) * alpha * neg_valid
    g_pos_in, g_neg_in, g_pos_out, g_neg_out = g_pos, g_neg, g_pos, g_neg
    if dup_div is not None:
        in_div, ctx_div, neg_div = dup_div
        g_pos_in, g_neg_in = g_pos / in_div, g_neg / in_div[:, None]
        g_pos_out = g_pos / ctx_div
        g_neg_out = g_neg / neg_div
    d_in = (g_pos_in[:, None].to(cd) * e_pos
            + torch.einsum("bn,bnd->bd", g_neg_in.to(cd), e_neg))
    # syn1's update rows, contexts then negatives, written in place into one buffer
    upd1 = torch.empty((B * (1 + n), D), dtype=cd, device=e_in.device)
    torch.mul(g_pos_out[:, None].to(cd), e_in, out=upd1[:B])
    torch.mul(g_neg_out[..., None].to(cd), e_in[:, None, :], out=upd1[B:].view(B, n, D))
    if (stabilizers or _OFF).update_clip:
        d_in, upd1 = clip_rows_together([d_in, upd1], stabilizers.update_clip, col_sum)
    if fused:
        neg_loss = torch.sum(torch.where(neg_valid, _log_sigmoid(-f_neg),
                                         torch.zeros((), dtype=f_neg.dtype,
                                                     device=f_neg.device)), dim=-1)
    else:
        neg_loss = torch.sum(_log_sigmoid(-f_neg) * neg_valid, dim=-1)
    return d_in, upd1, ((-_log_sigmoid(f_pos) * mask - neg_loss).sum(),
                        (f_pos * mask).sum())


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
    compute_dtype: Optional[torch.dtype] = None,
    fused: bool = False,
    bf16_chain: bool = False,
    hot_slabs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> StepMetrics:
    """One per-pair SGNS step (the reference's n negatives per pair), in place on
    ``params``. Negatives equal to their pair's context, and masked pairs, get zero
    gradient. ``scatter`` is the row scatter (the plain one only to hold the kernel
    against it). ``duplicate_scaling`` and ``stabilizers`` as in the JAX function:
    ``update_clip`` caps d_in, d_pos and every d_neg row; the touched rows are syn0's
    live centers and syn1's live contexts and their pairs' negatives.
    ``compute_dtype``, ``fused``, ``bf16_chain`` (both logits f32-accumulated) and
    ``hot_slabs`` as in the JAX function; the per-pair chain has no logits dtype."""
    syn0, syn1 = params
    B, n = negatives.shape
    cd = compute_dtype or syn0.dtype
    slab0, slab1 = hot_slabs if hot_slabs is not None else (None, None)
    e_in = _gather(syn0, centers, cd, slab0)                         # [B, D]
    e_pos = _gather(syn1, contexts, cd, slab1)                       # [B, D]
    e_neg = _gather(syn1, negatives, cd, slab1)                      # [B, n, D]
    neg_valid, neg_live = per_pair_valid(negatives, contexts, mask, fused)
    dup = None
    if duplicate_scaling:
        V = syn0.shape[0]
        cnt0 = _counts(V, (centers, mask))
        cnt1 = _counts(V, (contexts, mask), (negatives.reshape(-1), neg_valid.reshape(-1)))
        dup = (torch.clamp(cnt0[centers], min=1.0), torch.clamp(cnt1[contexts], min=1.0),
               torch.clamp(cnt1[negatives], min=1.0))
    d_in, upd1, (loss_num, fpos_num) = per_pair_updates_from_rows(
        e_in, e_pos, e_neg, mask, neg_valid, alpha, sigmoid_mode, dup_div=dup,
        stabilizers=stabilizers, fused=fused, bf16_chain=bf16_chain)
    idx1 = torch.cat([contexts, negatives.reshape(-1)])
    live1 = torch.cat([mask, neg_live.reshape(-1)])
    if hot_slabs is not None:
        hot_scatter_add(syn0, slab0, centers, d_in, mask, scatter)
        hot_scatter_add(syn1, slab1, idx1, upd1, live1, scatter)
    else:
        scatter(syn0, centers, d_in.to(syn0.dtype), mask)
        scatter(syn1, idx1, upd1.to(syn1.dtype), live1)
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
    return StepMetrics(loss_num / denom, fpos_num / denom, mask.sum())


def _cbow_hidden(syn0: torch.Tensor, contexts: torch.Tensor, ctx_mask: torch.Tensor,
                 cd: torch.dtype):
    """(hidden [B, D], ctx_n [B], has_ctx [B]): the mean of the live context rows, and
    its divisor, in the compute dtype ``cd``."""
    return cbow_hidden_from_rows(syn0[contexts].to(cd), ctx_mask)


def cbow_hidden_from_rows(e_ctx: torch.Tensor, ctx_mask: torch.Tensor):
    """:func:`_cbow_hidden` on the context rows already gathered ([B, C, D] in the
    compute dtype)."""
    cd = e_ctx.dtype
    ctx_count = ctx_mask.sum(dim=-1)
    ctx_n = torch.clamp(ctx_count, min=1.0).to(cd)
    hidden = torch.einsum("bc,bcd->bd", ctx_mask.to(cd), e_ctx) / ctx_n[:, None]
    return hidden, ctx_n, (ctx_count > 0).to(torch.float32)


def cbow_context_rows(d_hidden: torch.Tensor, ctx_n: torch.Tensor,
                      ctx_mask: torch.Tensor,
                      ctx_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The context slots' update rows [B·C, D]: the mean convention gives each live
    slot d_hidden / |context| (times ``ctx_scale`` [B, C], duplicate scaling's per-slot
    factor, when given); a dead slot's row is zero."""
    D = d_hidden.shape[1]
    d_ctx = (d_hidden / ctx_n[:, None])[:, None, :] \
        * ctx_mask.to(d_hidden.dtype)[..., None]                       # [B, C, D]
    if ctx_scale is not None:
        d_ctx = d_ctx * ctx_scale.to(d_hidden.dtype)[..., None]
    return d_ctx.reshape(-1, D)


def _scatter_cbow_contexts(syn0: torch.Tensor, contexts: torch.Tensor,
                           ctx_mask: torch.Tensor, mask: torch.Tensor,
                           d_hidden: torch.Tensor, ctx_n: torch.Tensor,
                           scatter: Scatter,
                           ctx_scale: Optional[torch.Tensor] = None) -> None:
    """Mean convention: each live context slot gets d_hidden / |context| (times
    ``ctx_scale`` [B, C], duplicate scaling's per-slot factor, when given)."""
    scatter(syn0, contexts.reshape(-1),
            cbow_context_rows(d_hidden, ctx_n, ctx_mask, ctx_scale).to(syn0.dtype),
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


def cbow_updates_from_rows(
    hidden: torch.Tensor, has_ctx: torch.Tensor, e_out: torch.Tensor,
    e_neg: torch.Tensor, centers: torch.Tensor, mask: torch.Tensor,
    negatives: torch.Tensor, alpha, sigmoid_mode: str = "exact", *,
    dup_div: Optional[Tuple[torch.Tensor, ...]] = None,
    stabilizers: Optional[Stabilizers] = None, col_sum: Optional[ColSum] = None,
):
    """The per-example CBOW step's math on the hidden mean and the rows already
    gathered in the compute dtype (e_out [B, D], e_neg [B, n, D]): d_hidden [B, D],
    syn1's update rows [B·(1 + n), D] (centers, then negatives), the live examples
    [B], the live negatives [B, n] and the loss and mean-f_pos numerators.
    ``dup_div`` (duplicate scaling): the context slots' scale [B, C] (1 / count) and
    the divisors of the centers' [B] and negatives' [B, n] updates. The
    single-device step and the row-sharded one run this one function; the
    column-sharded one too, with ``col_sum`` (the hidden mean is column-local)."""
    B, n, D = e_neg.shape
    cd = hidden.dtype
    wide = _wide(cd)
    neg_valid = (negatives != centers[:, None]).to(torch.float32) * mask[:, None]
    f_pos = torch.sum(hidden * e_out, dim=-1).to(wide)
    f_neg = torch.einsum("bd,bnd->bn", hidden, e_neg).to(wide)
    if col_sum is not None:
        f_pos, f_neg = col_sum([f_pos, f_neg])
    live = mask * has_ctx
    neg_live = neg_valid * has_ctx[:, None]
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * live
    g_neg = (0.0 - _sigmoid(f_neg, sigmoid_mode)) * alpha * neg_live
    g_pos_out, g_neg_out = g_pos, g_neg
    if dup_div is not None:
        _, out_div, neg_div = dup_div
        g_pos_out = g_pos / out_div
        g_neg_out = g_neg / neg_div
    d_hidden = (g_pos[:, None].to(cd) * e_out
                + torch.einsum("bn,bnd->bd", g_neg.to(cd), e_neg))
    upd1 = torch.empty((B * (1 + n), D), dtype=cd, device=hidden.device)
    torch.mul(g_pos_out[:, None].to(cd), hidden, out=upd1[:B])
    torch.mul(g_neg_out[..., None].to(cd), hidden[:, None, :],
              out=upd1[B:].view(B, n, D))
    if (stabilizers or _OFF).update_clip:
        d_hidden, upd1 = clip_rows_together([d_hidden, upd1], stabilizers.update_clip,
                                            col_sum)
    loss_num = (-_log_sigmoid(f_pos) * live
                - torch.sum(_log_sigmoid(-f_neg) * neg_live, dim=-1)).sum()
    return d_hidden, upd1, live, neg_live, (loss_num, (f_pos * live).sum())


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
    compute_dtype: Optional[torch.dtype] = None,
) -> StepMetrics:
    """One CBOW step with per-example negatives, in place on ``params``: hidden =
    mean of the context rows of syn0, the center is the positive, and the hidden
    gradient is split equally over the context slots. Examples with no context
    (``has_ctx = 0``) train nothing and do not count in ``pairs``.
    ``duplicate_scaling`` and ``stabilizers`` as in the JAX function: ``update_clip``
    caps d_hidden (before the split over the context slots), d_out and every d_neg
    row. ``compute_dtype`` as in the JAX function (the logits are f32-wide)."""
    syn0, syn1 = params
    B, n = negatives.shape
    cd = compute_dtype or syn0.dtype
    hidden, ctx_n, has_ctx = _cbow_hidden(syn0, contexts, ctx_mask, cd)
    e_out = syn1[centers].to(cd)                                     # [B, D]
    e_neg = syn1[negatives].to(cd)                                   # [B, n, D]
    dup = None
    if duplicate_scaling:
        V = syn0.shape[0]
        live = mask * has_ctx
        neg_live = (negatives != centers[:, None]).to(torch.float32) \
            * mask[:, None] * has_ctx[:, None]
        cnt0 = _counts(V, (contexts.reshape(-1), (ctx_mask * live[:, None]).reshape(-1)))
        cnt1 = _counts(V, (centers, live), (negatives.reshape(-1), neg_live.reshape(-1)))
        dup = (1.0 / torch.clamp(cnt0[contexts], min=1.0),
               torch.clamp(cnt1[centers], min=1.0), torch.clamp(cnt1[negatives], min=1.0))
    d_hidden, upd1, live, neg_live, (loss_num, fpos_num) = cbow_updates_from_rows(
        hidden, has_ctx, e_out, e_neg, centers, mask, negatives, alpha, sigmoid_mode,
        dup_div=dup, stabilizers=stabilizers)
    _scatter_cbow_contexts(syn0, contexts, ctx_mask, mask, d_hidden, ctx_n, scatter,
                           None if dup is None else dup[0])
    scatter(syn1, torch.cat([centers, negatives.reshape(-1)]), upd1.to(syn1.dtype),
            torch.cat([live, neg_live.reshape(-1)]))
    _cbow_post_pass(syn0, syn1, contexts, ctx_mask, mask, has_ctx, centers,
                    _mask_sentinel(negatives, mask[:, None].expand(B, n),
                                   syn0.shape[0]).reshape(-1), alpha, stabilizers)
    denom = torch.clamp(live.sum(), min=1.0)
    return StepMetrics(loss_num / denom, fpos_num / denom, live.sum())


def cbow_shared_updates_from_rows(
    hidden: torch.Tensor, has_ctx: torch.Tensor, e_out: torch.Tensor, Z: torch.Tensor,
    centers: torch.Tensor, mask: torch.Tensor, negatives: torch.Tensor, alpha,
    num_negatives: int, sigmoid_mode: str = "exact", *,
    stabilizers: Optional[Stabilizers] = None,
    logits_dtype: Optional[torch.dtype] = None, with_metrics: bool = True,
    col_sum: Optional[ColSum] = None,
):
    """The shared-pool CBOW step's math on the hidden mean and the rows already
    gathered in the compute dtype (e_out [B, D], Z [P, D]): d_hidden [B, D], syn1's
    update rows [B + P, D] (centers, then the pool), the live examples [B] and the
    loss and mean-f_pos numerators (zeros without ``with_metrics``). The single-device
    step and the row-sharded one run this one function; the pool rows' dZ is summed
    over the examples given (the sharded step sums the data shards' parts). The
    column-sharded step passes ``col_sum`` (the logits summed over the model axis)."""
    B, D = hidden.shape
    P = negatives.shape[0]
    cd = hidden.dtype
    ld = logits_dtype or _wide(cd)
    neg_valid = (negatives[None, :] != centers[:, None]).to(ld) * mask[:, None].to(ld)
    f_pos = torch.sum(hidden * e_out, dim=-1).to(_wide(cd))
    f_neg = (hidden @ Z.T).to(ld)                                    # [B, P]
    if col_sum is not None:
        f_pos, f_neg = col_sum([f_pos, f_neg])
    live = mask * has_ctx
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * live
    g_neg = ((0.0 - _sigmoid(f_neg, sigmoid_mode)) * _scalar(alpha, ld) * neg_valid
             * has_ctx[:, None].to(ld) * _scalar(num_negatives / P, ld))
    d_hidden = g_pos[:, None].to(cd) * e_out + g_neg.to(cd) @ Z
    upd1 = torch.empty((B + P, D), dtype=cd, device=hidden.device)
    torch.mul(g_pos[:, None].to(cd), hidden, out=upd1[:B])
    torch.matmul(g_neg.to(cd).T, hidden, out=upd1[B:])               # dZ [P, D]
    if (stabilizers or _OFF).update_clip:
        d_hidden, upd1[:B] = clip_rows_together([d_hidden, upd1[:B]],
                                                stabilizers.update_clip, col_sum)
    if with_metrics:
        neg_term = torch.sum(_log_sigmoid(-f_neg) * neg_valid * has_ctx[:, None].to(ld),
                             dim=-1, dtype=_wide(ld))
        stats = ((-_log_sigmoid(f_pos) * live - neg_term * (num_negatives / P)).sum(),
                 (f_pos * live).sum())
    else:
        zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
        stats = (zero, zero)
    return d_hidden, upd1, live, stats


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
    compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
) -> StepMetrics:
    """One CBOW step with a batch-shared pool of P negatives, each negative term
    reweighted by n/P, in place on ``params``: f_neg = hidden·Zᵀ and dZ = g_negᵀ·hidden.
    ``with_metrics=False`` skips the loss and mean_f_pos (both 0) and keeps ``pairs``
    exact, like the JAX package's elided twin. ``stabilizers`` as in the JAX function:
    ``update_clip`` caps d_hidden and d_out, never dZ; the touched rows are the live
    context slots, the live centers and the whole pool. ``compute_dtype`` and
    ``logits_dtype`` (the [B, P] chain) as in the JAX function."""
    syn0, syn1 = params
    P = negatives.shape[0]
    cd = compute_dtype or syn0.dtype
    hidden, ctx_n, has_ctx = _cbow_hidden(syn0, contexts, ctx_mask, cd)
    e_out = syn1[centers].to(cd)                                     # [B, D]
    Z = syn1[negatives].to(cd)                                       # [P, D]
    d_hidden, upd1, live, (loss_num, fpos_num) = cbow_shared_updates_from_rows(
        hidden, has_ctx, e_out, Z, centers, mask, negatives, alpha, num_negatives,
        sigmoid_mode, stabilizers=stabilizers, logits_dtype=logits_dtype,
        with_metrics=with_metrics)
    _scatter_cbow_contexts(syn0, contexts, ctx_mask, mask, d_hidden, ctx_n, scatter)
    scatter(syn1, torch.cat([centers, negatives]), upd1.to(syn1.dtype),
            torch.cat([live, torch.ones(P, dtype=live.dtype, device=live.device)]))
    _cbow_post_pass(syn0, syn1, contexts, ctx_mask, mask, has_ctx, centers, negatives,
                    alpha, stabilizers)
    if not with_metrics:
        return StepMetrics(loss_num, fpos_num, live.sum())
    denom = torch.clamp(live.sum(), min=1.0)
    return StepMetrics(loss_num / denom, fpos_num / denom, live.sum())


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
