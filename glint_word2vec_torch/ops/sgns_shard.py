"""The row-sharded shared-pool SGNS step, ported from
``glint_word2vec_tpu/ops/sgns_shard.py`` (its explicit ``shard_map`` schedule), op for
op, on a ``torch.distributed`` mesh (``parallel/mesh.py``).

The reference's discipline (Ordentlich et al., CIKM'16): ship indices and scalar
coefficients, keep embedding-row traffic off the wire. Per step, on a (data, model)
mesh with rows sharded over ``model`` (each rank owns ``Vs = Vp / num_model``
contiguous rows of both matrices) and the batch split over ``data`` (``Bl = B /
num_data`` pairs a rank):

1. **Forward assembly: ONE all_reduce over the model axis.** Each rank gathers the rows
   it owns (``index − row_offset``; rows it does not own exactly zero) for its data
   slice's centers and contexts and for the shared pool, into one ``[2·Bl + P, D]``
   block; one sum over the model group assembles the full rows (every row has one
   owner, so the sum adds exact zeros).
2. **The local coefficient chain** on the assembled rows: the port's shared helper
   (``ops/sgns.shared_pool_updates_from_rows``, with ``fused`` / ``bf16_chain`` and the
   stabilizers' update clip), the one the single-device steps run.
3. **Payload exchange: all_gathers over the data axis.** The update rows (``[2·Bl +
   P, D]``, cast to the parameters' dtype) and their index list. The batch mask rides
   in the index list (−1 on a masked slot), so the stabilizers' touched-row pass needs
   no third gather (the JAX schedule gathers the mask for it).
4. **Owner-local scatters.** Every rank applies the gathered rows it owns, one call of
   ``ops/scatter.scatter_add_rows_`` a matrix (the row-scatter kernel on the card). A
   slot the rank does not own (or a masked one) points at local row 0 with ``live =
   0``: the port's scatter has no drop mode and refuses out-of-range indices, so the
   JAX step's out-of-range sentinel never reaches it. No update row crosses the model
   axis.
5. **Metrics**: three scalars (the loss and mean-f_pos numerators and the pair count)
   summed over the data axis.

Every collective goes through ``parallel/distributed.COLLECTIVES``, which counts them:
a step issues one model-axis all_reduce (at ``num_model > 1``), two data-axis
all_gathers and one data-axis all_reduce (at ``num_data > 1``).

``sync_every = k > 1`` (local SGD) returns a *window* over k stacked steps: each rank
runs k owner-local steps on its data shard's replica (the forward assembly as above,
but each rank applies only its own payload: nothing crosses the data axis inside the
window), each data shard drawing from its own disjoint ``[k, P]`` slice of the negative
lattice; the window ends in one ``local_sgd_delta_merge`` (the mean of the replicas'
deltas) and one all_reduce of the ``[k, 3]`` metric numerators. The touched-row pass
runs on each rank's local touched set; the merge keeps a row clamp (convexity).

Both forms update the rank's row blocks in place and return :class:`.sgns.StepMetrics`
of the whole global batch (``[k]`` vectors for a window). Floating point: the sums run
in another order than the single-device step's (and than the JAX step's), so the steps
agree to reassociation tolerance, bit for bit only where no row repeats.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from glint_word2vec_torch.ops.scatter import scatter_add_rows_
from glint_word2vec_torch.ops.sgns import (
    Stabilizers, StepMetrics, shared_pool_loss_terms,
    shared_pool_updates_from_rows, stabilize_rows_)
from glint_word2vec_torch.parallel.distributed import COLLECTIVES, local_sgd_delta_merge
from glint_word2vec_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, MeshPlan


def owned_rows(mat: torch.Tensor, idx: torch.Tensor, row_offset: int) -> torch.Tensor:
    """``mat[idx − row_offset]`` for the indices this rank owns, exactly zero for the
    rest (``idx`` global, int64)."""
    loc = idx - row_offset
    own = (loc >= 0) & (loc < mat.shape[0])
    rows = mat[torch.where(own, loc, 0)]
    return torch.where(own[:, None], rows, torch.zeros((), dtype=mat.dtype,
                                                        device=mat.device))


def _plain_scatter(mat: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                   live: torch.Tensor) -> torch.Tensor:
    """``index_add_`` of the live slots: the scatter of the float64 steps, which the
    kernel does not take."""
    keep = torch.nonzero(live != 0).reshape(-1)
    return mat.index_add_(0, idx[keep], upd[keep])


def default_scatter(dtype: torch.dtype) -> Callable:
    """The row scatter for parameters of ``dtype``: the kernel's wrapper for f32 and
    bf16, a plain ``index_add_`` otherwise (the float64 tests)."""
    return scatter_add_rows_ if dtype in (torch.float32, torch.bfloat16) else _plain_scatter


def owner_local_scatter_add_(mat: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                             row_offset: int, scatter: Callable) -> None:
    """``mat[idx − row_offset] += upd`` for the slots this rank owns (``idx`` global;
    −1 marks a masked slot), in one ``scatter`` call: the other slots point at local
    row 0 with ``live = 0``."""
    loc = idx - row_offset
    own = (loc >= 0) & (loc < mat.shape[0])
    scatter(mat, torch.where(own, loc, 0).contiguous(), upd.contiguous(),
            own.to(torch.float32))


def _local_or_sentinel(idx: torch.Tensor, row_offset: int, vs: int) -> torch.Tensor:
    """The touched-row list of :func:`.sgns.stabilize_rows_`: local indices, ``vs``
    (its untouched sentinel) for the slots this rank does not own or that are masked."""
    loc = idx - row_offset
    return torch.where((loc >= 0) & (loc < vs), loc, vs)


def _finish_metrics(stats: torch.Tensor, with_metrics: bool) -> StepMetrics:
    """StepMetrics from summed [..., 3] numerators (loss, f_pos, pairs)."""
    pairs = stats[..., 2].to(torch.float32)
    if not with_metrics:
        zero = torch.zeros_like(pairs)
        return StepMetrics(zero, zero, pairs)
    denom = torch.clamp(stats[..., 2], min=1.0)
    return StepMetrics((stats[..., 0] / denom).to(torch.float32),
                       (stats[..., 1] / denom).to(torch.float32), pairs)


def make_sharded_sgns_step(
    plan: MeshPlan,
    num_negatives: int,
    sigmoid_mode: str = "exact",
    compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
    with_metrics: bool = True,
    stabilizers: Optional[Stabilizers] = None,
    fused: bool = False,
    bf16_chain: bool = False,
    sync_every: int = 1,
) -> Callable[..., StepMetrics]:
    """Build the row-sharded step on ``plan``. ``sync_every=1`` returns
    ``step(params, batch, negatives, alpha)``: ``params`` this rank's row blocks
    (``[Vs, D]`` each, updated in place), ``batch`` its data slice (``centers``,
    ``contexts``, ``mask``, ``[Bl]``), ``negatives`` the shared pool ``[P]`` (the same
    on every rank), ``alpha`` a float or a one-element tensor. ``sync_every = k > 1``
    returns ``window(params, batch, negatives, alphas)`` over ``[k, Bl]`` batch leaves,
    this data shard's ``[k, P]`` pool slice and ``[k]`` alphas. ``compute_dtype`` and
    ``logits_dtype`` (None: the parameters' dtype and its f32 widening), ``fused``,
    ``bf16_chain`` and ``stabilizers`` as in the JAX step factory; ``duplicate_scaling``
    and the hot rows have no sharded form. The owner-local scatters run
    :func:`default_scatter` of the parameters' dtype."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    nd, nm = plan.num_data, plan.num_model
    stab = stabilizers if stabilizers is not None and stabilizers.enabled else None
    post = stab is not None and stab.post_pass

    def assemble(syn0, syn1, centers, contexts, negatives, off):
        """Steps 1-2: owner-local gathers, the model-axis sum, the update rows."""
        cat = torch.cat([owned_rows(syn0, centers, off), owned_rows(syn1, contexts, off),
                         owned_rows(syn1, negatives, off)])
        if nm > 1:
            COLLECTIVES.all_reduce(cat, plan.model_group, MODEL_AXIS)
        return cat

    def chain(cat, bl, centers, contexts, mask, negatives, alpha, cd):
        e_in, e_pos, Z = cat[:bl].to(cd), cat[bl:2 * bl].to(cd), cat[2 * bl:].to(cd)
        return shared_pool_updates_from_rows(
            e_in, e_pos, Z, centers, contexts, mask, negatives, alpha, num_negatives,
            sigmoid_mode, torch.matmul, stab, logits_dtype, fused, bf16_chain)

    def stats_of(chain_out, mask) -> torch.Tensor:
        pairs = mask.sum()
        if not with_metrics:
            return torch.stack([torch.zeros_like(pairs), torch.zeros_like(pairs), pairs])
        loss_num, fpos_num = shared_pool_loss_terms(*chain_out, mask, num_negatives)
        wide = loss_num.dtype
        return torch.stack([loss_num, fpos_num.to(wide), pairs.to(wide)])

    def step(params, batch, negatives, alpha) -> StepMetrics:
        syn0, syn1 = params
        scat = default_scatter(syn0.dtype)
        vs, D = syn0.shape
        off = plan.model_index * vs
        centers, contexts = batch["centers"].long(), batch["contexts"].long()
        mask, negatives = batch["mask"], negatives.long()
        bl, pool = centers.shape[0], negatives.shape[0]
        cat = assemble(syn0, syn1, centers, contexts, negatives, off)
        d_in, d_pos, d_Z, ch = chain(cat, bl, centers, contexts, mask, negatives, alpha,
                                     compute_dtype or syn0.dtype)
        payload = torch.cat([d_in, d_pos, d_Z]).to(syn0.dtype)        # [2·Bl + P, D]
        live = mask > 0
        idx = torch.cat([torch.where(live, centers, -1), torch.where(live, contexts, -1),
                         negatives])
        if nd > 1:
            payload = COLLECTIVES.all_gather(payload, plan.data_group, DATA_AXIS)
            idx = COLLECTIVES.all_gather(idx, plan.data_group, DATA_AXIS)
        seg = payload.view(nd, 2 * bl + pool, D)
        seg_idx = idx.view(nd, 2 * bl + pool)
        idx0 = seg_idx[:, :bl].reshape(-1)
        idx1 = seg_idx[:, bl:].reshape(-1)
        owner_local_scatter_add_(syn0, idx0, seg[:, :bl].reshape(-1, D), off, scat)
        owner_local_scatter_add_(syn1, idx1, seg[:, bl:].reshape(-1, D), off, scat)
        if post:
            enable = (idx0 >= 0).any()
            stabilize_rows_(syn0, _local_or_sentinel(idx0, off, vs), alpha, stab, enable)
            stabilize_rows_(syn1, _local_or_sentinel(idx1, off, vs), alpha, stab, enable)
        stats = stats_of(ch, mask)
        if nd > 1:
            COLLECTIVES.all_reduce(stats, plan.data_group, DATA_AXIS)
        return _finish_metrics(stats, with_metrics)

    if sync_every == 1:
        return step
    k = int(sync_every)

    def owner_local_step(syn0, syn1, centers, contexts, mask, negatives, alpha, scat):
        """One in-window step on this rank's diverged replica: the same assembly, but
        only this rank's own payload is applied. Returns the [3] local numerators."""
        vs = syn0.shape[0]
        off = plan.model_index * vs
        bl = centers.shape[0]
        cat = assemble(syn0, syn1, centers, contexts, negatives, off)
        d_in, d_pos, d_Z, ch = chain(cat, bl, centers, contexts, mask, negatives, alpha,
                                     compute_dtype or syn0.dtype)
        live = mask > 0
        idx0 = torch.where(live, centers, -1)
        idx1 = torch.cat([torch.where(live, contexts, -1), negatives])
        owner_local_scatter_add_(syn0, idx0, d_in.to(syn0.dtype), off, scat)
        owner_local_scatter_add_(syn1, idx1, torch.cat([d_pos, d_Z]).to(syn1.dtype),
                                 off, scat)
        if post:
            enable = live.any()
            stabilize_rows_(syn0, _local_or_sentinel(idx0, off, vs), alpha, stab, enable)
            stabilize_rows_(syn1, _local_or_sentinel(idx1, off, vs), alpha, stab, enable)
        return stats_of(ch, mask)

    def window(params, batch, negatives, alphas) -> StepMetrics:
        syn0, syn1 = params
        scat = default_scatter(syn0.dtype)
        if batch["centers"].shape[0] != k:
            raise ValueError(f"sync_every={k} window needs [k, Bl]-stacked batch "
                             f"leaves, got leading dim {batch['centers'].shape[0]}")
        start = (syn0.clone(), syn1.clone())
        stats = torch.stack([
            owner_local_step(syn0, syn1, batch["centers"][i].long(),
                             batch["contexts"][i].long(), batch["mask"][i],
                             negatives[i].long(), alphas[i], scat)
            for i in range(k)])                                          # [k, 3]
        # the one data-axis collective of the window's parameters
        local_sgd_delta_merge(start, (syn0, syn1), plan.data_group, nd)
        if nd > 1:
            COLLECTIVES.all_reduce(stats, plan.data_group, DATA_AXIS)
        return _finish_metrics(stats, with_metrics)

    return window

