"""The row-sharded SGNS and CBOW steps, ported from
``glint_word2vec_tpu/ops/sgns_shard.py`` (its explicit ``shard_map`` schedule), on a
``torch.distributed`` mesh (``parallel/mesh.py``).

The reference's discipline (Ordentlich et al., CIKM'16): ship indices and scalar
coefficients, keep embedding-row traffic off the wire. Per step, on a (data, model)
mesh with rows sharded over ``model`` (each rank owns ``Vs = Vp / num_model``
contiguous rows of both matrices) and the batch split over ``data`` (``Bl = B /
num_data`` examples a rank):

1. **Forward assembly: ONE all_reduce over the model axis.** Each rank gathers the rows
   it owns (``index − row_offset``; rows it does not own exactly zero) for its data
   slice, into one block; one sum over the model group assembles the full rows (every
   row has one owner, so the sum adds exact zeros).
2. **The index list: an all_gather over the data axis.** Every slot a step may touch
   (−1 for a dead one: a masked pair, an empty context slot) in one int64 list, the
   syn0 slots then the syn1 slots. With ``duplicate_scaling`` every rank counts each
   of its slice's rows in this global list before the chain: the JAX step divides the
   coefficients by a row's count in the whole batch, before ``update_clip``. No
   [V]-sized collective is needed (the reference's ``shard_map`` refuses
   duplicate_scaling for that psum).
3. **The local chain** on the assembled rows: the port's shared helpers, the ones the
   single-device steps run (``ops/sgns.*_updates_from_rows``,
   ``ops/cbow_banded.banded_updates_from_rows``).
4. **Metrics** (the loss and mean-f_pos numerators, the examples, the mask's sum,
   which gates the touched-row pass as the whole batch's does): one all_reduce over
   the data axis.
5. **Payload exchange: an all_gather over the data axis** of the update rows, cast to
   the parameters' dtype.
6. **Owner-local scatters.** Every rank applies the gathered rows it owns, one call of
   ``ops/scatter.scatter_add_rows_`` a matrix (the row-scatter kernel on the card). A
   slot the rank does not own, or a dead one, points at local row 0 with ``live =
   0``: the port's scatter has no drop mode and refuses out-of-range indices, so the
   JAX step's out-of-range sentinel never reaches it. No update row crosses the model
   axis. Then the stabilizers' touched-row pass on the owned slots of the list.

The index list carries the touched slots of the stabilizers' pass, a superset of the
slots the single-device step scatters: the slots in between (a per-pair negative equal
to its context, a per-example CBOW negative of an example with no context) carry an
update of exactly zero.

The forms (each ``step(params, batch, negatives, alpha)`` over this rank's row blocks,
updated in place, and its data slice; each returns :class:`.sgns.StepMetrics` of the
whole global batch):

- :func:`make_sharded_sgns_step`: the shared-pool skip-gram step, [2·Bl + P] rows, with
  ``duplicate_scaling`` (the pool rows' scale counts the pairs of the whole batch) and,
  with ``sync_every = k > 1`` (local SGD), a *window* over k stacked steps: each rank
  runs k owner-local steps on its data shard's replica (the forward assembly as above,
  but each rank applies only its own payload), each data shard drawing from its own
  disjoint ``[k, P]`` slice of the negative lattice; the window ends in one
  ``local_sgd_delta_merge`` and one all_reduce of the ``[k, 3]`` metric numerators;
- :func:`make_sharded_per_pair_step`: the per-pair step (``negative_pool=0``), [Bl·(2
  + n)] rows, its negatives this data shard's [Bl, n] slice of the single-device draw;
- :func:`make_sharded_cbow_step`: scatter CBOW, [Bl·C + Bl + P] rows with the shared
  pool, [Bl·(C + 1 + n)] with per-example negatives (and ``duplicate_scaling``);
- :func:`make_sharded_banded_step`: banded CBOW on this data shard's token block,
  [2·T + P] rows; the endpoint delta runs locally.

Every collective goes through ``parallel/distributed.COLLECTIVES``, which counts them:
a synchronous step issues one model-axis all_reduce (at ``num_model > 1``), two
data-axis all_gathers and one data-axis all_reduce (at ``num_data > 1``). Floating
point: the sums run in another order than the single-device step's (and than the JAX
step's), so the steps agree to reassociation tolerance, bit for bit only where no row
repeats.

**The column layout** (``cols=True`` on every factory; ``embedding_partition="cols"``,
the reference's partial-dot scheme, which the JAX package runs under GSPMD): each rank
holds columns ``[m·Dc, (m+1)·Dc)`` of every row of both matrices (``plan.cols``), so
every row is local and step 1 is a plain gather of the rank's columns. The chain runs
on those columns and stops once, between its dot products and its sigmoid: the
:data:`.sgns.ColSum` hook sums the partial logits (``[Bl]`` + ``[Bl, P]`` scalars, or
``[Bl]`` + ``[Bl, n]`` per pair) in one model-axis all_reduce, and the rest of the chain
runs on the summed logits, identical on every rank of the model axis. A CBOW hidden
vector, the banded prefix sums and every update row (a coefficient times the other
matrix's columns) stay column-local. ``update_clip`` and ``max_row_norm`` need whole-row
norms: the squared norms of the rank's columns, summed by the same hook (one more
all_reduce each, of the clipped rows' and of the touched rows' partial norms);
``row_l2``'s decay is per column. The data axis runs as on rows: the index list and the
payload (now the rank's columns of each update row) are gathered, and every rank applies
every slot to its own column block through the row-scatter kernel. No update row crosses
the model axis.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch

from glint_word2vec_torch.ops.cbow_banded import banded_updates_from_rows
from glint_word2vec_torch.ops.scatter import scatter_add_rows_
from glint_word2vec_torch.ops.sgns import (
    Stabilizers, StepMetrics, _counts, cbow_context_rows, cbow_hidden_from_rows,
    cbow_shared_updates_from_rows, cbow_updates_from_rows, per_pair_updates_from_rows,
    per_pair_valid, shared_pool_loss_terms, shared_pool_updates_from_rows,
    stabilize_rows_, stabilize_rows_together_)
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
    """StepMetrics from summed [..., >= 3] numerators (loss, f_pos, examples)."""
    pairs = stats[..., 2].to(torch.float32)
    if not with_metrics:
        zero = torch.zeros_like(pairs)
        return StepMetrics(zero, zero, pairs)
    denom = torch.clamp(stats[..., 2], min=1.0)
    return StepMetrics((stats[..., 0] / denom).to(torch.float32),
                       (stats[..., 1] / denom).to(torch.float32), pairs)


def _gate(idx: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """``idx`` (int64, any shape) flattened, −1 where ``live`` is 0."""
    return torch.where(live > 0, idx, -1).reshape(-1)


def _count_live(Vp: int, idx: torch.Tensor, live: Optional[torch.Tensor] = None):
    """Each row's count [Vp] (float32) over the slots of ``idx`` that are >= 0 (and
    ``live``): exact integers, as the single-device step's ``_counts``."""
    ok = idx >= 0 if live is None else (idx >= 0) & live
    idx = idx.reshape(-1)
    ok = ok.reshape(-1)
    return _counts(Vp, (torch.where(ok, idx, 0), ok.to(torch.float32)))


def column_sum(plan: MeshPlan):
    """The column layout's :data:`.sgns.ColSum` on ``plan``: each tensor of the list
    summed over the model axis in one all_reduce (flattened together, in the widest of
    their dtypes and at least float32, each returned in its own dtype: a bf16 partial
    is summed in f32 and rounded once). None on a model axis of one."""
    if plan.num_model == 1:
        return None

    def col_sum(parts: List[torch.Tensor]) -> List[torch.Tensor]:
        wide = functools.reduce(torch.promote_types, [p.dtype for p in parts],
                                torch.float32)
        flat = torch.cat([p.reshape(-1).to(wide) for p in parts])
        COLLECTIVES.all_reduce(flat, plan.model_group, MODEL_AXIS)
        out, off = [], 0
        for p in parts:
            out.append(flat[off:off + p.numel()].view(p.shape).to(p.dtype))
            off += p.numel()
        return out

    return col_sum


class _Exchange:
    """One synchronous owner-local step's collectives and scatters on ``plan``: the
    model-axis row assembly, the data-axis index list, the metric all_reduce, the
    payload exchange, the owner-local scatters and the touched-row pass. ``cols``: the
    parameters are the rank's column blocks [Vp, Dc] (every row local, no assembly);
    ``col_sum`` is the chain's hook (:func:`column_sum`), None on rows."""

    def __init__(self, plan: MeshPlan, params, stab: Optional[Stabilizers],
                 cols: bool = False):
        self.plan = plan
        self.syn0, self.syn1 = params
        self.cols = cols
        self.vs = self.syn0.shape[0]
        self.off = 0 if cols else plan.model_index * self.vs
        self.Vp = self.vs if cols else self.vs * plan.num_model
        self.stab = stab
        self.scat = default_scatter(self.syn0.dtype)
        self.col_sum = column_sum(plan) if cols else None

    def assemble(self, parts) -> list:
        """The full rows of each ``(matrix, global index)`` of ``parts`` (this rank's
        owned rows, summed over the model axis), split back into the parts. Under
        ``cols`` the rank's columns of every row, gathered locally."""
        if self.cols:
            return [m[i.reshape(-1)] for m, i in parts]
        cat = torch.cat([owned_rows(m, i.reshape(-1), self.off) for m, i in parts])
        if self.plan.num_model > 1:
            COLLECTIVES.all_reduce(cat, self.plan.model_group, MODEL_AXIS)
        sizes = [i.numel() for _, i in parts]
        return list(torch.split(cat, sizes))

    def gather_index(self, idx0: torch.Tensor, idx1: torch.Tensor) -> torch.Tensor:
        """The data axis's index lists [num_data, n0 + n1] (syn0's slots, then
        syn1's), in data order."""
        self.n0 = idx0.shape[0]
        idx = torch.cat([idx0, idx1])
        if self.plan.num_data > 1:
            idx = COLLECTIVES.all_gather(idx, self.plan.data_group, DATA_AXIS)
        self.idx = idx.view(self.plan.num_data, -1)
        return self.idx

    def reduce_stats(self, loss_num, fpos_num, examples, gate) -> torch.Tensor:
        """[loss numerator, f_pos numerator, examples, gate] summed over the data axis
        (``gate``: the mask's sum, which enables the touched-row pass)."""
        wide = loss_num.dtype
        stats = torch.stack([loss_num, fpos_num.to(wide), examples.to(wide),
                             gate.to(wide)])
        if self.plan.num_data > 1:
            COLLECTIVES.all_reduce(stats, self.plan.data_group, DATA_AXIS)
        return stats

    def apply(self, upd0: torch.Tensor, upd1: torch.Tensor, alpha,
              stats: torch.Tensor) -> None:
        """Gather the payload (the update rows of the index list, in its order) over
        the data axis, scatter the owned slots into this rank's blocks, then the
        touched-row pass."""
        syn0, syn1, nd = self.syn0, self.syn1, self.plan.num_data
        D = syn0.shape[1]
        payload = torch.cat([upd0.to(syn0.dtype), upd1.to(syn1.dtype)])
        if nd > 1:
            payload = COLLECTIVES.all_gather(payload, self.plan.data_group, DATA_AXIS)
        seg = payload.view(nd, -1, D)
        idx0 = self.idx[:, :self.n0].reshape(-1)
        idx1 = self.idx[:, self.n0:].reshape(-1)
        owner_local_scatter_add_(syn0, idx0, seg[:, :self.n0].reshape(-1, D), self.off,
                                 self.scat)
        owner_local_scatter_add_(syn1, idx1, seg[:, self.n0:].reshape(-1, D), self.off,
                                 self.scat)
        if self.stab is not None and self.stab.post_pass:
            enable = stats[3] > 0
            stabilize_rows_together_(
                [(syn0, _local_or_sentinel(idx0, self.off, self.vs)),
                 (syn1, _local_or_sentinel(idx1, self.off, self.vs))],
                alpha, self.stab, enable, self.col_sum)


def _stab_or_none(stabilizers: Optional[Stabilizers]) -> Optional[Stabilizers]:
    return stabilizers if stabilizers is not None and stabilizers.enabled else None


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
    duplicate_scaling: bool = False,
    cols: bool = False,
) -> Callable[..., StepMetrics]:
    """Build the row-sharded shared-pool step on ``plan``. ``sync_every=1`` returns
    ``step(params, batch, negatives, alpha)``: ``params`` this rank's row blocks
    (``[Vs, D]`` each, updated in place), ``batch`` its data slice (``centers``,
    ``contexts``, ``mask``, ``[Bl]``), ``negatives`` the shared pool ``[P]`` (the same
    on every rank), ``alpha`` a float or a one-element tensor. ``sync_every = k > 1``
    returns ``window(params, batch, negatives, alphas)`` over ``[k, Bl]`` batch leaves,
    this data shard's ``[k, P]`` pool slice and ``[k]`` alphas. ``compute_dtype`` and
    ``logits_dtype`` (None: the parameters' dtype and its f32 widening), ``fused``,
    ``bf16_chain``, ``stabilizers`` and ``duplicate_scaling`` (synchronous steps only,
    as the JAX config has it) as in the JAX step factory. The owner-local scatters run
    :func:`default_scatter` of the parameters' dtype. ``cols``: ``params`` are this
    rank's column blocks ``[Vp, Dc]`` (synchronous steps only: the column layout runs
    under GSPMD in the JAX package, which has no local-SGD form)."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    if cols and sync_every > 1:
        raise ValueError("the column layout has no local-SGD window form "
                         "(sync_every=1)")
    if duplicate_scaling and sync_every > 1:
        raise ValueError("duplicate_scaling has no local-SGD window form")
    nd = plan.num_data
    stab = _stab_or_none(stabilizers)
    post = stab is not None and stab.post_pass

    def chain(e_in, e_pos, Z, centers, contexts, mask, negatives, alpha, cd,
              dup_scales=None, col_sum=None):
        return shared_pool_updates_from_rows(
            e_in.to(cd), e_pos.to(cd), Z.to(cd), centers, contexts, mask, negatives,
            alpha, num_negatives, sigmoid_mode, torch.matmul, stab, logits_dtype, fused,
            bf16_chain, dup_scales=dup_scales, col_sum=col_sum)

    def loss_terms(chain_out, mask):
        if not with_metrics:
            zero = torch.zeros((), dtype=torch.float32, device=mask.device)
            return zero, zero
        return shared_pool_loss_terms(*chain_out, mask, num_negatives)

    def step(params, batch, negatives, alpha) -> StepMetrics:
        ex = _Exchange(plan, params, stab, cols)
        centers, contexts = batch["centers"].long(), batch["contexts"].long()
        mask, negatives = batch["mask"], negatives.long()
        e_in, e_pos, Z = ex.assemble([(ex.syn0, centers), (ex.syn1, contexts),
                                      (ex.syn1, negatives)])
        idx = ex.gather_index(_gate(centers, mask),
                              torch.cat([_gate(contexts, mask), negatives]))
        dup = None
        if duplicate_scaling:
            bl = centers.shape[0]
            cnt_in = _count_live(ex.Vp, idx[:, :bl])
            cnt_out = _count_live(ex.Vp, idx[:, bl:2 * bl])
            ones = torch.ones(negatives.shape[0], dtype=torch.float32,
                              device=mask.device)
            pool_mult = _counts(ex.Vp, (negatives, ones))[negatives]
            # each pool slot's valid pairs in the whole batch: the live pairs whose
            # context is another word
            valid = (idx[:, bl:2 * bl] >= 0).sum().to(torch.float32) - cnt_out[negatives]
            dup = (1.0 / torch.clamp(cnt_in[centers], min=1.0),
                   torch.clamp(cnt_out[contexts], min=1.0),
                   1.0 / (torch.clamp(valid, min=1.0) * pool_mult))
        d_in, d_pos, d_Z, ch = chain(e_in, e_pos, Z, centers, contexts, mask, negatives,
                                     alpha, compute_dtype or ex.syn0.dtype, dup,
                                     ex.col_sum)
        stats = ex.reduce_stats(*loss_terms(ch, mask), mask.sum(), mask.sum())
        ex.apply(d_in, torch.cat([d_pos, d_Z]), alpha, stats)
        return _finish_metrics(stats, with_metrics)

    if sync_every == 1:
        return step
    k = int(sync_every)

    def owner_local_step(syn0, syn1, centers, contexts, mask, negatives, alpha, scat):
        """One in-window step on this rank's diverged replica: the same assembly, but
        only this rank's own payload is applied. Returns the [3] local numerators."""
        ex = _Exchange(plan, (syn0, syn1), stab)
        vs, off = ex.vs, ex.off
        e_in, e_pos, Z = ex.assemble([(syn0, centers), (syn1, contexts),
                                      (syn1, negatives)])
        d_in, d_pos, d_Z, ch = chain(e_in, e_pos, Z, centers, contexts, mask, negatives,
                                     alpha, compute_dtype or syn0.dtype)
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
        loss_num, fpos_num = loss_terms(ch, mask)
        wide = loss_num.dtype
        return torch.stack([loss_num, fpos_num.to(wide), mask.sum().to(wide)])

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


def make_sharded_per_pair_step(
    plan: MeshPlan,
    sigmoid_mode: str = "exact",
    compute_dtype: Optional[torch.dtype] = None,
    stabilizers: Optional[Stabilizers] = None,
    fused: bool = False,
    bf16_chain: bool = False,
    duplicate_scaling: bool = False,
    cols: bool = False,
) -> Callable[..., StepMetrics]:
    """The row-sharded per-pair step (the JAX package's ``sgns_step_core`` on a mesh):
    ``step(params, batch, negatives, alpha)`` with ``batch`` this rank's data slice
    (``centers``, ``contexts``, ``mask``, [Bl]) and ``negatives`` its [Bl, n] slice of
    the single-device draw. ``compute_dtype``, ``stabilizers``, ``fused``,
    ``bf16_chain`` and ``duplicate_scaling`` as in the single-device step; the metrics
    are always computed (the per-pair step has no elided twin). ``cols``: the
    column-sharded step on this rank's column blocks."""
    stab = _stab_or_none(stabilizers)

    def step(params, batch, negatives, alpha) -> StepMetrics:
        ex = _Exchange(plan, params, stab, cols)
        centers, contexts = batch["centers"].long(), batch["contexts"].long()
        mask, negatives = batch["mask"], negatives.long()
        bl, n = negatives.shape
        cd = compute_dtype or ex.syn0.dtype
        e_in, e_pos, e_neg = ex.assemble([(ex.syn0, centers), (ex.syn1, contexts),
                                          (ex.syn1, negatives)])
        neg_valid, _ = per_pair_valid(negatives, contexts, mask, fused)
        idx = ex.gather_index(_gate(centers, mask), torch.cat([
            _gate(contexts, mask), _gate(negatives, mask[:, None].expand(bl, n))]))
        dup = None
        if duplicate_scaling:
            ctx_g = idx[:, bl:2 * bl]
            neg_g = idx[:, 2 * bl:].view(-1, bl, n)
            cnt0 = _count_live(ex.Vp, idx[:, :bl])
            cnt1 = _count_live(ex.Vp, ctx_g) + _count_live(
                ex.Vp, neg_g, neg_g != ctx_g[..., None])
            dup = (torch.clamp(cnt0[centers], min=1.0),
                   torch.clamp(cnt1[contexts], min=1.0),
                   torch.clamp(cnt1[negatives], min=1.0))
        d_in, upd1, (loss_num, fpos_num) = per_pair_updates_from_rows(
            e_in.to(cd), e_pos.to(cd), e_neg.to(cd).view(bl, n, -1), mask, neg_valid,
            alpha, sigmoid_mode, dup_div=dup, stabilizers=stab, fused=fused,
            bf16_chain=bf16_chain, col_sum=ex.col_sum)
        stats = ex.reduce_stats(loss_num, fpos_num, mask.sum(), mask.sum())
        ex.apply(d_in, upd1, alpha, stats)
        return _finish_metrics(stats, True)

    return step


def make_sharded_cbow_step(
    plan: MeshPlan,
    num_negatives: int,
    shared_pool: bool,
    sigmoid_mode: str = "exact",
    compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
    with_metrics: bool = True,
    stabilizers: Optional[Stabilizers] = None,
    duplicate_scaling: bool = False,
    cols: bool = False,
) -> Callable[..., StepMetrics]:
    """The row-sharded scatter CBOW step (the JAX package's ``cbow_step_shared_core``
    with ``shared_pool``, else ``cbow_step_core``, on a mesh): ``step(params, batch,
    negatives, alpha)`` with ``batch`` this rank's data slice (``centers`` [Bl],
    ``contexts`` and ``ctx_mask`` [Bl, C], ``mask`` [Bl]) and ``negatives`` the shared
    pool [P] or this data shard's [Bl, n] slice of the per-example draw.
    ``duplicate_scaling`` (per-example negatives only, as the JAX config has it),
    ``stabilizers``, ``compute_dtype`` and ``logits_dtype`` (the pool's chain) as in
    the single-device steps. ``cols``: the column-sharded step on this rank's column
    blocks."""
    if duplicate_scaling and shared_pool:
        raise ValueError("duplicate_scaling CBOW runs per-example negatives "
                         "(negative_pool=0), as in the JAX package")
    stab = _stab_or_none(stabilizers)

    def step(params, batch, negatives, alpha) -> StepMetrics:
        ex = _Exchange(plan, params, stab, cols)
        centers, contexts = batch["centers"].long(), batch["contexts"].long()
        ctx_mask, mask, negatives = batch["ctx_mask"], batch["mask"], negatives.long()
        bl, C = contexts.shape
        cd = compute_dtype or ex.syn0.dtype
        e_ctx, e_out, e_neg = ex.assemble([(ex.syn0, contexts), (ex.syn1, centers),
                                           (ex.syn1, negatives)])
        hidden, ctx_n, has_ctx = cbow_hidden_from_rows(
            e_ctx.to(cd).view(bl, C, -1), ctx_mask)
        live = mask * has_ctx
        neg_idx = (negatives if shared_pool
                   else _gate(negatives, mask[:, None].expand_as(negatives)))
        idx = ex.gather_index(_gate(contexts, ctx_mask * mask[:, None]),
                              torch.cat([_gate(centers, live), neg_idx]))
        if shared_pool:
            d_hidden, upd1, live, (loss_num, fpos_num) = cbow_shared_updates_from_rows(
                hidden, has_ctx, e_out.to(cd), e_neg.to(cd), centers, mask, negatives,
                alpha, num_negatives, sigmoid_mode, stabilizers=stab,
                logits_dtype=logits_dtype, with_metrics=with_metrics,
                col_sum=ex.col_sum)
            ctx_scale = None
        else:
            n = negatives.shape[1]
            dup = None
            if duplicate_scaling:
                cen_g = idx[:, bl * C:bl * C + bl]
                neg_g = idx[:, bl * C + bl:].view(-1, bl, n)
                cnt0 = _count_live(ex.Vp, idx[:, :bl * C])
                cnt1 = _count_live(ex.Vp, cen_g) + _count_live(
                    ex.Vp, neg_g, (cen_g[..., None] >= 0) & (neg_g != cen_g[..., None]))
                dup = (1.0 / torch.clamp(cnt0[contexts], min=1.0),
                       torch.clamp(cnt1[centers], min=1.0),
                       torch.clamp(cnt1[negatives], min=1.0))
            d_hidden, upd1, live, _, (loss_num, fpos_num) = cbow_updates_from_rows(
                hidden, has_ctx, e_out.to(cd), e_neg.to(cd).view(bl, n, -1), centers,
                mask, negatives, alpha, sigmoid_mode, dup_div=dup, stabilizers=stab,
                col_sum=ex.col_sum)
            ctx_scale = None if dup is None else dup[0]
        d_ctx = cbow_context_rows(d_hidden, ctx_n, ctx_mask, ctx_scale)
        stats = ex.reduce_stats(loss_num, fpos_num, live.sum(), mask.sum())
        ex.apply(d_ctx, upd1, alpha, stats)
        return _finish_metrics(stats, with_metrics or not shared_pool)

    return step


def make_sharded_banded_step(
    plan: MeshPlan,
    num_negatives: int,
    window: int,
    sigmoid_mode: str = "exact",
    compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
    with_metrics: bool = True,
    stabilizers: Optional[Stabilizers] = None,
    cols: bool = False,
) -> Callable[..., StepMetrics]:
    """The row-sharded banded CBOW step (the JAX package's ``cbow_step_banded_core``
    on a mesh, each data shard on its own token block): ``step(params, batch,
    negatives, alpha)`` with ``batch`` this rank's block (``tokens``, ``left``,
    ``right`` int64 [T], ``center`` and ``token`` float32 [T]) and ``negatives`` the
    shared pool [P]. The prefix sums and the endpoint delta run locally (the endpoint's
    scatter form through :func:`default_scatter` on the card); the tokens' syn0 and
    syn1 updates and the pool's go to their owners. ``cols``: the column-sharded step on
    this rank's column blocks."""
    stab = _stab_or_none(stabilizers)

    def step(params, batch, negatives, alpha) -> StepMetrics:
        ex = _Exchange(plan, params, stab, cols)
        tokens, negatives = batch["tokens"].long(), negatives.long()
        center, token = batch["center"], batch["token"]
        left, right = batch["left"], batch["right"]
        cd = compute_dtype or ex.syn0.dtype
        e, e_out, Z = ex.assemble([(ex.syn0, tokens), (ex.syn1, tokens),
                                   (ex.syn1, negatives)])
        live = center * ((left + right) > 0).to(torch.float32)
        ex.gather_index(_gate(tokens, token), torch.cat([_gate(tokens, live), negatives]))
        d_ctx, d_out, d_Z, live, (loss_num, fpos_num) = banded_updates_from_rows(
            e, e_out.to(cd), Z.to(cd), tokens, left, right, center, token, negatives,
            alpha, num_negatives, window, sigmoid_mode, with_metrics, ex.scat,
            stabilizers=stab, logits_dtype=logits_dtype, col_sum=ex.col_sum)
        stats = ex.reduce_stats(loss_num, fpos_num, live.sum(), token.sum())
        ex.apply(d_ctx, torch.cat([d_out, d_Z]), alpha, stats)
        return _finish_metrics(stats, with_metrics)

    return step
