"""Banded CBOW step, ported from ``glint_word2vec_tpu/ops/cbow_banded.py``: the context
gathers and scatters of CBOW as prefix-sum differences over a sentence-ordered token
block, O(T) rows instead of the scatter step's T·C.

When slot b of a block holds kept token b of the stream, with window interval
[b − left_b, b + right_b] (from ``ops/pairgen.device_cbow_windows``):

- forward: ``hidden_b = (S[b + r_b] − S[b − l_b − 1] − e_b) / n_b`` with S the
  inclusive prefix sum of the gathered rows e = syn0[tokens];
- backward: slot j receives ``Σ_{b : j ∈ interval_b} g_b`` with g_b = d_hidden_b / n_b:
  +g_b at each interval start, −g_b one past each end, a prefix sum, then the self
  term g_b removed at b.

Prefix sums run in ``promote_types(param dtype, float32)``: the differences cancel, so
they are never taken in a narrower type.

Differences from the JAX module, none of which changes what is computed:

- :func:`cumsum_rows` is ``torch.cumsum`` on the CPU; on the card it is two levels of
  ``torch.cumsum`` (within chunks of :data:`SCAN_CHUNK` rows, then over the chunk
  totals), the JAX package's decomposition with a scan where it has a triangular
  matmul;
- the step updates ``params`` in place (every gather before the first scatter) and
  returns only the metrics, like the port's other in-place steps; its row updates go
  through ``ops/scatter.scatter_add_rows_`` (the CUDA row-scatter kernel on the card),
  ``scatter=`` replaces it (the float64 tests pass ``index_add_``);
- on CUDA tensors the endpoint delta takes the form :data:`CUDA_ENDPOINT` (the scatter
  form through ``scatter``: one kernel launch instead of ~4 torch ops per shift, ~40 at
  window 5); on the CPU it follows the JAX rule (the unrolled shifted adds up to window
  16), so the CPU path reproduces the JAX package's arithmetic. ``endpoint=`` forces
  either form.

``duplicate_scaling`` has no banded form (refused by the config, as in the JAX package).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from glint_word2vec_torch.ops.scatter import scatter_add_rows_
from glint_word2vec_torch.ops.sgns import (
    _OFF, ColSum, EmbeddingPair, Scatter, StepMetrics, Stabilizers, _log_sigmoid,
    _mask_sentinel, _scalar, _sigmoid, _wide, clip_rows_together, stabilize_rows_)

# above this window the unrolled shifted adds (2·window [T, D] terms) lose to one
# 2T-row scatter-add (the JAX package's rule for its CPU and TPU path)
_SHIFT_UNROLL_MAX_WINDOW = 16
ENDPOINT_FORMS = ("auto", "shift", "scatter")
# the endpoint form of ``endpoint="auto"`` on CUDA tensors (stepprof --endpoint A/Bs it)
CUDA_ENDPOINT = "scatter"
# rows per chunk of the two-level prefix sum on the card (stepprof times 32 to 256)
SCAN_CHUNK = 64


def cumsum_rows(x: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """Inclusive prefix sum along dim 0 of a [T, D] tensor, in its own dtype (the
    caller picks one at least float32). On CUDA tensors in two levels: each chunk of
    ``chunk`` rows (default :data:`SCAN_CHUNK`) scanned alone, then each chunk offset
    by the scanned totals of the chunks before it. torch's scan along dim 0 of a tall
    tensor runs one thread per column down all T rows: 0.85 ms at [8202, 384] on an
    H100, 90% of the banded step (stepprof ``--path cbow_banded``, ``parts``)."""
    if not x.is_cuda:
        # graftlint: disable=R4 -- the dtype is the caller's contract (docstring above); both call sites pass >= f32 and are R4-checked there, as in the JAX package
        return torch.cumsum(x, dim=0)
    return _cumsum_rows_chunked(x, chunk or SCAN_CHUNK)


def _cumsum_rows_chunked(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """:func:`cumsum_rows`' two-level form, on any device."""
    T, D = x.shape
    rows = -(-T // chunk)
    # graftlint: disable=R4 -- the dtype is the caller's contract (docstring above); both call sites pass >= f32 and are R4-checked there, as in the JAX package
    within = torch.cumsum(torch.nn.functional.pad(x, (0, 0, 0, rows * chunk - T))
                          .view(rows, chunk, D), dim=1)
    totals = within[:, -1]
    # graftlint: disable=R4 -- the dtype is the caller's contract (docstring above); both call sites pass >= f32 and are R4-checked there, as in the JAX package
    offsets = torch.cumsum(totals, dim=0) - totals                  # exclusive
    return (within + offsets[:, None]).view(rows * chunk, D)[:T]


def _band_endpoint_delta(
    g: torch.Tensor,       # [T, D] per-example spread gradient (rows of dead slots 0)
    left: torch.Tensor,    # int64 [T]
    right: torch.Tensor,   # int64 [T]
    window: int,
    form: str = "auto",
    scatter: Scatter = scatter_add_rows_,
    live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The difference array of the backward spread: +g_b at ``b − left_b``, −g_b at
    ``b + right_b + 1`` (an end at T is dropped: its prefix mass is never read).

    ``form="shift"``: since left ∈ [0, window) and right + 1 ∈ [1, window], 2·window
    shifted masked adds. ``form="scatter"``: one 2T-row ``scatter`` into a zeroed
    [T + 1, D] target, sliced to [:T]; ``live`` [T] skips the rows of dead slots
    (their g is 0). ``form="auto"``: the JAX rule, shifts up to window 16."""
    T, D = g.shape
    if form == "auto":
        form = "shift" if window <= _SHIFT_UNROLL_MAX_WINDOW else "scatter"
    if form == "scatter":
        t = torch.arange(T, dtype=torch.int64, device=g.device)
        out = torch.zeros((T + 1, D), dtype=g.dtype, device=g.device)
        scatter(out, torch.cat([t - left, t + right + 1]), torch.cat([g, -g]),
                None if live is None else torch.cat([live, live]))
        return out[:T]
    if form != "shift":
        raise ValueError(f"endpoint form must be one of {ENDPOINT_FORMS}, got {form!r}")
    # start marks: g_b lands at j = b − left_b  ⇔  left[j + d] == d, d ∈ [0, W)
    gs = torch.nn.functional.pad(g, (0, 0, 0, window))
    ls = torch.nn.functional.pad(left, (0, window), value=-1)
    delta = torch.zeros((T, D), dtype=g.dtype, device=g.device)
    for d in range(window):
        sel = (ls[d:d + T] == d).to(g.dtype)[:, None]
        delta = delta + gs[d:d + T] * sel
    # end marks: g_b removed at j = b + right_b + 1  ⇔  right[j − d] == d − 1,
    # d ∈ [1, W]
    ge = torch.nn.functional.pad(g, (0, 0, window, 0))
    re = torch.nn.functional.pad(right, (window, 0), value=-2)
    for d in range(1, window + 1):
        sel = (re[window - d:window - d + T] == d - 1).to(g.dtype)[:, None]
        delta = delta - ge[window - d:window - d + T] * sel
    return delta


def cbow_step_banded_core(
    params: EmbeddingPair,
    tokens: torch.Tensor,       # int64 [T] — kept tokens, sentence-contiguous
    left: torch.Tensor,         # int64 [T] — context extent left (in-sentence)
    right: torch.Tensor,        # int64 [T] — context extent right
    center_mask: torch.Tensor,  # float32 [T] — 1.0 for slots trained as centers
    token_mask: torch.Tensor,   # float32 [T] — 1.0 for valid token slots
    negatives: torch.Tensor,    # int64 [P] — pre-drawn shared pool
    alpha: Union[float, torch.Tensor],
    num_negatives: int,
    window: int,
    sigmoid_mode: str = "exact",
    with_metrics: bool = True,
    scatter: Scatter = scatter_add_rows_,
    *,
    stabilizers: Optional[Stabilizers] = None,
    endpoint: str = "auto",
    compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
) -> StepMetrics:
    """One banded CBOW step, in place on ``params``: the shared-pool scatter CBOW step
    (``ops/sgns.cbow_step_shared_core``) on the examples {b : center_mask_b = 1,
    left_b + right_b > 0} with contexts ``tokens[b − left_b : b + right_b + 1] \\ {b}``,
    equal to it up to the order of floating-point sums.

    Halo slots carry ``center_mask 0`` and ``token_mask 1``: they train no example in
    this block but receive the context gradient of this block's centers, so each
    (center, context) link is applied once across the overlapping blocks.

    Three scatters: syn0 at the tokens, syn1 at the tokens then the pool, and (the
    endpoint delta's scatter form, ``endpoint="auto"`` on CUDA) the difference array.
    ``stabilizers``: ``update_clip`` caps d_hidden (before the spread) and d_out, never
    dZ; the touched rows are syn0 at every valid slot (a context-less token too: the
    one touched-set difference from the scatter step, as in the JAX package), syn1 at
    the live centers and the whole pool. ``compute_dtype`` and ``logits_dtype`` as in
    the JAX function (default: the parameters' dtype and its f32-wide type); the prefix
    sums stay in ``promote_types(param dtype, float32)``."""
    if endpoint not in ENDPOINT_FORMS:
        raise ValueError(f"endpoint must be one of {ENDPOINT_FORMS}, got {endpoint!r}")
    syn0, syn1 = params
    P = negatives.shape[0]
    dev = syn0.device
    cd = compute_dtype or syn0.dtype
    d_ctx, d_out, d_Z, live, stats = banded_updates_from_rows(
        syn0[tokens], syn1[tokens].to(cd), syn1[negatives].to(cd), tokens, left, right,
        center_mask, token_mask, negatives, alpha, num_negatives, window, sigmoid_mode,
        with_metrics, scatter, stabilizers=stabilizers, endpoint=endpoint,
        logits_dtype=logits_dtype)
    scatter(syn0, tokens, d_ctx.to(syn0.dtype), token_mask)
    scatter(syn1, torch.cat([tokens, negatives]), torch.cat([d_out, d_Z]).to(syn1.dtype),
            torch.cat([live, torch.ones(P, dtype=live.dtype, device=dev)]))
    if (stabilizers or _OFF).post_pass:
        V = syn0.shape[0]
        enable = token_mask.sum() > 0
        stabilize_rows_(syn0, _mask_sentinel(tokens, token_mask, V), alpha,
                        stabilizers, enable)
        stabilize_rows_(syn1, torch.cat([_mask_sentinel(tokens, live, V), negatives]),
                        alpha, stabilizers, enable)
    pairs = live.sum()
    if not with_metrics:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return StepMetrics(zero, zero, pairs)
    denom = torch.clamp(pairs, min=1.0)
    return StepMetrics(stats[0] / denom, stats[1] / denom, pairs)


def banded_updates_from_rows(
    e: torch.Tensor,            # [T, D] syn0 rows of the tokens, the parameters' dtype
    e_out: torch.Tensor,        # [T, D] syn1 rows of the tokens, the compute dtype
    Z: torch.Tensor,            # [P, D] syn1 rows of the pool, the compute dtype
    tokens: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
    center_mask: torch.Tensor, token_mask: torch.Tensor, negatives: torch.Tensor,
    alpha, num_negatives: int, window: int, sigmoid_mode: str = "exact",
    with_metrics: bool = True, scatter: Scatter = scatter_add_rows_, *,
    stabilizers: Optional[Stabilizers] = None, endpoint: str = "auto",
    logits_dtype: Optional[torch.dtype] = None, col_sum: Optional[ColSum] = None,
):
    """The banded step's math on rows already gathered: the tokens' context update
    rows d_ctx [T, D] (in ``promote_types(e.dtype, float32)``, zero at dead slots),
    their output rows d_out [T, D] and the pool's dZ [P, D] (the compute dtype), the
    live examples [T] and the loss and mean-f_pos numerators (zeros without
    ``with_metrics``). ``scatter`` builds the endpoint delta's scatter form. The
    single-device step and the row-sharded one (``ops/sgns_shard.py``) run this one
    function, and so does the column-sharded one: its rows are a rank's columns (the
    prefix sums run along the token axis, column by column), and ``col_sum`` sums the
    logits over the model axis."""
    T = tokens.shape[0]
    P = negatives.shape[0]
    dev = e.device
    t = torch.arange(T, dtype=torch.int64, device=dev)
    pf = torch.promote_types(e.dtype, torch.float32)  # prefix accumulation dtype
    cd = e_out.dtype
    ld = logits_dtype or _wide(cd)

    ctx_n_i = left + right
    has_ctx = (ctx_n_i > 0).to(torch.float32)
    live = center_mask * has_ctx                                     # [T]

    # forward: the windowed context mean as one prefix-sum difference
    ep = e.to(pf)
    S = cumsum_rows(ep)
    Spad = torch.cat([torch.zeros((1, S.shape[1]), dtype=pf, device=dev), S])
    ctx_sum = Spad[t + right + 1] - Spad[t - left] - ep
    ctx_n = torch.clamp(ctx_n_i, min=1).to(pf)
    hidden = (ctx_sum / ctx_n[:, None]).to(cd)                       # [T, D]

    # the shared-pool chain of the scatter step
    f_pos = torch.sum(hidden * e_out, dim=-1).to(_wide(cd))
    f_neg = (hidden @ Z.T).to(ld)                                    # [T, P]
    if col_sum is not None:
        f_pos, f_neg = col_sum([f_pos, f_neg])
    neg_valid = (negatives[None, :] != tokens[:, None]).to(ld) \
        * center_mask[:, None].to(ld)
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * live
    g_neg = ((0.0 - _sigmoid(f_neg, sigmoid_mode)) * _scalar(alpha, ld) * neg_valid
             * has_ctx[:, None].to(ld) * _scalar(num_negatives / P, ld))
    gp, gn = g_pos[:, None].to(cd), g_neg.to(cd)
    d_hidden = gp * e_out + gn @ Z                                   # [T, D]
    d_out = gp * hidden
    d_Z = gn.T @ hidden                                              # [P, D]
    if (stabilizers or _OFF).update_clip:
        # before the spread: the quantity the scatter step clips
        d_hidden, d_out = clip_rows_together([d_hidden, d_out], stabilizers.update_clip,
                                             col_sum)

    # backward: the banded spread of d_hidden/n as a difference array and a prefix sum
    g_row = d_hidden.to(pf) / ctx_n[:, None]                         # [T, D]
    form = endpoint
    if form == "auto" and g_row.is_cuda:
        form = CUDA_ENDPOINT
    delta = _band_endpoint_delta(g_row, left, right, window, form, scatter, live)
    d_ctx = (cumsum_rows(delta) - g_row) * token_mask[:, None].to(pf)

    if not with_metrics:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return d_ctx, d_out, d_Z, live, (zero, zero)
    neg_term = torch.sum(_log_sigmoid(-f_neg) * neg_valid * has_ctx[:, None].to(ld),
                         dim=-1, dtype=_wide(ld))
    return d_ctx, d_out, d_Z, live, (
        (-_log_sigmoid(f_pos) * live - neg_term * (num_negatives / P)).sum(),
        (f_pos * live).sum())
