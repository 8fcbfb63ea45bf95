"""The health probe, ported from ``glint_word2vec_tpu/obs/probe.py``: one pass over
each parameter matrix for its row-norm channels, fetched from the card once.

Per matrix, over the real vocabulary rows (the padding rows are zero and would skew
every channel):

- ``max_norm`` / ``mean_norm``: the extremes and scale of the L2 row norms;
- ``p99_norm``: the upper edge of the quarter-octave log2 bucket where the rows' CDF
  crosses 99% (128 buckets over 2^-12 .. 2^20; exact to one bucket, ratio <= 2^0.25),
  from an integer histogram (``scatter_add_`` of int64 ones into per-block
  sub-histograms, then summed: exact, no sort);
- ``frac_over``: the fraction of rows whose norm exceeds the watchdog threshold.

Plus the ``finite`` bit over the padded matrices. Norms accumulate in float32 whatever
the parameter dtype (``vector_norm(..., dtype=float32)`` casts before it squares).

One read of each matrix gives every channel: a row's norm is finite exactly when its
entries are (finite entries whose squares overflow float32 aside), so the bit comes
from the norms of all padded rows; only when one of them is not finite does the exact
per-entry check run, a second fetch on the way to a rollback or a halt. The device
results are stacked into one small float64 tensor and fetched with one ``.cpu()``.
Not a kernel: the JAX package's probe is an XLA reduction, not a Pallas kernel.

Under the column layout a rank's squared row norms are summed over the model axis
first (:func:`column_probe_partials`), so every rank folds the whole rows. On a mesh
each rank reduces its own row blocks to partials (histogram counts, the
maximum and sum of the norms, the rows over the threshold, the finite bit:
:func:`sharded_probe_partials`), the trainer gathers them, and every rank folds the same
bytes into the same channels (:func:`combine_partials`), so the guards and the watchdog
decide alike on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_HIST_LO = -12.0
_HIST_PER_OCTAVE = 4
_HIST_BUCKETS = (20 - (-12)) * _HIST_PER_OCTAVE  # 128


class MatrixStats(NamedTuple):
    """Row-norm channels of one matrix (real vocabulary rows), as host floats."""

    max_norm: float
    mean_norm: float
    p99_norm: float    # upper edge of the p99 bucket
    frac_over: float   # fraction of rows with norm > threshold


class HealthStats(NamedTuple):
    """The probe's fetched result."""

    finite: bool       # over the padded matrices
    syn0: MatrixStats
    syn1: MatrixStats


def _matrix_stats(m: torch.Tensor, vocab_size: int, threshold: float) -> torch.Tensor:
    """[5] float64 on m's device: max, mean, rows over the threshold, the p99 bucket
    index and whether every padded row's norm is finite."""
    norms_all = torch.linalg.vector_norm(m, dim=1, dtype=torch.float32)
    norms = norms_all[:vocab_size]
    logn = torch.log2(torch.clamp_min(norms, 2.0 ** _HIST_LO))
    idx = torch.nan_to_num(torch.floor((logn - _HIST_LO) * _HIST_PER_OCTAVE), nan=0.0)
    idx = idx.clamp_(0, _HIST_BUCKETS - 1).long()
    # one sub-histogram per block of ~1024 rows, summed after: most rows land in a few
    # buckets, and one int64 atomic per row into 128 counters serialises on them
    blocks = max(1, min(1024, vocab_size // 1024))
    if blocks > 1:
        idx = idx + _HIST_BUCKETS * (torch.arange(vocab_size, device=m.device)
                                     * blocks // vocab_size)
    hist = torch.zeros(blocks * _HIST_BUCKETS, dtype=torch.int64, device=m.device)
    hist.scatter_add_(0, idx, torch.ones_like(idx))
    hist = hist.view(blocks, _HIST_BUCKETS).sum(0)
    need = -(-vocab_size * 99 // 100)
    # graftlint: disable=R4 -- hist is int64 (made with dtype=torch.int64 above; its reshaped sum keeps the dtype), exact
    k = (torch.cumsum(hist, 0) < need).sum()  # the first bucket whose CDF reaches need
    over = (norms > threshold).sum()
    return torch.stack([norms.max().double(), norms.mean().double(), over.double(),
                        k.double(), torch.isfinite(norms_all).all().double()])


def probe_tensor(params, vocab_size: int, threshold: float) -> torch.Tensor:
    """The probe's device half: [10] float64 (syn0's five values, then syn1's), not
    fetched."""
    return torch.cat([_matrix_stats(params[0], vocab_size, threshold),
                      _matrix_stats(params[1], vocab_size, threshold)])


def _block_partials(m: torch.Tensor, row_lo: int, vocab_size: int,
                    threshold: float) -> torch.Tensor:
    """[132] float64 partials of one row block (global rows ``row_lo`` on) of a
    row-sharded matrix: the p99 histogram of its real rows (128), their max and sum of
    norms, the rows over the threshold, and whether every row's norm is finite."""
    return _norm_partials(torch.linalg.vector_norm(m, dim=1, dtype=torch.float32),
                          row_lo, vocab_size, threshold)


def column_probe_partials(params, vocab_size: int, threshold: float,
                          col_sum) -> torch.Tensor:
    """The probe's [264] partials under the column layout, where a rank holds columns
    of every row: each row's squared norm over the rank's columns (float32), summed
    over the model axis by ``col_sum`` (``ops/sgns_shard.column_sum``; None on a model
    axis of one) in one collective, then the partials of the whole matrices, the same
    on every rank."""
    sq = [torch.sum(torch.square(m.to(torch.float32)), dim=1) for m in params]
    if col_sum is not None:
        sq = col_sum(sq)
    return torch.cat([_norm_partials(torch.sqrt(s), 0, vocab_size, threshold)
                      for s in sq])


def _norm_partials(norms_all: torch.Tensor, row_lo: int, vocab_size: int,
                   threshold: float) -> torch.Tensor:
    """:func:`_block_partials` from the block's row norms."""
    real = max(0, min(norms_all.shape[0], vocab_size - row_lo))
    norms = norms_all[:real]
    logn = torch.log2(torch.clamp_min(norms, 2.0 ** _HIST_LO))
    idx = torch.nan_to_num(torch.floor((logn - _HIST_LO) * _HIST_PER_OCTAVE), nan=0.0)
    hist = torch.bincount(idx.clamp_(0, _HIST_BUCKETS - 1).long(),
                          minlength=_HIST_BUCKETS)
    top = norms.max() if real else torch.zeros((), device=norms_all.device)
    return torch.cat([hist.double(), torch.stack([
        top.double(), norms.double().sum(), (norms > threshold).sum().double(),
        torch.isfinite(norms_all).all().double()])])


def sharded_probe_partials(params, row_lo: int, vocab_size: int,
                           threshold: float) -> torch.Tensor:
    """The probe's device half on a rank's row blocks: [264] float64 (syn0's partials,
    then syn1's), which :func:`combine_partials` folds over the model axis."""
    return torch.cat([_block_partials(params[0], row_lo, vocab_size, threshold),
                      _block_partials(params[1], row_lo, vocab_size, threshold)])


def combine_partials(parts: np.ndarray, vocab_size: int) -> HealthStats:
    """:class:`HealthStats` of the whole matrices from the [n, 264] partials of their
    n row blocks (every block once): the histograms and sums add, the maxima and the
    finite bits fold. The channels are :func:`health_stats`' (the mean's sum runs in
    another order)."""
    out = []
    need = -(-vocab_size * 99 // 100)
    for off in (0, 132):
        p = parts[:, off:off + 132]
        hist = p[:, :_HIST_BUCKETS].sum(0)
        k = float((np.cumsum(hist) < need).sum())
        out.append(np.array([p[:, 128].max(), p[:, 129].sum() / vocab_size,
                             p[:, 130].sum(), k, p[:, 131].min()]))
    return HealthStats(finite=bool(out[0][4] and out[1][4]),
                       syn0=_host_stats(out[0], vocab_size),
                       syn1=_host_stats(out[1], vocab_size))


def _host_stats(v: np.ndarray, vocab_size: int) -> MatrixStats:
    # the bucket edge 2^((k+1)/4 - 12) rounded once to float32 (XLA's float32 exp2 is
    # a few ulps off it: the same bucket, another last digit)
    return MatrixStats(
        max_norm=float(np.float32(v[0])),
        mean_norm=float(np.float32(v[1])),
        p99_norm=float(np.float32(2.0 ** ((v[3] + 1.0) / _HIST_PER_OCTAVE + _HIST_LO))),
        frac_over=float(np.float32(v[2]) / np.float32(vocab_size)))


def health_stats(params, vocab_size: int, threshold: float) -> HealthStats:
    """Run the probe and fetch it: one ``.cpu()`` of the stacked result (a second
    fetch only when a padded row's norm is not finite)."""
    v = probe_tensor(params, vocab_size, threshold).cpu().numpy()
    finite = bool(v[4] and v[9])
    if not finite:  # exact per-entry check (an overflowing square is not a NaN)
        finite = bool(torch.isfinite(params[0]).all() & torch.isfinite(params[1]).all())
    return HealthStats(finite=finite, syn0=_host_stats(v[:5], vocab_size),
                       syn1=_host_stats(v[5:], vocab_size))


def stats_to_channels(stats: HealthStats) -> dict:
    """Flatten a fetched :class:`HealthStats` into the plain-float channel dict the
    heartbeat, the sink and the watchdog read."""
    out = {"finite": bool(stats.finite)}
    for name in ("syn0", "syn1"):
        ms = getattr(stats, name)
        out[name] = {"max_norm": float(ms.max_norm), "mean_norm": float(ms.mean_norm),
                     "p99_norm": float(ms.p99_norm), "frac_over": float(ms.frac_over)}
    return out
