"""Unigram negative sampler, ported from ``glint_word2vec_tpu/ops/sampler.py``.

A Walker alias table over the counts^0.75 distribution, built on the host in numpy
(bit-identical to the JAX package's builder, partitioned build included), and the
hot-path draw from the counter-based hash PRNG (:mod:`.prng`) in torch, on whatever
device the tables live on.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from glint_word2vec_torch.ops.prng import randint_mod, uniform01


class AliasTable(NamedTuple):
    """prob[i]: probability of keeping bucket i; alias[i]: the index drawn otherwise."""

    prob: np.ndarray   # float32 [V]
    alias: np.ndarray  # int32 [V]

    @property
    def vocab_size(self) -> int:
        return self.prob.shape[0]


# Fixed partition fan-out of the large-vocabulary build (a constant, so the table is
# deterministic per (counts, power)); must match the JAX package.
_ALIAS_PARTITIONS = 16
_ALIAS_PARTITION_MIN_V = 1 << 18


def _alias_pair_sweep(scaled: np.ndarray, prob: np.ndarray, alias: np.ndarray,
                      small: np.ndarray, large: np.ndarray):
    """Vose pairing by cumulative matching: each round assigns every coverable small
    bucket to a large donor by aligning cumulative deficits against cumulative
    surpluses; a donor pushed below 1 demotes to the small queue, and the fp endgame
    falls back to one literal Vose round. Mutates prob/alias/scaled in place and
    returns the leftover (small, large) queues. Copied from the JAX package."""
    while small.size and large.size:
        d = 1.0 - scaled[small]
        j = np.searchsorted(np.cumsum(scaled[large] - 1.0), np.cumsum(d),
                            side="left")
        assigned = j < large.size
        if assigned.any():
            sa, ja = small[assigned], j[assigned]
            prob[sa] = scaled[sa]
            alias[sa] = large[ja]
            take = np.bincount(ja, weights=d[assigned], minlength=large.size)
            scaled[large] -= take
            now_small = scaled[large] < 1.0
            small = np.concatenate([small[~assigned], large[now_small]])
            large = large[~now_small]
        else:
            k = min(small.size, large.size)
            s, small = small[:k], small[k:]
            l = large[:k]
            prob[s] = scaled[s]
            alias[s] = l
            scaled[l] -= 1.0 - scaled[s]
            now_small = scaled[l] < 1.0
            small = np.concatenate([small, l[now_small]])
            large = np.concatenate([l[~now_small], large[k:]])
    return small, large


def build_alias_table(counts: np.ndarray, power: float = 0.75) -> AliasTable:
    """Alias tables for p(w) proportional to counts[w]^power. Above
    ``_ALIAS_PARTITION_MIN_V`` rows the build sweeps 16 strided partitions in order and
    merges their leftovers, exactly as the JAX package does (it may run the partitions
    on threads; the result is the same)."""
    counts = np.asarray(counts, dtype=np.float64)
    if counts.ndim != 1 or counts.size == 0:
        raise ValueError("counts must be a nonempty 1-D array")
    weights = np.power(np.maximum(counts, 0.0), power)
    total = weights.sum()
    if total <= 0:
        raise ValueError("all counts are zero")
    V = counts.size
    scaled = weights * (V / total)  # mean 1.0
    prob = np.ones(V, dtype=np.float64)
    alias = np.arange(V, dtype=np.int64)
    if V >= _ALIAS_PARTITION_MIN_V:
        leftovers = []
        for c in range(_ALIAS_PARTITIONS):
            idx = np.arange(c, V, _ALIAS_PARTITIONS)
            sc = scaled[idx]
            leftovers.append(_alias_pair_sweep(
                scaled, prob, alias, idx[sc < 1.0], idx[sc >= 1.0]))
        small = np.concatenate([s for s, _ in leftovers])
        large = np.concatenate([l for _, l in leftovers])
    else:
        small = np.flatnonzero(scaled < 1.0)
        large = np.flatnonzero(scaled >= 1.0)
    small, large = _alias_pair_sweep(scaled, prob, alias, small, large)
    prob[small] = 1.0
    prob[large] = 1.0
    return AliasTable(prob=prob.astype(np.float32), alias=alias.astype(np.int32))


def sample_negatives_hash(
    prob: torch.Tensor,    # float32 [V]
    alias: torch.Tensor,   # int64 [V]
    seed: int,
    counter: int,
    shape: Tuple[int, ...],
) -> torch.Tensor:
    """Alias-method draw from the hash PRNG: bucket from stream 0, keep-vs-alias
    uniform from stream 1, both at ``counter``. Returns int64 indices of ``shape`` on
    the tables' device, bit-identical to the JAX package's ``sample_negatives_hash``."""
    V = prob.shape[0]
    buckets = randint_mod(seed, 0, counter, shape, V, prob.device)
    u = uniform01(seed, 1, counter, shape, prob.device)
    keep = u < prob[buckets]
    return torch.where(keep, buckets, alias[buckets])
