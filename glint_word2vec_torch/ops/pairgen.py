"""On-device pair generation, ported from ``glint_word2vec_tpu/ops/pairgen.py``.

With ``device_pairgen=True`` the host ships blocks of kept tokens (whole sentences,
T slots per step, ~4 bytes per token instead of 8 per pair) with their packed
sentence-start bits and ordinal bases, and the card expands each block into a step's
B (center, context) pairs: the window draws come from the same position-keyed murmur3
lattice as the host feed (:mod:`..data.hashrng`), so the device stream is bit-identical
to the host's ``_block_pairs`` on the same tokens (tested against the JAX package).

The uint32 lattice lives in int64 tensors holding [0, 2^32), as in :mod:`.prng`
(whose ``mix32`` multiplies by 16-bit halves so no product leaves int64); additions
are masked back to 32 bits, and a 64-bit ordinal is a (lo, hi) pair whose carry is
``hi + (lo < ord_lo)``.

Differences from the JAX function, none of which changes a value:

- :func:`device_block_pairs` takes a chunk's K blocks at once, ``[K, T] -> [K, B]``,
  so that a chunk costs one set of torch ops (~120 small kernels on the card) rather
  than K sets (the host's dispatch of small ops is what paces the port's fits); row k
  equals the JAX function on block k. A 1-D block is accepted too.
- Prefix sums are ``torch.cumsum`` on int64, exact at any size. The JAX package's
  ``_cumsum_i32`` is a triangular f32 matmul, exact only below 2^24; the config keeps
  that package's 2^24 refusal so both refuse the same configs.
- ``.at[...].set/add(mode="drop")`` become scatters into one spare slot past the end,
  which is sliced off; the marks of empty groups pile up on one slot and are summed
  (``scatter_add_``, exact on integers).
- Centers and contexts come back as int64 (the steps index with them); kept_words and
  dropped_pairs as int64 tensors of shape [K] (0-d for a 1-D block).

:func:`device_cbow_windows` (banded CBOW's window geometry over halo-overlapped blocks)
is batched the same way, ``[K, T] -> [K, T]``; its left and right extents come back as
int64.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from glint_word2vec_torch.ops.prng import mix32

_M32 = 0xFFFFFFFF
_Int = Union[int, torch.Tensor]


def hash_bits_at(base: _Int, ord_lo: torch.Tensor, ord_hi: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) for 64-bit ordinals given as (lo, hi) uint32 halves;
    the twin of ``data/hashrng.hash_bits_at``."""
    return mix32(ord_lo ^ mix32(ord_hi ^ 0xDEADBEEF) ^ base)


def hash_u01_at(base: _Int, ord_lo: torch.Tensor, ord_hi: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) with 24 bits; exact, as ``(bits >> 8)`` <= 2^24
    and 2^-24 is a power of two."""
    return (hash_bits_at(base, ord_lo, ord_hi) >> 8).to(torch.float32) * (2.0 ** -24)


def hash_mod_at(base: _Int, ord_lo: torch.Tensor, ord_hi: torch.Tensor,
                bound: int) -> torch.Tensor:
    """int64 draws in [0, bound), with the host's modulo bias."""
    return hash_bits_at(base, ord_lo, ord_hi) % bound


class DevicePairs(NamedTuple):
    centers: torch.Tensor        # int64 [K, B]
    contexts: torch.Tensor       # int64 [K, B]
    mask: torch.Tensor           # float32 [K, B], 1.0 for real pairs (a prefix)
    kept_words: torch.Tensor     # int64 [K], tokens that survived subsampling
    dropped_pairs: torch.Tensor  # int64 [K], pairs past the B slots


def _col(x, K: int, device) -> _Int:
    """A per-block value as int64 [K, 1]; a python int stays a python int, which
    broadcasts in every op (a tensor made from it would be a blocking host-to-device
    copy)."""
    if not isinstance(x, torch.Tensor):
        return int(x)
    return x.to(device, torch.int64).reshape(-1, 1).expand(K, 1)


def device_block_pairs(
    tokens: torch.Tensor,      # int [K, T] or [T]: token ids, whole sentences,
                               # zero-padded past n_valid
    start_bits: torch.Tensor,  # uint8 [K, ceil(T/8)]: bit t set iff a sentence
                               # starts at slot t
    n_valid,                   # [K] or scalar: real token count of each block
    ord_lo,                    # [K] or scalar: ordinal of slot 0, low 32 bits
    ord_hi,                    # [K] or scalar: high 32 bits
    keep_prob: torch.Tensor,   # float32 [V_pad]: per-word keep probability
    sub_base,                  # scalar or [K]: hashrng base of STREAM_SUBSAMPLE
    win_base,                  # scalar or [K]: hashrng base of STREAM_WINDOW
    window: int,
    num_pairs: int,            # B, the pair slots of a step
    legacy_asymmetric_window: bool = True,
    presubsampled: bool = False,
) -> DevicePairs:
    """The (centers, contexts, mask) of each block, stage for stage as the JAX
    function: subsample (unless ``presubsampled``, the trainer's mode, where the host
    already dropped the subsampled tokens and the window draws are keyed by the
    kept-token ordinal), compact the kept tokens, segmented positions within the
    subsampled sentences, the window draw ``b = hash % window``, and the ragged pair
    expansion inverted by marks at each token's first pair slot and a prefix sum.
    Pairs past B are dropped (and counted); slots past the pairs are masked."""
    squeeze = tokens.dim() == 1
    if squeeze:
        tokens, start_bits = tokens[None], start_bits.reshape(1, -1)
    dev = tokens.device
    K, T = tokens.shape
    B = num_pairs
    t = torch.arange(T, dtype=torch.int64, device=dev)[None, :]        # [1, T]
    nv = _col(n_valid, K, dev)
    lo0, hi0 = _col(ord_lo, K, dev), _col(ord_hi, K, dev)
    if not isinstance(nv, torch.Tensor):
        nv = torch.full((K, 1), nv, dtype=torch.int64, device=dev)
    valid = t < nv
    tok = tokens.to(torch.int64)

    # ordinals of each slot as uint32 (lo, hi), with the carry
    lo = (lo0 + t) & _M32
    hi = (hi0 + (lo < lo0).to(torch.int64)) & _M32
    lo, hi = lo.expand(K, T), hi.expand(K, T)

    # sentence ids on the raw stream
    bits = start_bits.to(torch.int64).index_select(1, t[0] >> 3)
    is_start = ((bits >> (t & 7)) & 1).bool() & valid
    sid = torch.cumsum(is_start.to(torch.int64), dim=1)

    if presubsampled:
        n_kept = nv
        comp_tok, comp_lo, comp_hi, ck = tok, lo, hi, valid
        comp_sid = torch.where(ck, sid, -1)
    else:
        u = hash_u01_at(_col(sub_base, K, dev), lo, hi)
        kept = valid & (u <= keep_prob[tok])
        kept_i = kept.to(torch.int64)
        n_kept = kept_i.sum(dim=1, keepdim=True)
        # compaction: the source slot of each compacted slot; dropped tokens go to a
        # spare slot T, sliced off
        dst = torch.where(kept, torch.cumsum(kept_i, dim=1) - 1, T)
        comp_src = torch.zeros((K, T + 1), dtype=torch.int64, device=dev)
        comp_src.scatter_(1, dst, t.expand(K, T))
        comp_src = comp_src[:, :T]
        comp_tok = tok.gather(1, comp_src)
        comp_lo = lo.gather(1, comp_src)
        comp_hi = hi.gather(1, comp_src)
        ck = t < n_kept
        comp_sid = torch.where(ck, sid.gather(1, comp_src), -1)
    prev_sid = torch.cat(
        [torch.full((K, 1), -2, dtype=torch.int64, device=dev), comp_sid[:, :-1]], 1)
    new_sent = (comp_sid != prev_sid) & ck

    # segmented position and distance to the sentence end on the compacted stream
    seg_base = torch.cummax(torch.where(new_sent, t, 0), dim=1).values
    pos = t - seg_base
    ns = torch.where(new_sent, t, T)
    ns_next = torch.cat(
        [ns[:, 1:], torch.full((K, 1), T, dtype=torch.int64, device=dev)], 1)
    seg_end = torch.flip(torch.cummin(torch.flip(ns_next, [1]), dim=1).values, [1])
    seg_end = torch.minimum(seg_end, n_kept)
    right_avail = seg_end - 1 - t

    # the window draw
    b = hash_mod_at(_col(win_base, K, dev), comp_lo, comp_hi, window)
    left = torch.minimum(b, pos)
    right_extent = b - 1 if legacy_asymmetric_window else b
    right = torch.clamp(torch.minimum(right_extent, right_avail), min=0)
    total = torch.where(ck, left + right, 0)

    # ragged expansion: a +1 mark at each token's first pair slot (those past B go
    # to the spare slot B), then a prefix sum gives each slot its source token
    offs = torch.cumsum(total, dim=1)
    total_pairs = offs[:, -1:]
    group_start = offs - total
    marks = torch.zeros((K, B + 1), dtype=torch.int64, device=dev)
    marks.scatter_add_(1, torch.clamp(group_start, max=B), torch.ones_like(group_start))
    src = torch.cumsum(marks[:, :B], dim=1) - 1
    src_c = torch.clamp(src, 0, T - 1)
    k = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    j = k - group_start.gather(1, src_c)
    left_s = left.gather(1, src_c)
    ctx_c = torch.clamp(src_c - left_s + j + (j >= left_s).to(torch.int64), 0, T - 1)
    live = k < torch.clamp(total_pairs, max=B)
    centers = torch.where(live, comp_tok.gather(1, src_c), 0)
    contexts = torch.where(live, comp_tok.gather(1, ctx_c), 0)
    out = DevicePairs(
        centers=centers, contexts=contexts, mask=live.to(torch.float32),
        kept_words=n_kept.expand(K, 1)[:, 0],
        dropped_pairs=torch.clamp(total_pairs[:, 0] - B, min=0))
    if squeeze:
        out = DevicePairs(*(x[0] for x in out))
    return out


class CbowBand(NamedTuple):
    """Per-slot CBOW window geometry of sentence-contiguous token blocks, the input of
    the banded step (``ops/cbow_banded.py``)."""

    left: torch.Tensor    # int64 [K, T]: context extent to the left of each slot
    right: torch.Tensor   # int64 [K, T]: context extent to the right
    center: torch.Tensor  # float32 [K, T]: 1.0 where the slot is a core center
    token: torch.Tensor   # float32 [K, T]: 1.0 for valid token slots


def device_cbow_windows(
    tokens: torch.Tensor,      # int [K, T] or [T]: kept tokens, sentence-contiguous,
                               # +-halo overlap at the block edges
    start_bits: torch.Tensor,  # uint8 [K, ceil(T/8)]: bit t set iff a sentence
                               # starts at slot t
    n_valid,                   # [K] or scalar: real token slots (a prefix)
    ord_lo,                    # [K] or scalar: kept-token ordinal of slot 0, low bits
    ord_hi,                    # [K] or scalar: high 32 bits
    win_base,                  # scalar or [K]: hashrng base of STREAM_WINDOW
    window: int,
    halo: int,                 # core slots are [halo, T - halo); needs halo >= window
    legacy_asymmetric_window: bool = True,
) -> CbowBand:
    """Each slot's window extents from the hash lattice, the JAX function's stages:
    the draw ``b = hash % window`` keyed by the kept-token ordinal (``ord_base + t``,
    so a token draws the same window in every block that holds it), ``left = min(b,
    pos)`` with pos counted from the last in-block sentence start (slot 0 as the implicit
    base), ``right`` clamped by the next in-block start bit or ``n_valid``. With ``halo
    >= window`` both clamps are exact for every core slot. Row k equals the JAX function
    on block k; block 0's base is −halo wrapped to 64 bits, whose carry into the high
    word is exact."""
    squeeze = tokens.dim() == 1
    if squeeze:
        tokens, start_bits = tokens[None], start_bits.reshape(1, -1)
    dev = tokens.device
    K, T = tokens.shape
    t = torch.arange(T, dtype=torch.int64, device=dev)[None, :]        # [1, T]
    nv = _col(n_valid, K, dev)
    valid = (t < nv).expand(K, T)
    lo0, hi0 = _col(ord_lo, K, dev), _col(ord_hi, K, dev)
    lo = (lo0 + t) & _M32
    hi = (hi0 + (lo < lo0).to(torch.int64)) & _M32

    bits = start_bits.to(torch.int64).index_select(1, t[0] >> 3)
    is_start = ((bits >> (t & 7)) & 1).bool() & valid
    seg_base = torch.cummax(torch.where(is_start, t, 0), dim=1).values
    pos = t - seg_base
    ns = torch.where(is_start, t, T)
    ns_next = torch.cat(
        [ns[:, 1:], torch.full((K, 1), T, dtype=torch.int64, device=dev)], 1)
    seg_end = torch.flip(torch.cummin(torch.flip(ns_next, [1]), dim=1).values, [1])
    seg_end = torch.minimum(seg_end, nv) if isinstance(nv, torch.Tensor) \
        else torch.clamp(seg_end, max=nv)
    right_avail = seg_end - 1 - t

    b = hash_mod_at(_col(win_base, K, dev), lo, hi, window)
    left = torch.minimum(b, pos)
    right_extent = b - 1 if legacy_asymmetric_window else b
    right = torch.clamp(torch.minimum(right_extent, right_avail), min=0)
    left = torch.where(valid, left, 0)
    right = torch.where(valid, right, 0)
    core = (t >= halo) & (t < T - halo) & valid
    out = CbowBand(left=left, right=right, center=core.to(torch.float32),
                   token=valid.to(torch.float32))
    if squeeze:
        out = CbowBand(*(x[0] for x in out))
    return out


def pack_start_bits(lengths: np.ndarray, T: int) -> np.ndarray:
    """Host side: sentence lengths -> the packed start bits a block ships, uint8
    [ceil(T/8)], bit t set iff a sentence begins at slot t (padding carries none)."""
    bits = np.zeros((T + 7) // 8, np.uint8)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    starts = starts[starts < T]
    np.bitwise_or.at(bits, starts >> 3, (1 << (starts & 7)).astype(np.uint8))
    return bits
