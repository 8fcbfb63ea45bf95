"""Position-keyed host-side hash RNG — the contract shared by the numpy pipeline and
the native C++ pair generator (``native/pairgen.cpp``).

Verbatim copy of ``glint_word2vec_tpu/data/hashrng.py``: the port keeps its own copy
because importing anything from the JAX package imports jax. The pair streams of the
two packages must stay bit-identical, so edit both or neither.

Every random decision in the pair stream (subsample keep/drop, per-position window
shrink) is a pure function of ``(seed, stream, iteration, shard, token_ordinal)`` using
the same murmur3-finalizer lattice as the device sampler (:mod:`..ops.prng`). This buys
three properties the previous sequential ``numpy.random.Generator`` scheme could not:

- **backend equivalence**: the numpy path and the multithreaded C++ path produce
  bit-identical pair streams (asserted by tests), so enabling the native generator
  never changes training results;
- **parallelism**: no sequential RNG state — any thread can draw for any position;
- **block-size independence**: the stream depends only on the token's global ordinal
  within (iteration, shard), not on how the pipeline batches sentences into blocks.

The reference's analog is the per-partition XORShift reseed
``seed ^ ((idx+1)<<16) ^ ((-k-1)<<8)`` (mllib:372,382) — deterministic per partition
but sequential within it.

Keep-probability comparison happens in float32 on both sides: ``(bits >> 8)`` is ≤ 2^24
(exact in f32) and the 2^-24 scale is a power of two, so the u01 values are exactly
representable and the comparison is bit-identical across implementations.
"""

from __future__ import annotations

import numpy as np

GOLDEN = np.uint32(0x9E3779B9)

# stream constants (must match native/pairgen.cpp)
STREAM_SUBSAMPLE = 101
STREAM_WINDOW = 102


def mix32(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 finalizer on uint32 arrays (wraps, as unsigned arithmetic does;
    the errstate guard silences numpy's overflow warning for 0-d scalar inputs)."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def stream_base(seed: int, stream: int, iteration: int, shard: int) -> np.uint32:
    """The per-(seed, stream, iteration, shard) base the per-ordinal mix folds in."""
    s = np.uint32((seed & 0xFFFFFFFF) * 0x9E3779B9 & 0xFFFFFFFF)
    t = np.uint32((stream * 0x7FEB352D + 0x68E31DA4) & 0xFFFFFFFF)
    c = np.uint32((iteration * 0x85EBCA6B + shard * 0xC2B2AE35) & 0xFFFFFFFF)
    return mix32(c ^ mix32(s ^ t))[()]


def hash_bits_at(base: np.uint32, ordinals: np.ndarray) -> np.ndarray:
    """uint32 bits for 64-bit token ordinals under a precomputed stream base."""
    o = np.asarray(ordinals, dtype=np.uint64)
    lo = (o & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (o >> np.uint64(32)).astype(np.uint32)
    return mix32(lo ^ mix32(hi ^ np.uint32(0xDEADBEEF)) ^ base)


def hash_u01_at(base: np.uint32, ordinals: np.ndarray) -> np.ndarray:
    """float32 uniforms in [0, 1) with 24 bits of mantissa entropy, position-keyed."""
    bits = hash_bits_at(base, ordinals)
    return (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def hash_mod_at(base: np.uint32, ordinals: np.ndarray, bound: int) -> np.ndarray:
    """int64 draws in [0, bound), position-keyed (modulo bias ≤ bound/2^32)."""
    bits = hash_bits_at(base, ordinals)
    return (bits % np.uint32(bound)).astype(np.int64)
