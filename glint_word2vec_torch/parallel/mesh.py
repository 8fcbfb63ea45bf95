"""Embedding geometry shared with the JAX package (glint_word2vec_tpu/parallel/mesh.py).

Only the two padding rules live here: the port runs on one device, but it keeps the
JAX package's padded shapes so that parameters are shape-identical between the two
packages (checkpoints, interop, equivalence tests). Padded rows are never indexed by
the feed and padded columns stay zero (every product with them vanishes), so both are
sliced off on export.
"""

from __future__ import annotations

import math


def pad_dim_to_lanes(vector_size: int, enabled: bool = True) -> int:
    """Physical embedding minor dim: ``vector_size`` rounded up to a multiple of 128
    when enabled (D=300 -> 384), the JAX package's lane-padded width."""
    return -(-vector_size // 128) * 128 if enabled else vector_size


def pad_vocab_for_sharding(vocab_size: int, num_model: int = 1, multiple: int = 8) -> int:
    """Smallest padded row count divisible by ``num_model`` and ``multiple``."""
    lcm = math.lcm(num_model, multiple)
    return -(-vocab_size // lcm) * lcm
