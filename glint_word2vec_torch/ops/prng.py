"""Counter-based stateless PRNG on torch tensors, ported from
``glint_word2vec_tpu/ops/prng.py``.

A murmur3-finalizer hash over a (seed, stream, counter, flat index) lattice; the draws
are bit-identical to the JAX package's (tested), so both packages sample the same
negatives from the same (seed, global step).

The lattice is uint32 arithmetic. Torch's uint32 coverage is partial, so values live in
int64 tensors holding [0, 2^32). The trap: ``x * 0x85EBCA6B`` with x < 2^32 reaches
~9.6e18, past the signed int64 range (9.2e18), and signed overflow is not something to
rely on. :func:`_mul32` therefore multiplies by the constant's 16-bit halves, each
partial product staying below 2^48.
"""

from __future__ import annotations

from typing import Tuple

import torch

_GOLDEN = 0x9E3779B9  # 2^32 / phi
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer on int64 tensors holding uint32 values."""
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix32_host(x: int) -> int:
    """:func:`mix32` of one uint32 held in a Python int."""
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & _M32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def hash_bits(seed: int, stream: int, counter: int, shape: Tuple[int, ...],
              device) -> torch.Tensor:
    """int64 tensor of uint32 pseudo-random bits, a pure function of
    (seed, stream, counter, flat index). ``seed`` and ``counter`` are masked to 32
    bits, as the JAX package's uint32 casts do. The draw's base is hashed on the host:
    a tensor made on the card from a Python int is a blocking copy, which would hold
    the host until the card has run everything queued before it."""
    n = 1
    for d in shape:
        n *= d
    s = ((int(seed) & _M32) * _GOLDEN) & _M32
    t = (stream * 0x7FEB352D + 0x68E31DA4) & _M32
    c = int(counter) & _M32
    base = _mix32_host(c ^ _mix32_host(s ^ t))
    i = torch.arange(n, dtype=torch.int64, device=device)
    return mix32(i ^ base).reshape(shape)


def uniform01(seed: int, stream: int, counter: int, shape: Tuple[int, ...],
              device) -> torch.Tensor:
    """float32 uniforms in [0, 1) with 24 bits of entropy (exactly representable)."""
    bits = hash_bits(seed, stream, counter, shape, device)
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def randint_mod(seed: int, stream: int, counter: int, shape: Tuple[int, ...],
                bound: int, device) -> torch.Tensor:
    """int64 draws in [0, bound) via modulo (bias <= bound / 2^32)."""
    return hash_bits(seed, stream, counter, shape, device) % bound
