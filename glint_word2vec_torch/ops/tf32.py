"""Plain emulation of the fused kernel's tensor-core arithmetic (``csrc/sgns_shared.cu``).

The kernel runs its three products as 3xTF32 on the tensor cores: every fp32 operand
x splits into ``big = round_tf32(x)`` and ``small = round_tf32(x - big)``, and a
product is ``small_a·big_b + big_a·small_b + big_a·big_b`` accumulated in fp32, with
the ``small_a·small_b`` term dropped. :func:`round_tf32` is PTX's ``cvt.rna.tf32.f32``
(round to nearest, ties away from zero, 10 explicit mantissa bits) in int32 bit
arithmetic, and :func:`matmul_3xtf32` is the split product. Products of TF32 values are
exact in fp32 (11 × 11 significant bits), so a float32 ``torch.matmul`` of the parts
accumulates them as the tensor cores do, up to the order of the sums.

The kernel sums each 32-deep k-slice on the tensor cores (whose additions drop low bits
toward zero) and adds the slices in fp32; this emulation sums in float32 throughout, so
the two differ in the order and rounding of the sums, not in the split.
``sgns_step_shared_core(..., matmul=matmul_3xtf32)`` is the kernel's step in plain
PyTorch; the tests hold it against the JAX package's step on the CPU.
"""

from __future__ import annotations

import torch

_HALF_ULP = 0x1000        # half a unit in the last place of a 10-bit mantissa
_KEEP = -0x2000           # int32 mask 0xFFFFE000: sign, exponent, 10 mantissa bits


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (``cvt.rna.tf32.f32``): nearest, ties away from
    zero, the 13 low mantissa bits cleared. Zeros and infinities are kept; a finite
    value past the largest TF32 rounds to infinity."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # adding half an ulp to the magnitude bits carries into the exponent where it
    # should; the sign bit is untouched for every finite value and for infinity
    return ((bits + _HALF_ULP) & _KEEP).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(big, small), both TF32: big = round_tf32(x), small = round_tf32(x - big)."""
    big = round_tf32(x)
    return big, round_tf32(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for float32 operands as the kernel computes it on the tensor cores:
    the two cross terms of the big/small split, then the big term, in float32."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big
