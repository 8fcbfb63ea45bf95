"""The fused shared-pool SGNS step: the port's CUDA kernel and its wrapper.

Source note. ``csrc/sgns_shared.cu`` replaces the TPU kernel
``glint_word2vec_tpu/ops/pallas/sgns_kernel.py:_sgns_tile_kernel`` (launched by
``fused_sgns_shared``, wrapped for the trainer by ``make_pallas_sgns_step``). It
computes what ``sgns_step_shared_core`` computes, with duplicate rows SUMMED (the
Pallas kernel writes in-tile duplicates last-wins), and it is the default shared-pool
step on CUDA. Its plain version is :func:`..ops.sgns.sgns_step_shared_core`.

What bounds it on an H100: the three products E·Zᵀ, G·Z and Gᵀ·E are 6·B·P·D flops
(4.8 GFLOP at B=8192, P=256, D=384). In plain fp32 on CUDA cores that is ~72 µs at
67 TFLOP/s; the kernel runs them on the tensor cores (wgmma) as 3xTF32, three TF32
products per fp32 product (~29 µs at 495 TFLOP/s), which keeps fp32-level accuracy
where plain TF32 would not (``ops/tf32.py`` is the plain emulation of that
arithmetic). Operand tiles stream through a cp.async ring in shared memory, and the
updates leave as float4 atomics. Every old-parameter read happens in the first of its
four launches (rows copied to scratch), so the scatter-adds of the later launches
cannot race a read; the batch-long Gᵀ·E reduction is split over blocks so it fills
the card. The csrc file's header gives the design and its reasons.

The wrapper updates the parameters IN PLACE on both devices (the JAX package's step is
functional; in-place updates spare a copy of two [V, D] matrices per step).
"""

from __future__ import annotations

from typing import Union

import torch

from glint_word2vec_torch.ops import kernels
from glint_word2vec_torch.ops.sgns import EmbeddingPair, StepMetrics, sgns_step_shared_core

KERNEL_SOURCE = "glint_word2vec_torch/csrc/sgns_shared.cu"
REPLACES = "glint_word2vec_tpu/ops/pallas/sgns_kernel.py:103"


def _check(params: EmbeddingPair, centers, contexts, mask, negatives) -> None:
    syn0, syn1 = params
    if syn0.device != syn1.device:
        raise ValueError("syn0 and syn1 must be on one device")
    for name, t, dtype in (("syn0", syn0, torch.float32), ("syn1", syn1, torch.float32),
                           ("centers", centers, torch.int64),
                           ("contexts", contexts, torch.int64),
                           ("mask", mask, torch.float32),
                           ("negatives", negatives, torch.int64)):
        if t.device != syn0.device:
            raise ValueError(f"{name} is on {t.device}, the parameters on {syn0.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if syn0.dim() != 2 or syn1.shape != syn0.shape:
        raise ValueError(f"syn0 {tuple(syn0.shape)} and syn1 {tuple(syn1.shape)} must be "
                         "the same [V, D] shape")
    B = centers.shape[0]
    if centers.dim() != 1 or contexts.shape != (B,) or mask.shape != (B,):
        raise ValueError("centers, contexts and mask must be 1-D of one length")
    if negatives.dim() != 1 or negatives.shape[0] == 0:
        raise ValueError("negatives must be a nonempty 1-D pool")


def fused_sgns_shared_step(
    params: EmbeddingPair,
    centers: torch.Tensor,    # int64 [B]
    contexts: torch.Tensor,   # int64 [B]
    mask: torch.Tensor,       # float32 [B]
    negatives: torch.Tensor,  # int64 [P]
    alpha: Union[float, torch.Tensor],
    num_negatives: int,
    sigmoid_mode: str = "exact",
    with_metrics: bool = True,
) -> StepMetrics:
    """One shared-pool SGNS step, in place on ``params``. Indices must lie in
    [0, V): the feed and the sampler produce them so, and the kernel does not check.

    CPU tensors take the plain version. CUDA tensors launch the kernel, and a build or
    launch failure raises: there is no fallback."""
    _check(params, centers, contexts, mask, negatives)
    syn0, syn1 = params
    if syn0.device.type == "cpu":
        new, metrics = sgns_step_shared_core(
            params, centers, contexts, mask, negatives, alpha, num_negatives,
            sigmoid_mode, with_metrics)
        syn0.copy_(new.syn0)
        syn1.copy_(new.syn1)
        return metrics
    if syn0.device.type != "cuda":
        raise ValueError(f"no kernel for device {syn0.device}")
    if sigmoid_mode not in ("exact", "clipped"):
        raise ValueError(f"sigmoid_mode must be 'exact' or 'clipped', got {sigmoid_mode!r}")
    lib = kernels.load("sgns_shared")
    B, P, D = centers.shape[0], negatives.shape[0], syn0.shape[1]
    scratch = torch.empty(int(lib.glint_sgns_scratch_floats(B, P, D)),
                          dtype=torch.float32, device=syn0.device)
    out = torch.empty(3, dtype=torch.float32, device=syn0.device)  # loss, f_pos, pairs
    stream = torch.cuda.current_stream(syn0.device).cuda_stream
    err = lib.glint_sgns_shared_step(
        syn0.data_ptr(), syn1.data_ptr(), centers.data_ptr(), contexts.data_ptr(),
        mask.data_ptr(), negatives.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        B, P, D, float(alpha), num_negatives / P, int(sigmoid_mode == "clipped"),
        int(with_metrics), stream)
    if err != 0:
        raise RuntimeError(f"sgns_shared kernel launch failed: cudaError {err}")
    fused_sgns_shared_step.launches += 1
    return StepMetrics(out[0], out[1], out[2])


# Kernel launches (one per fused step on a CUDA tensor; each is four CUDA launches).
fused_sgns_shared_step.launches = 0
