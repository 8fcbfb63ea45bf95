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

bf16 forms: the JAX step's ``compute_dtype``, ``logits_dtype``, ``fused`` and
``bf16_chain`` become flags of the same four launches, which round to bf16 where the
JAX step casts (the source's header lists where). On bf16 parameters the kernel writes
its updates, rounded to bf16, to bf16 scratch instead of adding them, and the wrapper
applies them with two calls of the row-scatter kernel's bf16 path
(``ops/scatter.scatter_add_rows_``: syn0 at the centers, syn1 at the contexts and the
pool), so each touched row takes its step's updates summed in f32 and is rounded once.
Those two calls count as launches of the scatter kernel. :func:`fused_sgns_shared_kernel`
is the launch alone: it hands those rows back unapplied (``ops/bf16_check`` holds them
against the plain step's update rows).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from glint_word2vec_torch.ops import kernels
from glint_word2vec_torch.ops.scatter import scatter_add_rows_
from glint_word2vec_torch.ops.sgns import (
    EmbeddingPair, StepMetrics, _wide, sgns_step_shared_core)

KERNEL_SOURCE = "glint_word2vec_torch/csrc/sgns_shared.cu"
REPLACES = "glint_word2vec_tpu/ops/pallas/sgns_kernel.py:103"
# flags of glint_sgns_shared_step (csrc/sgns_shared.cu: Flags)
STORE_BF16, COMPUTE_BF16, LOGITS_BF16, FUSED, BF16_CHAIN = 1, 2, 4, 8, 16


def _check(params: EmbeddingPair, centers, contexts, mask, negatives) -> None:
    syn0, syn1 = params
    if syn0.device != syn1.device:
        raise ValueError("syn0 and syn1 must be on one device")
    if syn0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"syn0 must be float32 or bfloat16, got {syn0.dtype}")
    for name, t, dtype in (("syn0", syn0, syn0.dtype), ("syn1", syn1, syn0.dtype),
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


def _dtypes(syn0, compute_dtype, logits_dtype) -> Tuple[torch.dtype, torch.dtype]:
    cd = compute_dtype or syn0.dtype
    ld = logits_dtype or _wide(cd)
    for name, dt in (("compute_dtype", cd), ("logits_dtype", ld)):
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {dt}")
    return cd, ld


def alpha_on_card(alpha: Union[float, torch.Tensor], device) -> torch.Tensor:
    """The step's learning rate as the kernel reads it: a one-element float32 tensor on
    the parameters' device, whose address the kernels read at run time (what a CUDA
    graph of the step needs: its replays take each step's alpha from the trainer's [K]
    alphas buffer). A Python float is written into a new such tensor by a fill on the
    card, which copies nothing from the host; the trainer always passes a tensor."""
    if not isinstance(alpha, torch.Tensor):
        return torch.full((1,), float(alpha), dtype=torch.float32, device=device)
    if alpha.dtype != torch.float32 or alpha.numel() != 1 or alpha.device != device:
        raise ValueError(f"alpha must be a float or a one-element float32 tensor on "
                         f"{device}, got {alpha.dtype} {tuple(alpha.shape)} on "
                         f"{alpha.device}")
    return alpha


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
    *,
    compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
    fused: bool = False,
    bf16_chain: bool = False,
) -> StepMetrics:
    """One shared-pool SGNS step, in place on ``params`` (float32 or bfloat16).
    Indices must lie in [0, V): the feed and the sampler produce them so, and the
    kernel does not check. ``alpha`` is a Python float or a one-element float32 tensor
    on the parameters' device (the kernel reads it on the card: see
    :func:`alpha_on_card`). ``compute_dtype`` (default: the parameters'),
    ``logits_dtype`` (default: ``promote_types(compute, float32)``), ``fused`` and
    ``bf16_chain`` as in ``sgns_step_shared_core``.

    CPU tensors take the plain version. CUDA tensors launch the kernel, and a build or
    launch failure raises: there is no fallback."""
    _check(params, centers, contexts, mask, negatives)
    syn0, syn1 = params
    cd, ld = _dtypes(syn0, compute_dtype, logits_dtype)
    if syn0.device.type == "cpu":
        new, metrics = sgns_step_shared_core(
            params, centers, contexts, mask, negatives, alpha, num_negatives,
            sigmoid_mode, with_metrics, compute_dtype=cd, logits_dtype=ld, fused=fused,
            bf16_chain=bf16_chain)
        syn0.copy_(new.syn0)
        syn1.copy_(new.syn1)
        return metrics
    metrics, upd0, upd1 = fused_sgns_shared_kernel(
        params, centers, contexts, mask, negatives, alpha, num_negatives, sigmoid_mode,
        with_metrics, compute_dtype=cd, logits_dtype=ld, fused=fused,
        bf16_chain=bf16_chain)
    if upd0 is not None:
        P = negatives.shape[0]
        scatter_add_rows_(syn0, centers, upd0, mask)
        scatter_add_rows_(syn1, torch.cat([contexts, negatives]), upd1,
                          torch.cat([mask, torch.ones(P, dtype=mask.dtype,
                                                      device=mask.device)]))
    return metrics


def fused_sgns_shared_kernel(
    params: EmbeddingPair,
    centers: torch.Tensor,
    contexts: torch.Tensor,
    mask: torch.Tensor,
    negatives: torch.Tensor,
    alpha: Union[float, torch.Tensor],
    num_negatives: int,
    sigmoid_mode: str = "exact",
    with_metrics: bool = True,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
    fused: bool = False,
    bf16_chain: bool = False,
) -> Tuple[StepMetrics, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One launch of the kernel on CUDA tensors, without the bf16 rows' scatters:
    returns (metrics, None, None) with f32 ``params`` updated in place, or, on bf16
    ``params`` (left untouched), the metrics and the kernel's bf16 update rows: d_in
    [B, D] and d_pos then dZ [B + P, D], the rows :func:`fused_sgns_shared_step`
    applies. Arguments as there; CPU tensors are refused (the step takes them)."""
    _check(params, centers, contexts, mask, negatives)
    syn0, syn1 = params
    if syn0.device.type != "cuda":
        raise ValueError(f"no kernel for device {syn0.device}")
    if sigmoid_mode not in ("exact", "clipped"):
        raise ValueError(f"sigmoid_mode must be 'exact' or 'clipped', got {sigmoid_mode!r}")
    cd, ld = _dtypes(syn0, compute_dtype, logits_dtype)
    lib = kernels.load("sgns_shared")
    B, P, D = centers.shape[0], negatives.shape[0], syn0.shape[1]
    # graftlint: disable=R3 -- a ctypes call's host integer (the scratch size), not a device value
    scratch = torch.empty(int(lib.glint_sgns_scratch_floats(B, P, D)),
                          dtype=torch.float32, device=syn0.device)
    out = torch.empty(3, dtype=torch.float32, device=syn0.device)  # loss, f_pos, pairs
    store_bf16 = syn0.dtype == torch.bfloat16
    upd0 = upd1 = None
    if store_bf16:  # the kernel's bf16 update rows: d_in; d_pos, then dZ
        upd0 = torch.empty((B, D), dtype=torch.bfloat16, device=syn0.device)
        upd1 = torch.empty((B + P, D), dtype=torch.bfloat16, device=syn0.device)
    flags = (STORE_BF16 * store_bf16 | COMPUTE_BF16 * (cd == torch.bfloat16)
             | LOGITS_BF16 * (ld == torch.bfloat16) | FUSED * bool(fused)
             | BF16_CHAIN * bool(bf16_chain))
    alpha_t = alpha_on_card(alpha, syn0.device)
    stream = torch.cuda.current_stream(syn0.device).cuda_stream
    err = lib.glint_sgns_shared_step(
        syn0.data_ptr(), syn1.data_ptr(), centers.data_ptr(), contexts.data_ptr(),
        mask.data_ptr(), negatives.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        None if upd0 is None else upd0.data_ptr(),
        None if upd1 is None else upd1.data_ptr(),
        B, P, D, alpha_t.data_ptr(), num_negatives / P,
        int(sigmoid_mode == "clipped"), int(with_metrics), flags, stream)
    if err != 0:
        raise RuntimeError(f"sgns_shared kernel launch failed: cudaError {err}")
    fused_sgns_shared_step.launches += 1
    fused_sgns_shared_step.bf16_launches += bool(
        flags & (STORE_BF16 | COMPUTE_BF16 | LOGITS_BF16))
    return StepMetrics(out[0], out[1], out[2]), upd0, upd1


# Kernel launches (one per fused step on a CUDA tensor; each is four CUDA launches),
# and those of them in a bf16 form (bf16 storage, compute or logits). A call captured
# into a CUDA graph runs here once, at capture, where nothing launches: the trainer's
# graphs (train/graphs.py) take that count back and add it once per replay.
fused_sgns_shared_step.launches = 0
fused_sgns_shared_step.bf16_launches = 0
