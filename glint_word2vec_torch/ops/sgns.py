"""The shared-pool SGNS step in plain PyTorch, ported from
``glint_word2vec_tpu/ops/sgns.py`` (the spec of the port's CUDA kernel).

Update rule (SGD on the SGNS objective, pre-update values on both sides):

    f_pos = syn0[c]·syn1[x]          g_pos = (1 − σ(f_pos))·α·mask
    f_neg = syn0[c]·Z_pᵀ             g_neg = −σ(f_neg)·α·valid·n/P
    syn0[c]    += g_pos·syn1[x] + Σ_p g_neg_p·Z_p
    syn1[x]    += g_pos·syn0[c]
    syn1[z_p]  += Σ_b g_neg_bp·syn0[c_b]

with one pool Z = syn1[negatives] of P rows shared by the whole batch, each negative
term reweighted by n/P, and valid = (context ≠ pool id)·mask. Duplicate indices sum
(``index_add_``), as the JAX package's ``.at[].add`` does.

This module is the plain version: the CPU path of the trainer, and what the kernel is
held against on the card. Only the default step is ported (f32, no fused chain, no
hot rows, no stabilizers, no duplicate scaling).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

MAX_EXP = 6.0  # the reference's sigmoid LUT clipping range


class EmbeddingPair(NamedTuple):
    """The two trainable matrices: input (syn0) and output (syn1neg) embeddings."""

    syn0: torch.Tensor  # [V, D]
    syn1: torch.Tensor  # [V, D]


class StepMetrics(NamedTuple):
    """Per-step telemetry: masked mean SGNS loss, mean positive logit, real pairs.
    Each is a 0-d float32 tensor on the step's device."""

    loss: torch.Tensor
    mean_f_pos: torch.Tensor
    pairs: torch.Tensor


def init_embeddings(vocab_size: int, vector_size: int,
                    generator: torch.Generator) -> EmbeddingPair:
    """Classic word2vec init on the CPU: syn0 ~ U(-0.5/D, 0.5/D), syn1 = 0. Draws
    come from ``generator`` (a CPU torch.Generator) and differ from the JAX package's,
    so tests that compare the packages inject parameters instead."""
    syn0 = torch.rand((vocab_size, vector_size), generator=generator,
                      dtype=torch.float32)
    syn0 = (syn0 - 0.5) / vector_size
    syn1 = torch.zeros((vocab_size, vector_size), dtype=torch.float32)
    return EmbeddingPair(syn0, syn1)


def _sigmoid(f: torch.Tensor, mode: str) -> torch.Tensor:
    """σ(f); "clipped" saturates to 1 above +6 and 0 below -6 (the reference LUT)."""
    s = torch.sigmoid(f)
    if mode == "clipped":
        s = torch.where(f > MAX_EXP, torch.ones_like(s),
                        torch.where(f < -MAX_EXP, torch.zeros_like(s), s))
    return s


def _log_sigmoid(f: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-f)


def shared_pool_coeffs(
    e_in: torch.Tensor,       # [B, D]
    e_pos: torch.Tensor,      # [B, D]
    Z: torch.Tensor,          # [P, D]
    contexts: torch.Tensor,   # int [B]
    negatives: torch.Tensor,  # int [P]
    mask: torch.Tensor,       # float32 [B]
    alpha: float,
    num_negatives: int,
    sigmoid_mode: str,
) -> Tuple[torch.Tensor, ...]:
    """The shared-pool logit chain: (f_pos, f_neg, neg_valid, g_pos, g_neg)."""
    P = negatives.shape[0]
    f_pos = torch.sum(e_in * e_pos, dim=-1)
    f_neg = e_in @ Z.T                                               # [B, P]
    g_pos = (1.0 - _sigmoid(f_pos, sigmoid_mode)) * alpha * mask
    neg_valid = (negatives[None, :] != contexts[:, None]).to(torch.float32) \
        * mask[:, None]
    g_neg = (0.0 - _sigmoid(f_neg, sigmoid_mode)) * alpha * neg_valid \
        * (num_negatives / P)
    return f_pos, f_neg, neg_valid, g_pos, g_neg


def shared_pool_loss_terms(
    f_pos: torch.Tensor, f_neg: torch.Tensor, neg_valid: torch.Tensor,
    mask: torch.Tensor, num_negatives: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-division numerators of the loss and of mean_f_pos (0-d tensors)."""
    P = f_neg.shape[-1]
    neg_term = torch.sum(_log_sigmoid(-f_neg) * neg_valid, dim=-1)
    loss_num = (-_log_sigmoid(f_pos) * mask - neg_term * (num_negatives / P)).sum()
    return loss_num, (f_pos * mask).sum()


def sgns_step_shared_core(
    params: EmbeddingPair,
    centers: torch.Tensor,    # int [B]
    contexts: torch.Tensor,   # int [B]
    mask: torch.Tensor,       # float32 [B]
    negatives: torch.Tensor,  # int [P] — pre-drawn shared pool
    alpha: Union[float, torch.Tensor],
    num_negatives: int,
    sigmoid_mode: str = "exact",
    with_metrics: bool = True,
) -> Tuple[EmbeddingPair, StepMetrics]:
    """One shared-pool SGNS step; returns NEW parameters (the inputs are untouched)
    and the step metrics. ``with_metrics=False`` skips the loss and mean_f_pos pass
    (both 0) and keeps ``pairs`` exact, like the JAX package's elided twin."""
    syn0, syn1 = params
    centers = centers.long()
    contexts = contexts.long()
    negatives = negatives.long()
    e_in = syn0[centers]
    e_pos = syn1[contexts]
    Z = syn1[negatives]
    f_pos, f_neg, neg_valid, g_pos, g_neg = shared_pool_coeffs(
        e_in, e_pos, Z, contexts, negatives, mask, alpha, num_negatives, sigmoid_mode)
    d_in = g_pos[:, None] * e_pos + g_neg @ Z                        # [B, D]
    d_pos = g_pos[:, None] * e_in
    d_Z = g_neg.T @ e_in                                             # [P, D]
    new_syn0 = syn0.clone().index_add_(0, centers, d_in)
    new_syn1 = syn1.clone().index_add_(0, contexts, d_pos)
    new_syn1.index_add_(0, negatives, d_Z)
    pairs = mask.sum()
    if with_metrics:
        denom = torch.clamp(pairs, min=1.0)
        loss_num, fpos_num = shared_pool_loss_terms(
            f_pos, f_neg, neg_valid, mask, num_negatives)
        loss, mean_f_pos = loss_num / denom, fpos_num / denom
    else:
        loss = mean_f_pos = torch.zeros((), dtype=torch.float32, device=syn0.device)
    return EmbeddingPair(new_syn0, new_syn1), StepMetrics(loss, mean_f_pos, pairs)


def alpha_schedule(
    words_processed,
    total_words: float,
    learning_rate: float,
    min_alpha_factor: float = 1e-4,
) -> float:
    """Linear lr decay with floor: ``lr·(1 − words/total)``, floored at
    ``lr·min_alpha_factor`` (the reference's schedule)."""
    alpha = learning_rate * (1.0 - words_processed / total_words)
    return max(float(alpha), learning_rate * min_alpha_factor)
