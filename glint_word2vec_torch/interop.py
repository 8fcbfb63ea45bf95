"""Carry parameters between the two packages as numpy arrays.

``params_from_numpy(np.asarray(jax_trainer.params.syn0), ...)`` turns the JAX
package's (possibly padded) parameters into the port's :class:`EmbeddingPair`;
:func:`params_to_numpy` goes the other way. The tests use these to start both
packages from one state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.ops.sgns import EmbeddingPair


def params_from_numpy(syn0: np.ndarray, syn1: np.ndarray, device="cuda",
                      padded_vocab: Optional[int] = None,
                      padded_dim: Optional[int] = None,
                      dtype: torch.dtype = torch.float32) -> EmbeddingPair:
    """Tensors of ``dtype`` (float32 or bfloat16) on ``device`` (the card unless the
    caller asks for the CPU; it raises without one), zero-padded to (padded_vocab,
    padded_dim) when given (default: the arrays' own shape). A JAX bf16 array arrives
    widened to float32 (``np.asarray(a, np.float32)``, exact) and is cast back to
    ``torch.bfloat16`` exactly, so both packages start a bf16 run from the same bits."""
    device = resolve_device(device)
    def place(a: np.ndarray) -> torch.Tensor:
        a = np.asarray(a, dtype=np.float32)
        V = padded_vocab or a.shape[0]
        D = padded_dim or a.shape[1]
        if a.shape[0] > V or a.shape[1] > D:
            raise ValueError(f"array {a.shape} is larger than the padded shape {(V, D)}")
        out = np.zeros((V, D), np.float32)
        out[:a.shape[0], :a.shape[1]] = a
        return torch.from_numpy(out).to(device, dtype)

    return EmbeddingPair(place(syn0), place(syn1))


def params_to_numpy(params: EmbeddingPair) -> Tuple[np.ndarray, np.ndarray]:
    """(syn0, syn1) as host float32 arrays (bf16 widens exactly)."""
    return (params.syn0.detach().float().cpu().numpy(),
            params.syn1.detach().float().cpu().numpy())
