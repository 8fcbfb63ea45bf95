"""The CUDA shared-pool step against its plain PyTorch version, on the card.

Marked ``cuda``: it needs an NVIDIA GPU and nvcc, and skips elsewhere (the kernel has
no CPU mode; chip_smoke.py holds it against the plain version at the main shape).
Tolerance: atol 1e-4 on parameters of scale ~0.5 — the kernel sums duplicate rows with
fp32 atomics in a run-dependent order and its products in another order than cuBLAS."""

import numpy as np
import pytest
import torch

from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "clipped"])
@pytest.mark.parametrize("B,P,D", [(512, 64, 128), (300, 70, 100)])
def test_kernel_matches_plain(cuda, mode, B, P, D):
    rng = np.random.default_rng(B + P)
    V = 2048
    syn0 = torch.from_numpy(rng.normal(0, 0.5, (V, D)).astype(np.float32)).to(cuda)
    syn1 = torch.from_numpy(rng.normal(0, 0.5, (V, D)).astype(np.float32)).to(cuda)
    c = torch.from_numpy((rng.zipf(1.3, B) - 1) % V).to(cuda)
    x = torch.from_numpy((rng.zipf(1.3, B) - 1) % V).to(cuda)
    neg = torch.from_numpy((rng.zipf(1.3, P) - 1) % V).to(cuda)
    neg[:4] = x[:4]
    mask = torch.ones(B, device=cuda)
    mask[-17:] = 0
    want, wm = tsgns.sgns_step_shared_core(
        tsgns.EmbeddingPair(syn0, syn1), c, x, mask, neg, 0.025, 5, mode)
    before = fused_sgns_shared_step.launches
    got = fused_sgns_shared_step(tsgns.EmbeddingPair(syn0, syn1), c, x, mask, neg,
                                 0.025, 5, mode)
    torch.cuda.synchronize()
    assert fused_sgns_shared_step.launches == before + 1
    torch.testing.assert_close(syn0, want.syn0, atol=1e-4, rtol=0)
    torch.testing.assert_close(syn1, want.syn1, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.loss, wm.loss, rtol=1e-4, atol=0)
