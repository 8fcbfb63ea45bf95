"""The CUDA kernels against their plain PyTorch versions, on the card: the fused
shared-pool step and the row scatter-add.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (the kernels have
no CPU mode; chip_smoke.py holds them against the plain versions at the main shapes).
Tolerance: atol 1e-4 on parameters of scale ~0.5 — the kernels sum duplicate rows with
fp32 atomics in a run-dependent order, and the fused kernel its products in another
order than cuBLAS."""

import numpy as np
import pytest
import torch

from glint_word2vec_torch.ops import scatter as tscatter
from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _step_inputs(cuda, seed, B, P, D, V, a=1.3, scale=0.5):
    """Zipf(a) centers, contexts and pool (a few pool entries equal to contexts), a
    masked tail of index 0, params N(0, scale)."""
    rng = np.random.default_rng(seed)
    syn0 = torch.from_numpy(rng.normal(0, scale, (V, D)).astype(np.float32)).to(cuda)
    syn1 = torch.from_numpy(rng.normal(0, scale, (V, D)).astype(np.float32)).to(cuda)
    c = torch.from_numpy((rng.zipf(a, B) - 1) % V).to(cuda)
    x = torch.from_numpy((rng.zipf(a, B) - 1) % V).to(cuda)
    neg = torch.from_numpy((rng.zipf(a, P) - 1) % V).to(cuda)
    neg[:4] = x[:4]
    mask = torch.ones(B, device=cuda)
    mask[-17:] = 0
    c[-17:] = 0
    x[-17:] = 0
    return syn0, syn1, c, x, mask, neg


def _check_kernel(syn0, syn1, c, x, mask, neg, mode):
    """One kernel step in place against the plain step: atol 1e-4 on the parameters,
    rtol 1e-4 on the loss, exactly one launch."""
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
    torch.testing.assert_close(got.pairs, wm.pairs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "clipped"])
@pytest.mark.parametrize("B,P,D,V,a,scale", [
    (512, 64, 128, 2048, 1.3, 0.5), (300, 70, 100, 2048, 1.3, 0.5),
    # batch-sized cases draw as the main path's data (chip_smoke.py) does, Zipf(1.1) and
    # params of scale 0.35. Under Zipf(1.3) and scale 0.5 the hottest rows take ~2000
    # large updates, and the plain version itself lies farther than 1e-4 from a float64
    # step there (chip_smoke.py's heavy-draw case): two fp32 summation orders cannot
    # agree to 1e-4, so test_kernel_heavy_draw holds that draw against float64
    (8191, 250, 300, 65536, 1.1, 0.35),   # ragged: every dimension pads to a tile
    (8191, 250, 102, 65536, 1.1, 0.35),   # rows not 16-byte aligned: scalar atomics
    (8192, 256, 384, 65536, 1.1, 0.35),   # the full width of the main path
])
def test_kernel_matches_plain(cuda, mode, B, P, D, V, a, scale):
    _check_kernel(*_step_inputs(cuda, B + P + D, B, P, D, V, a, scale), mode)


@pytest.mark.cuda
def test_kernel_heavy_draw(cuda):
    """Zipf(1.3) indices and params of scale 0.5 at the full width: kernel and plain
    each against a float64 step. The kernel may be no farther from it than twice the
    plain version's own distance (an fp32 sum in another order), on either matrix."""
    syn0, syn1, c, x, mask, neg = _step_inputs(cuda, 13, 8192, 256, 384, 65536)
    pair = tsgns.EmbeddingPair
    ref, _ = tsgns.sgns_step_shared_core(pair(syn0.double(), syn1.double()), c, x,
                                         mask.double(), neg, 0.025, 5, "exact")
    want, wm = tsgns.sgns_step_shared_core(pair(syn0, syn1), c, x, mask, neg, 0.025, 5,
                                           "exact")
    before = fused_sgns_shared_step.launches
    got = fused_sgns_shared_step(pair(syn0, syn1), c, x, mask, neg, 0.025, 5, "exact")
    torch.cuda.synchronize()
    assert fused_sgns_shared_step.launches == before + 1
    for kernel, plain, exact in ((syn0, want.syn0, ref.syn0), (syn1, want.syn1, ref.syn1)):
        err_kernel = float((kernel.double() - exact).abs().max())
        err_plain = float((plain.double() - exact).abs().max())
        assert err_kernel <= 2 * err_plain, (err_kernel, err_plain)
    torch.testing.assert_close(got.loss, wm.loss, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "clipped"])
def test_kernel_hot_row_matches_plain(cuda, mode):
    """Every live center on one row and the whole pool on one row: thousands of
    atomics on the same addresses, summed as the plain version sums them."""
    syn0, syn1, c, x, mask, neg = _step_inputs(cuda, 11, 512, 64, 128, 2048)
    c[mask > 0] = 7
    neg[:] = 11
    _check_kernel(syn0, syn1, c, x, mask, neg, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [384, 102])  # 102: rows not 16-byte aligned, scalar path
@pytest.mark.parametrize("rows_per_block", [1, 32, 1024])
def test_scatter_kernel_matches_plain(cuda, D, rows_per_block):
    rng = np.random.default_rng(D + rows_per_block)
    V, N = 4096, 20000
    base = torch.from_numpy(rng.normal(0, 0.5, (V, D)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy((rng.zipf(1.2, N) - 1) % V).to(cuda)
    live = torch.from_numpy((rng.random(N) > 0.3).astype(np.float32)).to(cuda)
    upd = torch.from_numpy(rng.normal(0, 0.1, (N, D)).astype(np.float32)).to(cuda)
    upd *= live[:, None]
    idx[live == 0] = 0
    want = tscatter.scatter_add_rows_reference(base.clone(), idx, upd)
    before = tscatter.scatter_add_rows_.launches
    got = tscatter.scatter_add_rows_(base.clone(), idx, upd, live,
                                     rows_per_block=rows_per_block)
    tscatter.check_errors()
    torch.cuda.synchronize()
    assert tscatter.scatter_add_rows_.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_scatter_kernel_refuses_out_of_range_rows(cuda):
    mat = torch.zeros(64, 128, device=cuda)
    idx = torch.tensor([3, 64, -1, 5], device=cuda)
    tscatter.scatter_add_rows_(mat, idx, torch.ones(4, 128, device=cuda))
    with pytest.raises(IndexError, match="outside"):
        tscatter.check_errors()
    assert mat[3].eq(1).all() and mat[5].eq(1).all() and mat.sum() == 2 * 128
    tscatter.check_errors()  # the flag was cleared by the raise
