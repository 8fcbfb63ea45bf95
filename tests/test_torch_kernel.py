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

from glint_word2vec_torch import scatterprobe
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


def _scatter_draw(cuda, seed, V, N, D, a=1.2, dead=0.3):
    """Zipf(a) rows, a dead share of slots pointing at row 0 with zero updates."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.normal(0, 0.5, (V, D)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy((rng.zipf(a, N) - 1) % V).to(cuda)
    live = torch.from_numpy((rng.random(N) > dead).astype(np.float32)).to(cuda)
    upd = torch.from_numpy(rng.normal(0, 0.1, (N, D)).astype(np.float32)).to(cuda)
    upd *= live[:, None]
    idx[live == 0] = 0
    return base, idx, upd, live


def _scatter_tol(base, idx, upd, live=None):
    """The recursive-summation bound m·2^-24·max(|target| + Σ|upd|) (chip_smoke.py's
    scatter_tol), m one more than the most live updates on one row: two fp32 sums of
    one row in different orders stay within it."""
    mag = base.abs().double().index_add_(0, idx, upd.abs().double())
    live_idx = idx if live is None else idx[live != 0]
    return (int(torch.bincount(live_idx).max()) + 1) * 2.0 ** -24 * float(mag.max())


def _kernel_call(mat, idx, upd, live=None):
    """One wrapper call; asserts it counted exactly one launch."""
    before = tscatter.scatter_add_rows_.launches
    out = tscatter.scatter_add_rows_(mat, idx, upd, live)
    tscatter.check_errors()
    torch.cuda.synchronize()
    assert tscatter.scatter_add_rows_.launches == before + 1
    return out


# The kernel's two paths: (CHUNK, GROUP_RATIO) of ops/scatter.py for each.
GROUPED = {"grouped": (tscatter.CHUNK, 0),
           "grouped_chunk1": (1, 0),  # every row's owners add by atomics
           "grouped_chunk32": (32, 0), "grouped_chunk1024": (1024, 0)}
PATHS = {**GROUPED, "one_launch": (tscatter.CHUNK, 1 << 40)}


@pytest.fixture
def path(request, monkeypatch):
    chunk, ratio = PATHS[request.param]
    monkeypatch.setattr(tscatter, "CHUNK", chunk)
    monkeypatch.setattr(tscatter, "GROUP_RATIO", ratio)
    return request.param


@pytest.mark.cuda
@pytest.mark.parametrize("D", [384, 102])  # 102: rows not 16-byte aligned, scalar path
@pytest.mark.parametrize("path", list(PATHS), indirect=True)
def test_scatter_kernel_matches_plain(cuda, D, path):
    base, idx, upd, live = _scatter_draw(cuda, D + len(path), 4096, 20000, D)
    want = tscatter.scatter_add_rows_reference(base.clone(), idx, upd)
    got = _kernel_call(base.clone(), idx, upd, live)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [4096 // tscatter.GROUP_RATIO, 4096 // tscatter.GROUP_RATIO + 1])
def test_scatter_kernel_either_side_of_group_ratio(cuda, V):
    """The path the sizes choose: grouped at GROUP_RATIO slots per row, one launch
    below."""
    base, idx, upd, live = _scatter_draw(cuda, V, V, 4096, 384)
    want = tscatter.scatter_add_rows_reference(base.clone(), idx, upd)
    got = _kernel_call(base.clone(), idx, upd, live)
    assert float((got - want).abs().max()) <= _scatter_tol(base, idx, upd, live)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [384, 102])
@pytest.mark.parametrize("path", ["grouped", "grouped_chunk1", "one_launch"],
                         indirect=True)
def test_scatter_kernel_runs_of_equal_rows(cuda, D, path):
    """Runs of one row, as the per-pair feed repeats each center once per context,
    some crossing a warp's 32 slots, with dead slots inside them."""
    rng = np.random.default_rng(D)
    lengths = rng.integers(1, 40, 600)
    idx = torch.from_numpy(np.repeat(rng.integers(0, 300, lengths.size), lengths)).to(cuda)
    N = idx.numel()
    live = torch.from_numpy((rng.random(N) > 0.1).astype(np.float32)).to(cuda)
    base = torch.from_numpy(rng.normal(0, 0.5, (300, D)).astype(np.float32)).to(cuda)
    upd = torch.from_numpy(rng.normal(0, 0.1, (N, D)).astype(np.float32)).to(cuda)
    upd *= live[:, None]
    want = base.double().index_add_(0, idx, upd.double())
    got = _kernel_call(base.clone(), idx, upd, live)
    assert float((got.double() - want).abs().max()) <= _scatter_tol(base, idx, upd, live)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [384, 102])
@pytest.mark.parametrize("path", list(GROUPED), indirect=True)
def test_scatter_kernel_matches_grouped_emulation(cuda, D, path):
    """The grouped path against its plain emulation. The kernel orders a row's slots
    by its integer atomics and adds a hot row's chunk sums with atomics, so the two
    agree within the summation bound, not bit for bit."""
    base, idx, upd, live = _scatter_draw(cuda, 3 * D + len(path), 4096, 20000, D, a=1.3)
    want = tscatter.scatter_add_rows_grouped(base.clone(), idx, upd, live,
                                             tscatter.CHUNK)
    got = _kernel_call(base.clone(), idx, upd, live)
    assert float((got - want).abs().max()) <= _scatter_tol(base, idx, upd, live)


# All 65536 slots on one row, each column moving by ~N(0, 0.26). Over 5 runs on an
# NVIDIA H100 80GB HBM3 (scatterprobe.py --hot-head) the grouped path landed at most
# 9.6e-6 from the float64 sum, the one-launch path 4.1e-6 and index_add_ 3.0e-5; the
# limit is three times the largest. One lost chunk of CHUNK updates would move a column
# by ~3e-3 (a lost warp's sum by ~6e-3).
HOT_HEAD_LIMIT = 9e-5


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["grouped", "one_launch"], indirect=True)
def test_scatter_kernel_hot_head(cuda, path):
    """Every slot on one row: owners of CHUNK slots (grouped) or of a warp's 32 slots
    (one launch) each add their sums to it with atomics."""
    base_np, idx_np, upd_np = scatterprobe.hot_head_draw()
    base, idx, upd = (torch.from_numpy(a).to(cuda) for a in (base_np, idx_np, upd_np))
    sum64 = upd.double().sum(0)
    got = _kernel_call(base.clone(), idx, upd)
    moved = got[3].double() - base[3].double()
    assert float((moved - sum64).abs().max()) <= HOT_HEAD_LIMIT
    plain = tscatter.scatter_add_rows_reference(base.clone(), idx, upd)
    assert float((plain[3].double() - base[3].double() - sum64).abs().max()) \
        <= HOT_HEAD_LIMIT
    assert torch.equal(got[:3], base[:3]) and torch.equal(got[4:], base[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["grouped"], indirect=True)
def test_scatter_kernel_tables_come_back_clean(cuda, path):
    """The grouped path's [V] tables and counters are left zeroed by every call: two
    calls with different index sets, then a call on a matrix of another V, all
    correct."""
    for seed, V in ((1, 4096), (2, 4096), (3, 100_000), (4, 512)):
        base, idx, upd, live = _scatter_draw(cuda, seed, V, 9000, 128, a=1.1 + seed / 10)
        want = tscatter.scatter_add_rows_reference(base.clone(), idx, upd)
        got = _kernel_call(base.clone(), idx, upd, live)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["grouped", "one_launch"], indirect=True)
def test_scatter_kernel_refuses_out_of_range_rows(cuda, path):
    mat = torch.zeros(64, 128, device=cuda)
    idx = torch.tensor([3, 64, -1, 5], device=cuda)
    tscatter.scatter_add_rows_(mat, idx, torch.ones(4, 128, device=cuda))
    with pytest.raises(IndexError, match="outside"):
        tscatter.check_errors()
    assert mat[3].eq(1).all() and mat[5].eq(1).all() and mat.sum() == 2 * 128
    tscatter.check_errors()  # the flag was cleared by the raise


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["grouped", "one_launch"], indirect=True)
def test_scatter_kernel_call_after_a_refused_index(cuda, path):
    """A call that flags an out-of-range index, then a correct call: the flag is
    raised once, and the skipped slot leaves nothing behind in the tables."""
    mat = torch.zeros(64, 128, device=cuda)
    tscatter.scatter_add_rows_(mat, torch.tensor([3, 70, 3], device=cuda),
                               torch.ones(3, 128, device=cuda))
    torch.cuda.synchronize()
    with pytest.raises(IndexError, match="outside"):  # raised at the next call
        tscatter.scatter_add_rows_(mat, torch.tensor([1], device=cuda),
                                   torch.ones(1, 128, device=cuda))
    base, idx, upd, live = _scatter_draw(cuda, 5, 64, 3000, 128)
    want = tscatter.scatter_add_rows_reference(base.clone(), idx, upd)
    got = _kernel_call(base.clone(), idx, upd, live)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert mat[3].eq(2).all() and mat.sum() == 2 * 128
