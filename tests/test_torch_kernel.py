"""The CUDA kernels against their plain PyTorch versions, on the card: the fused
shared-pool step and the row scatter-add (alone, and inside the banded CBOW step and the
stabilized steps).

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (the kernels have
no CPU mode; chip_smoke.py holds them against the plain versions at the main shapes).
Tolerance: atol 1e-4 on parameters of scale ~0.5 — the kernels sum duplicate rows with
fp32 atomics in a run-dependent order, and the fused kernel its products in another
order than cuBLAS."""

import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import scatterprobe
from glint_word2vec_torch.ops import bf16_check
from glint_word2vec_torch.ops import scatter as tscatter
from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_torch.ops.fused_sgns import alpha_on_card, fused_sgns_shared_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


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
    rtol 1e-4 on the loss, exactly one launch. The kernel takes alpha in the trainer's
    form (a one-element tensor on the card), the plain step the Python float."""
    want, wm = tsgns.sgns_step_shared_core(
        tsgns.EmbeddingPair(syn0, syn1), c, x, mask, neg, 0.025, 5, mode)
    before = fused_sgns_shared_step.launches
    got = fused_sgns_shared_step(tsgns.EmbeddingPair(syn0, syn1), c, x, mask, neg,
                                 alpha_on_card(0.025, syn0.device), 5, mode)
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
    got = fused_sgns_shared_step(pair(syn0, syn1), c, x, mask, neg,
                                 alpha_on_card(0.025, cuda), 5, "exact")
    torch.cuda.synchronize()
    assert fused_sgns_shared_step.launches == before + 1
    for kernel, plain, exact in ((syn0, want.syn0, ref.syn0), (syn1, want.syn1, ref.syn1)):
        err_kernel = float((kernel.double() - exact).abs().max())
        err_plain = float((plain.double() - exact).abs().max())
        assert err_kernel <= 2 * err_plain, (err_kernel, err_plain)
    torch.testing.assert_close(got.loss, wm.loss, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_kernel_reads_alpha_at_run_time(cuda):
    """The kernel captured in a CUDA graph, as the trainer captures it, and replayed
    after alpha's tensor took another value: each replay trains at the value it finds
    there, against the plain step at that value (atol 1e-4, loss rtol 1e-4)."""
    syn0, syn1, c, x, mask, neg = _step_inputs(cuda, 17, 512, 64, 128, 2048)
    pair = tsgns.EmbeddingPair
    alpha = alpha_on_card(0.0, cuda)
    got0, got1 = syn0.clone(), syn1.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up at alpha 0: an exact no-op
        fused_sgns_shared_step(pair(got0, got1), c, x, mask, neg, alpha, 5, "exact")
    torch.cuda.current_stream().wait_stream(stream)
    torch.testing.assert_close(got0, syn0, atol=0, rtol=0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        metrics = fused_sgns_shared_step(pair(got0, got1), c, x, mask, neg, alpha, 5,
                                         "exact")
    ref0, ref1 = syn0, syn1
    for value in (0.025, 0.0125):
        alpha.fill_(value)
        graph.replay()
        want, wm = tsgns.sgns_step_shared_core(pair(ref0, ref1), c, x, mask, neg, value,
                                               5, "exact")
        torch.cuda.synchronize()
        torch.testing.assert_close(got0, want.syn0, atol=1e-4, rtol=0)
        torch.testing.assert_close(got1, want.syn1, atol=1e-4, rtol=0)
        torch.testing.assert_close(metrics.loss, wm.loss, rtol=1e-4, atol=0)
        assert float((got1 - ref1).abs().max()) > 1e-3  # the replay trained
        ref0, ref1 = want.syn0, want.syn1


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


@pytest.mark.cuda
def test_staged_feed_trains_as_the_calling_thread(cuda):
    """The trainer's producer thread stages each chunk on the card (pinned copies on a
    stream of their own, an event the consumer waits on): the same steps and pairs as
    the synchronous feed, parameters within 1e-4 (the kernel's fp32 atomics), and no
    feed thread left behind."""
    import threading

    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.train.trainer import Trainer

    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(300)]
    p = 1.0 / np.arange(1, 301)
    p /= p.sum()
    sents = [[words[j] for j in rng.choice(300, size=20, p=p)] for _ in range(600)]
    vocab = build_vocab(sents, 1)
    enc = encode_sentences(sents, vocab)
    base = dict(vector_size=64, pairs_per_batch=512, negative_pool=128,
                steps_per_dispatch=4, num_iterations=2, subsample_ratio=1e-3,
                allow_unstable=True, min_count=1, seed=3)
    runs = []
    for prefetch, workers in ((0, 1), (8, 1), (8, 4)):
        t = Trainer(Word2VecConfig(prefetch_chunks=prefetch, producer_workers=workers,
                                   **base), vocab, device=cuda)
        t.fit(enc)
        runs.append(t)
    for t in runs[1:]:
        assert (t.global_step, t.pairs_trained) == (runs[0].global_step,
                                                     runs[0].pairs_trained)
        for a, b in zip(t.params, runs[0].params):
            assert float((a - b).abs().max()) <= 1e-4
    assert runs[0].global_step >= 8
    assert not [th.name for th in threading.enumerate()
                if th.name.startswith(("glint-batch-producer", "glint-feed-worker"))]


def _banded_case(cuda, seed, V=5000, D=128, T=600, P=64, W=5):
    """A banded block on the card: Zipf tokens in sentences of 3 to 30, a padded
    tail, block 0's wrapped base, a Zipf pool; params N(0, 0.5)."""
    from glint_word2vec_torch.ops.pairgen import device_cbow_windows

    rng = np.random.default_rng(seed)
    syn0 = torch.from_numpy(rng.normal(0, 0.5, (V, D)).astype(np.float32)).to(cuda)
    syn1 = torch.from_numpy(rng.normal(0, 0.5, (V, D)).astype(np.float32)).to(cuda)
    n_valid = T - 37
    tokens = torch.from_numpy((rng.zipf(1.2, T) - 1) % V).to(cuda)
    tokens[n_valid:] = 0
    cuts = np.cumsum(np.concatenate([[0], rng.integers(3, 31, T)]))
    starts = np.zeros(T, bool)
    starts[cuts[cuts < n_valid]] = True
    bits = torch.from_numpy(np.packbits(starts, bitorder="little")).to(cuda)
    base = (-W) & 0xFFFFFFFFFFFFFFFF
    band = device_cbow_windows(tokens, bits, n_valid, base & 0xFFFFFFFF, base >> 32, 77,
                               W, W)
    neg = torch.from_numpy((rng.zipf(1.2, P) - 1) % V).to(cuda)
    return syn0, syn1, tokens, band, neg


@pytest.mark.cuda
@pytest.mark.parametrize("endpoint", ["auto", "shift"])
@pytest.mark.parametrize("stab", [False, True])
def test_banded_step_kernel_matches_plain(cuda, endpoint, stab):
    """The banded step through the scatter kernel (three launches with the scatter
    endpoint form, two with the shifted adds) against the same step through the plain
    scatter, and the window geometry on the card against the CPU's."""
    from glint_word2vec_torch.ops import cbow_banded

    syn0, syn1, tokens, band, neg = _banded_case(cuda, 3)
    st = tsgns.Stabilizers(max_row_norm=5.0, update_clip=0.05, row_l2=1e-3) if stab \
        else None
    runs = []
    for scatter in (tscatter.scatter_add_rows_, tscatter.scatter_add_rows_reference):
        p = tsgns.EmbeddingPair(syn0.clone(), syn1.clone())
        before = tscatter.scatter_add_rows_.launches
        m = cbow_banded.cbow_step_banded_core(
            p, tokens, band.left, band.right, band.center, band.token, neg, 0.025, 5, 5,
            "exact", True, scatter, stabilizers=st, endpoint=endpoint)
        runs.append((p, m, tscatter.scatter_add_rows_.launches - before))
    tscatter.check_errors()
    (got, gm, launched), (want, wm, _) = runs
    assert launched == (3 if endpoint == "auto" else 2)
    torch.testing.assert_close(got.syn0, want.syn0, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.syn1, want.syn1, atol=1e-4, rtol=0)
    torch.testing.assert_close(gm.loss, wm.loss, rtol=1e-4, atol=0)
    assert float(gm.pairs) == float(wm.pairs) > 300
    assert float((want.syn0 - syn0).abs().max()) > 1e-3


@pytest.mark.cuda
def test_device_cbow_windows_card_equals_cpu(cuda):
    from glint_word2vec_torch.ops.pairgen import device_cbow_windows

    _, _, tokens, band, _ = _banded_case(cuda, 4)
    rng = np.random.default_rng(4)
    assert band.center.sum() > 0
    for K in (1, 3):
        toks = torch.stack([tokens.roll(k) for k in range(K)])
        bits = torch.from_numpy(rng.integers(0, 256, (K, (toks.shape[1] + 7) // 8),
                                             dtype=np.uint8)).to(cuda)
        nv = torch.tensor([toks.shape[1] - 5 * k for k in range(K)], device=cuda)
        lo = torch.tensor([0xFFFFFFFB, 7, 0xFFFFFF00][:K], device=cuda)
        hi = torch.tensor([0xFFFFFFFF, 0, 3][:K], device=cuda)
        got = device_cbow_windows(toks, bits, nv, lo, hi, 99, 5, 5)
        want = device_cbow_windows(toks.cpu(), bits.cpu(), nv.cpu(), lo.cpu(), hi.cpu(),
                                   99, 5, 5)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("step,knob", [
    (step, "stabilizers") for step in ("per_pair", "shared_scatter", "cbow",
                                       "cbow_per_example")] + [
    (step, "duplicate_scaling") for step in ("per_pair", "shared_scatter",
                                             "cbow_per_example")])
def test_stabilized_steps_kernel_matches_plain(cuda, step, knob):
    """Each in-place step with the stabilizers (or duplicate scaling, where the step
    has it) through the scatter kernel against the plain scatter: two launches, atol
    1e-4, and the clamp holding every moved row to max_row_norm."""
    rng = np.random.default_rng(6)
    V, D, B, P, C, n = 4096, 128, 512, 64, 8, 5
    syn0, syn1, c, x, mask, pool = _step_inputs(cuda, 6, B, P, D, V)
    neg = torch.from_numpy((rng.zipf(1.3, (B, n)) - 1) % V).to(cuda)
    nctx = torch.from_numpy(rng.integers(0, C + 1, B)).to(cuda)
    cm = (torch.arange(C, device=cuda)[None, :] < nctx[:, None]).float()
    ctx = torch.from_numpy((rng.zipf(1.3, (B, C)) - 1) % V).to(cuda) * cm.long()
    kw = ({"stabilizers": tsgns.Stabilizers(max_row_norm=5.0, update_clip=0.05,
                                            row_l2=1e-3)}
          if knob == "stabilizers" else {"duplicate_scaling": True})

    def run(p, scatter):
        if step == "per_pair":
            return tsgns.sgns_step_core(p, c, x, mask, neg, 0.025, "exact", scatter, **kw)
        if step == "shared_scatter":
            return tsgns.sgns_step_shared_scatter_(p, c, x, mask, pool, 0.025, 5, "exact",
                                                   True, scatter, **kw)
        if step == "cbow":
            return tsgns.cbow_step_shared_core(p, c, ctx, cm, mask, pool, 0.025, 5,
                                               "exact", True, scatter, **kw)
        return tsgns.cbow_step_core(p, c, ctx, cm, mask, neg, 0.025, "exact", scatter,
                                    **kw)

    runs = []
    for scatter in (tscatter.scatter_add_rows_, tscatter.scatter_add_rows_reference):
        p = tsgns.EmbeddingPair(syn0.clone(), syn1.clone())
        before = tscatter.scatter_add_rows_.launches
        m = run(p, scatter)
        runs.append((p, m, tscatter.scatter_add_rows_.launches - before))
    tscatter.check_errors()
    (got, gm, launched), (want, wm, _) = runs
    assert launched == 2
    torch.testing.assert_close(got.syn0, want.syn0, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.syn1, want.syn1, atol=1e-4, rtol=0)
    torch.testing.assert_close(gm.loss, wm.loss, rtol=1e-4, atol=0)
    if knob == "stabilizers":
        for new, old in zip(got, (syn0, syn1)):
            moved = (new != old).any(1)
            assert moved.any() and float(new[moved].norm(dim=1).max()) <= 5.0 * (1 + 1e-5)


# -- bf16 forms --------------------------------------------------------------------------
#
# The bf16 scatter sums each row's updates in f32 and rounds the row once, in the kernel
# and in the plain version; their f32 sums differ only in order, so after the one
# rounding they agree within one bf16 ulp of the row (<= 2^-7 |row|) plus twice the
# recursive-summation bound of the f32 sums.

BF16 = torch.bfloat16


def _bf16_scatter_tol(base, idx, upd, live):
    """Elementwise: 2^-7·|row| + 2·m·2^-24·(|row| + Σ|upd|), m the live updates of the
    row plus one."""
    keep = live != 0
    mag = base.abs().double().index_add_(0, idx[keep], upd[keep].abs().double())
    m = torch.bincount(idx[keep], minlength=base.shape[0]).double()[:, None] + 1
    return 2.0 ** -7 * base.abs().double().maximum(mag) + 2 * m * 2.0 ** -24 * mag


@pytest.mark.cuda
@pytest.mark.parametrize("D", [384, 102])  # 102: the scalar path
@pytest.mark.parametrize("chunk", [tscatter.CHUNK, 1])  # 1: every repeated row shared
def test_bf16_scatter_kernel_matches_plain(cuda, monkeypatch, D, chunk):
    monkeypatch.setattr(tscatter, "CHUNK", chunk)
    base, idx, upd, live = _scatter_draw(cuda, 21, 4096, 20000, D)
    base, upd = base.to(BF16), upd.to(BF16)
    want = tscatter.scatter_add_rows_reference(base.clone(), idx, upd)
    got = _kernel_call(base.clone(), idx, upd, live)
    tol = _bf16_scatter_tol(base, idx, upd, live)
    assert bool(((got.double() - want.double()).abs() <= tol).all())
    untouched = torch.ones(base.shape[0], dtype=torch.bool, device=cuda)
    untouched[idx[live != 0]] = False
    assert torch.equal(got[untouched], base[untouched])
    # this call's stream state (a process that ran earlier card tests holds others)
    state = tscatter._streams[(got.get_device(),
                               torch._C._cuda_getCurrentRawStream(got.get_device()))]
    assert not state.acc.any()  # the accumulator rows come back zeroed


@pytest.mark.cuda
def test_bf16_scatter_kernel_rounds_each_row_once(cuda):
    """1000 updates of bf16(1e-3) to one row of 1.0: the f32 sum 0.99945... added once
    gives 2.0, where rounding after every add would leave the row at 1.0."""
    mat = torch.ones((4, 128), dtype=BF16, device=cuda)
    idx = torch.full((1000,), 2, dtype=torch.int64, device=cuda)
    upd = torch.full((1000, 128), 1e-3, device=cuda).to(BF16)
    got = _kernel_call(mat, idx, upd, torch.ones(1000, device=cuda))
    assert got[2].eq(2.0).all() and got[[0, 1, 3]].eq(1.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(bf16_check.FORMS))
@pytest.mark.parametrize("B,P,D,V", [(8192, 256, 384, 65536), (300, 70, 100, 2048)])
def test_bf16_fused_kernel_matches_plain(cuda, form, B, P, D, V):
    """The kernel's bf16 forms against the plain step with the same dtypes, by
    ``ops/bf16_check.check_form``: the touched rows within 2^-7·|row| (bf16 storage)
    plus 2^-4·Σ|terms|, kernel, plain and float64 each against the others; the update
    rows, kernel against plain, differing in at most 2% of the elements and by more
    than one bf16 ulp in at most 0.2%, while the f32 kernel (the flags cleared) breaks
    that limit; the loss within 1e-2, the pairs equal, one fused launch and two bf16
    scatters (bf16 storage)."""
    syn0, syn1, c, x, mask, neg = _step_inputs(cuda, B + P + D, B, P, D, V, 1.1, 0.35)
    res = bf16_check.check_form(syn0, syn1, c, x, mask, neg, form)
    assert not res["failures"], res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_probe_on_the_card_matches_the_cpu(cuda, dtype):
    """The health probe on the card against its CPU run at V=200,000 (D=384, padding
    rows, a blown-up twentieth of syn0): max and mean within 1e-6 relative, frac_over,
    the p99 bucket and the finite bit equal; one fetch."""
    from glint_word2vec_torch.obs.probe import health_stats, stats_to_channels
    rng = np.random.default_rng(5)
    V, Vp, D = 200_000, 200_008, 384
    mats = [rng.normal(0, s, (Vp, D)).astype(np.float32) for s in (0.05, 0.02)]
    for m in mats:
        m[V:] = 0
    mats[0][rng.choice(V, V // 20, replace=False)] *= 4000.0
    host = [torch.from_numpy(m).to(dtype) for m in mats]
    card = [m.to(cuda) for m in host]
    for thr in (1.0, 100.0):
        want = stats_to_channels(health_stats(host, V, thr))
        got = stats_to_channels(health_stats(card, V, thr))
        assert got["finite"] == want["finite"] is True
        for name in ("syn0", "syn1"):
            for k in ("max_norm", "mean_norm"):
                assert got[name][k] == pytest.approx(want[name][k], rel=1e-6)
            for k in ("frac_over", "p99_norm"):
                assert got[name][k] == want[name][k]


def _runtime_fit(cuda, plan, **knobs):
    """A small shared-pool fit on the card (V=5000, D=64, B=4096, P=128, 16 steps a
    chunk) under a fault plan; returns the trainer and the fused and scatter launch
    counts at its one restore and at its end."""
    from glint_word2vec_torch import Vocabulary
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.train import faults
    from glint_word2vec_torch.train.trainer import Trainer
    rng = np.random.default_rng(2)
    V = 5000
    counts = (1e7 / np.arange(1, V + 1)).astype(np.int64) + 1
    vocab = Vocabulary.from_words_and_counts([f"w{i}" for i in range(V)], counts)
    ids = rng.choice(V, size=200_000, p=counts / counts.sum()).astype(np.int32)
    enc = encode_sentences([[f"w{i}" for i in ids[j:j + 40]]
                            for j in range(0, ids.size, 40)], vocab)
    cfg = Word2VecConfig(vector_size=64, pairs_per_batch=4096, min_count=1,
                         heartbeat_every_steps=16, subsample_ratio=1e-4, seed=3,
                         allow_unstable=True, **knobs)
    tr = Trainer(cfg, vocab, device="cuda")
    assert tr.config.negative_pool == 128
    at_restore = []
    real = tr._restore_snapshot

    def restore():
        at_restore.append((fused_sgns_shared_step.launches,
                           tscatter.scatter_add_rows_.launches))
        return real()

    tr._restore_snapshot = restore
    fused_sgns_shared_step.launches = tscatter.scatter_add_rows_.launches = 0
    faults.configure(**plan)
    try:
        tr.fit(enc)
    finally:
        faults.reset()
    torch.cuda.synchronize()
    assert len(at_restore) == 1
    end = (fused_sgns_shared_step.launches, tscatter.scatter_add_rows_.launches)
    return tr, at_restore[0], end


@pytest.mark.cuda
def test_rollback_fit_on_the_card(cuda):
    """NaN at step 40 under nonfinite_policy="rollback": one rollback, the counter past
    2^22, finite parameters, and the fused kernel launching before and after."""
    tr, before, end = _runtime_fit(cuda, {"nan_at_step": 40},
                                   nonfinite_policy="rollback")
    assert tr.rollbacks_performed == 1 and tr.global_step > 1 << 22
    assert all(bool(torch.isfinite(m).all()) for m in tr.params)
    assert 0 < before[0] < end[0] and end[1] == 0


@pytest.mark.cuda
def test_recovery_fit_on_the_card(cuda):
    """A x1e6 blowup at step 40 under norm_watch="recover": one recovery, lr_scale 0.5,
    max_row_norm engaged at the threshold; the fused kernel before the recovery and
    never after, the scatter kernel (two a step) only after; finite and under the
    threshold at the end."""
    from glint_word2vec_torch.obs.probe import health_stats
    tr, before, end = _runtime_fit(cuda, {"scale_params_at_step": 40},
                                   norm_watch="recover")
    assert tr.recoveries_performed == 1 and tr._lr_scale == 0.5
    assert tr._stabilizers.max_row_norm == tr.config.norm_watch_threshold
    assert before[0] > 0 and end[0] == before[0]
    assert before[1] == 0 and end[1] > 0 and end[1] % 2 == 0
    stats = health_stats(tr.params, tr.vocab.size, 100.0)
    assert stats.finite
    assert max(stats.syn0.max_norm, stats.syn1.max_norm) <= 100.0 * (1 + 1e-5)
