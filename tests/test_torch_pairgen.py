"""The port's device pair generator (glint_word2vec_torch/ops/pairgen.py) against the
JAX package's (glint_word2vec_tpu/ops/pairgen.py) on the same numpy inputs: every
output (centers, contexts, mask, kept_words, dropped_pairs) bit for bit, in both
subsampling modes and both window shapes, at ordinal bases across 2^32, with overflow
past B, on empty and all-dropped blocks, and for a chunk of K blocks in one call
against the JAX function block by block. Integer streams: no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.data.hashrng import STREAM_SUBSAMPLE, STREAM_WINDOW, stream_base
from glint_word2vec_torch.data.pipeline import _block_pairs, keep_probabilities
from glint_word2vec_torch.ops import pairgen as tpg
from glint_word2vec_tpu.ops import pairgen as jpg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


V = 500
WINDOW = 5
_jfn = jax.jit(jpg.device_block_pairs, static_argnames=(
    "window", "num_pairs", "legacy_asymmetric_window", "presubsampled"))


def _corpus(rng, n_sent, max_len):
    lengths = rng.integers(1, max_len, n_sent).astype(np.int64)
    return rng.integers(0, V, int(lengths.sum())).astype(np.int32), lengths


def _keep(ratio):
    counts = np.maximum(1000 / (np.arange(V) + 2.0), 1.0)
    return keep_probabilities(counts, int(counts.sum()), ratio).astype(np.float32)


def _block(tokens, lengths, T):
    padded = np.zeros(T, np.int32)
    padded[:tokens.shape[0]] = tokens
    return padded, tpg.pack_start_bits(lengths, T)


def _both(padded, bits, n, base, keep, seed, B, legacy=True, presub=False, it=1, sh=0):
    sub = int(stream_base(seed, STREAM_SUBSAMPLE, it, sh))
    win = int(stream_base(seed, STREAM_WINDOW, it, sh))
    j = _jfn(jnp.asarray(padded), jnp.asarray(bits), jnp.int32(n),
             jnp.uint32(base & 0xFFFFFFFF), jnp.uint32(base >> 32),
             jnp.asarray(keep), jnp.uint32(sub), jnp.uint32(win), window=WINDOW,
             num_pairs=B, legacy_asymmetric_window=legacy, presubsampled=presub)
    t = tpg.device_block_pairs(
        torch.from_numpy(padded), torch.from_numpy(bits), n, base & 0xFFFFFFFF,
        base >> 32, torch.from_numpy(keep), sub, win, WINDOW, B,
        legacy_asymmetric_window=legacy, presubsampled=presub)
    return j, t


def _assert_equal(j, t):
    for name in tpg.DevicePairs._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)


@pytest.mark.parametrize("presub", [False, True])
@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("ratio", [0.0, 1e-2])
def test_block_matches_jax(presub, legacy, ratio):
    rng = np.random.default_rng(0)
    tokens, lengths = _corpus(rng, 60, 30)
    padded, bits = _block(tokens, lengths, 1024)
    j, t = _both(padded, bits, tokens.shape[0], 0, _keep(ratio), 7, 4096, legacy, presub,
                 it=2)
    _assert_equal(j, t)
    assert int(t.mask.sum()) > 0 and int(t.dropped_pairs) == 0
    if not presub:
        # and both are the host feed's stream
        hc, hx, _, hkept = _block_pairs(tokens, lengths, _keep(ratio), WINDOW, 7, 2, 0, 0,
                                        legacy)
        n = hc.shape[0]
        np.testing.assert_array_equal(t.centers[:n].numpy(), hc)
        np.testing.assert_array_equal(t.contexts[:n].numpy(), hx)
        assert int(t.kept_words) == hkept


@pytest.mark.parametrize("base", [12_345, (1 << 32) - 5, (1 << 32) - 100, (7 << 32) + 3])
@pytest.mark.parametrize("presub", [False, True])
def test_ordinal_base_across_2_32(base, presub):
    """The (lo, hi) carry: bases just below 2^32 put the wrap inside the block."""
    rng = np.random.default_rng(1)
    tokens, lengths = _corpus(rng, 40, 25)
    padded, bits = _block(tokens, lengths, 1024)
    j, t = _both(padded, bits, tokens.shape[0], base, _keep(1e-2), 3, 4096, presub=presub,
                 sh=2)
    _assert_equal(j, t)


@pytest.mark.parametrize("presub", [False, True])
def test_overflow_past_b(presub):
    rng = np.random.default_rng(2)
    tokens, lengths = _corpus(rng, 50, 30)
    padded, bits = _block(tokens, lengths, 2048)
    j, t = _both(padded, bits, tokens.shape[0], 0, np.ones(V, np.float32), 1, 300,
                 presub=presub)
    _assert_equal(j, t)
    assert int(t.mask.sum()) == 300 and int(t.dropped_pairs) > 0


@pytest.mark.parametrize("presub", [False, True])
def test_empty_and_all_dropped_blocks(presub):
    tokens = np.arange(20, dtype=np.int32) % V
    padded, bits = _block(tokens, np.asarray([10, 10]), 64)
    j, t = _both(padded, bits, 20, 0, np.zeros(V, np.float32), 0, 128, presub=presub)
    _assert_equal(j, t)
    if not presub:
        assert int(t.mask.sum()) == 0 and int(t.kept_words) == 0
    padded, bits = _block(np.empty(0, np.int32), np.empty(0, np.int64), 64)
    j, t = _both(padded, bits, 0, 0, np.ones(V, np.float32), 0, 128, presub=presub)
    _assert_equal(j, t)
    assert int(t.mask.sum()) == 0


@pytest.mark.parametrize("presub", [False, True])
def test_chunk_of_blocks_matches_jax_row_by_row(presub):
    """One [K, T] call against K calls of the JAX function: each row is the JAX
    function on that block, with its own n_valid and ordinal base (one block empty,
    one overflowing, one across the 2^32 carry)."""
    rng = np.random.default_rng(5)
    K, T, B = 5, 512, 700
    keep = _keep(1e-2)
    blocks, nvs, bases = [], [], []
    for k in range(K):
        tokens, lengths = _corpus(rng, 30, 20)
        n = min(tokens.shape[0], T)
        if k == 2:
            n = 0
        cut = np.cumsum(lengths)
        lengths = np.diff(np.concatenate([[0], cut[cut < n], [n]]))
        lengths = lengths[lengths > 0]
        blocks.append(_block(tokens[:n], lengths, T))
        nvs.append(n)
        bases.append((1 << 32) - 7 if k == 3 else 1000 * k)
    tokens = torch.from_numpy(np.stack([b[0] for b in blocks]))
    bits = torch.from_numpy(np.stack([b[1] for b in blocks]))
    sub = int(stream_base(4, STREAM_SUBSAMPLE, 1, 0))
    win = int(stream_base(4, STREAM_WINDOW, 1, 0))
    lo = torch.tensor([b & 0xFFFFFFFF for b in bases])
    hi = torch.tensor([b >> 32 for b in bases])
    t = tpg.device_block_pairs(tokens, bits, torch.tensor(nvs), lo, hi,
                               torch.from_numpy(keep), sub, win, WINDOW, B,
                               presubsampled=presub)
    assert t.centers.shape == (K, B) and t.dropped_pairs.shape == (K,)
    for k in range(K):
        j, one = _both(blocks[k][0], blocks[k][1], nvs[k], bases[k], keep, 4, B,
                       presub=presub)
        _assert_equal(j, tpg.DevicePairs(*(x[k] for x in t)))
        _assert_equal(j, one)
    assert int(t.dropped_pairs.max()) > 0 and int(t.mask[2].sum()) == 0


def test_hash_helpers_match_jax():
    rng = np.random.default_rng(6)
    lo = rng.integers(0, 1 << 32, 257, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, 257, dtype=np.uint64).astype(np.uint32)
    base = 0x9E3779B9
    tl, th = torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64))
    jl, jh = jnp.asarray(lo), jnp.asarray(hi)
    np.testing.assert_array_equal(tpg.hash_bits_at(base, tl, th).numpy(),
                                  np.asarray(jpg.hash_bits_at(jnp.uint32(base), jl, jh)))
    np.testing.assert_array_equal(tpg.hash_u01_at(base, tl, th).numpy(),
                                  np.asarray(jpg.hash_u01_at(jnp.uint32(base), jl, jh)))
    np.testing.assert_array_equal(tpg.hash_mod_at(base, tl, th, 7).numpy(),
                                  np.asarray(jpg.hash_mod_at(jnp.uint32(base), jl, jh, 7)))


@pytest.mark.parametrize("T", [1, 8, 64, 1000])
def test_pack_start_bits_matches_jax(T):
    rng = np.random.default_rng(T)
    lengths = rng.integers(1, 9, 40)
    np.testing.assert_array_equal(tpg.pack_start_bits(lengths, T),
                                  jpg.pack_start_bits(lengths, T))
