"""The plain emulation of the fused kernel's tensor-core arithmetic (``ops/tf32.py``):
TF32 rounding as ``cvt.rna.tf32.f32`` does it, the 3xTF32 split product against
float64, and one shared-pool step through that product against the JAX package's step.

Tolerances: the 3xTF32 product stays within 2x the float32 product's own error against
float64 (it drops the small·small term, ~2^-22 relative, and rounds the small parts,
below float32's accumulation error at these depths; measured 1.05-1.13x), while plain
1xTF32 lands >= 100x away (measured ~900x). The step is held to the existing f32
tolerance of ``test_torch_sgns.py`` (atol 1e-5, loss rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import interop
from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_torch.ops.tf32 import matmul_3xtf32, round_tf32, split_tf32
from glint_word2vec_tpu.ops import sgns as jsgns


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


ATOL = 1e-5
LOSS_RTOL = 1e-5
N_NEG = 5


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.int32)).view(torch.float32)


def test_round_tf32_keeps_representable_values():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 10000, dtype=np.uint64).astype(np.uint32)
    bits &= np.uint32(0xFFFFE000)                      # 10 explicit mantissa bits
    bits = bits[(bits & 0x7F800000) != 0x7F800000]     # finite only
    x = _f32(bits)
    assert torch.equal(round_tf32(x).view(torch.int32), x.view(torch.int32))


def test_round_tf32_rounds_to_nearest_ties_away():
    u = 2.0 ** -10                                     # TF32 ulp at 1
    x = torch.tensor([1 + u / 2, 1 + 3 * u / 2, -(1 + u / 2), -(1 + 3 * u / 2),
                      1 + u / 2 - 2 ** -23, 1 + u / 2 + 2 ** -23, 2 - u / 2],
                     dtype=torch.float32)
    want = torch.tensor([1 + u, 1 + 2 * u, -(1 + u), -(1 + 2 * u), 1.0, 1 + u, 2.0],
                        dtype=torch.float32)
    assert torch.equal(round_tf32(x), want)


def test_round_tf32_keeps_zeros_and_infinities():
    x = torch.tensor([0.0, -0.0, float("inf"), float("-inf")], dtype=torch.float32)
    got = round_tf32(x)
    assert torch.equal(got.view(torch.int32), x.view(torch.int32))  # signs of zero too
    with pytest.raises(TypeError):
        round_tf32(x.double())


def test_split_is_exact_to_the_dropped_bits():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 3, 4096).astype(np.float32))
    big, small = split_tf32(x)
    assert torch.equal(round_tf32(big), big) and torch.equal(round_tf32(small), small)
    rest = (x.double() - big.double() - small.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("K", [384, 8192])  # E·Zᵀ's depth D, and Gᵀ·E's depth B
def test_matmul_3xtf32_error_is_an_fp32_products(K):
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.normal(0, 1, (64, K)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (K, 48)).astype(np.float32))
    ref = a.double() @ b.double()
    err_fp32 = float((a @ b - ref).abs().max())
    err_3x = float((matmul_3xtf32(a, b).double() - ref).abs().max())
    err_1x = float(((round_tf32(a) @ round_tf32(b)).double() - ref).abs().max())
    assert err_3x <= 2.0 * err_fp32
    assert err_1x >= 100.0 * err_fp32  # why the split exists


def _inputs(seed, Dreal, V=1024, D=128, B=512, P=64, masked=37):
    """As test_torch_sgns: Zipf duplicates, pool entries equal to contexts, a masked
    zero-index tail, params big enough that some logits pass +-6."""
    rng = np.random.default_rng(seed)
    syn0 = np.zeros((V, D), np.float32)
    syn1 = np.zeros((V, D), np.float32)
    syn0[:, :Dreal] = rng.normal(0, 0.5, (V, Dreal))
    syn1[:, :Dreal] = rng.normal(0, 0.5, (V, Dreal))
    centers = (rng.zipf(1.3, B) - 1) % V
    contexts = (rng.zipf(1.3, B) - 1) % V
    negatives = (rng.zipf(1.3, P) - 1) % V
    negatives[:8] = contexts[:8]
    mask = np.ones(B, np.float32)
    mask[-masked:] = 0.0
    centers[-masked:] = 0
    contexts[-masked:] = 0
    return (syn0, syn1, centers.astype(np.int32), contexts.astype(np.int32), mask,
            negatives.astype(np.int32))


@pytest.mark.parametrize("mode", ["exact", "clipped"])
@pytest.mark.parametrize("Dreal", [128, 100])  # 100: lane-padded to 128, zero columns
def test_emulated_3xtf32_step_matches_jax(mode, Dreal):
    syn0, syn1, c, x, m, neg = _inputs(seed=Dreal + 7, Dreal=Dreal)
    jp, jm = jsgns.sgns_step_shared_core(
        jsgns.EmbeddingPair(jnp.asarray(syn0), jnp.asarray(syn1)), jnp.asarray(c),
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(neg), jnp.float32(0.025), N_NEG, mode)
    new, tm = tsgns.sgns_step_shared_core(
        interop.params_from_numpy(syn0, syn1, device="cpu"), torch.from_numpy(c).long(),
        torch.from_numpy(x).long(), torch.from_numpy(m), torch.from_numpy(neg).long(),
        0.025, N_NEG, mode, matmul=matmul_3xtf32)
    np.testing.assert_allclose(new.syn0.numpy(), np.asarray(jp.syn0), atol=ATOL, rtol=0)
    np.testing.assert_allclose(new.syn1.numpy(), np.asarray(jp.syn1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm.mean_f_pos), float(jm.mean_f_pos),
                               rtol=LOSS_RTOL, atol=1e-6)
    assert not new.syn0[:, Dreal:].any() and not new.syn1[:, Dreal:].any()
    assert np.abs(new.syn0.numpy() - syn0).max() > 1e-3  # the step moved the rows
