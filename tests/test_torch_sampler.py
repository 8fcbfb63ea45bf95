"""The port's alias table and hash-PRNG negatives against the JAX package's:
bit-identical, including the int64 emulation of the uint32 lattice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.data import hashrng as thash
from glint_word2vec_torch.ops import prng as tprng
from glint_word2vec_torch.ops import sampler as ts
from glint_word2vec_tpu.data import hashrng as jhash
from glint_word2vec_tpu.ops import prng as jprng
from glint_word2vec_tpu.ops import sampler as js


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.mark.parametrize("V", [7, 1000, 1 << 18])  # 1 << 18: the partitioned build
def test_alias_table_identical(V):
    rng = np.random.default_rng(V)
    counts = rng.zipf(1.2, V).clip(1, 10 ** 7)
    a = js.build_alias_table(counts, 0.75)
    b = ts.build_alias_table(counts, 0.75)
    np.testing.assert_array_equal(np.asarray(a.prob), b.prob)
    np.testing.assert_array_equal(np.asarray(a.alias), b.alias)


def test_mix32_matches_uint32_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint64),
                        np.array([0, 1, (1 << 32) - 1, 1 << 31], np.uint64)])
    want = jhash.mix32(x.astype(np.uint32))
    got = tprng.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(thash.mix32(x.astype(np.uint32)), want)


@pytest.mark.parametrize("seed", [0, 3, -7, (1 << 40) + 5])
@pytest.mark.parametrize("counter", [0, 17, (1 << 31) + 9])
def test_hash_bits_identical(seed, counter):
    shape = (3, 37)
    want = np.asarray(jprng.hash_bits(np.uint32(seed & 0xFFFFFFFF), 1,
                                      jnp.uint32(counter), shape))
    got = tprng.hash_bits(seed, 1, counter, shape, "cpu")
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 12345, -1, (1 << 63) - 3])
@pytest.mark.parametrize("counter", [0, 17, (1 << 31) + 1])
def test_sample_negatives_hash_identical(seed, counter):
    rng = np.random.default_rng(1)
    counts = rng.zipf(1.3, 5000).clip(1, 10 ** 6)
    table = js.build_alias_table(counts, 0.75)
    shape = (16, 128)  # (steps_per_dispatch, pool) — the trainer's chunk draw
    want = np.asarray(js.sample_negatives_hash(
        table.prob, table.alias, np.uint32(seed & 0xFFFFFFFF), jnp.uint32(counter),
        shape))
    ttab = ts.build_alias_table(counts, 0.75)
    got = ts.sample_negatives_hash(
        torch.from_numpy(ttab.prob), torch.from_numpy(ttab.alias.astype(np.int64)),
        seed, counter, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
