"""The row scatter-add's plain version and the wrapper's CPU path, against numpy and
against what the TPU probe kernel computes (``tools/pallas_vmem_scatter.py:58``).

The Pallas probe is defined inside that tool's ``main()`` and cannot be imported, so its
function, ``out = zeros([H, D]); out[idx[i]] += x[i]``, is computed here the way the
JAX package writes every such scatter: ``jnp.zeros((H, D)).at[idx].add(x)``.

Tolerance: the f32 sums are compared with the float64 sum within the standard bound
of recursive summation, (m - 1)·2^-24·Σ|x| for a row that takes m updates, computed from
each test's own data. The JAX sum may order the duplicates differently from
``index_add_``, so it is held to the same bound, not to bit equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.ops import scatter as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


EPS32 = 2.0 ** -24


def _probe_draw(H, D, B, seed=0):
    """The probe's draw: default_rng(seed), p ∝ (i + 10)^-1.07 over H rows,
    x ~ N(0, 1)·1e-3."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(H) + 10.0) ** 1.07
    p /= p.sum()
    idx = rng.choice(H, size=B, p=p)
    x = (rng.standard_normal((B, D), np.float32) * 1e-3).astype(np.float32)
    return idx, x


def _f64_and_bound(base, idx, x):
    """The float64 sum of base[idx] += x and the per-test f32 error bound."""
    want = base.astype(np.float64).copy()
    np.add.at(want, idx, x.astype(np.float64))
    mag = np.abs(base).astype(np.float64)
    np.add.at(mag, idx, np.abs(x).astype(np.float64))
    m = np.bincount(idx, minlength=base.shape[0]).max() + 1
    return want, m * EPS32 * mag.max()


@pytest.mark.parametrize("H,D,B", [(2048, 384, 8192), (256, 128, 4096), (64, 100, 1000)])
def test_reference_matches_numpy_and_the_probe(H, D, B):
    idx, x = _probe_draw(H, D, B)
    assert np.bincount(idx).max() > B // 100  # heavy duplicates on the Zipf head
    want, bound = _f64_and_bound(np.zeros((H, D), np.float32), idx, x)
    got = ts.scatter_add_rows_reference(torch.zeros(H, D), torch.from_numpy(idx),
                                        torch.from_numpy(x)).numpy()
    probe = np.asarray(jnp.zeros((H, D), jnp.float32).at[jnp.asarray(idx)].add(
        jnp.asarray(x)))
    assert np.abs(got - want).max() <= bound
    assert np.abs(probe - want).max() <= bound
    np.testing.assert_allclose(got, probe, atol=2 * bound, rtol=0)


def test_wrapper_cpu_path_is_the_reference_in_place():
    rng = np.random.default_rng(1)
    V, D, N = 500, 128, 3000
    base = torch.from_numpy(rng.normal(0, 1, (V, D)).astype(np.float32))
    idx = torch.from_numpy((rng.zipf(1.2, N) - 1) % V)
    upd = torch.from_numpy(rng.normal(0, 0.1, (N, D)).astype(np.float32))
    want = ts.scatter_add_rows_reference(base.clone(), idx, upd)
    got = base.clone()
    before = ts.scatter_add_rows_.launches
    out = ts.scatter_add_rows_(got, idx, upd)
    assert out is got and torch.equal(got, want)
    assert ts.scatter_add_rows_.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("dead_share", [0.1, 0.7])
def test_live_mask_equals_scattering_the_zero_rows(dead_share):
    """Skipping rows with live == 0 is bit-equal to adding their (zero) updates."""
    rng = np.random.default_rng(2)
    V, D, N = 300, 128, 4000
    base = torch.from_numpy(rng.normal(0, 1, (V, D)).astype(np.float32))
    idx = torch.from_numpy((rng.zipf(1.3, N) - 1) % V)
    live = torch.from_numpy((rng.random(N) >= dead_share).astype(np.float32))
    upd = torch.from_numpy(rng.normal(0, 0.1, (N, D)).astype(np.float32)) * live[:, None]
    idx[live == 0] = 0  # padded slots point at the most frequent row
    want = ts.scatter_add_rows_reference(base.clone(), idx, upd)
    got = ts.scatter_add_rows_(base.clone(), idx, upd, live)
    assert torch.equal(got, want)


def test_wrapper_refuses_bad_inputs():
    mat = torch.zeros(10, 8)
    idx = torch.tensor([0, 3, 9])
    upd = torch.ones(3, 8)
    with pytest.raises(TypeError):
        ts.scatter_add_rows_(mat.double(), idx, upd.double())
    with pytest.raises(TypeError):
        ts.scatter_add_rows_(mat, idx.int(), upd)
    with pytest.raises(TypeError):
        ts.scatter_add_rows_(mat, idx, upd, live=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        ts.scatter_add_rows_(mat, idx, upd[:2])
    with pytest.raises(ValueError):
        ts.scatter_add_rows_(mat, idx, torch.ones(3, 7))
    with pytest.raises(ValueError):
        ts.scatter_add_rows_(mat, idx, upd, live=torch.ones(4))
    with pytest.raises(ValueError):
        ts.scatter_add_rows_(mat, idx[None], upd)
    with pytest.raises(ValueError):
        ts.scatter_add_rows_(mat, idx, torch.ones(8, 3).T)  # not contiguous
    with pytest.raises(ValueError):
        ts.scatter_add_rows_(mat, idx.to("meta"), upd)      # another device
    with pytest.raises(ValueError):
        ts.scatter_add_rows_(mat.to("meta"), idx.to("meta"), upd.to("meta"))
    assert not mat.any()  # nothing was written


@pytest.mark.parametrize("bad", [-1, 10, 1 << 40])
def test_out_of_range_index_raises_before_writing(bad):
    mat = torch.zeros(10, 8)
    idx = torch.tensor([0, bad, 9])
    with pytest.raises(IndexError, match="outside"):
        ts.scatter_add_rows_(mat, idx, torch.ones(3, 8))
    assert not mat.any()
    # a dead row is never written, so its index is not checked
    ts.scatter_add_rows_(mat, idx, torch.ones(3, 8), live=torch.tensor([1.0, 0.0, 1.0]))
    assert mat[0].eq(1).all() and mat[9].eq(1).all() and mat[1:9].eq(0).all()
