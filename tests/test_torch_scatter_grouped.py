"""The plain emulation of the scatter kernel's grouping (``scatter_add_rows_grouped``:
live slots grouped by row, rows cut into chunks of at most ``chunk`` slots, each chunk
summed from zero, the chunk sums added to the row in chunk order) against
``index_add_``, against the JAX package's ``.at[].add`` (what the TPU probe kernel
``tools/pallas_vmem_scatter.py:58`` computes) and against a float64 sum.

Tolerance: the three fp32 sums order a row's updates differently, so each is held to
the float64 sum, and to the others, within the standard bound of recursive summation,
m·2^-24·max(|target| + Σ|upd|) for rows that take at most m - 1 updates, computed from
each case's own data (``scatter_tol`` of chip_smoke.py). The emulation is also held
bit for bit to a loop that adds the updates in the order its docstring states."""

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
CHUNK = ts.CHUNK
HOT = 5  # the row that takes the m updates of the m=... cases
CASES = {  # name -> updates on row HOT (None: the case's own draw)
    "m=chunk-1": CHUNK - 1, "m=chunk": CHUNK, "m=chunk+1": CHUNK + 1,
    "m=3chunk+1": 3 * CHUNK + 1, "one_row": None, "distinct": None, "live_mask": None}


def _draw(case, D, seed):
    """(base [V, D], idx [N], upd [N, D], live [N] or None) as numpy arrays."""
    rng = np.random.default_rng(seed)
    V, N = 700, 600
    if case == "distinct":
        idx = rng.permutation(V)[:N]
    elif case == "one_row":
        idx = np.full(N, HOT)
    else:  # rows drawn away from HOT, then the case's m slots on HOT, interleaved
        idx = (rng.zipf(1.3, N) - 1) % (V - 10) + 10
        if CASES[case] is not None:
            idx[rng.choice(N, CASES[case], replace=False)] = HOT
    base = rng.normal(0, 0.5, (V, D)).astype(np.float32)
    upd = rng.normal(0, 0.1, (N, D)).astype(np.float32)
    live = None
    if case == "live_mask":
        live = (rng.random(N) > 0.4).astype(np.float32)
        upd *= live[:, None]
        idx[live == 0] = 0  # dead slots point at row 0, as the steps' padding does
    return base, idx.astype(np.int64), upd, live


def _f64_and_bound(base, idx, upd):
    want = base.astype(np.float64).copy()
    np.add.at(want, idx, upd.astype(np.float64))
    mag = np.abs(base).astype(np.float64)
    np.add.at(mag, idx, np.abs(upd).astype(np.float64))
    m = np.bincount(idx, minlength=base.shape[0]).max() + 1
    return want, m * EPS32 * mag.max()


@pytest.mark.parametrize("D", [384, 102])
@pytest.mark.parametrize("case", list(CASES))
def test_grouped_matches_index_add_and_jax(case, D):
    base, idx, upd, live = _draw(case, D, seed=D + len(case))
    if CASES[case] is not None:
        assert np.bincount(idx)[HOT] == CASES[case]
    keep = np.ones(idx.shape[0], bool) if live is None else live != 0
    want, bound = _f64_and_bound(base, idx[keep], upd[keep])
    t = (torch.from_numpy(idx), torch.from_numpy(upd),
         None if live is None else torch.from_numpy(live))
    got = ts.scatter_add_rows_grouped(torch.from_numpy(base.copy()), *t).numpy()
    plain = ts.scatter_add_rows_reference(torch.from_numpy(base.copy()), *t).numpy()
    probe = np.asarray(jnp.asarray(base).at[jnp.asarray(idx)].add(jnp.asarray(upd)))
    for name, x in (("grouped", got), ("index_add_", plain), ("jax", probe)):
        assert np.abs(x - want).max() <= bound, name
    assert np.abs(got - plain).max() <= bound
    assert np.abs(got - probe).max() <= bound
    assert np.abs(got - base).max() > 1e-3  # it did move the rows


def _ordered_loop(base, idx, upd, live, chunk):
    """The emulation's stated order, one fp32 addition at a time in numpy."""
    out = base.copy()
    rows = {}
    for i in range(idx.shape[0]):
        if live is None or live[i] != 0:
            rows.setdefault(int(idx[i]), []).append(i)
    for row, slots in rows.items():
        for c in range(0, len(slots), chunk):
            acc = np.zeros(base.shape[1], np.float32)
            for i in slots[c:c + chunk]:
                acc = acc + upd[i]
            out[row] = out[row] + acc
    return out


@pytest.mark.parametrize("chunk", [1, 3, CHUNK])
def test_grouped_adds_in_the_stated_order(chunk):
    base, idx, upd, live = _draw("live_mask", 40, seed=chunk)
    idx[:50] = HOT  # one row cut into several chunks
    live[:50] = 1.0
    got = ts.scatter_add_rows_grouped(torch.from_numpy(base.copy()), torch.from_numpy(idx),
                                      torch.from_numpy(upd), torch.from_numpy(live), chunk)
    np.testing.assert_array_equal(got.numpy(), _ordered_loop(base, idx, upd, live, chunk))


def test_grouped_checks_only_live_indices():
    mat = torch.zeros(10, 8)
    idx = torch.tensor([0, 12, 9])
    with pytest.raises(IndexError, match="outside"):
        ts.scatter_add_rows_grouped(mat, idx, torch.ones(3, 8))
    assert not mat.any()
    ts.scatter_add_rows_grouped(mat, idx, torch.ones(3, 8), torch.tensor([1.0, 0.0, 1.0]))
    assert mat[0].eq(1).all() and mat[9].eq(1).all() and mat[1:9].eq(0).all()
