"""The port's row-sharded SGNS step (glint_word2vec_torch/ops/sgns_shard.py) on gloo
worlds of 2 and 4 ranks on the CPU, against the JAX package's explicit shard_map step
(glint_word2vec_tpu/ops/sgns_shard.py) at the same mesh shapes on its host CPU devices,
against the port's own single-device step, and, for the local-SGD window, against a
NumPy float64 oracle.

One world a world size (module-scoped): the 2-rank world runs the (1, 2) and (2, 1)
meshes, the 4-rank world (2, 2), (1, 4) and (4, 1); every case of this file reads their
results. Inputs come from a seed through numpy (tests/_torch_mesh_worker.step_inputs)
and are injected into both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import (
    NEG, STAB, assemble, check_world, one_torch_thread, spawn_world, step_inputs)
from glint_word2vec_torch.ops.sgns import (
    EmbeddingPair as TPair, Stabilizers as TStab, sgns_step_shared_core)
from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair, Stabilizers as JStab
from glint_word2vec_tpu.ops.sgns_shard import make_shard_map_sgns_step
from glint_word2vec_tpu.parallel.mesh import make_mesh as j_make_mesh

# the JAX step's tests hold it to the NumPy oracle of tests/test_stabilizers.py
from test_stabilizers import _np_shared_step

WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4), (4, 1)]}
MESHES = [shape for shapes in WORLDS.values() for shape in shapes]
VARIANTS = {"plain": (None, False), "stab": (STAB, False), "fused": (None, True)}
ATOL = RTOL = 1e-5  # f32, three steps: the sums run in other orders


@pytest.fixture(autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_step")
    out = {}
    for world, shapes in WORLDS.items():
        res = spawn_world("steps", world, tmp / f"w{world}", {"shapes": shapes})
        check_world(res)
        for shape in shapes:
            out[shape] = res
    return out


def _full(res, key, nm):
    return assemble(res, key, nm)


def _jax_steps(shape, variant):
    """Three steps of the JAX shard_map step at ``shape`` on the host CPU devices."""
    nd, nm = shape
    stab, fused = VARIANTS[variant]
    inp = step_inputs(11, nd, 3)
    plan = j_make_mesh(nd, nm)
    params = JPair(jax.device_put(jnp.asarray(inp["syn0"]), plan.embedding),
                   jax.device_put(jnp.asarray(inp["syn1"]), plan.embedding))
    step = jax.jit(make_shard_map_sgns_step(
        plan.mesh, NEG, "exact", jnp.float32, jnp.float32, True,
        stabilizers=JStab(**stab) if stab else None, fused=fused))
    metrics = []
    for i in range(3):
        batch = {"centers": jnp.asarray(inp["centers"][i], jnp.int32),
                 "contexts": jnp.asarray(inp["contexts"][i], jnp.int32),
                 "mask": jnp.asarray(inp["mask"][i])}
        params, m = step(params, batch, jnp.asarray(inp["negatives"][i, :inp["P"]],
                                                    jnp.int32),
                         jnp.float32(inp["alpha"]))
        metrics.append([float(m.loss), float(m.mean_f_pos), float(m.pairs)])
    return np.asarray(params.syn0), np.asarray(params.syn1), metrics


def _port_single(variant, nd):
    """Three steps of the port's single-device shared-pool step on the full batch."""
    stab, fused = VARIANTS[variant]
    inp = step_inputs(11, nd, 3)
    p = TPair(torch.tensor(inp["syn0"]), torch.tensor(inp["syn1"]))
    for i in range(3):
        p, _ = sgns_step_shared_core(
            p, torch.tensor(inp["centers"][i]), torch.tensor(inp["contexts"][i]),
            torch.tensor(inp["mask"][i]), torch.tensor(inp["negatives"][i, :inp["P"]]),
            inp["alpha"], NEG, stabilizers=TStab(**stab) if stab else None, fused=fused)
    return p.syn0.numpy(), p.syn1.numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_jax_shard_map(worlds, shape, variant):
    """Three steps at the same mesh shape, f32: parameters within atol/rtol 1e-5 of the
    JAX shard_map step's, and the metrics too."""
    res, nm = worlds[shape], shape[1]
    tag = f"{shape[0]}x{shape[1]}/{variant}"
    j0, j1, jm = _jax_steps(shape, variant)
    np.testing.assert_allclose(_full(res, f"{tag}/syn0", nm), j0, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_full(res, f"{tag}/syn1", nm), j1, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(res[0]["meta"][f"{tag}/metrics"], jm, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_single_device_step(worlds, shape, variant):
    """The same three steps against the port's sgns_step_shared_core on the whole
    batch, atol/rtol 1e-5; every data replica of a row block holds the same bits."""
    nd, nm = shape
    res = worlds[shape]
    tag = f"{nd}x{nm}/{variant}"
    s0, s1 = _port_single(variant, nd)
    np.testing.assert_allclose(_full(res, f"{tag}/syn0", nm), s0, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_full(res, f"{tag}/syn1", nm), s1, atol=ATOL, rtol=RTOL)
    for r in range(nm, nd * nm):
        for m in ("syn0", "syn1"):
            assert np.array_equal(res[r]["arrays"][f"{tag}/{m}"],
                                  res[r % nm]["arrays"][f"{tag}/{m}"])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sync_every_one_is_the_synchronous_step(worlds, shape):
    """A step built with sync_every=1 gives bit-identical parameters to one built
    without the knob, on every rank."""
    for r in worlds[shape]:
        assert r["meta"][f"{shape[0]}x{shape[1]}/sync1_identical"] is True


@pytest.mark.parametrize("variant", ["plain", "stab"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_window_matches_numpy_oracle_f64(worlds, shape, variant):
    """The two-step local-SGD window in float64 over gloo against the NumPy replay
    (each data shard runs its steps on its batch columns and its pool slice, then the
    replicas' deltas are averaged), at 1e-12; the replicas of each row block are
    bit-identical after the merge."""
    nd, nm = shape
    res = worlds[shape]
    stab = TStab(**STAB) if variant == "stab" else TStab()
    inp = step_inputs(5, nd, 2, dtype=np.float64)
    syn0, syn1 = inp["syn0"].astype(np.float64), inp["syn1"].astype(np.float64)
    B, P = inp["centers"].shape[1], inp["P"]
    bl = B // nd
    locals_ = []
    for j in range(nd):
        s0, s1 = syn0.copy(), syn1.copy()
        cols = slice(j * bl, (j + 1) * bl)
        for i in range(2):
            s0, s1 = _np_shared_step(
                s0, s1, inp["centers"][i, cols], inp["contexts"][i, cols],
                inp["mask"][i, cols].astype(np.float64),
                inp["negatives"][i, j * P:(j + 1) * P], inp["alpha"], NEG, stab)
        locals_.append((s0, s1))
    want0 = syn0 + sum(s0 - syn0 for s0, _ in locals_) / nd
    want1 = syn1 + sum(s1 - syn1 for _, s1 in locals_) / nd
    tag = f"{nd}x{nm}/window_{variant}"
    np.testing.assert_allclose(_full(res, f"{tag}/syn0", nm), want0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(_full(res, f"{tag}/syn1", nm), want1, rtol=0, atol=1e-12)
    for r in range(nm, nd * nm):
        for m in ("syn0", "syn1"):
            assert np.array_equal(res[r]["arrays"][f"{tag}/{m}"],
                                  res[r % nm]["arrays"][f"{tag}/{m}"])
    assert res[0]["meta"][f"{tag}/pairs"] == inp["mask"].sum(axis=1).tolist()


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_collective_schedule(worlds, shape):
    """Each synchronous step: ONE model-axis all_reduce (the row assembly) when the
    model axis is split, and over a split data axis the two all_gathers the JAX
    schedule names (update rows, index list; the mask rides in the index list even
    with the stabilizers on) and the three-scalar metric all_reduce. A window of k
    steps: k assembly all_reduces and, over a split data axis, one merge and one
    metric all_reduce."""
    nd, nm = shape
    for r in worlds[shape]:
        for variant in VARIANTS:
            want = {}
            if nm > 1:
                want["all_reduce/model"] = 3
            if nd > 1:
                want.update({"all_gather/data": 6, "all_reduce/data": 3})
            assert r["meta"][f"{nd}x{nm}/{variant}/counts"] == want, variant
        for variant in ("plain", "stab"):
            want = {}
            if nm > 1:
                want["all_reduce/model"] = 2
            if nd > 1:
                want["all_reduce/data"] = 2  # the merge, then the metrics
            assert r["meta"][f"{nd}x{nm}/window_{variant}/counts"] == want, variant


def test_ranks_sit_row_major(worlds):
    """Rank r is (data r // num_model, model r % num_model), the order in which the
    JAX make_mesh reshapes its devices."""
    for shape in MESHES:
        nd, nm = shape
        for r, res in enumerate(worlds[shape]):
            assert res["meta"][f"{nd}x{nm}/place"] == [r // nm, r % nm]
