"""The port's multi-process scaffolding (glint_word2vec_torch/parallel/distributed.py
and parallel/mesh.py): initialize's resolution order, the world-of-one forms, the
mesh's geometry and carving, and, on a 4-rank gloo world on the CPU, the collective
interface (the round's allgather, local_sgd_delta_merge, broadcast_object, the
barrier and a model-axis group), each call counted by operation and axis.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_mesh_worker import check_world, one_torch_thread, spawn_world
from glint_word2vec_torch.parallel import distributed
from glint_word2vec_torch.parallel.mesh import (
    MeshPlan, Sharding, make_mesh, pad_vocab_for_sharding, shard_batch, shard_params)

W = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    res = spawn_world("dist", W, tmp_path_factory.mktemp("dist"))
    check_world(res)
    return res


@pytest.fixture
def captured(monkeypatch):
    """initialize's call into torch.distributed, captured instead of made."""
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(dict(backend=backend, **kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    for name in ("GLINT_COORDINATOR", "GLINT_NUM_PROCESSES", "GLINT_PROCESS_ID", "RANK",
                 "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    return calls


def test_initialize_without_a_world_is_a_no_op(captured):
    assert distributed.initialize(device="cpu") is False
    assert captured == []
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert not distributed.is_multiprocess()


@pytest.mark.parametrize("how", ["args", "glint", "torchrun", "file"])
def test_initialize_resolution_order(captured, monkeypatch, how):
    """Explicit arguments, then GLINT_COORDINATOR / GLINT_NUM_PROCESSES /
    GLINT_PROCESS_ID, then torchrun's RANK / WORLD_SIZE / MASTER_ADDR; NCCL for a card,
    gloo on the CPU unless named."""
    if how == "args":
        assert distributed.initialize("h0:1234", 4, 2, device="cuda")
        want = dict(backend="nccl", init_method="tcp://h0:1234", world_size=4, rank=2)
    elif how == "glint":
        monkeypatch.setenv("GLINT_COORDINATOR", "h1:99")
        monkeypatch.setenv("GLINT_NUM_PROCESSES", "8")
        monkeypatch.setenv("GLINT_PROCESS_ID", "5")
        monkeypatch.setenv("RANK", "0")  # the GLINT_* variables come first
        distributed.initialize(device="cpu")
        want = dict(backend="gloo", init_method="tcp://h1:99", world_size=8, rank=5)
    elif how == "torchrun":
        for k, v in dict(RANK="3", WORLD_SIZE="4", MASTER_ADDR="h2",
                         MASTER_PORT="7").items():
            monkeypatch.setenv(k, v)
        distributed.initialize(device="cpu", backend="gloo")
        want = dict(backend="gloo", init_method="env://", world_size=4, rank=3)
    else:
        distributed.initialize(init_method="file:///tmp/x", num_processes=2,
                               process_id=1, device="cpu")
        want = dict(backend="gloo", init_method="file:///tmp/x", world_size=2, rank=1)
    (got,) = captured
    assert {k: got[k] for k in want} == want
    assert got["timeout"].total_seconds() == distributed.DEFAULT_TIMEOUT_S


def test_initialize_refuses_a_partial_world(captured):
    with pytest.raises(ValueError, match="world size"):
        distributed.initialize("h0:1", device="cpu")


def test_world_of_one_forms():
    """At a world of one the allgather launches nothing (it stacks the arrays), the
    merge returns its input, and put_global carves nothing."""
    tree = {"a": np.arange(6).reshape(2, 3), "b": np.asarray([7])}
    got = distributed.allgather(tree)
    assert got["a"].shape == (1, 2, 3) and np.array_equal(got["a"][0], tree["a"])
    loc = (torch.ones(3),)
    assert distributed.local_sgd_delta_merge((torch.zeros(3),), loc, None, 1) is loc
    plan = make_mesh(1, 1)
    assert plan.size == 1 and plan.model_group is None
    out = distributed.put_global(plan, {"x": np.arange(4)}, plan.embedding)
    assert torch.equal(out["x"], torch.arange(4))


def test_pack_round_trip():
    tree = {"pairs": np.arange(24, dtype=np.int32).reshape(2, 3, 4),
            "clock": np.asarray([0.5, 1.5]), "alive": np.asarray([1], np.int32)}
    buf, layout = distributed._pack(tree)
    back = distributed._unpack(np.stack([buf, buf]), layout)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k][1], v)


@pytest.mark.parametrize("nd,nm,rank", [(2, 2, 3), (1, 4, 2), (4, 1, 1), (2, 4, 5)])
def test_mesh_geometry_and_carving(nd, nm, rank):
    """Rank r at (r // num_model, r % num_model); its row block of a matrix, its data
    slice of a batch (and of a [K, B] chunk)."""
    plan = MeshPlan(nd, nm, rank)
    d, m = rank // nm, rank % nm
    assert (plan.data_index, plan.model_index) == (d, m)
    vp = pad_vocab_for_sharding(100, nm)
    assert vp % nm == 0 and vp % 8 == 0 and vp >= 100
    lo, hi = plan.rows(vp)
    assert (lo, hi) == (m * vp // nm, (m + 1) * vp // nm)
    mat = np.arange(vp * 3).reshape(vp, 3)
    sh = shard_params((mat, None), plan)
    assert np.array_equal(sh.syn0.numpy(), mat[lo:hi]) and sh.syn1 is None
    b = np.arange(16 * nd)
    assert np.array_equal(shard_batch({"c": b}, plan)["c"], b[d * 16:(d + 1) * 16])
    chunk = np.arange(2 * 8 * nd).reshape(2, 8 * nd)
    assert np.array_equal(plan.carve(chunk, plan.batch_stacked),
                          chunk[:, d * 8:(d + 1) * 8])
    assert plan.carve(mat, Sharding(None)) is mat
    if nm > 1:
        with pytest.raises(ValueError, match="divisible"):
            plan.rows(vp + 1)
    if nd > 1:
        with pytest.raises(ValueError, match="divisible"):
            plan.carve(np.arange(nd * 2 + 1), plan.batch)


@pytest.mark.parametrize("nd,rank", [(2, 1), (4, 2)])
def test_put_global_carves_the_ranks_data_slice(nd, rank):
    """put_global takes this rank's data slice of [K, B] chunks: a numpy array as a
    contiguous host tensor, a torch tensor as a view of it, both equal to carve's."""
    plan = MeshPlan(nd, 2, rank * 2)
    c = np.arange(3 * 8 * nd, dtype=np.int32).reshape(3, 8 * nd)
    m = torch.arange(3 * 8 * nd, dtype=torch.float32).reshape(3, 8 * nd)
    out = distributed.put_global(plan, {"c": c, "m": m}, plan.batch_stacked)
    want = c[:, rank * 8:(rank + 1) * 8]
    assert out["c"].is_contiguous() and np.array_equal(out["c"].numpy(), want)
    assert out["m"].untyped_storage().data_ptr() == m.untyped_storage().data_ptr()
    assert torch.equal(out["m"], torch.from_numpy(want.astype(np.float32)))
    by_name = distributed.put_global(plan, {"c": c}, {"c": plan.replicated},
                                     device="cpu")
    assert np.array_equal(by_name["c"].numpy(), c)


def test_allgather_round_is_one_collective(world):
    """A round's dict (three arrays) travels as one packed allgather; every rank gets
    every rank's arrays in rank order, dtypes kept."""
    for res in world:
        a = res["arrays"]
        assert np.array_equal(a["gather/pairs"],
                              np.stack([np.full((2, 3), r, np.int32) for r in range(W)]))
        assert a["gather/alive"].ravel().tolist() == list(range(W))
        assert a["gather/clock"].dtype == np.float64
        assert a["gather/clock"].ravel().tolist() == [1.5 * r for r in range(W)]


def test_delta_merge_is_the_mean_of_the_deltas_and_identical(world):
    """local <- start + mean of the ranks' deltas, in one all_reduce, the same bits on
    every rank."""
    want0 = np.full(4, np.mean([r + 1 for r in range(W)]))
    want1 = np.full((2, 3), np.mean([r + 2 for r in range(W)]))
    for res in world:
        np.testing.assert_allclose(res["arrays"]["merge/0"], want0, rtol=0, atol=1e-15)
        np.testing.assert_allclose(res["arrays"]["merge/1"], want1, rtol=0, atol=1e-15)
        for k in ("merge/0", "merge/1"):
            assert np.array_equal(res["arrays"][k], world[0]["arrays"][k])


def test_broadcast_barrier_groups_and_counts(world):
    for r, res in enumerate(world):
        m = res["meta"]
        assert m["broadcast"] == {"from": 0}
        assert m["place"] == [r // 2, r % 2]
        assert m["model_sum"] == float(sum(x for x in range(W) if x // 2 == r // 2))
        assert m["counts"] == {"all_gather/world": 1, "all_reduce/world": 1,
                               "broadcast/world": 1, "barrier/world": 1,
                               "all_reduce/model": 1}
        assert m["staged_calls"] == 0  # host tensors: nothing to stage
