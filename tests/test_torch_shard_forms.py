"""The port's row-sharded step forms beside the shared pool (glint_word2vec_torch/ops/
sgns_shard.py: the per-pair step, CBOW with either pool, duplicate scaling) on gloo
worlds of 2 and 4 ranks on the CPU, against the JAX package's step at the same mesh
shapes (its core jitted with the parameters under ``plan.embedding`` and the batch
under the data sharding, on its host CPU devices) and against the port's own
single-device step.

One world a world size (module-scoped): the 2-rank world runs every form at (1, 2) and
(2, 1), the 4-rank world the per-pair step and shared-pool CBOW at (2, 2). Inputs come
from a seed through numpy (tests/_torch_mesh_worker.form_inputs) and are injected into
both packages; the duplicate-scaling inputs put one row in the slices of two data
shards, so the global count is what is tested.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from _torch_mesh_worker import (
    FORMS, NEG, STAB, assemble, check_world, form_inputs, form_step_args,
    one_torch_thread, spawn_world)
from glint_word2vec_torch.ops import sgns as tsgns
from glint_word2vec_torch.ops.scatter import scatter_add_rows_reference
from glint_word2vec_tpu.ops import sgns as jsgns
from glint_word2vec_tpu.parallel.mesh import make_mesh as j_make_mesh

ALL = list(FORMS)
WORLDS = {2: [(1, 2, ALL), (2, 1, ALL)], 4: [(2, 2, ["pp", "cbow_shared"])]}
CASES = [((nd, nm), name) for cases in WORLDS.values() for nd, nm, names in cases
         for name in names]
ATOL = RTOL = 1e-5  # f32, three steps: the sums run in other orders


@pytest.fixture(autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_forms")
    out = {}
    for world, cases in WORLDS.items():
        res = spawn_world("forms", world, tmp / f"w{world}", {"cases": cases})
        check_world(res)
        for nd, nm, _ in cases:
            out[(nd, nm)] = res
    return out


def _ids(case):
    (nd, nm), name = case
    return f"{nd}x{nm}-{name}"


def _jax_steps(shape, name):
    """Three steps of the JAX core of form ``name``, jitted with the parameters under
    the mesh's row sharding and the batch under its data sharding."""
    nd, nm = shape
    f = FORMS[name]
    inp = form_inputs(21, 3)
    plan = j_make_mesh(nd, nm)
    data = NamedSharding(plan.mesh, PartitionSpec("data"))
    stab = jsgns.Stabilizers(**STAB) if f.get("stab") else None
    dup = bool(f.get("dup"))
    kind = f["kind"]

    def core(params, batch, negatives, alpha):
        c, x, m = batch["centers"], batch["contexts"], batch["mask"]
        if kind == "per_pair":
            return jsgns.sgns_step_core(params, c, x, m, negatives, alpha, "exact",
                                        jnp.float32, dup, stabilizers=stab)
        if kind == "shared":
            return jsgns.sgns_step_shared_core(params, c, x, m, negatives, alpha, NEG,
                                               "exact", jnp.float32, dup,
                                               stabilizers=stab)
        if kind == "cbow_shared":
            return jsgns.cbow_step_shared_core(params, c, x, batch["ctx_mask"], m,
                                               negatives, alpha, NEG, stabilizers=stab)
        return jsgns.cbow_step_core(params, c, x, batch["ctx_mask"], m, negatives, alpha,
                                    "exact", jnp.float32, dup, stabilizers=stab)

    step = jax.jit(core)
    params = jsgns.EmbeddingPair(jax.device_put(jnp.asarray(inp["syn0"]), plan.embedding),
                                 jax.device_put(jnp.asarray(inp["syn1"]), plan.embedding))
    pooled = kind in ("shared", "cbow_shared")
    metrics = []
    for i in range(3):
        batch, negs = form_step_args(name, inp, i, lambda a: a)
        batch = {k: jax.device_put(jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                                               else jnp.float32), data)
                 for k, v in batch.items()}
        negs = jnp.asarray(negs, jnp.int32)
        negs = negs if pooled else jax.device_put(negs, data)
        params, m = step(params, batch, negs, jnp.float32(inp["alpha"]))
        metrics.append([float(m.loss), float(m.mean_f_pos), float(m.pairs)])
    return np.asarray(params.syn0), np.asarray(params.syn1), metrics


def _plain(mat, idx, upd, live):
    keep = torch.nonzero(live != 0).reshape(-1)
    return scatter_add_rows_reference(mat, idx[keep], upd[keep])


def _port_single(name):
    """Three steps of the port's single-device step of form ``name`` on the whole
    batch."""
    f = FORMS[name]
    inp = form_inputs(21, 3)
    stab = tsgns.Stabilizers(**STAB) if f.get("stab") else None
    dup = bool(f.get("dup"))
    p = tsgns.EmbeddingPair(torch.tensor(inp["syn0"]), torch.tensor(inp["syn1"]))
    for i in range(3):
        batch, negs = form_step_args(name, inp, i, torch.as_tensor)
        c, x, m, negs = batch["centers"], batch["contexts"], batch["mask"], \
            torch.as_tensor(negs)
        if f["kind"] == "per_pair":
            tsgns.sgns_step_core(p, c, x, m, negs, inp["alpha"], scatter=_plain,
                                 duplicate_scaling=dup, stabilizers=stab)
        elif f["kind"] == "shared":
            p, _ = tsgns.sgns_step_shared_core(p, c, x, m, negs, inp["alpha"], NEG,
                                               duplicate_scaling=dup, stabilizers=stab)
        elif f["kind"] == "cbow_shared":
            tsgns.cbow_step_shared_core(p, c, x, batch["ctx_mask"], m, negs,
                                        inp["alpha"], NEG, scatter=_plain,
                                        stabilizers=stab)
        else:
            tsgns.cbow_step_core(p, c, x, batch["ctx_mask"], m, negs, inp["alpha"],
                                 scatter=_plain, duplicate_scaling=dup, stabilizers=stab)
    return p.syn0.numpy(), p.syn1.numpy()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_form_matches_jax_step_on_the_same_mesh(worlds, case):
    """Three steps at the same mesh shape, f32: parameters and metrics within
    atol/rtol 1e-5 of the JAX step's; every data replica of a row block holds the same
    bits."""
    (nd, nm), name = case
    res = worlds[(nd, nm)]
    tag = f"{nd}x{nm}/{name}"
    j0, j1, jm = _jax_steps((nd, nm), name)
    np.testing.assert_allclose(assemble(res, f"{tag}/syn0", nm), j0, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(assemble(res, f"{tag}/syn1", nm), j1, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(res[0]["meta"][f"{tag}/metrics"], jm, atol=ATOL, rtol=RTOL)
    for r in range(nm, nd * nm):
        for m in ("syn0", "syn1"):
            assert np.array_equal(res[r]["arrays"][f"{tag}/{m}"],
                                  res[r % nm]["arrays"][f"{tag}/{m}"])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_form_matches_single_device_step(worlds, case):
    """The same three steps against the port's single-device step on the whole batch,
    atol/rtol 1e-5, and the collective schedule of a synchronous step: one model-axis
    all_reduce when the model axis is split, two data-axis all_gathers (the index
    list, the payload) and one data-axis all_reduce (the metrics) when the data axis
    is."""
    (nd, nm), name = case
    res = worlds[(nd, nm)]
    tag = f"{nd}x{nm}/{name}"
    s0, s1 = _port_single(name)
    np.testing.assert_allclose(assemble(res, f"{tag}/syn0", nm), s0, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(assemble(res, f"{tag}/syn1", nm), s1, atol=ATOL, rtol=RTOL)
    want = {}
    if nm > 1:
        want["all_reduce/model"] = 3
    if nd > 1:
        want.update({"all_gather/data": 6, "all_reduce/data": 3})
    for r in res:
        assert r["meta"][f"{tag}/counts"] == want


def test_duplicate_inputs_span_data_shards():
    """The duplicate-scaling inputs hold one live center, context, negative and CBOW
    context row in both data shards' slices of every step (the data axis of 2 that
    the forms run)."""
    inp = form_inputs(21, 3)
    bl = inp["centers"].shape[1] // 2
    for i in range(3):
        for key, row in (("centers", 7), ("contexts", 9)):
            a = inp[key][i]
            assert (a[:bl] == row).any() and (a[bl:] == row).any()
        n = inp["negatives"][i, ..., 0]
        assert (n[:bl] == 11).any() and (n[bl:] == 11).any()
        c = inp["cbow_contexts"][i, :, 0] * (inp["ctx_mask"][i, :, 0] > 0)
        assert (c[:bl] == 13).any() and (c[bl:] == 13).any()
        assert inp["mask"][i, 0] == inp["mask"][i, -1] == 1.0
