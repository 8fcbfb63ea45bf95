"""The column layout on a mesh (``embedding_partition="cols"``, the reference's
partial-dot scheme) in the port: the column-sharded step forms of
glint_word2vec_torch/ops/sgns_shard.py on gloo worlds of 2 and 4 ranks on the CPU,
against the JAX package's step at the same mesh shapes (its core jitted with the
parameters under ``plan.embedding_cols`` and the batch under the data sharding, on its
host CPU devices); the trainer's column fit against its rows fit and the JAX Trainer's
column fit; the dense checkpoint a column mesh writes; and the refusals.

One world a world size (module-scoped): the 2-rank world runs every form at (1, 2) and
the column fits, the 4-rank world every form at (2, 2). Inputs come from a seed through
numpy (tests/_torch_mesh_worker) and are injected into both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from _torch_mesh_worker import (
    BAND_WINDOW, COLS_FORMS, FIT_KNOBS, NEG, STAB, bf16_cols_inputs, check_world,
    cols_inputs, cols_step_args, fit_corpus, fit_params, one_torch_thread, spawn_world)
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.parallel.mesh import MeshPlan
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data.pipeline import encode_sentences as j_encode
from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
from glint_word2vec_tpu.ops import cbow_banded as jband
from glint_word2vec_tpu.ops import sgns as jsgns
from glint_word2vec_tpu.parallel.mesh import make_mesh as j_make_mesh

ALL = list(COLS_FORMS)
WORLDS = {2: [(1, 2, ALL)], 4: [(2, 2, ALL)]}
FIT_WORLD = 2  # the world that also runs the column fits (tests/_torch_mesh_worker)
CASES = [((nd, nm), name) for cases in WORLDS.values() for nd, nm, names in cases
         for name in names]
ATOL = RTOL = 1e-5  # f32, three steps: the sums run in other orders


@pytest.fixture(autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cols")
    out = {}
    for world, cases in WORLDS.items():
        res = spawn_world("cols", world, tmp / f"w{world}",
                          {"cases": cases, "fit": world == FIT_WORLD})
        out[("world", world)] = (res, tmp / f"w{world}" / "world-cols")
        check_world(res)
        for nd, nm, _ in cases:
            out[(nd, nm)] = res
    return out


def _ids(case):
    (nd, nm), name = case
    return f"{nd}x{nm}-{name}"


def assemble_cols(results: list, key: str, nm: int) -> np.ndarray:
    """The full matrix of ``key`` from the column blocks of data replica 0 (ranks
    0..nm-1, in model order)."""
    return np.concatenate([results[r]["arrays"][key] for r in range(nm)], axis=1)


def _jax_steps(shape, name):
    """Three steps of the JAX core of column form ``name``, jitted with the parameters
    under the mesh's column sharding and the batch under its data sharding."""
    nd, nm = shape
    f = COLS_FORMS[name]
    inp = cols_inputs(name, nd)
    plan = j_make_mesh(nd, nm)
    data = NamedSharding(plan.mesh, PartitionSpec("data"))
    stab = jsgns.Stabilizers(**STAB) if f.get("stab") else None
    dup = bool(f.get("dup"))
    kind = f["kind"]

    def core(params, batch, negatives, alpha):
        if kind == "banded":
            return jband.cbow_step_banded_core(
                params, batch["tokens"], batch["left"], batch["right"], batch["center"],
                batch["token"], negatives, alpha, NEG, BAND_WINDOW, stabilizers=stab)
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
    params = jsgns.EmbeddingPair(
        jax.device_put(jnp.asarray(inp["syn0"]), plan.embedding_cols),
        jax.device_put(jnp.asarray(inp["syn1"]), plan.embedding_cols))
    pooled = kind in ("shared", "cbow_shared", "banded")
    metrics = []
    for i in range(3):
        batch, negs = cols_step_args(name, inp, i, lambda a: a)
        batch = {k: jax.device_put(jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                                               else jnp.float32), data)
                 for k, v in batch.items()}
        negs = jnp.asarray(negs, jnp.int32)
        negs = negs if pooled else jax.device_put(negs, data)
        params, m = step(params, batch, negs, jnp.float32(inp["alpha"]))
        metrics.append([float(m.loss), float(m.mean_f_pos), float(m.pairs)])
    return np.asarray(params.syn0), np.asarray(params.syn1), metrics


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cols_form_matches_jax_step_on_the_same_mesh(worlds, case):
    """Three steps at the same mesh shape, f32: the column blocks put together and the
    metrics within atol/rtol 1e-5 of the JAX step's under ``plan.embedding_cols``;
    every data replica of a column block holds the same bits, and every rank of the
    model axis reports the same metrics."""
    (nd, nm), name = case
    res = worlds[(nd, nm)]
    tag = f"{nd}x{nm}"
    j0, j1, jm = _jax_steps((nd, nm), name)
    got0 = assemble_cols(res, f"{tag}/{name}/syn0", nm)
    got1 = assemble_cols(res, f"{tag}/{name}/syn1", nm)
    assert got0.shape == j0.shape
    np.testing.assert_allclose(got0, j0, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got1, j1, atol=ATOL, rtol=RTOL)
    for r in range(nd * nm):
        np.testing.assert_allclose(res[r]["meta"][f"{tag}/{name}/metrics"], jm,
                                   atol=ATOL, rtol=RTOL)
        for m in ("syn0", "syn1"):
            np.testing.assert_array_equal(res[r]["arrays"][f"{tag}/{name}/{m}"],
                                          res[r % nm]["arrays"][f"{tag}/{name}/{m}"])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cols_form_moves_only_scalars_over_the_model_axis(worlds, case):
    """A column step's model-axis traffic is the partial logits: one all_reduce a step,
    one more for each of ``update_clip`` and ``max_row_norm``; no all_gather crosses
    the model axis. The data axis runs as on rows (the index list and the payload)."""
    (nd, nm), name = case
    counts = worlds[(nd, nm)][0]["meta"][f"{nd}x{nm}/{name}/counts"]
    per_step = 3 if COLS_FORMS[name].get("stab") else 1
    assert counts.get("all_reduce/model") == 3 * per_step
    assert "all_gather/model" not in counts
    if nd > 1:
        assert counts["all_gather/data"] == 6 and counts["all_reduce/data"] == 3


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits), floored at the smallest normal's."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_cols_bf16_step_matches_jax_without_repeated_rows(worlds):
    """bf16 parameters, compute and logits on (1, 2): the partial logits summed over the
    model axis (in f32, rounded once: at two ranks a bf16 add), then the chain. Held to
    the JAX step jitted under ``plan.embedding_cols`` in bf16 on inputs whose rows do
    not repeat, under tests/test_torch_precision.py's rule: within 2 bf16 ulps of the
    value plus 2^-7 of the matrix's largest update, the loss within 1e-2 relative."""
    res, _ = _fit_world(worlds)
    inp = bf16_cols_inputs()
    plan = j_make_mesh(1, 2)
    jb = jnp.bfloat16
    params = jsgns.EmbeddingPair(
        jax.device_put(jnp.asarray(inp["syn0"], jb), plan.embedding_cols),
        jax.device_put(jnp.asarray(inp["syn1"], jb), plan.embedding_cols))
    step = jax.jit(lambda p, c, x, m, pool: jsgns.sgns_step_shared_core(
        p, c, x, m, pool, jnp.float32(inp["alpha"]), NEG, "exact", jb, False, jb, True))
    (j0, j1), jm = step(params, jnp.asarray(inp["centers"], jnp.int32),
                        jnp.asarray(inp["contexts"], jnp.int32), jnp.asarray(inp["mask"]),
                        jnp.asarray(inp["pool"], jnp.int32))
    got0 = assemble_cols(res, "bf16/syn0", 2)
    got1 = assemble_cols(res, "bf16/syn1", 2)
    for got, want, before in ((got0, j0, inp["syn0"]), (got1, j1, inp["syn1"])):
        want = np.asarray(want.astype(jnp.float32), np.float64)
        step_max = np.abs(want - before).max()
        assert step_max > 0
        tol = 2 * _bf16_ulp(want) + 2.0 ** -7 * step_max
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    jl = float(jm.loss)
    for r in range(2):
        assert abs(res[r]["meta"]["bf16/loss"] - jl) <= 1e-2 * abs(jl)


FIT_TOL = dict(rtol=1e-5, atol=1e-7)


def _fit_world(worlds):
    return worlds[("world", FIT_WORLD)]


def test_cols_fit_equals_the_rows_fit(worlds):
    """The trainer's column fit on (1, 2) equals its row fit of the same stream from the
    same parameters at rtol 1e-5, atol 1e-7 (the JAX package's layout-independence
    test); the relaid row blocks are the gathered matrix's rows, bit for bit."""
    res, _ = _fit_world(worlds)
    full0 = res[0]["arrays"]["colsfit/full0"]
    full1 = res[0]["arrays"]["colsfit/full1"]
    rows0 = np.concatenate([res[r]["arrays"]["rowsfit/syn0"] for r in range(2)])
    rows1 = np.concatenate([res[r]["arrays"]["rowsfit/syn1"] for r in range(2)])
    V = full0.shape[0]
    np.testing.assert_allclose(full0, rows0[:V, :full0.shape[1]], **FIT_TOL)
    np.testing.assert_allclose(full1, rows1[:V, :full1.shape[1]], **FIT_TOL)
    assert res[0]["meta"]["colsfit/global_step"] == res[0]["meta"]["rowsfit/global_step"]
    relaid = np.concatenate([res[r]["arrays"]["colsfit/rows0"] for r in range(2)])
    np.testing.assert_array_equal(relaid[:V], full0)
    for r in range(2):
        np.testing.assert_array_equal(res[r]["arrays"]["colsfit/full0"], full0)


def test_cols_fit_matches_the_jax_cols_fit(worlds):
    """The column fit equals the JAX Trainer's column fit on a (1, 2) mesh of its host
    CPU devices, from the injected parameters, at rtol 1e-5, atol 1e-7."""
    from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair
    from glint_word2vec_tpu.train.trainer import Trainer as JTrainer

    res, _ = _fit_world(worlds)
    sents = fit_corpus()
    vocab = j_build_vocab(sents, 1)
    jt = JTrainer(JConfig(**dict(FIT_KNOBS, embedding_partition="cols")), vocab,
                  params=JPair(*(jnp.asarray(m) for m in fit_params(vocab.size))),
                  plan=j_make_mesh(1, 2))
    jt.fit(j_encode(sents, vocab, 1000))
    assert jt.params.syn0.sharding.is_equivalent_to(jt.plan.embedding_cols, 2)
    want = jt.unpadded_params()
    np.testing.assert_allclose(res[0]["arrays"]["colsfit/full0"],
                               np.asarray(want.syn0), **FIT_TOL)
    np.testing.assert_allclose(res[0]["arrays"]["colsfit/full1"],
                               np.asarray(want.syn1), **FIT_TOL)
    assert res[0]["meta"]["colsfit/global_step"] == int(jt.global_step)


def test_cols_checkpoint_is_dense_and_loads_in_jax(worlds):
    """A column mesh saves the dense format (data 0 / model 0 writes the gathered
    columns, bit for bit); the JAX package loads it; resumed onto the column mesh it
    carves each rank's columns and ends as the same row blocks the fit's model
    holds."""
    from glint_word2vec_tpu.train import checkpoint as jckpt

    res, out = _fit_world(worlds)
    ck = str(out / "cols-ck")
    data = jckpt.load_model(ck)
    assert jckpt.load_model_header(ck)["layout"] == "dense"
    np.testing.assert_array_equal(data["syn0"], res[0]["arrays"]["colsfit/full0"])
    np.testing.assert_array_equal(data["syn1"], res[0]["arrays"]["colsfit/full1"])
    assert data["config"].embedding_partition == "cols"
    for r in range(2):
        assert res[r]["meta"]["resume/type"] == "ShardedWord2VecModel"
        np.testing.assert_array_equal(res[r]["arrays"]["resume/rows0"],
                                      res[r]["arrays"]["colsfit/rows0"])
        np.testing.assert_array_equal(res[r]["arrays"]["resume/rows1"],
                                      res[r]["arrays"]["colsfit/rows1"])


def test_cols_estimator_fit_returns_row_blocks(worlds):
    """``Word2Vec(embedding_partition="cols").fit(plan=)`` ends as the JAX estimator's
    does, its model on row blocks: a ``ShardedWord2VecModel`` whose rows are those of
    the estimator's row fit at rtol 1e-5, atol 1e-7."""
    res, _ = _fit_world(worlds)
    for r in range(2):
        assert res[r]["meta"]["est/type"] == "ShardedWord2VecModel"
        got, want = res[r]["arrays"]["est/rows0"], res[r]["arrays"]["est/rowsfit0"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **FIT_TOL)


def test_cols_world_across_hosts_is_refused_as_jax(worlds):
    """A world whose ranks run on two hosts refuses the column layout with the JAX
    trainer's multi-process ValueError and message, on every rank."""
    res, _ = _fit_world(worlds)
    for r in range(2):
        assert res[r]["meta"]["multihost"].startswith(
            "embedding_partition='cols' is experimental and single-host only: "
            "multi-process runs need each process to own whole rows")


def test_cols_config_constructs_and_keeps_the_jax_refusals():
    """``embedding_partition="cols"`` constructs; every refusal that involves it gives
    the JAX config's class and message."""
    from glint_word2vec_torch import config as tconfig

    assert tconfig._UNPORTED == ("use_pallas",)
    assert TConfig(embedding_partition="cols").embedding_partition == "cols"
    for kw in (dict(sharded_checkpoint=True), dict(hot_rows=8),
               dict(step_lowering="shard_map", negative_pool=128),
               dict(step_lowering="shard_map", negative_pool=128, sync_every=2,
                    steps_per_dispatch=2),
               dict(sync_every=2, steps_per_dispatch=2)):
        with pytest.raises(ValueError) as want:
            JConfig(embedding_partition="cols", **kw)
        with pytest.raises(ValueError) as got:
            TConfig(embedding_partition="cols", **kw)
        assert str(got.value) == str(want.value)
    for bad in ("diag", "ROWS"):
        with pytest.raises(ValueError) as want:
            JConfig(embedding_partition=bad)
        with pytest.raises(ValueError) as got:
            TConfig(embedding_partition=bad)
        assert str(got.value) == str(want.value)


def test_cols_trainer_refusals_give_the_jax_messages():
    """The trainer's column refusals: a padded width the model axis does not divide
    (the JAX trainer's message)."""
    from glint_word2vec_tpu.train.trainer import Trainer as JTrainer

    sents = fit_corpus()
    knobs = dict(FIT_KNOBS, vector_size=15, embedding_partition="cols")
    with pytest.raises(ValueError) as want:
        JTrainer(JConfig(**knobs), j_build_vocab(sents, 1), plan=j_make_mesh(1, 2))
    with pytest.raises(ValueError) as got:
        TTrainer(TConfig(**knobs), t_build_vocab(sents, 1), device="cpu",
                 plan=MeshPlan(1, 2))
    assert str(got.value) == str(want.value)
