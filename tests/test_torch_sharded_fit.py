"""The port's mesh fit (glint_word2vec_torch/train/trainer.py on a MeshPlan) on gloo
worlds on the CPU: the W-rank feed against the JAX pipeline's W shards, the fit against
the port's single-process step on the same global batches, local SGD's replicas, peer
beacons, one round of each step form beside the shared pool, and the refusals that
remain on a mesh (ROADMAP A9b.2, and the JAX package's own).

Two worlds (module-scoped): four ranks on a (2, 2) mesh run the sharded-input fit, the
replicated-feed fit (``shard_input=False``) and a local-SGD fit, each recording every
round's global chunk, two fits under ``feed_consistency_check`` (one with a diverged
rank) and one round of CBOW, banded CBOW, duplicate scaling, the per-pair step and
``device_pairgen``; two ranks run the beacon drill, in which rank 1 dies.
"""

import numpy as np
import pytest
import torch

from _torch_mesh_worker import (
    FIT_KNOBS, check_world, fit_corpus, fit_params, one_torch_thread, spawn_world)
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.ops.sampler import build_alias_table, sample_negatives_hash
from glint_word2vec_torch.ops.sgns import EmbeddingPair as TPair, sgns_step_shared_core
from glint_word2vec_torch.parallel.mesh import MeshPlan, make_mesh
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data.pipeline import (
    encode_sentences as j_encode, epoch_batches as j_epoch_batches,
    expected_kept_words as j_kept)
from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
from glint_word2vec_tpu.ops.sgns import alpha_schedule as j_alpha

W, NM = 4, 2
K, B = FIT_KNOBS["steps_per_dispatch"], FIT_KNOBS["pairs_per_batch"]
PEER_DEATH_BOUND_S = 10.0  # from rank 1's death to rank 0's PeerDeathError


@pytest.fixture(autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def fit_world(tmp_path_factory):
    res = spawn_world("fit", W, tmp_path_factory.mktemp("fit"))
    check_world(res)
    return res


@pytest.fixture(scope="module")
def beacon_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("beacon")
    return spawn_world("beacon", 2, tmp, {"dir": str(tmp)}, timeout_s=90), tmp


def _jax_rounds(num_shards: int) -> list:
    """The global chunks of the JAX trainer's feed over its pipeline's ``num_shards``
    shards. Sharded (``_fit_sharded``): each shard's local chunks (K batches of
    B/num_shards pairs, per iteration, the last padded), one round a chunk, a zero
    chunk once a shard is done, the word clock from the summed deltas. One shard (the
    replicated feed, ``fit``): the clock is the iteration's base plus the batch's
    words seen."""
    sents = fit_corpus()
    vocab = j_build_vocab(sents, 1)
    enc = j_encode(sents, vocab, 1000)
    kept = j_kept(vocab.counts, vocab.train_words_count, 0.0)
    b = B // num_shards
    per_shard = []
    for s in range(num_shards):
        chunks = []
        for k in range(1, FIT_KNOBS["num_iterations"] + 1):
            pending, prev = [], 0
            for bt in j_epoch_batches(enc, vocab, pairs_per_batch=b, window=3,
                                      subsample_ratio=0.0, seed=7, iteration=k,
                                      shard=s, num_shards=num_shards):
                pending.append((bt.centers, bt.contexts, bt.num_real_pairs,
                                bt.words_seen - prev, (k - 1) * kept + bt.words_seen))
                prev = bt.words_seen
                if len(pending) == K:
                    chunks.append(pending)
                    pending = []
            if pending:
                chunks.append(pending)
        per_shard.append(chunks)
    total = float(FIT_KNOBS["num_iterations"] * kept + 1)
    rounds, clock = [], 0.0
    for r in range(max(len(c) for c in per_shard)):
        c = np.zeros((K, B), np.int64)
        x = np.zeros((K, B), np.int64)
        reals = np.zeros((K, num_shards), np.float32)
        deltas = np.zeros(K, np.int64)
        words = []
        for s, chunks in enumerate(per_shard):
            if r >= len(chunks):
                continue
            for j, (bc, bx, n, d, w) in enumerate(chunks[r]):
                c[j, s * b:(s + 1) * b], x[j, s * b:(s + 1) * b] = bc, bx
                reals[j, s] = n
                deltas[j] += d
                words.append(w)
        clocks = clock + np.cumsum(deltas)
        clock = float(clocks[-1])
        if num_shards == 1:
            clocks = words
        alphas = np.asarray([j_alpha(float(w), total, 0.01875, 1e-4) for w in clocks],
                            np.float32)
        rounds.append(dict(centers=c, contexts=x, reals=reals, alphas=alphas,
                           real=int((reals > 0).any(axis=1).sum())))
    return rounds


def _port_rounds(res, name: str, rank: int = 0) -> list:
    a, meta = res[rank]["arrays"], res[rank]["meta"]
    return [dict(centers=a[f"{name}/rounds/centers"][i],
                 contexts=a[f"{name}/rounds/contexts"][i],
                 reals=a[f"{name}/rounds/reals"][i], alphas=a[f"{name}/rounds/alphas"][i],
                 real=meta[f"{name}/rounds/real"][i])
            for i in range(len(meta[f"{name}/rounds/real"]))]


@pytest.mark.parametrize("name,segments", [("sharded", W), ("replicated", 1)])
def test_feed_is_bit_identical_to_jax_shards(fit_world, name, segments):
    """Every round's global batch (pairs and per-segment real counts) and alphas equal
    the JAX pipeline's: the concatenation of ``epoch_batches(shard=s,
    num_shards=W)``'s segments with ``shard_input``, its one stream without (streams
    of uneven length: the ranks run out at different rounds)."""
    got, want = _port_rounds(fit_world, name), _jax_rounds(segments)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("centers", "contexts"):
            assert np.array_equal(g[key].astype(np.int64), w[key]), (name, i, key)
        assert np.array_equal(g["reals"].reshape(K, segments), w["reals"]), (name, i)
        assert np.array_equal(g["alphas"], w["alphas"]), (name, i)
        assert g["real"] == w["real"]
    if segments > 1:  # the streams end unevenly: a round with a spent segment
        assert any((w["reals"] == 0).all(axis=0).any() for w in want)


@pytest.mark.parametrize("name", ["sharded", "replicated"])
def test_every_rank_assembles_the_same_rounds(fit_world, name):
    ref = fit_world[0]["arrays"]
    for r in range(1, W):
        for key in ("centers", "contexts", "reals", "alphas"):
            assert np.array_equal(fit_world[r]["arrays"][f"{name}/rounds/{key}"],
                                  ref[f"{name}/rounds/{key}"])


def _replay(rounds: list) -> tuple:
    """The port's single-process shared-pool step over the recorded global chunks,
    from the same start parameters, with the trainer's negatives and masks."""
    sents = fit_corpus()
    vocab = t_build_vocab(sents, 1)
    table = build_alias_table(vocab.counts, 0.75)
    prob = torch.from_numpy(table.prob)
    alias = torch.from_numpy(table.alias.astype(np.int64))
    p = TPair(*(torch.tensor(m) for m in fit_params(vocab.size)))
    step = 0
    P = FIT_KNOBS["negative_pool"]
    for rd in rounds:
        negs = sample_negatives_hash(prob, alias, 7, step + 1, (K, P))
        reals = torch.tensor(rd["reals"]).reshape(K, -1)
        pos = torch.arange(B // reals.shape[1])
        mask = (pos < reals[:, :, None]).to(torch.float32).reshape(K, B)
        for k in range(rd["real"]):
            p, _ = sgns_step_shared_core(
                p, torch.tensor(rd["centers"][k]).long(),
                torch.tensor(rd["contexts"][k]).long(), mask[k], negs[k],
                torch.tensor(rd["alphas"][k]), FIT_KNOBS["negatives"])
        step += rd["real"]
    return p, step


@pytest.mark.parametrize("name", ["sharded", "replicated"])
def test_mesh_fit_matches_single_process_step(fit_world, name):
    """The (2, 2) fit's parameters, gathered from data replica 0's row blocks, equal
    the port's single-process step applied to the same global batches from the same
    start, within atol/rtol 1e-5 (f32); its data replicas hold the same bits."""
    p, steps = _replay(_port_rounds(fit_world, name))
    for m, want in (("syn0", p.syn0), ("syn1", p.syn1)):
        got = np.concatenate([fit_world[r]["arrays"][f"{name}/{m}"] for r in range(NM)])
        np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)
        for r in range(NM, W):
            assert np.array_equal(fit_world[r]["arrays"][f"{name}/{m}"],
                                  fit_world[r % NM]["arrays"][f"{name}/{m}"])
    assert fit_world[0]["meta"][f"{name}/global_step"] == steps


def test_local_sgd_fit_ends_merged(fit_world):
    """sync_every=2: every chunk ends on a merge, so the data replicas of each row
    block hold the same bits at the end, and the fit trained as many pairs as the
    synchronous one."""
    for r in range(NM, W):
        for m in ("syn0", "syn1"):
            assert np.array_equal(fit_world[r]["arrays"][f"localsgd/{m}"],
                                  fit_world[r % NM]["arrays"][f"localsgd/{m}"])
    meta = fit_world[0]["meta"]
    assert meta["localsgd/pairs_trained"] == meta["sharded/pairs_trained"]
    assert not np.array_equal(fit_world[0]["arrays"]["localsgd/syn0"],
                              fit_world[0]["arrays"]["sharded/syn0"])


def test_feed_consistency_check_passes_a_consistent_feed(fit_world):
    """feed_consistency_check=True on the sharded feed: one more world allgather a
    dispatched round (the fingerprints), no error, and the same bits as the fit
    without the check."""
    for res in fit_world:
        a, meta = res["arrays"], res["meta"]
        for m in ("syn0", "syn1"):
            assert np.array_equal(a[f"checked/{m}"], a[f"sharded/{m}"])
        assert "checked/error" not in meta
        assert meta["checked/chunks_run"] == meta["sharded/chunks_run"] > 0
        assert meta["checked/world_gathers"] == (meta["sharded/world_gathers"]
                                                 + meta["sharded/chunks_run"])


def test_feed_consistency_check_catches_a_diverged_rank(fit_world):
    """Rank 1's replicated feed differs from its peers' in one alpha of the first
    chunk: every rank raises the SPMD feed divergence error at that round, before it
    runs a step."""
    for res in fit_world:
        meta = res["meta"]
        assert "SPMD feed divergence" in meta["diverged/error"]
        assert meta["diverged/chunks_run"] == 0
        assert meta["diverged/world_gathers"] == 1


def test_peer_death_raises_instead_of_hanging(beacon_world):
    """peer_beacon_s=0.2: rank 1 is killed at the end of the round reaching step 6;
    rank 0 raises PeerDeathError within PEER_DEATH_BOUND_S of the kill."""
    (r0, r1), tmp = beacon_world
    assert r1["rc"] != 0  # killed
    assert r0["rc"] == 0, r0["stderr"][-3000:]
    assert r0["meta"]["error"] == "PeerDeathError", r0["meta"]
    died = float((tmp / "world-beacon" / "died").read_text())
    assert 0 <= r0["meta"]["t_end"] - died < PEER_DEATH_BOUND_S


# -- refusals and the config -------------------------------------------------------------


A9B = [
    dict(cbow=True),
    dict(cbow=True, cbow_update="banded"),
    dict(duplicate_scaling=True),
    dict(negative_pool=0),
    dict(device_pairgen=True),
]
A9B_FORMS = {"cbow": "sharded_cbow_shared", "cbow-cbow_update": "sharded_banded",
             "duplicate_scaling": "sharded_shared", "negative_pool": "sharded_per_pair",
             "device_pairgen": "sharded_shared"}


@pytest.mark.parametrize("kw", A9B, ids=lambda kw: "-".join(kw))
def test_a9b_combinations_are_refused_by_name(fit_world, kw):
    """The combinations the port refused on a mesh until the rest of ROADMAP A9b.1 and
    A9b.3 landed are refused by no name now: the config that names a mesh
    constructs, the Trainer on a plan picks the row-sharded twin of the step the JAX
    trainer selects, and the (2, 2) world trained one round of each (finite
    parameters that moved, the same bits on every data replica)."""
    TConfig(pairs_per_batch=8192, num_model_shards=2, **kw)
    vocab = t_build_vocab(fit_corpus(), 1)
    t = TTrainer(TConfig(pairs_per_batch=8192, **kw), vocab, device="cpu",
                 plan=MeshPlan(2, 1))
    name = "-".join(kw)
    assert t._step_form() == A9B_FORMS[name]
    start = fit_params(vocab.size)
    for r, res in enumerate(fit_world):
        meta, a = res["meta"], res["arrays"]
        assert meta[f"a9b/{name}/stopped_at"] == K
        for i, m in enumerate(("syn0", "syn1")):
            got = a[f"a9b/{name}/{m}"]
            assert np.isfinite(got).all()
            lo = (r % NM) * got.shape[0]
            assert not np.array_equal(got[:, :start[i].shape[1]],
                                      start[i][lo:lo + got.shape[0]])
            assert np.array_equal(got, fit_world[r % NM]["arrays"][f"a9b/{name}/{m}"])


def test_hot_rows_and_cols_are_refused_on_a_mesh():
    """hot_rows on a plan of several ranks raises the JAX trainer's ValueError and
    message. The column layout is ported: on a (1, 2) plan the trainer holds this
    rank's column blocks [Vp, Dp / 2] of both matrices and runs the column-sharded
    shared-pool step; with hot_rows it raises the JAX config's refusal."""
    vocab = t_build_vocab(fit_corpus(), 1)
    with pytest.raises(ValueError, match="hot_rows is the single-chip step "
                                         "restructuring"):
        TTrainer(TConfig(pairs_per_batch=8192, hot_rows=8), vocab, device="cpu",
                 plan=MeshPlan(1, 2))
    with pytest.raises(ValueError, match="hot_rows requires the rows layout"):
        TConfig(embedding_partition="cols", hot_rows=8)
    start = fit_params(vocab.size)
    t = TTrainer(TConfig(**dict(FIT_KNOBS, embedding_partition="cols")), vocab,
                 params=start, device="cpu", plan=MeshPlan(1, 2, rank=1))
    assert t._step_form() == "sharded_shared" and t._cols
    assert tuple(t.params.syn0.shape) == (t.padded_vocab, t.padded_dim // 2)
    np.testing.assert_array_equal(t.params.syn0[:vocab.size].numpy(),
                                  start[0][:, t.padded_dim // 2:])


@pytest.mark.parametrize("kw", [dict(num_model_shards=2), dict(num_data_shards=4),
                                dict(mesh_shape=(2, 2))])
def test_world_mesh_mismatch_raises(kw):
    """A mesh larger than the world raises, naming both sizes: one rank is one device,
    and there is no fallback to fewer devices (the JAX Trainer drops to 1x1)."""
    vocab = t_build_vocab(fit_corpus(), 1)
    cfg = TConfig(pairs_per_batch=8192, **kw)
    with pytest.raises(ValueError, match=r"needs \d ranks.*this world has 1"):
        TTrainer(cfg, vocab, device="cpu")
    with pytest.raises(ValueError, match="this world has 1"):
        make_mesh(*cfg.mesh_size)


MESH_CONFIGS = [
    dict(step_lowering="shard_map", cbow=True),
    dict(step_lowering="shard_map", duplicate_scaling=True),
    dict(step_lowering="shard_map", negative_pool=0),
    dict(step_lowering="shard_map", embedding_partition="cols"),
    dict(step_lowering="pjit"),
    dict(sync_every=2),
    dict(sync_every=0),
    dict(sync_every=3, step_lowering="shard_map"),
    dict(sync_every=2, step_lowering="shard_map", device_pairgen=True),
    dict(embedding_partition="cols", sharded_checkpoint=True),
    dict(num_data_shards=0),
    dict(peer_beacon_s=-1.0),
]


@pytest.mark.parametrize("kw", MESH_CONFIGS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_mesh_config_refusals_give_the_jax_messages(kw):
    """The step_lowering and sync_every selection matrices and their neighbours raise
    the JAX config's class and message for the same inputs."""
    with pytest.raises(ValueError) as je:
        JConfig(pairs_per_batch=8192, **kw)
    with pytest.raises(ValueError) as te:
        TConfig(pairs_per_batch=8192, **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(num_model_shards=2), dict(num_data_shards=2, step_lowering="shard_map",
                                   sync_every=4),
    dict(mesh_shape=(2, 2), sharded_checkpoint=True, peer_beacon_s=5.0),
    dict(pairs_per_batch=256, step_lowering="shard_map", num_data_shards=2)],
    ids=["model", "localsgd", "mesh", "small-batch"])
def test_mesh_configs_resolve_as_jax(kw):
    """The lifted knobs are accepted and resolve (the AUTO pool among them) as the JAX
    config does; to_dict round-trips through both packages."""
    kw = dict(dict(pairs_per_batch=8192), **kw)
    t, j = TConfig(**kw), JConfig(**kw)
    assert t.negative_pool == j.negative_pool
    assert t.to_dict() == j.to_dict()
    assert TConfig.from_dict(j.to_dict(auto_markers=False)).to_dict() == \
        JConfig.from_dict(j.to_dict(auto_markers=False)).to_dict()
