"""The port's mesh feeds beside the host pair feed (glint_word2vec_torch/train/
trainer.py): the sharded token-block feed of ``device_pairgen`` and banded CBOW, with
its rounds staged one ahead or not and its per-segment elastic resume, and the
sharded-input CBOW host feed, on a gloo world of two ranks on the CPU.

The JAX package's claim for its own sharded token feed (tests/test_multiprocess.py) is
that its rounds are the single-process device feed's on the same mesh, bit for bit.
Here the port's rounds at (2, 1) and (1, 2) are held to the JAX single-process
device-feed Trainer on ``make_mesh(nd, nm)`` over the host CPU devices: the assembled
token rows, their alphas, the step count and the trained-example count bit for bit,
the parameters within 1e-5.

One world (module-scoped) runs every fit; the refusals need none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import (
    BANDED_KNOBS, FIT_KNOBS, TOKEN_CKPT_EVERY, TOKEN_KNOBS, _resume_recorded,
    check_world, fit_corpus, fit_params, one_torch_thread, spawn_world)
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.ops.sampler import build_alias_table, sample_negatives_hash
from glint_word2vec_torch.ops.sgns import EmbeddingPair as TPair, cbow_step_shared_core
from glint_word2vec_torch.parallel.mesh import MeshPlan
from glint_word2vec_torch.train.checkpoint import TrainState
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data.pipeline import (
    encode_sentences as j_encode, epoch_batches_cbow as j_epoch_batches_cbow,
    expected_kept_words as j_kept)
from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair, alpha_schedule as j_alpha
from glint_word2vec_tpu.parallel.mesh import make_mesh as j_make_mesh
from glint_word2vec_tpu.train.trainer import Trainer as JTrainer

MESHES = [(2, 1), (1, 2)]
FORMS = {"pairgen": TOKEN_KNOBS, "banded": BANDED_KNOBS}
K, B = FIT_KNOBS["steps_per_dispatch"], FIT_KNOBS["pairs_per_batch"]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tokens")
    res = spawn_world("tokens", 2, tmp, {"dir": str(tmp)})
    check_world(res)
    return res, tmp


def _rounds(res, name: str, rank: int = 0) -> list:
    a, meta = res[rank]["arrays"], res[rank]["meta"]
    keys = sorted({k.split("/rounds/")[1] for k in a if k.startswith(f"{name}/rounds/")})
    return [dict({k: a[f"{name}/rounds/{k}"][i] for k in keys}, real=r)
            for i, r in enumerate(meta[f"{name}/rounds/real"])]


def _full(res, key: str, nm: int) -> np.ndarray:
    return np.concatenate([res[r]["arrays"][key] for r in range(nm)])


def _jax_device_feed(shape, knobs):
    """The JAX single-process device-feed fit on ``make_mesh(*shape)``: its trainer
    and every dispatched round (the stacked token arrays, the alphas and valid counts
    of its meta, the real steps)."""
    sents = fit_corpus()
    vocab = j_build_vocab(sents, 1)
    jt = JTrainer(JConfig(**knobs), vocab,
                  params=JPair(*(jnp.asarray(m) for m in fit_params(vocab.size))),
                  plan=j_make_mesh(*shape))
    rounds = []
    dispatch = jt._dispatch_step_fn

    def recording(real):
        fn = dispatch(real)

        def call(params, stacked, meta, *rest):
            meta_np = np.asarray(meta)
            rounds.append(dict({k: np.asarray(v) for k, v in stacked.items()},
                               alphas=meta_np[0], nvalid=meta_np[1:].T, real=real))
            return fn(params, stacked, meta, *rest)
        return call

    jt._dispatch_step_fn = recording
    jt.fit(j_encode(sents, vocab, 1000))
    return jt, rounds


def _assert_token_rounds_equal(got: list, want: list) -> None:
    """Rounds of the token feed, bit for bit over each round's real rows: tokens,
    start bits, valid counts, ordinal bases (the JAX package's uint32 view) and
    alphas (a round of either package, or of the port's one-process feed)."""
    assert [g["real"] for g in got] == [w["real"] for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        n = g["real"]
        assert np.array_equal(g["tokens"][:n].astype(np.int64),
                              w["tokens"][:n].astype(np.int64)), i
        assert np.array_equal(g["starts"][:n], w["starts"][:n]), i
        assert np.array_equal(g["nvalid"][:n].astype(np.float32), w["nvalid"][:n]), i
        wo = w["obase"][:n]
        wo = wo.view(np.uint32) if wo.dtype == np.int32 else wo
        assert np.array_equal(g["obase"][:n], wo.astype(np.int64)), i
        assert np.array_equal(g["alphas"][:n], w["alphas"][:n]), i


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_token_feed_is_the_jax_single_process_device_feed(world, shape, form):
    """The mesh fit's rounds equal the JAX single-process device feed's on the same
    mesh bit for bit (every rank assembles the same), its step count and trained
    pairs (banded: examples) equal the JAX trainer's, and its parameters lie within
    1e-5 of the JAX fit's; the data replicas of a row block hold the same bits."""
    res, _ = world
    nd, nm = shape
    name = f"{nd}x{nm}/{form}"
    jt, want = _jax_device_feed(shape, FORMS[form])
    got = _rounds(res, name)
    _assert_token_rounds_equal(got, want)
    for r in range(1, nd * nm):
        _assert_token_rounds_equal(_rounds(res, name, r), want)
    meta = res[0]["meta"]
    assert meta[f"{name}/global_step"] == jt.global_step
    assert meta[f"{name}/pairs_trained"] == jt.pairs_trained > 0
    V, D = jt.vocab.size, FIT_KNOBS["vector_size"]
    for m in ("syn0", "syn1"):
        got_m = _full(res, f"{name}/{m}", nm)[:V, :D]
        np.testing.assert_allclose(got_m, np.asarray(getattr(jt.params, m))[:V, :D],
                                   atol=ATOL, rtol=0)
        for r in range(nm, nd * nm):
            assert np.array_equal(res[r]["arrays"][f"{name}/{m}"],
                                  res[r % nm]["arrays"][f"{name}/{m}"])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_staged_rounds_give_the_same_bits(world, shape):
    """``sharded_prefetch`` on (the rounds one ahead on a thread, the default) and off
    give the same rounds and the same parameter bits on every rank."""
    res, _ = world
    tag = f"{shape[0]}x{shape[1]}"
    for r in res:
        a = r["arrays"]
        for key in a:
            if key.startswith(f"{tag}/pairgen/"):
                other = key.replace("/pairgen/", "/pairgen_unstaged/")
                assert np.array_equal(a[key], a[other]), key
        assert r["meta"][f"{tag}/pairgen/rounds/real"] == \
            r["meta"][f"{tag}/pairgen_unstaged/rounds/real"]


def _jax_cbow_rounds(num_shards: int) -> list:
    """The JAX ``_fit_sharded`` CBOW rounds over ``num_shards`` shards, assembled
    from its pipeline: each shard's local chunks of K batches (per iteration, the last
    padded), one round a chunk, zeros once a shard is done, the clock from the summed
    word deltas."""
    sents = fit_corpus()
    vocab = j_build_vocab(sents, 1)
    enc = j_encode(sents, vocab, 1000)
    kept = j_kept(vocab.counts, vocab.train_words_count, 0.0)
    b = B // num_shards
    C = 2 * FIT_KNOBS["window"]
    per_shard = []
    for s in range(num_shards):
        chunks = []
        for k in range(1, FIT_KNOBS["num_iterations"] + 1):
            pending, prev = [], 0
            for bt in j_epoch_batches_cbow(enc, vocab, pairs_per_batch=b, window=3,
                                           subsample_ratio=0.0, seed=7, iteration=k,
                                           shard=s, num_shards=num_shards):
                pending.append((bt.centers, bt.contexts, bt.n_ctx, bt.num_real,
                                bt.words_seen - prev))
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
        out = dict(centers=np.zeros((K, B), np.int64),
                   contexts=np.zeros((K, B, C), np.int64), nctx=np.zeros((K, B), np.int64))
        reals = np.zeros((K, num_shards), np.float32)
        deltas = np.zeros(K, np.int64)
        for s, chunks in enumerate(per_shard):
            if r >= len(chunks):
                continue
            for j, (bc, bx, bn, n, d) in enumerate(chunks[r]):
                sl = slice(s * b, (s + 1) * b)
                out["centers"][j, sl], out["contexts"][j, sl], out["nctx"][j, sl] = \
                    bc, bx, bn
                reals[j, s] = n
                deltas[j] += d
        clocks = clock + np.cumsum(deltas)
        clock = float(clocks[-1])
        out.update(reals=reals, real=int((reals > 0).any(axis=1).sum()),
                   alphas=np.asarray([j_alpha(float(w), total, 0.01875, 1e-4)
                                      for w in clocks], np.float32))
        rounds.append(out)
    return rounds


def _replay_cbow(rounds: list) -> TPair:
    """The port's single-process shared-pool CBOW step over the recorded global
    rounds, from the same start parameters, with the trainer's negatives and masks."""
    vocab = t_build_vocab(fit_corpus(), 1)
    table = build_alias_table(vocab.counts, 0.75)
    prob = torch.from_numpy(table.prob)
    alias = torch.from_numpy(table.alias.astype(np.int64))
    p = TPair(*(torch.tensor(m) for m in fit_params(vocab.size)))
    step, P = 0, FIT_KNOBS["negative_pool"]
    C = 2 * FIT_KNOBS["window"]
    for rd in rounds:
        negs = sample_negatives_hash(prob, alias, 7, step + 1, (K, P))
        reals = torch.tensor(rd["reals"]).reshape(K, -1)
        mask = (torch.arange(B // reals.shape[1]) < reals[:, :, None]).to(
            torch.float32).reshape(K, B)
        ctx_mask = (torch.arange(C) < torch.tensor(rd["nctx"]).long()[..., None]).to(
            torch.float32)
        for k in range(rd["real"]):
            cbow_step_shared_core(
                p, torch.tensor(rd["centers"][k]).long(),
                torch.tensor(rd["contexts"][k]).long(), ctx_mask[k], mask[k], negs[k],
                torch.tensor(rd["alphas"][k]), FIT_KNOBS["negatives"])
        step += rd["real"]
    return p


def test_cbow_sharded_input_feed_is_the_jax_feed(world):
    """The sharded-input CBOW fit at (2, 1): every round's grouped centers, contexts,
    context counts, per-segment real counts and alphas equal the JAX ``_fit_sharded``
    CBOW rounds over two shards bit for bit, on every rank; its parameters equal the
    port's single-process CBOW step over the same rounds within 1e-5."""
    res, _ = world
    want = _jax_cbow_rounds(2)
    for rank in range(2):
        got = _rounds(res, "2x1/cbow", rank)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            for key in ("centers", "contexts", "nctx"):
                assert np.array_equal(g[key].astype(np.int64), w[key]), (i, key)
            assert np.array_equal(g["reals"].reshape(K, 2), w["reals"]), i
            assert np.array_equal(g["alphas"], w["alphas"]), i
            assert g["real"] == w["real"]
    assert any((w["reals"] == 0).all(axis=0).any() for w in want)  # uneven streams
    p = _replay_cbow(_rounds(res, "2x1/cbow"))
    np.testing.assert_allclose(res[0]["arrays"]["2x1/cbow/syn0"], p.syn0.numpy(),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(res[0]["arrays"]["2x1/cbow/syn1"], p.syn1.numpy(),
                               atol=ATOL, rtol=ATOL)


def _assert_resumed(res, got: list, syn0, syn1) -> None:
    """A resume's rounds are the uninterrupted (2, 1) fit's after the checkpoint's
    round, bit for bit, and its parameters end within 1e-5 of that fit's."""
    full = _rounds(res, "2x1/pairgen")
    done = TOKEN_CKPT_EVERY // K
    _assert_token_rounds_equal(got, full[done:])
    V, D = syn0.shape
    np.testing.assert_allclose(syn0, res[0]["arrays"]["2x1/pairgen/syn0"][:V, :D],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(syn1, res[0]["arrays"]["2x1/pairgen/syn1"][:V, :D],
                               atol=ATOL, rtol=0)


def test_token_checkpoint_resumes_on_two_ranks(world):
    """A (2, 1) ``device_pairgen`` fit stopped at its first checkpoint (mid-iteration,
    per-segment positions) resumes on the same two ranks to the uninterrupted fit's
    rounds."""
    res, _ = world
    assert res[0]["meta"]["2x1/stopped/stopped_at"] == TOKEN_CKPT_EVERY
    _assert_resumed(res, _rounds(res, "2x1/resumed"), res[0]["arrays"]["2x1/resumed/syn0"],
                    res[0]["arrays"]["2x1/resumed/syn1"])


def test_token_checkpoint_resumes_on_one_process(world):
    """The same checkpoint resumes on one process: the one-device token feed takes the
    checkpoint's two segments and fast-forwards each, and ends on the uninterrupted
    2-rank fit's rounds."""
    res, tmp = world
    rounds: list = []
    m = _resume_recorded(str(tmp / "ck_tok_stopped"), None, rounds)
    for r in rounds:
        assert r["tokens"].shape[1] == 2  # the checkpoint's two data segments
    _assert_resumed(res, rounds, m.syn0.numpy(), m.syn1.numpy())


# -- refusals ---------------------------------------------------------------------------


def _vocab():
    return t_build_vocab(fit_corpus(), 1)


def test_hot_rows_is_refused_as_the_jax_trainer_does():
    """hot_rows on a plan of several devices: the JAX trainer's ValueError and
    message, naming the plan's device count."""
    with pytest.raises(ValueError, match=r"hot_rows is the single-chip step "
                                         r"restructuring \(PERF\.md §11\) and the mesh "
                                         r"plan has 2 devices"):
        TTrainer(TConfig(pairs_per_batch=8192, hot_rows=8), _vocab(), device="cpu",
                 plan=MeshPlan(2, 1))


@pytest.mark.parametrize("kw", [dict(device_pairgen=True),
                                dict(cbow=True, cbow_update="banded")],
                         ids=["pairgen", "banded"])
def test_replicated_token_feed_is_refused_on_a_mesh(kw):
    """The token feeds need each rank to pack its own segment (the JAX trainer's
    refusal of shard_input=False with several processes)."""
    with pytest.raises(ValueError, match="requires shard_input=True"):
        TTrainer(TConfig(pairs_per_batch=128, shard_input=False, negative_pool=16,
                         min_count=1, **kw), _vocab(), device="cpu", plan=MeshPlan(2, 1))


@pytest.mark.parametrize("state,match", [
    (TrainState(iteration=1, words_processed=5, global_step=4, batches_done=0,
                shard_progress=[[1, 2], [1, 2], [1, 2]], shard_feed="tokens"),
     "has 3 entries but the mesh data degree is 2"),
    (TrainState(iteration=1, words_processed=5, global_step=4, batches_done=0,
                shard_progress=[[1, 2], [1, 2]], shard_feed="pairs"),
     "indexes the host-feed pair streams"),
], ids=["segments", "pairs"])
def test_token_resume_mismatches_are_refused(state, match):
    """A mesh token feed refuses a checkpoint of another data axis or of the pair
    feed, with the JAX trainer's messages."""
    t = TTrainer(TConfig(**TOKEN_KNOBS), _vocab(), train_state=state, device="cpu",
                 plan=MeshPlan(2, 1))
    with pytest.raises(ValueError, match=match):
        t._check_resume_position()


def test_one_process_resume_takes_the_checkpoint_segments():
    """On one device a per-segment token checkpoint sets the feed's segments (and the
    token slots a segment block holds) to the checkpoint's; a step-row checkpoint
    keeps one."""
    st = TrainState(iteration=1, words_processed=5, global_step=4, batches_done=0,
                    shard_progress=[[1, 2], [1, 3]], shard_feed="tokens")
    t = TTrainer(TConfig(**TOKEN_KNOBS), _vocab(), train_state=st, device="cpu")
    one = TTrainer(TConfig(**TOKEN_KNOBS), _vocab(), device="cpu")
    assert (t._token_segments, one._token_segments) == (2, 1)
    assert t._tokens_per_step < one._tokens_per_step
    assert t._device_seg_resume_state() == [[1, 2], [1, 3]]
    enc = encode_sentences(fit_corpus(), t.vocab, 1000)
    chunk = next(iter(t._token_chunk_stream(enc, 1e9, 1e6)))
    assert chunk["arrays"]["tokens"].shape[1:] == (2, t._tokens_per_step)
    assert chunk["batches_done"] == 0 and len(chunk["shard_progress"]) == 2
