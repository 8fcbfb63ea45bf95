"""Row-shards checkpoints of a mesh fit (glint_word2vec_torch/train/checkpoint.py
``save_model_sharded`` and ``load_params_into_plan``) on a 2-rank gloo world on the
CPU: cross-loads with the JAX package in both directions, elastic resume 2 -> 1 and
1 -> 2 (the mirror of tests/test_multiprocess.py's shrink and grow drills, on the
replicated feed, whose position means the same at any world size), the same-world
resume of a sharded-input fit from its shard_progress, the estimator's sharded model,
and the three crash points of a save.

One world (module-scoped) runs every case; the JAX-written checkpoint and the
one-process checkpoint it resumes are written before it starts.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh_worker import (
    FIT_KNOBS, REPO, check_world, fit_corpus, fit_params, one_torch_thread,
    run_continual, spawn_world, write_segment)
from glint_word2vec_torch import Word2Vec, Word2VecModel
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.train.checkpoint import load_latest_valid, load_model_header
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.parallel.mesh import make_mesh as j_make_mesh
from glint_word2vec_tpu.train.checkpoint import (
    load_model as j_load_model, load_params_into_plan as j_load_plan,
    save_model_sharded as j_save_sharded)

JV, JD = 50, 16  # the JAX-written checkpoint: 50 words padded to 56 rows over 2 shards
JPV = 56
ATOL = RTOL = 1e-5


def _single_fit(interrupt_dir=None, **knobs):
    """The port's one-process fit of the shared corpus from the injected start
    parameters; with ``interrupt_dir``, stopped right after its first checkpoint
    there (every 12 steps)."""
    sents = fit_corpus()
    vocab = t_build_vocab(sents, 1)
    cfg = TConfig(**dict(FIT_KNOBS, **knobs))
    t = TTrainer(cfg, vocab, params=fit_params(vocab.size), device="cpu",
                 feed_backend="numpy")
    if interrupt_dir is None:
        t.fit(encode_sentences(sents, vocab, 1000))
        return t

    class Stop(Exception):
        pass

    save = t.save_checkpoint

    def save_once(path):
        save(path)
        raise Stop()

    t.save_checkpoint = save_once
    with pytest.raises(Stop):
        t.fit(encode_sentences(sents, vocab, 1000), checkpoint_path=interrupt_dir,
              checkpoint_every_steps=12)
    return t


def _jax_params():
    rng = np.random.default_rng(21)
    out = []
    for scale in (1.0, 0.1):
        m = np.zeros((JPV, JD), np.float32)
        m[:JV] = rng.standard_normal((JV, JD)) * scale
        out.append(m)
    return out


@pytest.fixture(autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    plan = j_make_mesh(1, 2)
    s0, s1 = (jax.device_put(jnp.asarray(m), plan.embedding) for m in _jax_params())
    j_save_sharded(str(d / "ck_jax"), [f"j{i}" for i in range(JV)],
                   np.arange(JV, 0, -1), s0, s1, JConfig(vector_size=JD, min_count=1),
                   vocab_size=JV, vector_size=JD)
    _single_fit(str(d / "ck_e12"), sharded_checkpoint=True)
    res = spawn_world("ckpt", 2, d, {"dir": str(d), "jax_vocab": JV, "jax_dim": JD})
    check_world(res)
    return res, d


@pytest.fixture(scope="module")
def uninterrupted():
    t = _single_fit()
    return t.params.syn0.numpy(), t.params.syn1.numpy()


def _full(res, key):
    return np.concatenate([res[0]["arrays"][key], res[1]["arrays"][key]])


def test_row_shards_checkpoint_loads_bit_for_bit_in_jax(world):
    """The port's 2-rank row-shards save loads bit for bit in the JAX package's
    load_model and in its load_params_into_plan at mesh (1, 2)."""
    res, d = world
    ck = str(d / "ck_full")
    g0, g1 = _full(res, "full/syn0"), _full(res, "full/syn1")
    V = len(load_model_header(ck)["words"])
    m = j_load_model(ck)
    assert np.array_equal(np.asarray(m["syn0"]), g0[:V])
    assert np.array_equal(np.asarray(m["syn1"]), g1[:V])
    j0, j1 = j_load_plan(ck, j_make_mesh(1, 2), g0.shape[0], g0.shape[1], verify=True)
    assert np.array_equal(np.asarray(j0), g0) and np.array_equal(np.asarray(j1), g1)
    names = sorted(os.listdir(os.path.join(ck, "syn0.shards")))
    assert names == [f"rows-{0:010d}-{32:010d}.npy", f"rows-{32:010d}-{64:010d}.npy"]


def test_jax_row_shards_checkpoint_streams_into_the_port_world(world):
    """A row-shards checkpoint the JAX package wrote from mesh (1, 2) streams into the
    port's 2-rank world, each rank reading only its own rows, bit for bit."""
    res, _ = world
    j0, j1 = _jax_params()
    assert res[0]["arrays"]["jax/syn0"].shape == (JPV // 2, JD)
    assert np.array_equal(_full(res, "jax/syn0"), j0)
    assert np.array_equal(_full(res, "jax/syn1"), j1)


def test_elastic_resume_two_to_one(world, uninterrupted):
    """A 2-rank replicated-feed fit stopped at its first checkpoint resumes on one
    process and ends where the uninterrupted one-process fit ends (f32 tolerance)."""
    _, d = world
    ck = str(d / "ck_e21")
    st = load_model_header(ck)["train_state"]
    assert st.batches_done > 0 and st.shard_progress is None and not st.finished
    m = Word2Vec.resume(ck, fit_corpus(), device="cpu")
    V = m.syn0.shape[0]
    np.testing.assert_allclose(m.syn0.numpy(), uninterrupted[0][:V], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(m.syn1.numpy(), uninterrupted[1][:V], atol=ATOL, rtol=RTOL)


def test_elastic_resume_one_to_two(world, uninterrupted):
    """A one-process row-shards checkpoint stopped mid-run resumes on the 2-rank mesh
    (each rank streaming its rows) and ends where the uninterrupted one-process fit
    ends (f32 tolerance)."""
    res, d = world
    assert load_model_header(str(d / "ck_e12"))["layout"] == "row-shards"
    np.testing.assert_allclose(_full(res, "e12/syn0"), uninterrupted[0], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(_full(res, "e12/syn1"), uninterrupted[1], atol=ATOL,
                               rtol=RTOL)


def test_sharded_input_resume_from_shard_progress_is_exact(world):
    """A sharded-input fit stopped at its first checkpoint (which records one stream
    position a rank) resumes in the same world and ends bit for bit where the
    uninterrupted fit ends."""
    res, _ = world
    st = res[0]["meta"]["sp/state"]
    assert st["shard_feed"] == "pairs" and len(st["shard_progress"]) == 2
    assert st["batches_done"] == 0 and not st["finished"]
    assert res[0]["meta"]["sp/format_version"] == 3
    for m in ("syn0", "syn1"):
        assert np.array_equal(_full(res, f"resumed/{m}"), _full(res, f"full/{m}"))


def test_estimator_fit_on_a_mesh(world):
    """Word2Vec(...).fit(plan=...) ends on every rank with a ShardedWord2VecModel:
    its model ops refused by name (A9b), its save a row-shards checkpoint that loads
    on one device, and its explicit gather the same model."""
    res, d = world
    for r in res:
        assert r["meta"]["estimator/type"] == "ShardedWord2VecModel"
        assert "A9b" in r["meta"]["estimator/refused"]
    loaded = Word2VecModel.load(str(d / "ck_est"), device="cpu")
    assert np.array_equal(loaded.syn0.numpy(), res[0]["arrays"]["estimator/syn0"])
    got = loaded.find_synonyms("w1", 3)
    want = res[0]["meta"]["estimator/synonyms"]
    assert [w for w, _ in got] == [w for w, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)
    assert res[1]["meta"]["estimator/synonyms"] == want


def test_continual_runner_on_a_mesh(world, tmp_path):
    """A ContinualRunner on the 2-rank mesh (rank 0 polls, extends and writes; every
    rank fits its rows on the replicated feed) publishes what the one-process runner
    publishes over the same stream: the same vocabulary growth and steps, parameters
    within f32 tolerance."""
    res, _ = world
    write_segment(tmp_path / "stream", "seg-000.txt", 1, 12)
    want = run_continual(tmp_path)
    assert res[0]["meta"]["continual"] == res[1]["meta"]["continual"] == want
    assert want["new_words"] > 0
    from glint_word2vec_torch.train.checkpoint import load_model
    ref = load_model(str(tmp_path / "publish" / "ck"))
    for m in ("syn0", "syn1"):
        np.testing.assert_allclose(res[0]["arrays"][f"continual/{m}"], ref[m],
                                   atol=ATOL, rtol=RTOL)


_CRASH = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[3])
from _torch_mesh_worker import FIT_KNOBS, fit_corpus, fit_params
from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab
from glint_word2vec_torch.train import faults
from glint_word2vec_torch.train.trainer import Trainer
point, ck = sys.argv[1], sys.argv[2]
sents = fit_corpus()
vocab = build_vocab(sents, 1)
cfg = Word2VecConfig(**dict(FIT_KNOBS, num_iterations=1, sharded_checkpoint=True))
t = Trainer(cfg, vocab, params=fit_params(vocab.size), device="cpu",
            feed_backend="numpy")
t.fit(encode_sentences(sents, vocab, 1000), checkpoint_path=ck)
np.save(ck + ".first.npy", t.params.syn0.numpy())
t.params.syn0.add_(1.0)
faults.configure(crash_point=point)
t.save_checkpoint(ck)
print("not killed")
"""


@pytest.mark.parametrize("point", ["save:arrays-written", "save:staged", "save:swap"])
def test_killed_save_leaves_the_previous_checkpoint_loadable(tmp_path, point):
    """A row-shards save killed at each crash point leaves the previous checkpoint: the
    newest valid one in the directory verifies and holds the first save's rows."""
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               GLINT_DISABLE_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", _CRASH, point, ck,
                        str(REPO / "tests")], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "not killed" not in r.stdout, r.stderr[-2000:]
    path = load_latest_valid(str(tmp_path), reclaim=False)
    from glint_word2vec_torch.train.checkpoint import load_model
    got = load_model(path, verify=True)
    first = np.load(ck + ".first.npy")
    assert np.array_equal(got["syn0"], first[:got["syn0"].shape[0]])
