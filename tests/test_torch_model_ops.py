"""The model surface after fit, the port against the JAX package on the same matrices:
sentence transforms within 1e-6 (segment sums in f32 in both; the order of the sums
differs), pull/multiply/get_vectors/iter_vectors/to_local, word2vec exports
byte-identical (text and binary, 1 and 4 io_workers), checkpoint writes and loads the
same at any worker count, load_latest with and without reclaim on a directory holding
save debris (the same winner and the same directory afterwards), and stop."""

import os
import shutil

import numpy as np
import pytest

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.vocab import Vocabulary as TVocab
from glint_word2vec_torch.models.word2vec import Word2VecModel as TModel
from glint_word2vec_torch.train import checkpoint as tck
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data.vocab import Vocabulary as JVocab
from glint_word2vec_tpu.models.word2vec import Word2VecModel as JModel
from glint_word2vec_tpu.train import checkpoint as jck


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


MEAN_ATOL = 1e-6


def _data(V=400, D=24, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(V)]
    counts = np.arange(V, 0, -1) * 3
    return (words, counts, rng.normal(0, 1, (V, D)).astype(np.float32),
            rng.normal(0, 1, (V, D)).astype(np.float32))


def _pair(words, counts, syn0, syn1, **knobs):
    knobs = dict(vector_size=syn0.shape[1], pairs_per_batch=8192, **knobs)
    t = TModel(TVocab.from_words_and_counts(words, counts), syn0, syn1,
               config=TConfig(**knobs), device="cpu")
    j = JModel(JVocab.from_words_and_counts(words, counts), syn0, syn1,
               config=JConfig(**knobs))
    return t, j


@pytest.mark.parametrize("batch_size", [10_000, 7, 3])
def test_transform_sentences_matches_jax(batch_size):
    """Ragged sentences with OOV words and empty ones, across batch boundaries."""
    words, counts, syn0, syn1 = _data()
    t, j = _pair(words, counts, syn0, syn1)
    rng = np.random.default_rng(1)
    sents = []
    for i in range(23):
        n = int(rng.integers(0, 12))
        sents.append([f"w{x}" if x < 400 else "oov" for x in rng.integers(0, 450, n)])
    sents[4] = ["oov", "nope"]  # no in-vocabulary word: the zero vector
    got = t.transform_sentences(sents, batch_size=batch_size)
    want = np.asarray(j.transform_sentences(sents, batch_size=batch_size))
    assert got.dtype == np.float32 and got.shape == (23, 24)
    np.testing.assert_allclose(got, want, atol=MEAN_ATOL, rtol=0)
    assert not got[4].any()


def test_pull_multiply_and_exports_match_jax():
    words, counts, syn0, syn1 = _data(seed=2)
    t, j = _pair(words, counts, syn0, syn1)
    idx = [0, 5, 5, 399, 17]
    np.testing.assert_array_equal(t.pull(idx), np.asarray(j.pull(idx)))
    v = np.random.default_rng(3).normal(0, 1, 24).astype(np.float32)
    np.testing.assert_allclose(t.multiply(v), np.asarray(j.multiply(v)), atol=1e-5,
                               rtol=1e-6)
    gv, jv = t.get_vectors(), j.get_vectors()
    assert list(gv) == list(jv)
    for w in ("w0", "w123"):
        np.testing.assert_array_equal(gv[w], jv[w])
    ti, ji = list(t.iter_vectors(batch_size=33)), list(j.iter_vectors(batch_size=33))
    assert [w for w, _ in ti] == [w for w, _ in ji] == words
    np.testing.assert_array_equal(np.stack([x for _, x in ti]),
                                  np.stack([x for _, x in ji]))
    tw, tm = t.to_local()
    jw, jm = j.to_local()
    assert tw == jw
    np.testing.assert_array_equal(tm, np.asarray(jm))
    assert t.find_synonyms_array("w3", 4) == t.find_synonyms("w3", 4)


@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
@pytest.mark.parametrize("workers", [1, 4])
def test_export_is_byte_identical_to_jax(tmp_path, binary, workers):
    """Both packages export one checkpoint to the same bytes, with sub-chunks past
    4096 rows and batches that do not divide V."""
    words, counts, syn0, syn1 = _data(V=9000, D=7, seed=4)
    syn0[3, 2] = np.float32(1e-8)      # reprs of small, large and exact values
    syn0[4, :] = np.float32(0.1)
    syn0[5, 0] = np.float32(-3.4028235e38)
    ck = str(tmp_path / "ck")
    jck.save_model(ck, words, counts, syn0, syn1, JConfig(vector_size=7))
    t = TModel.load(ck, device="cpu")
    j = JModel.load(ck)
    tp, jp = str(tmp_path / "t.vec"), str(tmp_path / "j.vec")
    t.export_word2vec(tp, binary=binary, batch_size=5000, io_workers=workers)
    j.export_word2vec(jp, binary=binary, batch_size=5000, io_workers=1)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    assert got.startswith(b"9000 7\n")


@pytest.mark.parametrize("workers", [1, 4])
def test_checkpoint_io_is_the_same_at_any_worker_count(tmp_path, workers):
    words, counts, syn0, syn1 = _data(V=300, D=16)
    cfg1 = TConfig(vector_size=16, pairs_per_batch=8192)
    cfgw = TConfig(vector_size=16, pairs_per_batch=8192, io_workers=workers)
    tck.save_model(str(tmp_path / "one"), words, counts, syn0, syn1, cfg1)
    tck.save_model(str(tmp_path / "many"), words, counts, syn0, syn1, cfgw)
    m1 = tck.verify_checkpoint(str(tmp_path / "one"), io_workers=workers)
    mw = tck.verify_checkpoint(str(tmp_path / "many"), io_workers=workers)
    assert m1["digests"] == mw["digests"]
    for name in m1["digests"]:
        with open(tmp_path / "one" / name, "rb") as a, \
                open(tmp_path / "many" / name, "rb") as b:
            assert a.read() == b.read()
    data = tck.load_model(str(tmp_path / "many"), io_workers=workers)
    np.testing.assert_array_equal(data["syn0"], syn0)
    np.testing.assert_array_equal(data["syn1"], syn1)
    m = TModel.load(str(tmp_path / "one"), io_workers=workers, device="cpu")
    np.testing.assert_array_equal(m.syn1.numpy(), syn1)


def _debris_dir(root, save):
    """A checkpoint directory after a writer died: a live checkpoint (step 10), a
    newer predecessor renamed aside in a torn swap (step 30, ``.old-*``), an older
    swap leftover (step 5), a corrupt newer one (step 40) and a staging directory."""
    words, counts, syn0, syn1 = _data(V=40, D=8)
    for step, name in ((10, "ck"), (30, "ck2.old-123"), (5, "ck.old-99"), (40, "bad")):
        save(str(root / name), words, counts, syn0 + step, syn1, step)
    with open(root / "bad" / "counts.npy", "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x7f")
    os.makedirs(root / ".ck.tmp-77")
    with open(root / ".ck.tmp-77" / "metadata.json", "w") as f:
        f.write("{}")
    return syn0


def _listing(root):
    return sorted(os.listdir(root))


@pytest.mark.parametrize("reclaim", [False, True])
def test_load_latest_matches_jax(tmp_path, reclaim):
    def tsave(p, w, c, s0, s1, step):
        tck.save_model(p, w, c, s0, s1, TConfig(vector_size=8, pairs_per_batch=8192),
                       tck.TrainState(global_step=step))

    tdir, jdir = tmp_path / "t", tmp_path / "j"
    os.makedirs(tdir)
    syn0 = _debris_dir(tdir, tsave)
    shutil.copytree(tdir, jdir)
    tpath = tck.load_latest_valid(str(tdir), reclaim=reclaim)
    jpath = jck.load_latest_valid(str(jdir), reclaim=reclaim)
    assert os.path.relpath(tpath, tdir) == os.path.relpath(jpath, jdir)
    assert _listing(tdir) == _listing(jdir)
    if reclaim:
        assert os.path.basename(tpath) == "ck2" and ".ck.tmp-77" not in _listing(tdir)
    else:
        assert os.path.basename(tpath) == "ck2.old-123"
        assert ".ck.tmp-77" in _listing(tdir)
    # the model-level entry point
    shutil.rmtree(tdir)
    os.makedirs(tdir)
    _debris_dir(tdir, tsave)
    before = _listing(tdir)
    m = TModel.load_latest(str(tdir), reclaim=reclaim, device="cpu")
    np.testing.assert_array_equal(m.syn0.numpy(), syn0 + 30)
    if not reclaim:
        assert _listing(tdir) == before


def test_stop_releases_and_every_op_raises(tmp_path):
    words, counts, syn0, syn1 = _data(V=50, D=8)
    t, j = _pair(words, counts, syn0, syn1)
    t.stop()
    j.stop()
    t.stop()  # idempotent
    ops = [lambda m: m.transform("w1"), lambda m: list(m.transform_words(["w1"])),
           lambda m: m.transform_sentences([["w1"]]), lambda m: m.pull([1]),
           lambda m: m.multiply(np.ones(8, np.float32)), lambda m: m.norms,
           lambda m: m.find_synonyms("w1", 3), lambda m: m.get_vectors(),
           lambda m: list(m.iter_vectors()), lambda m: m.to_local(),
           lambda m: m.export_word2vec(str(tmp_path / "x.vec")),
           lambda m: m.save(str(tmp_path / "ck")), lambda m: m.syn0]
    for op in ops:
        for m in (t, j):
            with pytest.raises(RuntimeError, match="stopped"):
                op(m)
    assert t.vector_size == 8 and t.num_words == 50


def test_plan_and_ann_are_refused(tmp_path):
    words, counts, syn0, syn1 = _data(V=50, D=8)
    t, _ = _pair(words, counts, syn0, syn1)
    t.save(str(tmp_path / "ck"))
    # load(plan=) and load_latest(plan=) are ported: a plan that is not the port's
    # MeshPlan raises the TypeError a fit raises, and a MeshPlan loads
    with pytest.raises(TypeError, match="MeshPlan"):
        TModel.load(str(tmp_path / "ck"), plan=object(), device="cpu")
    with pytest.raises(TypeError, match="MeshPlan"):
        TModel.load_latest(str(tmp_path), plan=object(), device="cpu")
    from glint_word2vec_torch.parallel.mesh import MeshPlan
    one = TModel.load(str(tmp_path / "ck"), plan=MeshPlan(1, 1), device="cpu")
    np.testing.assert_array_equal(one.pull([0, 1]), t.pull([0, 1]))
    one = TModel.load_latest(str(tmp_path), plan=MeshPlan(1, 1), device="cpu")
    np.testing.assert_array_equal(one.pull([0, 1]), t.pull([0, 1]))
    # ann=True is ported: without an attached index it is refused as in the JAX package
    with pytest.raises(RuntimeError, match="no index attached"):
        t.find_synonyms_batch(["w1"], 3, ann=True)
    from glint_word2vec_torch import Word2Vec
    # a fit takes the port's MeshPlan (a mesh fit); any other plan is refused
    with pytest.raises(TypeError, match="MeshPlan"):
        Word2Vec(vector_size=8, device="cpu").fit([["a", "b"]], plan=object())
