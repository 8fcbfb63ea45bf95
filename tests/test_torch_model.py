"""Checkpoints and model ops of the port against the JAX package's: digest-verified
round trips, cross-loading in both directions, identical find_synonyms lists
(lax.top_k's lowest-index-first tie order included) and analogies."""

import os

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


SCORE_ATOL = 1e-6  # cosines from two f32 matmul implementations


def _model_data(V=400, D=32, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(V)]
    counts = np.arange(V, 0, -1) * 3
    syn0 = rng.normal(0, 1, (V, D)).astype(np.float32)
    syn1 = rng.normal(0, 1, (V, D)).astype(np.float32)
    return words, counts, syn0, syn1


def _pair(words, counts, syn0, syn1, knobs=None):
    knobs = knobs or dict(vector_size=syn0.shape[1], pairs_per_batch=8192)
    t = TModel(TVocab.from_words_and_counts(words, counts), syn0, syn1,
               config=TConfig(**knobs), device="cpu")
    j = JModel(JVocab.from_words_and_counts(words, counts), syn0, syn1,
               config=JConfig(**knobs))
    return t, j


def test_round_trip_with_digests(tmp_path):
    words, counts, syn0, syn1 = _model_data()
    t, _ = _pair(words, counts, syn0, syn1)
    path = str(tmp_path / "ck")
    t.save(path)
    meta = tck.verify_checkpoint(path)
    assert meta["framework"] == "glint_word2vec_torch"
    assert set(meta["digests"]) == {"words", "counts.npy", "syn0.npy", "syn1.npy"}
    back = TModel.load(path, device="cpu")
    np.testing.assert_array_equal(back.syn0.numpy(), syn0)
    np.testing.assert_array_equal(back.syn1.numpy(), syn1)
    assert back.vocab.words == words
    assert back.config.to_dict() == t.config.to_dict(auto_markers=False)
    # a flipped byte is refused
    with open(os.path.join(path, "syn0.npy"), "r+b") as f:
        f.seek(-3, os.SEEK_END)
        b = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(tck.CheckpointCorruptError):
        TModel.load(path, device="cpu")


def _tear(path, how):
    """Damage ``path`` the way a torn publish or a bad disk would."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if how == "truncated":
            f.truncate(size - 7)
        elif how == "trailing":
            f.seek(0, os.SEEK_END)
            f.write(b"\0" * 4)
        elif how == "flipped_across_blocks":
            f.seek(1000)  # the first block's end with a 1,000-byte block
            b = f.read(2)
            f.seek(1000)
            f.write(bytes([b[0] ^ 1, b[1] ^ 1]))
        else:  # header: the .npy magic itself
            f.seek(0)
            f.write(b"X")


@pytest.mark.parametrize("how", ["truncated", "trailing", "flipped_across_blocks",
                                 "header"])
def test_one_pass_load_refuses_what_the_jax_loader_refuses(tmp_path, monkeypatch, how):
    """The load hashes each matrix as it reads it, in blocks: a small block size reads
    the same arrays, and every damaged file is refused by digest, as the JAX package's
    hash-then-load refuses it."""
    monkeypatch.setattr(tck, "_READ_BLOCK", 1000)
    words, counts, syn0, syn1 = _model_data()
    t, _ = _pair(words, counts, syn0, syn1)
    path = str(tmp_path / "ck")
    t.save(path)
    back = TModel.load(path, device="cpu")
    np.testing.assert_array_equal(back.syn0.numpy(), syn0)
    np.testing.assert_array_equal(back.syn1.numpy(), syn1)
    _tear(os.path.join(path, "syn1.npy"), how)
    with pytest.raises(tck.CheckpointCorruptError, match="syn1.npy"):
        TModel.load(path, device="cpu")
    with pytest.raises(ValueError, match="syn1.npy"):
        JModel.load(path)


def test_checkpoints_cross_load(tmp_path):
    words, counts, syn0, syn1 = _model_data()
    t, j = _pair(words, counts, syn0, syn1)
    t.save(str(tmp_path / "from_torch"))
    j.save(str(tmp_path / "from_jax"))
    jj = JModel.load(str(tmp_path / "from_torch"))
    tt = TModel.load(str(tmp_path / "from_jax"), device="cpu")
    for m in (jj, tt):
        np.testing.assert_array_equal(np.asarray(m.syn0), syn0)
        np.testing.assert_array_equal(np.asarray(m.syn1), syn1)
        assert list(m.vocab.words) == words
    # checkpoints store the RESOLVED AUTO values
    assert jj.config.to_dict() == j.config.to_dict(auto_markers=False)
    assert tt.config.to_dict() == t.config.to_dict(auto_markers=False)
    assert t.config.to_dict() == j.config.to_dict()


def test_jax_checkpoint_with_unported_knobs_still_loads(tmp_path):
    """A per-pair-trained JAX model (pool resolves to 0) serves the model ops, and
    its config now constructs in the port too."""
    words, counts, syn0, _ = _model_data()
    j = JModel(JVocab.from_words_and_counts(words, counts), syn0, None,
               config=JConfig(vector_size=32, pairs_per_batch=256))
    j.save(str(tmp_path / "pp"))
    t = TModel.load(str(tmp_path / "pp"), device="cpu")
    assert t.config.negative_pool == 0 and t.syn1 is None
    assert [w for w, _ in t.find_synonyms("w3", 5)] == [
        w for w, _ in j.find_synonyms("w3", 5)]
    assert TConfig(vector_size=32, pairs_per_batch=256).negative_pool == 0


@pytest.mark.parametrize("pool", [-1, 64, 0])
def test_cbow_checkpoints_cross_load(tmp_path, pool):
    """A CBOW model (AUTO, explicit or per-example pool) saved by either package loads
    in the other with the same config, and the port can resume training from it."""
    from glint_word2vec_torch.train.trainer import Trainer
    words, counts, syn0, syn1 = _model_data(V=300, D=16)
    knobs = dict(vector_size=16, pairs_per_batch=512, cbow=True, negative_pool=pool,
                 window=3)
    t, j = _pair(words, counts, syn0, syn1, knobs=knobs)
    t.save(str(tmp_path / "from_torch"))
    j.save(str(tmp_path / "from_jax"))
    jj = JModel.load(str(tmp_path / "from_torch"))
    tt = TModel.load(str(tmp_path / "from_jax"), device="cpu")
    for m in (jj, tt):
        np.testing.assert_array_equal(np.asarray(m.syn1), syn1)
        assert m.config.cbow and m.config.negative_pool == (64 if pool == 64 else 0)
    assert tt.config.to_dict() == jj.config.to_dict() == j.config.to_dict(
        auto_markers=False)
    data = tck.load_model(str(tmp_path / "from_jax"))  # the refusals apply: none fires
    trainer = Trainer(data["config"], tt.vocab, params=(data["syn0"], data["syn1"]),
                      device="cpu")
    assert trainer.config.cbow and trainer.config.negative_pool == tt.config.negative_pool


@pytest.mark.parametrize("num", [1, 10, 50])
def test_find_synonyms_identical(num):
    words, counts, syn0, syn1 = _model_data()
    t, j = _pair(words, counts, syn0, syn1)
    queries = ["w0", "w17", "w399", syn0[5] * 2.0 - syn0[9]]
    tr = t.find_synonyms_batch(queries, num, chunk=3)
    jr = j.find_synonyms_batch(queries, num, chunk=3)
    for a, b in zip(tr, jr):
        assert [w for w, _ in a] == [w for w, _ in b]
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                                   atol=SCORE_ATOL)
    assert all(w != "w17" for w, _ in t.find_synonyms("w17", num))


def test_find_synonyms_tie_order():
    """Exactly tied cosines (small-integer vectors, duplicated rows) must come out
    lowest index first, as lax.top_k orders them."""
    V, D = 60, 8
    rng = np.random.default_rng(3)
    base = rng.integers(-2, 3, (V, D)).astype(np.float32)
    base[[11, 23, 37, 41, 52]] = base[5]     # five exact copies of row 5
    base[[30, 31]] = base[7] * 2.0           # same direction, other norm
    words = [f"t{i}" for i in range(V)]
    t, j = _pair(words, np.arange(V, 0, -1), base, base,
                 knobs=dict(vector_size=D, pairs_per_batch=8192))
    for q in ("t5", "t7", base[5]):
        a, b = t.find_synonyms(q, 12), j.find_synonyms(q, 12)
        assert [w for w, _ in a] == [w for w, _ in b]
    top = [w for w, _ in t.find_synonyms("t5", 5)]
    assert top == ["t11", "t23", "t37", "t41", "t52"]


def test_analogy_and_transform_agree():
    words, counts, syn0, syn1 = _model_data(seed=2)
    t, j = _pair(words, counts, syn0, syn1)
    np.testing.assert_array_equal(t.transform("w4"), np.asarray(j.transform("w4")))
    got = np.stack(list(t.transform_words(["w1", "w2", "w3"], batch_size=2)))
    np.testing.assert_array_equal(got, syn0[[1, 2, 3]])
    np.testing.assert_allclose(t.norms.numpy(), np.asarray(j.norms), rtol=1e-6)
    a = t.analogy("w1", "w2", "w3", 8)
    b = j.analogy("w1", "w2", "w3", 8)
    assert [w for w, _ in a] == [w for w, _ in b]
    with pytest.raises(KeyError):
        t.transform("nope")


def test_load_latest_valid_picks_newest_verifiable(tmp_path):
    words, counts, syn0, syn1 = _model_data(V=50, D=8)
    cfg = TConfig(vector_size=8, pairs_per_batch=8192)
    for step, name in ((10, "a"), (30, "b"), (20, "c")):
        tck.save_model(str(tmp_path / name), words, counts, syn0, syn1, cfg,
                       tck.TrainState(global_step=step))
    os.makedirs(tmp_path / ".x.tmp-1")
    with open(tmp_path / "b" / "words", "a", encoding="utf-8") as f:
        f.write("tampered\n")  # b is newest but fails its digest
    assert tck.load_latest_valid(str(tmp_path)) == str(tmp_path / "c")
    assert not os.path.exists(tmp_path / ".x.tmp-1")
