"""Row-shards checkpoints written by the JAX package (a fit on its 8-device CPU mesh,
embeddings sharded 4 ways over rows, as tests/test_sharded_checkpoint.py writes them)
read in the port onto one device: arrays equal to the JAX reader's (bf16 shards
included, read through torch.bfloat16 without ml_dtypes), the reader's row ranges and
scattered gathers, verify_checkpoint, model ops on the loaded model, and a corrupted
shard caught by its digest."""

import os

import numpy as np
import pytest

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.models.word2vec import Word2VecModel as TModel
from glint_word2vec_torch.train import checkpoint as tck
from glint_word2vec_tpu.config import Word2VecConfig
from glint_word2vec_tpu.data.pipeline import encode_sentences
from glint_word2vec_tpu.data.vocab import build_vocab
from glint_word2vec_tpu.models.word2vec import Word2VecModel as JModel
from glint_word2vec_tpu.parallel.mesh import make_mesh
from glint_word2vec_tpu.train import checkpoint as jck
from glint_word2vec_tpu.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


def _small_corpus(n=120, v=50, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(v)]
    return [[words[j] for j in rng.integers(0, v, 10)] for _ in range(n)]


def _sharded_fit(path, **extra):
    sents = _small_corpus(seed=extra.pop("corpus_seed", 0))
    vocab = build_vocab(sents, min_count=1)
    cfg = Word2VecConfig(vector_size=12, min_count=1, pairs_per_batch=128,
                         num_iterations=1, window=2, negatives=3, negative_pool=8,
                         steps_per_dispatch=2, seed=3, sharded_checkpoint=True, **extra)
    trainer = Trainer(cfg, vocab, plan=make_mesh(2, 4))
    trainer.fit(encode_sentences(sents, vocab, cfg.max_sentence_length))
    trainer.save_checkpoint(path)
    return trainer


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shards") / "model")
    return _sharded_fit(path), path


@pytest.mark.parametrize("workers", [1, 4])
def test_row_shards_load_equal_to_jax(sharded, workers):
    trainer, path = sharded
    assert tck.load_model_header(path, check_ported=False)["layout"] == "row-shards"
    assert len(os.listdir(os.path.join(path, "syn0.shards"))) == 4
    want = jck.load_model(path)
    got = tck.load_model(path, check_ported=False, io_workers=workers)
    for name in ("syn0", "syn1"):
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])
    assert got["words"] == want["words"]
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["train_state"].to_dict() == want["train_state"].__dict__
    assert got["config"].to_dict() == want["config"].to_dict()
    meta = tck.verify_checkpoint(path, io_workers=workers)
    assert meta["layout"] == "row-shards"


def test_reader_matches_jax_reader(sharded):
    trainer, path = sharded
    d = os.path.join(path, "syn0.shards")
    t, j = tck.ShardedMatrixReader(d), jck.ShardedMatrixReader(d)
    assert (t.rows, t.cols, t.dtype) == (j.rows, j.cols, j.dtype)
    per = trainer.padded_vocab // 4
    for lo, hi in ((0, t.rows), (5, 17), (per - 2, per + 2)):
        np.testing.assert_array_equal(t.read(lo, hi, workers=3), j.read(lo, hi))
    np.testing.assert_array_equal(t.read_all(workers=2), j.read_all())
    ids = np.asarray([t.rows - 1, 0, per, per - 1, 7, 7])
    np.testing.assert_array_equal(t.gather(ids), j.gather(ids))


def test_model_from_row_shards_serves_the_jax_answers(sharded):
    _, path = sharded
    t = TModel.load(path, device="cpu")
    j = JModel.load(path)
    np.testing.assert_array_equal(t.syn0.numpy(), np.asarray(j.syn0))
    assert ([w for w, _ in t.find_synonyms("w3", 5)]
            == [w for w, _ in j.find_synonyms("w3", 5)])


def test_bf16_shards_read_through_torch(tmp_path):
    """A bf16 run stores its shards as raw 2-byte voids; the port widens them to the
    float32 values of the JAX reader's bfloat16 arrays."""
    path = str(tmp_path / "bf16")
    trainer = _sharded_fit(path, corpus_seed=5, param_dtype="bfloat16",
                           compute_dtype="bfloat16")
    d = os.path.join(path, "syn0.shards")
    t, j = tck.ShardedMatrixReader(d), jck.ShardedMatrixReader(d)
    assert t.dtype == np.float32 and j.dtype != np.float32
    np.testing.assert_array_equal(t.read_all(), j.read_all().astype(np.float32))
    ids = np.asarray([3, 0, t.rows - 1])
    np.testing.assert_array_equal(t.gather(ids), j.gather(ids).astype(np.float32))
    got = tck.load_model(path, check_ported=False)
    want = jck.load_model(path)
    np.testing.assert_array_equal(got["syn0"], want["syn0"].astype(np.float32))
    V = trainer.vocab.size
    np.testing.assert_array_equal(
        got["syn0"], np.asarray(trainer.params.syn0)[:V, :12].astype(np.float32))


def test_corrupt_shard_is_caught(sharded, tmp_path):
    import shutil
    _, src = sharded
    path = str(tmp_path / "model")
    shutil.copytree(src, path)
    shard = sorted(os.listdir(os.path.join(path, "syn1.shards")))[2]
    fp = os.path.join(path, "syn1.shards", shard)
    with open(fp, "r+b") as f:
        f.seek(-5, os.SEEK_END)
        b = f.read(1)
        f.seek(-5, os.SEEK_END)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(tck.CheckpointCorruptError, match=shard):
        tck.verify_checkpoint(path)
    with pytest.raises(tck.CheckpointCorruptError):
        tck.load_model(path, check_ported=False)
    with pytest.raises(tck.CheckpointCorruptError):
        TModel.load(path, device="cpu")
    # a missing shard is a gap in the spans
    os.unlink(fp)
    with pytest.raises(tck.CheckpointCorruptError):
        tck.verify_checkpoint(path)
