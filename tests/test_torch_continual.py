"""Continual training in the port against the JAX package's, on the CPU at toy sizes:
vocabulary extension (dense and row-shards, digests and lineage equal), the stream and
its cursor (files cross-read), the trainer's hooks (extra checkpoint metadata, the
``corpus_words`` clock), the ``ContinualRunner`` (an increment from the same base equal
to the JAX runner's), ``Word2Vec.resume`` across a grown vocabulary and the CLI drill.

Tolerance: integers, words, digests, lineage chains and new rows are compared exactly
(the extension is host numpy, numpy's generator in both packages). An increment's
parameters: atol 1e-5, the port's f32 trainer tolerance of tests/test_torch_trainer.py
(each step differs from the JAX step by f32 reassociation only)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import Word2Vec as TWord2Vec
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.continual import extend as text
from glint_word2vec_torch.continual import stream as tstream
from glint_word2vec_torch.continual.loop import ContinualRunner as TRunner
from glint_word2vec_torch.data.corpus import vocab_fingerprint as t_fingerprint
from glint_word2vec_torch.data.pipeline import encode_sentences as t_encode
from glint_word2vec_torch.data.vocab import Vocabulary as TVocab
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.train import checkpoint as tckpt
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.continual import extend as jext
from glint_word2vec_tpu.continual import stream as jstream
from glint_word2vec_tpu.continual.loop import ContinualRunner as JRunner
from glint_word2vec_tpu.data.vocab import Vocabulary as JVocab
from glint_word2vec_tpu.parallel.mesh import make_mesh
from glint_word2vec_tpu.train import checkpoint as jckpt
from glint_word2vec_tpu.train.trainer import Trainer as JTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
CPU = "cpu"

_RUNNER_CFG = dict(vector_size=8, min_count=1, window=2, pairs_per_batch=64,
                   num_iterations=1, subsample_ratio=0.0, seed=1, prefetch_chunks=0)
_FIT_CFG = dict(vector_size=8, window=2, min_count=1, num_iterations=1,
                pairs_per_batch=64, subsample_ratio=0.0, seed=1, prefetch_chunks=0)


def _words_counts():
    return ["the", "cat", "sat", "mat"], [40, 20, 10, 5]


def _toy_checkpoint(path, dim=8, seed=3):
    """A dense checkpoint the JAX package writes (the port writes the same bytes)."""
    words, counts = _words_counts()
    rng = np.random.default_rng(seed)
    syn0 = rng.normal(size=(len(words), dim)).astype(np.float32)
    syn1 = rng.normal(size=(len(words), dim)).astype(np.float32)
    jckpt.save_model(path, words, counts, syn0, syn1, JConfig(vector_size=dim, min_count=2),
                     jckpt.TrainState(global_step=17, finished=True))
    return syn0, syn1


def _meta(path) -> dict:
    with open(os.path.join(path, "metadata.json"), encoding="utf-8") as f:
        return json.load(f)


def _write_segment(path, sentences):
    with open(path, "w", encoding="utf-8") as f:
        for s in sentences:
            f.write(" ".join(s) + "\n")


def _fit_corpus(n=120, words=14, seed=0):
    rng = np.random.default_rng(seed)
    return [[f"w{i}" for i in rng.integers(0, words, 10)] for _ in range(n)]


# -- the extension's functions, bit for bit ----------------------------------------------


@pytest.mark.parametrize("fn", ["compute_vocab_delta", "extended_vocabulary",
                                "seed_new_rows", "lineage_fingerprints"])
def test_extension_functions_equal_the_jax_ones(fn):
    rng = np.random.default_rng(11)
    words = [f"w{i}" for i in range(50)]
    counts = np.sort(rng.integers(1, 500, 50))[::-1]
    tail = {f"w{i}": int(c) for i, c in zip(rng.integers(0, 80, 60),
                                            rng.integers(1, 20, 60))}
    tv, jv = TVocab.from_words_and_counts(words, counts), JVocab.from_words_and_counts(
        words, counts)
    td, jd = text.compute_vocab_delta(tv, tail, 5), jext.compute_vocab_delta(jv, tail, 5)
    if fn == "compute_vocab_delta":
        assert td.new_words == jd.new_words and td.num_new == jd.num_new > 0
        np.testing.assert_array_equal(td.new_counts, jd.new_counts)
        np.testing.assert_array_equal(td.merged_counts, jd.merged_counts)
        assert td.tail_words_total == jd.tail_words_total
    elif fn == "extended_vocabulary":
        t2, j2 = text.extended_vocabulary(tv, td), jext.extended_vocabulary(jv, jd)
        assert t2.words == j2.words and t2.words[:50] == words
        np.testing.assert_array_equal(t2.counts, j2.counts)
        assert t2.train_words_count == j2.train_words_count
        assert t_fingerprint(t2) == t_fingerprint(j2)
    elif fn == "seed_new_rows":
        for seed, v_old, n, d in ((7, 100, 5, 16), (2**40 + 3, 1_000_000, 33, 300)):
            a = text.seed_new_rows(n, d, seed, v_old)
            np.testing.assert_array_equal(a, jext.seed_new_rows(n, d, seed, v_old))
            assert a.dtype == np.float32 and np.abs(a).max() <= 0.5 / d
        assert not np.array_equal(text.seed_new_rows(5, 16, 7, 100),
                                  text.seed_new_rows(5, 16, 7, 200))
    else:
        t2 = text.extended_vocabulary(tv, td)
        link = text.lineage_entry(tv, t2, td, "seg=1-abc")
        assert link == jext.lineage_entry(jv, jext.extended_vocabulary(jv, jd), jd,
                                          "seg=1-abc")
        chains = ([link], [link, dict(link, remap="permuted")],
                  [dict(link, remap="permuted"), link], [])
        for chain in chains:
            assert text.lineage_fingerprints(chain) == jext.lineage_fingerprints(chain)
        assert text.lineage_fingerprints([link]) == [t_fingerprint(tv), t_fingerprint(t2)]


# -- dense extension ---------------------------------------------------------------------


def test_dense_extension_equals_the_jax_packages(tmp_path):
    """Each package extends a copy of one checkpoint: the same digests of words,
    counts, syn0 and syn1, the same lineage chain, carried rows bit for bit."""
    src = str(tmp_path / "src")
    syn0, syn1 = _toy_checkpoint(src)
    tail = {"dog": 9, "cat": 5, "fox": 4, "rare": 1}
    for name in ("t", "j"):
        shutil.copytree(src, tmp_path / name)
    rt = text.extend_checkpoint(str(tmp_path / "t"), tail, tail_fingerprint="seg=x")
    rj = jext.extend_checkpoint(str(tmp_path / "j"), tail, tail_fingerprint="seg=x")
    assert {k: v for k, v in rt.items() if k != "path"} == \
        {k: v for k, v in rj.items() if k != "path"}
    mt, mj = _meta(tmp_path / "t"), _meta(tmp_path / "j")
    assert mt["digests"] == mj["digests"]
    assert set(mt["digests"]) == {"words", "counts.npy", "syn0.npy", "syn1.npy"}
    assert mt["vocab_lineage"] == mj["vocab_lineage"] and len(mt["vocab_lineage"]) == 1
    assert mt["framework"] == "glint_word2vec_torch"
    tckpt.verify_checkpoint(str(tmp_path / "t"))
    data = tckpt.load_model(str(tmp_path / "t"))
    np.testing.assert_array_equal(data["syn0"][:4], syn0)
    np.testing.assert_array_equal(data["syn1"][:4], syn1)
    np.testing.assert_array_equal(data["syn1"][4:], np.zeros((2, 8)))
    np.testing.assert_array_equal(data["syn0"][4:],
                                  text.seed_new_rows(2, 8, JConfig().seed, 4))
    assert data["words"] == ["the", "cat", "sat", "mat", "dog", "fox"]
    assert data["counts"].tolist() == [40, 25, 10, 5, 9, 4]


@pytest.mark.parametrize("case", ["zero_growth", "threshold", "chain", "applied"])
def test_dense_extension_cases_match(tmp_path, case):
    """Zero growth still links the chain, ``min_new_words`` gates growth, two
    increments chain, and a tail already applied is skipped: each in both packages."""
    out = {}
    for name, ext in (("t", text), ("j", jext)):
        ck = str(tmp_path / name)
        _toy_checkpoint(ck)
        if case == "zero_growth":
            reps = [ext.extend_checkpoint(ck, {"cat": 5}, min_count=2)]
        elif case == "threshold":
            reps = [ext.extend_checkpoint(ck, {"dog": 9, "fox": 3}, min_count=2,
                                          min_new_words=3)]
        elif case == "chain":
            reps = [ext.extend_checkpoint(ck, {"dog": 9}, min_count=2),
                    ext.extend_checkpoint(ck, {"fox": 4}, min_count=2)]
        else:
            reps = [ext.extend_checkpoint(ck, {"dog": 9}, min_count=2,
                                          tail_fingerprint="seg-001=9-ab"),
                    ext.extend_checkpoint(ck, {"dog": 9}, min_count=2,
                                          tail_fingerprint="seg-001=9-ab")]
        out[name] = (reps, _meta(ck))
    (rt, mt), (rj, mj) = out["t"], out["j"]
    assert [{k: v for k, v in r.items() if k != "path"} for r in rt] == \
        [{k: v for k, v in r.items() if k != "path"} for r in rj]
    assert mt["digests"] == mj["digests"] and mt["vocab_lineage"] == mj["vocab_lineage"]
    chain = mt["vocab_lineage"]
    if case == "zero_growth":
        assert rt[0]["new_words"] == 0 and chain[0]["new_words"] == 0
        assert chain[0]["parent_fingerprint"] != chain[0]["fingerprint"]
    elif case == "threshold":
        assert rt[0]["new_words"] == 0 and mt["vocab_size"] == 4
    elif case == "chain":
        assert [e["new_vocab_size"] for e in chain] == [5, 6]
        assert chain[1]["parent_fingerprint"] == chain[0]["fingerprint"]
        assert len(text.lineage_fingerprints(chain)) == 3
    else:
        assert rt[1]["already_applied"] and len(chain) == 1
        assert tckpt.load_model_header(str(tmp_path / "t"))["counts"].tolist() == \
            [40, 20, 10, 5, 9]


# -- row-shards extension ----------------------------------------------------------------


def _sharded_checkpoint(path, V=10, dim=8, shards=2):
    """A row-shards checkpoint the JAX package writes on its CPU mesh, V=10 padded to
    12 over 2 shard files: the boundary shard holds padding rows."""
    plan = make_mesh(1, shards, devices=jax.devices()[:shards])
    Vp = (V // shards + 1) * shards
    rng = np.random.default_rng(0)
    syn0 = np.zeros((Vp, dim), np.float32)
    syn1 = np.zeros((Vp, dim), np.float32)
    syn0[:V] = rng.normal(size=(V, dim))
    syn1[:V] = rng.normal(size=(V, dim))
    sh = NamedSharding(plan.mesh, PartitionSpec("model", None))
    jckpt.save_model_sharded(
        path, [f"w{i}" for i in range(V)], np.arange(V, 0, -1) * 10,
        jax.device_put(syn0, sh), jax.device_put(syn1, sh),
        JConfig(vector_size=dim, min_count=2), jckpt.TrainState(global_step=5, finished=True),
        vocab_size=V, vector_size=dim)
    return syn0[:V], syn1[:V]


def test_row_shards_extension_equals_the_jax_packages(tmp_path):
    src = str(tmp_path / "src")
    syn0, syn1 = _sharded_checkpoint(src)
    for name in ("t", "j"):
        shutil.copytree(src, tmp_path / name)
    tail = {"dog": 9, "fox": 4}
    rt = text.extend_checkpoint(str(tmp_path / "t"), tail, min_count=2)
    jext.extend_checkpoint(str(tmp_path / "j"), tail, min_count=2)
    assert rt["layout"] == "row-shards" and rt["new_words"] == 2
    mt, mj = _meta(tmp_path / "t"), _meta(tmp_path / "j")
    assert mt["digests"] == mj["digests"]
    assert mt["vocab_lineage"] == mj["vocab_lineage"]
    for m in ("syn0", "syn1"):
        names = sorted(os.listdir(tmp_path / "t" / f"{m}.shards"))
        assert names == sorted(os.listdir(tmp_path / "j" / f"{m}.shards"))
        assert names[-1] == f"rows-{10:010d}-{12:010d}.npy"  # the new rows' span
    assert (mt["padded_vocab"], mt["vocab_size"], mt["format_version"]) == (12, 12, 2)
    tckpt.verify_checkpoint(str(tmp_path / "t"))
    data = tckpt.load_model(str(tmp_path / "t"))
    np.testing.assert_array_equal(data["syn0"][:10], syn0)
    np.testing.assert_array_equal(data["syn1"][:10], syn1)
    np.testing.assert_array_equal(data["syn1"][10:], np.zeros((2, 8)))
    assert data["words"][-2:] == ["dog", "fox"]


def test_row_shards_extension_refuses_a_corrupt_carried_shard(tmp_path):
    ck = str(tmp_path / "ck")
    _sharded_checkpoint(ck)
    p = os.path.join(ck, "syn0.shards", sorted(os.listdir(os.path.join(ck, "syn0.shards")))[0])
    raw = bytearray(open(p, "rb").read())
    raw[-1] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(tckpt.CheckpointCorruptError, match="corrupt shard"):
        text.extend_checkpoint(ck, {"dog": 9}, min_count=2, out_path=str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")


# -- the stream ----------------------------------------------------------------------------


def test_segment_fingerprint_and_cursor_cross_read(tmp_path):
    d = str(tmp_path / "stream")
    os.makedirs(d)
    rng = np.random.default_rng(1)
    _write_segment(os.path.join(d, "a.txt"), [["x", "y"]] * 5)
    # a segment past the 1 MiB head/tail windows
    _write_segment(os.path.join(d, "b.txt"),
                   [[f"w{i}" for i in rng.integers(0, 999, 30)] for _ in range(15000)])
    for name in ("a.txt", "b.txt"):
        p = os.path.join(d, name)
        assert tstream.segment_fingerprint(p) == jstream.segment_fingerprint(p)
    assert os.path.getsize(os.path.join(d, "b.txt")) > 2 * (1 << 20)
    for writer, reader in ((tstream, jstream), (jstream, tstream)):
        work = str(tmp_path / f"work-{writer.__name__.split('.')[0]}")
        cur = writer.StreamCursor(work)
        s = writer.CorpusStream(d)
        assert cur.new_segments(s) == ["a.txt", "b.txt"]
        fp = writer.segment_fingerprint(s.path("a.txt"))
        cur.mark_counted("b.txt", writer.segment_fingerprint(s.path("b.txt")))
        cur.mark_consumed("a.txt", fp, "vfp", {"n_sentences": 5, "total_tokens": 10})
        cur.save()
        back = reader.StreamCursor(work)
        assert back.consumed == cur.consumed and back.counted == cur.counted
        assert back.new_segments(reader.CorpusStream(d)) == ["b.txt"]
        assert back.uncounted(["b.txt"]) == []
    with open(tmp_path / "work-glint_word2vec_torch" / "cursor.json") as f:
        t_doc = f.read()
    with open(tmp_path / "work-glint_word2vec_tpu" / "cursor.json") as f:
        assert f.read() == t_doc


def test_rewriting_a_consumed_segment_is_refused(tmp_path, monkeypatch):
    d = str(tmp_path / "stream")
    os.makedirs(d)
    _write_segment(os.path.join(d, "a.txt"), [["x", "y"]] * 5)
    stream = tstream.CorpusStream(d)
    cur = tstream.StreamCursor(str(tmp_path / "work"))
    cur.mark_consumed("a.txt", tstream.segment_fingerprint(stream.path("a.txt")), "v", {})
    calls = []
    real = tstream.segment_fingerprint
    monkeypatch.setattr(tstream, "segment_fingerprint", lambda p: calls.append(p) or real(p))
    for _ in range(3):
        assert cur.new_segments(stream) == []
    assert len(calls) == 1  # verified once, then memoized on its stat
    _write_segment(os.path.join(d, "a.txt"), [["CHANGED"]] * 9)
    with pytest.raises(ValueError, match="append-only"):
        cur.new_segments(stream)
    os.remove(os.path.join(d, "a.txt"))
    with pytest.raises(ValueError, match="vanished"):
        cur.new_segments(stream)


def test_concat_corpus_indexing():
    a = [np.array([1, 2]), np.array([3])]
    b = [np.array([4, 5, 6])]
    c = tstream.ConcatCorpus([a, b, []])
    assert len(c) == 3
    np.testing.assert_array_equal(c[1], [3])
    np.testing.assert_array_equal(c[2], [4, 5, 6])
    np.testing.assert_array_equal(c[-1], [4, 5, 6])
    with pytest.raises(IndexError):
        c[3]
    with pytest.raises(TypeError):
        c[0:1]


def test_encode_delta_encodes_only_the_tail(tmp_path, monkeypatch):
    """The consumed segment's cache (written under an ancestor vocabulary) is reused
    untouched; only the new segment is encoded, under the grown vocabulary."""
    d = str(tmp_path / "stream")
    os.makedirs(d)
    _write_segment(os.path.join(d, "a.txt"), [["x", "y", "x"]] * 4)
    _write_segment(os.path.join(d, "b.txt"), [["y", "z"]] * 4)
    stream = tstream.CorpusStream(d)
    cache = str(tmp_path / "cache")
    vocab = TVocab.from_words_and_counts(["x", "y"], [8, 8])
    cur = tstream.StreamCursor(str(tmp_path / "work"))
    enc_a = tstream.encode_segment(stream, "a.txt", vocab, cache, 1000)
    cur.mark_consumed("a.txt", tstream.segment_fingerprint(stream.path("a.txt")),
                      t_fingerprint(vocab), enc_a.meta)
    vocab2 = TVocab.from_words_and_counts(["x", "y", "z"], [8, 12, 4])
    encoded = []
    real = tstream.encode_corpus
    monkeypatch.setattr(tstream, "encode_corpus",
                        lambda s, *a, **k: encoded.append(s.path) or real(s, *a, **k))
    mtime = os.path.getmtime(os.path.join(cache, "a.txt.enc", "tokens.bin"))
    res = tstream.encode_delta(stream, cur, vocab2, cache,
                               lineage=[t_fingerprint(vocab)], replay_segments=1)
    assert res["new"] == ["b.txt"] and res["replayed"] == ["a.txt"]
    assert encoded == [stream.path("b.txt")]
    assert os.path.getmtime(os.path.join(cache, "a.txt.enc", "tokens.bin")) == mtime
    assert len(res["corpus"]) == 8 and res["corpus"].total_tokens == 12 + 8
    np.testing.assert_array_equal(res["corpus"][7], [1, 2])  # y z under the grown ids


# -- the trainer's hooks -------------------------------------------------------------------


def test_extra_checkpoint_meta_rides_every_save(tmp_path, monkeypatch):
    sents = _fit_corpus(60)
    vocab = t_build_vocab(sents, 1)
    trainer = TTrainer(TConfig(**_FIT_CFG), vocab, device=CPU)
    trainer.extra_checkpoint_meta = {"vocab_lineage": [{"remap": "x"}]}
    ck = str(tmp_path / "ck")
    metas = []
    real = tckpt._save_model

    def spy(path, *a):
        real(path, *a)
        metas.append(_meta(path))

    monkeypatch.setattr(tckpt, "_save_model", spy)
    trainer.fit(t_encode(sents, vocab), checkpoint_path=ck, checkpoint_every_steps=2)
    assert len(metas) >= 2 and metas[-1]["train_state"]["finished"]
    assert not metas[0]["train_state"]["finished"]  # a periodic save
    assert all(m["vocab_lineage"] == [{"remap": "x"}] for m in metas)


def test_reserved_metadata_keys_are_refused_as_in_jax(tmp_path):
    words, counts = _words_counts()
    syn0 = np.zeros((4, 8), np.float32)
    msgs = []
    for save, cfg in ((tckpt.save_model, TConfig(vector_size=8)),
                      (jckpt.save_model, JConfig(vector_size=8))):
        with pytest.raises(ValueError, match="writer-owned") as e:
            save(str(tmp_path / "ck"), words, counts, syn0, None, cfg,
                 extra_metadata={"digests": {}, "config": 1})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="writer-owned"):
        tckpt.save_row_shards(str(tmp_path / "rs"), words, counts, syn0,
                              TConfig(vector_size=8), 2,
                              extra_metadata={"layout": "dense"})
    assert not os.path.exists(tmp_path / "ck")


@pytest.mark.parametrize("feed", ["host", "device_pairgen"])
def test_fit_corpus_words_anneals_as_the_jax_trainer(feed):
    """With vocabulary counts claiming 100x the fed corpus (a continual increment's
    merged history), ``corpus_words=`` re-arms the lr clock: the alpha trace equals the
    JAX trainer's on both feeds, and ends far below the default's."""
    sents = _fit_corpus(n=80, words=6)
    tokens = sum(len(s) for s in sents)
    base = t_build_vocab(sents, 1)
    knobs = dict(_FIT_CFG, heartbeat_every_steps=2, steps_per_dispatch=2)
    if feed == "device_pairgen":
        knobs.update(device_pairgen=True, tokens_per_step=32)
    tv = TVocab.from_words_and_counts(base.words, base.counts * 100)
    jv = JVocab.from_words_and_counts(base.words, base.counts * 100)
    enc = t_encode(sents, tv, 1000)

    def alphas(trainer, **kw):
        trainer.fit(enc, **kw)
        return [(h.global_step, h.alpha) for h in trainer.heartbeats]

    clocked = alphas(TTrainer(TConfig(**knobs), tv, device=CPU), corpus_words=tokens)
    assert clocked == alphas(JTrainer(JConfig(**knobs), jv), corpus_words=tokens)
    default = alphas(TTrainer(TConfig(**knobs), tv, device=CPU))
    assert len(clocked) >= 3 and clocked[-1][1] < default[-1][1] * 0.5


# -- the runner ----------------------------------------------------------------------------


def _runner_stream(tmp_path):
    d = str(tmp_path / "stream")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(12)]
    _write_segment(os.path.join(d, "seg-000.txt"),
                   [[words[i] for i in rng.integers(0, 12, 10)] for _ in range(100)])
    return d


def test_runner_increment_equals_the_jax_runners(tmp_path):
    """The JAX runner bootstraps a base; both runners take one increment from copies
    of it over the same segment: the same report, vocabulary, lineage, counts and
    global_step, parameters within atol 1e-5; telemetry validates."""
    d = _runner_stream(tmp_path)
    # the shared negative pool: the fused kernel's step (its plain version here)
    cfg = dict(_RUNNER_CFG, steps_per_dispatch=2, heartbeat_every_steps=2,
               negative_pool=16, allow_unstable=True, continual_lr_rewarm=0.5)
    jck, jwork = str(tmp_path / "j" / "publish" / "ck"), str(tmp_path / "j" / "work")
    with JRunner(jck, d, jwork, config_overrides=cfg) as jr:
        assert jr.ensure_base()["action"] == "base"
        shutil.copytree(tmp_path / "j", tmp_path / "t")
        _write_segment(os.path.join(d, "seg-001.txt"),
                       [["w0", "fresh1", "w3", "fresh2", "w5"]] * 60)
        jrep = jr.run_once()
    tck, twork = str(tmp_path / "t" / "publish" / "ck"), str(tmp_path / "t" / "work")
    tele = str(tmp_path / "continual.jsonl")
    with TRunner(tck, d, twork, config_overrides=cfg, telemetry_path=tele,
                 device=CPU) as tr:
        assert tr.ensure_base()["action"] == "none"
        trep = tr.run_once()
        assert tr.run_once() == {"action": "idle", "segments": 0}
    for k in ("action", "segments", "grew", "new_words", "vocab_size", "words",
              "lineage_depth"):
        assert trep[k] == jrep[k], k
    assert trep["new_words"] == 2 and trep["vocab_size"] == 14
    th, jh = tckpt.load_model_header(tck), jckpt.load_model_header(jck)
    assert th["words"] == jh["words"] and th["vocab_lineage"] == jh["vocab_lineage"]
    np.testing.assert_array_equal(th["counts"], jh["counts"])
    assert th["train_state"].global_step == jh["train_state"].global_step
    assert trep["trainer"]["global_step"] == th["train_state"].global_step > \
        trep["trainer"]["global_step_start"] > 0
    assert th["config"].learning_rate == jh["config"].learning_rate
    td, jd = tckpt.load_model(tck), jckpt.load_model(jck)
    np.testing.assert_allclose(td["syn0"], jd["syn0"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(td["syn1"], jd["syn1"], atol=ATOL, rtol=0)
    assert np.abs(td["syn1"][12:]).max() > 1e-4  # the new rows trained
    with open(os.path.join(twork, "cursor.json")) as f:
        assert set(json.load(f)["consumed"]) == {"seg-000.txt", "seg-001.txt"}
    from glint_word2vec_torch.obs.schema import validate_file
    summary = validate_file(tele)
    assert summary["ok"], summary["errors"]
    assert summary["kinds"].get("continual_extend") == 1
    assert summary["kinds"].get("continual_increment") == 1
    assert summary["kinds"].get("publish") == 1


def test_runner_retry_does_not_merge_counts_twice(tmp_path):
    d = str(tmp_path / "stream")
    os.makedirs(d)
    _write_segment(os.path.join(d, "seg-000.txt"), [["a", "b"]] * 60)
    ck = str(tmp_path / "publish" / "ck")
    runner = TRunner(ck, d, str(tmp_path / "work"), config_overrides=_RUNNER_CFG,
                     device=CPU)
    runner.ensure_base()
    _write_segment(os.path.join(d, "seg-001.txt"), [["a", "c"]] * 40)
    orig = runner._load_params

    def boom(*a, **k):
        raise RuntimeError("injected mid-increment crash")

    runner._load_params = boom
    with pytest.raises(RuntimeError):
        runner.run_once()
    counts_after_crash = tckpt.load_model_header(ck)["counts"]
    runner._load_params = orig
    assert runner.run_once()["action"] == "increment"
    np.testing.assert_array_equal(tckpt.load_model_header(ck)["counts"],
                                  counts_after_crash)
    cur = tstream.StreamCursor(str(tmp_path / "work"))
    assert "seg-001.txt" in cur.consumed and not cur.counted


def test_crash_between_extension_publish_and_cursor_save_is_idempotent(tmp_path):
    d = str(tmp_path / "stream")
    os.makedirs(d)
    _write_segment(os.path.join(d, "seg-000.txt"), [["a", "b"]] * 60)
    ck = str(tmp_path / "publish" / "ck")
    runner = TRunner(ck, d, str(tmp_path / "work"), config_overrides=_RUNNER_CFG,
                     device=CPU)
    runner.ensure_base()
    _write_segment(os.path.join(d, "seg-001.txt"), [["a", "c"]] * 40)

    def crash():
        raise RuntimeError("injected crash before the cursor save")

    runner.cursor.save = crash
    with pytest.raises(RuntimeError):
        runner.run_once()
    counts_after_crash = tckpt.load_model_header(ck)["counts"]
    runner2 = TRunner(ck, d, str(tmp_path / "work"), config_overrides=_RUNNER_CFG,
                      device=CPU)
    assert runner2.run_once()["action"] == "increment"
    header = tckpt.load_model_header(ck)
    np.testing.assert_array_equal(header["counts"], counts_after_crash)
    assert len(header["vocab_lineage"]) == 1


def test_lr_neither_compounds_nor_rewrites_the_base_config(tmp_path, monkeypatch):
    d = str(tmp_path / "stream")
    os.makedirs(d)
    _write_segment(os.path.join(d, "seg-000.txt"), [["a", "b", "c"]] * 80)
    ck = str(tmp_path / "publish" / "ck")
    runner = TRunner(ck, d, str(tmp_path / "work"), device=CPU,
                     config_overrides=dict(_RUNNER_CFG, learning_rate=0.04,
                                           continual_lr_rewarm=0.5))
    runner.ensure_base()
    scales = []
    real_fit = TTrainer.fit

    def fit(self, *a, **k):
        scales.append(self._lr_scale)
        return real_fit(self, *a, **k)

    monkeypatch.setattr(TTrainer, "fit", fit)
    for i in (1, 2):
        _write_segment(os.path.join(d, f"seg-00{i}.txt"), [["a", f"fresh{i}"]] * 50)
        assert runner.run_once()["action"] == "increment"
    cfg = tckpt.load_model_header(ck)["config"]
    assert cfg.learning_rate == 0.04 and cfg.continual_lr_rewarm == 0.5
    assert scales == [0.5, 0.5]


def test_run_forever_reads_poll_s_from_the_checkpoint(tmp_path):
    import time
    d = str(tmp_path / "stream")
    os.makedirs(d)
    _write_segment(os.path.join(d, "seg-000.txt"), [["a", "b"]] * 60)
    ck = str(tmp_path / "publish" / "ck")
    TRunner(ck, d, str(tmp_path / "work"), device=CPU,
            config_overrides=dict(_RUNNER_CFG, continual_poll_s=0.05)).ensure_base()
    # a new runner without overrides: the cadence comes from the checkpoint
    runner = TRunner(ck, d, str(tmp_path / "work"), device=CPU)
    t0 = time.monotonic()
    assert runner.run_forever(max_idle_polls=3) == {"increments": 0, "stopped": "idle"}
    assert time.monotonic() - t0 < 1.5  # not the dataclass default of 2 s a poll


def test_runner_refuses_plan_and_defaults_to_the_card(tmp_path, monkeypatch):
    # the runner takes the port's MeshPlan (a mesh of ranks); any other plan is refused
    with pytest.raises(TypeError, match="MeshPlan"):
        TRunner(str(tmp_path / "ck"), str(tmp_path), str(tmp_path / "w"), plan=object(),
                device=CPU)
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TRunner(str(tmp_path / "ck"), str(tmp_path), str(tmp_path / "w"))


# -- resume across a grown vocabulary -----------------------------------------------------


@pytest.mark.parametrize("extender", ["port", "jax"])
def test_resume_accepts_an_ancestor_cache_after_extension(tmp_path, monkeypatch,
                                                          extender):
    """A mid-run checkpoint extended (by either package) resumes to the grown V from
    the cache encoded under the pre-extension vocabulary, with no re-encode, and its
    saves keep the chain."""
    sents = _fit_corpus()
    cache = str(tmp_path / "cache")
    ck = str(tmp_path / "ck")
    knobs = dict(_FIT_CFG, num_iterations=2)
    model = TWord2Vec(device=CPU, **knobs).fit(sents, encode_cache_dir=cache)
    # a mid-run checkpoint of that vocabulary (three steps into its first iteration)
    tr = TTrainer(TConfig(**knobs), model.vocab, device=CPU)
    tr.state = tckpt.TrainState(iteration=1, batches_done=3, global_step=3)
    tr.save_checkpoint(ck)
    (text if extender == "port" else jext).extend_checkpoint(ck, {"brandnew": 6},
                                                             min_count=1)
    assert tckpt.load_model_header(ck)["vocab_size"] == 15
    import glint_word2vec_torch.data.corpus as corpus_mod
    import glint_word2vec_torch.models.estimator as est_mod

    def boom(*a, **k):
        raise AssertionError("resume re-encoded a valid ancestor cache")

    monkeypatch.setattr(corpus_mod, "encode_corpus", boom)
    monkeypatch.setattr(est_mod, "encode_corpus", boom)
    grown = TWord2Vec.resume(ck, sents, encode_cache_dir=cache, device=CPU)
    assert grown.num_words == 15 and grown.train_state.finished
    header = tckpt.load_model_header(ck)
    assert header["train_state"].finished and len(header["vocab_lineage"]) == 1
    assert np.isfinite(grown.syn0.numpy()).all()


def test_resume_mismatch_names_the_migration_path(tmp_path):
    from glint_word2vec_torch.data.corpus import encode_corpus
    sents = _fit_corpus()
    ck = str(tmp_path / "ck")
    TWord2Vec(device=CPU, **_FIT_CFG).fit(sents, checkpoint_path=ck)
    cache = str(tmp_path / "stale-cache")
    encode_corpus([["x", "y", "z"]], TVocab.from_words_and_counts(["x", "y", "z"],
                                                                  [3, 2, 1]), cache)
    with pytest.raises(ValueError) as e:
        TWord2Vec.resume(ck, sents, encode_cache_dir=cache, device=CPU)
    msg = str(e.value)
    assert "glint_word2vec_torch.continual.extend.extend_checkpoint" in msg
    assert "lineage" in msg


# -- the CLI drill -------------------------------------------------------------------------


def test_continual_run_smoke_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.continual_run", "--smoke",
         "--device", "cpu", "--workdir", str(tmp_path / "drill")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert report["ok"] is True and report["device"] == "cpu"
    assert report["vocab_grown"] == report["vocab_base"] + report["new_words"] > 12
    assert report["failed_queries"] == 0 and report["refused"] == 0
    assert report["vocab_change_reloads"] >= 1 and report["lineage_depth"] == 1
