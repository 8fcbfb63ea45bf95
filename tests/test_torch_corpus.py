"""The port's corpus ingestion and resume against the JAX package's: vocabulary
counting (serial, slab-parallel and native), the encoded corpus cache (native and Python
passes), its vocabulary fingerprint, and ``Word2Vec.resume``.

Counts, word order and encoded files are compared exactly (byte for byte). Resumed
parameters: atol 1e-5, as in tests/test_torch_trainer.py (each step differs between the
packages by f32 reassociation only)."""

import collections
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import Word2Vec as TWord2Vec
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data import corpus as tcorpus
from glint_word2vec_torch.data import ingest_native as tingest
from glint_word2vec_torch.data import vocab as tvocab
from glint_word2vec_torch.train import checkpoint as tckpt
from glint_word2vec_torch.train import faults as tfaults
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data import corpus as jcorpus
from glint_word2vec_tpu.data import ingest_native as jingest
from glint_word2vec_tpu.data import vocab as jvocab
from glint_word2vec_tpu.models.estimator import Word2Vec as JWord2Vec
from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair
from glint_word2vec_tpu.train import checkpoint as jckpt
from glint_word2vec_tpu.train.trainer import Trainer as JTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


def _token_lines(seed=0, n_words=250, n_sent=300, unicode=False):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)] + ["été", "naïve"]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    lines = []
    for i in range(n_sent):
        toks = [words[j] for j in rng.choice(len(words), size=rng.integers(0, 30), p=p)]
        sep = "\u00a0" if unicode and i == 5 else " "
        lines.append(sep.join(toks) + ("  \t" if i % 7 == 0 else ""))
    return lines


def _corpus_file(tmp_path, **kw) -> str:
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(_token_lines(**kw)) + "\n", encoding="utf-8")
    return str(path)


def _same_vocab(t, j):
    assert t.words == j.words
    assert np.array_equal(t.counts, j.counts)
    assert t.train_words_count == j.train_words_count
    assert t.index == j.index


@pytest.fixture(autouse=True)
def _no_faults():
    tfaults.reset()
    yield
    tfaults.reset()


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_count_words_parallel_matches_the_counter(workers):
    sents = [line.split() for line in _token_lines(seed=2)]
    want = jvocab.count_words_parallel(sents, workers, slab_sentences=17)
    got = tvocab.count_words_parallel(sents, workers, slab_sentences=17)
    assert got == want == collections.Counter(w for s in sents for w in s)
    assert list(got) == list(want)  # first-seen order: the tie-break of equal counts
    assert list(got.items()) == list(tvocab.count_words(sents).items())


@pytest.mark.parametrize("route", ["serial", "parallel", "token_file"])
def test_build_vocab_matches_the_jax_package(tmp_path, monkeypatch, route):
    path = _corpus_file(tmp_path, seed=3)
    sents = [line.split() for line in Path(path).read_text().splitlines()]
    if route == "parallel":
        monkeypatch.setattr(tvocab, "parallel_counting_profitable", lambda w: w > 1)
        got = tvocab.build_vocab(sents, 2, workers=4)
    elif route == "token_file":
        assert tingest.ingest_available()
        calls = []
        real = tingest.count_words_native
        monkeypatch.setattr(tingest, "count_words_native",
                            lambda *a: calls.append(1) or real(*a))
        got = tvocab.build_vocab(tcorpus.TokenFileCorpus(path), 2)
        assert calls == [1]
    else:
        got = tvocab.build_vocab(sents, 2)
    _same_vocab(got, jvocab.build_vocab(sents, 2))
    _same_vocab(got, jvocab.build_vocab(jcorpus.TokenFileCorpus(path), 2))
    assert tvocab.parallel_counting_profitable(1) is False


def test_read_corpus_matches(tmp_path):
    path = _corpus_file(tmp_path, seed=4)
    for lower in (False, True):
        assert (list(tvocab.read_corpus(path, lowercase=lower))
                == list(jvocab.read_corpus(path, lowercase=lower)))


def _files(d):
    return {name: (Path(d) / name).read_bytes()
            for name in ("tokens.bin", "offsets.bin", "meta.json")}


@pytest.mark.parametrize("unicode", [False, True], ids=["ascii", "unicode_space"])
@pytest.mark.parametrize("route", ["native", "python_file", "python_list"])
def test_encode_corpus_is_byte_identical(tmp_path, monkeypatch, route, unicode):
    """The port's native pass, its Python pass over the file and over a list write the
    bytes the JAX package's encode writes (a file with a no-break space makes the
    native passes of both packages hand over to Python)."""
    path = _corpus_file(tmp_path, seed=5, unicode=unicode)
    jv = jvocab.build_vocab(jcorpus.TokenFileCorpus(path), 2)
    tv = tvocab.build_vocab(tcorpus.TokenFileCorpus(path), 2)
    _same_vocab(tv, jv)
    jdirs = {}
    for name, use_native in (("native", True), ("python", False)):
        with monkeypatch.context() as m:
            if not use_native:
                m.setattr(jingest, "ingest_available", lambda: False)
            jdirs[name] = str(tmp_path / f"jax_{name}")
            jcorpus.encode_corpus(jcorpus.TokenFileCorpus(path), jv, jdirs[name], 12)
    assert _files(jdirs["native"]) == _files(jdirs["python"])
    out = str(tmp_path / "port")
    if route == "native":
        enc = tcorpus.encode_corpus(tcorpus.TokenFileCorpus(path), tv, out, 12)
    elif route == "python_file":
        monkeypatch.setattr(tingest, "ingest_available", lambda: False)
        enc = tcorpus.encode_corpus(tcorpus.TokenFileCorpus(path), tv, out, 12)
    else:
        sents = [line.split() for line in
                 Path(path).read_text(encoding="utf-8").splitlines()]
        enc = tcorpus.encode_corpus(sents, tv, out, 12)
    assert _files(out) == _files(jdirs["native"])
    meta = json.loads(Path(out, "meta.json").read_text())
    assert meta["vocab_fingerprint"] == tcorpus.vocab_fingerprint(tv)
    assert tcorpus.vocab_fingerprint(tv) == jcorpus.vocab_fingerprint(jv)
    jenc = jcorpus.EncodedCorpus(out)
    assert len(enc) == len(jenc) > 100 and enc.total_tokens == jenc.total_tokens
    for i in (0, 1, len(enc) // 2, -1):
        assert np.array_equal(enc[i], jenc[i])
    assert max(s.shape[0] for s in enc) == 12


def test_encoded_corpus_refuses_bad_input(tmp_path):
    path = _corpus_file(tmp_path, seed=6)
    tv = tvocab.build_vocab(tcorpus.TokenFileCorpus(path), 1)
    enc = tcorpus.encode_corpus(tcorpus.TokenFileCorpus(path), tv, str(tmp_path / "e"))
    with pytest.raises(TypeError):
        enc[0:2]
    with pytest.raises(IndexError):
        enc[len(enc)]
    with open(tmp_path / "e" / "tokens.bin", "ab") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(ValueError, match="corrupt"):
        tcorpus.EncodedCorpus(str(tmp_path / "e"))


def test_ingest_retries_injected_faults(tmp_path):
    """Two injected ingest faults are retried on the corpus open, the native passes
    and the encoded-corpus reads; a permanent error is not."""
    path = _corpus_file(tmp_path, seed=7)
    want = tvocab.build_vocab(tcorpus.TokenFileCorpus(path), 1)
    tfaults.configure(fail_ingest_first_n=2)
    got = tvocab.build_vocab(tcorpus.TokenFileCorpus(path), 1)
    _same_vocab(got, want)
    tfaults.configure(fail_ingest_first_n=2)
    enc = tcorpus.encode_corpus(tcorpus.TokenFileCorpus(path), got, str(tmp_path / "e"))
    tfaults.configure(fail_ingest_first_n=2)
    assert sum(1 for _ in tcorpus.TokenFileCorpus(path)) > 0
    tfaults.configure(fail_ingest_first_n=2)
    assert len(tcorpus.EncodedCorpus(str(tmp_path / "e"))) == len(enc)
    tfaults.configure(fail_ingest_first_n=9)
    with pytest.raises(tfaults.InjectedFault):
        list(tcorpus.TokenFileCorpus(path))
    tfaults.reset()
    with pytest.raises(FileNotFoundError):
        list(tcorpus.TokenFileCorpus(str(tmp_path / "missing.txt")))


def test_fit_from_the_encode_cache_trains_as_in_ram(tmp_path):
    path = _corpus_file(tmp_path, seed=8, n_sent=400)
    knobs = dict(vector_size=16, pairs_per_batch=256, negative_pool=32, window=3,
                 steps_per_dispatch=2, min_count=2, subsample_ratio=1e-3,
                 allow_unstable=True, seed=4)
    a = TWord2Vec(device="cpu", **knobs).fit(tcorpus.TokenFileCorpus(path),
                                             encode_cache_dir=str(tmp_path / "cache"))
    sents = [line.split() for line in Path(path).read_text().splitlines()]
    b = TWord2Vec(device="cpu", **knobs).fit(sents)
    assert torch.equal(a.syn0, b.syn0) and a.train_state.global_step >= 6
    assert Path(tmp_path, "cache", "meta.json").exists()


def _interrupted_jax_run(tmp_path, knobs, sents):
    """A JAX fit that keeps only its first periodic checkpoint, as if it died there,
    and the encode cache of its corpus."""
    jv = jvocab.build_vocab(sents, knobs["min_count"])
    enc = jcorpus.encode_corpus(sents, jv, str(tmp_path / "cache"))
    rng = np.random.default_rng(1)
    syn0 = rng.uniform(-0.03, 0.03, (jv.size, knobs["vector_size"])).astype(np.float32)
    syn1 = rng.normal(0, 0.01, syn0.shape).astype(np.float32)
    jt = JTrainer(JConfig(**knobs), jv, params=JPair(jnp.asarray(syn0), jnp.asarray(syn1)))
    ck = str(tmp_path / "ck")
    saved = []
    real_save = jt.save_checkpoint

    def save_once(path, *a, **kw):
        if not saved:
            real_save(path, *a, **kw)
            saved.append(jt.global_step)

    jt.save_checkpoint = save_once
    jt.fit(enc, checkpoint_path=ck, checkpoint_every_steps=4)
    assert len(saved) == 1 and 0 < saved[0] < jt.global_step - 2
    return ck, jv


@pytest.mark.parametrize("extra", [dict(negative_pool=64), dict(cbow=True)],
                         ids=["shared", "cbow_per_example"])
def test_resume_matches_the_jax_resume(tmp_path, extra):
    rng = np.random.default_rng(9)
    words = [f"w{i}" for i in range(200)]
    p = 1.0 / np.arange(1, 201)
    p /= p.sum()
    sents = [[words[j] for j in rng.choice(200, size=20, p=p)] for _ in range(400)]
    knobs = dict(vector_size=32, pairs_per_batch=256, window=4, steps_per_dispatch=4,
                 num_iterations=2, subsample_ratio=1e-3, allow_unstable=True,
                 learning_rate=0.025, seed=7, min_count=1, **extra)
    ck, jv = _interrupted_jax_run(tmp_path, knobs, sents)
    shutil.copytree(ck, tmp_path / "ck_port")
    cache = str(tmp_path / "cache")
    jm = JWord2Vec.resume(ck, sents, encode_cache_dir=cache)
    tm = TWord2Vec.resume(str(tmp_path / "ck_port"), sents, encode_cache_dir=cache,
                          device="cpu")
    assert tm.train_state.global_step == jm.train_state.global_step
    assert tm.train_state.finished and jm.train_state.finished
    assert tm.vocab.words == jv.words
    np.testing.assert_allclose(tm.syn0.numpy(), np.asarray(jm.syn0), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.syn1.numpy(), np.asarray(jm.syn1), atol=1e-5, rtol=0)


def test_resume_refuses_a_foreign_cache_and_a_lineage(tmp_path):
    rng = np.random.default_rng(3)
    sents = [[f"w{j}" for j in rng.integers(0, 80, 15)] for _ in range(400)]
    knobs = dict(vector_size=16, pairs_per_batch=128, negative_pool=32, window=3,
                 steps_per_dispatch=2, num_iterations=1, allow_unstable=True,
                 min_count=1, subsample_ratio=1e-3)
    ck, jv = _interrupted_jax_run(tmp_path, knobs, sents)
    other = [s + ["extra"] for s in sents]
    foreign = str(tmp_path / "foreign")
    tcorpus.encode_corpus(other, tvocab.build_vocab(other, 1), foreign)
    with pytest.raises(ValueError, match="different vocabulary") as e:
        TWord2Vec.resume(ck, sents, encode_cache_dir=foreign, device="cpu")
    assert "glint_word2vec_torch.continual.extend.extend_checkpoint" in str(e.value)
    data = jckpt.load_model(ck)
    lineage = str(tmp_path / "lineage")
    chain = [{"fingerprint": "x"}]
    jckpt.save_model(lineage, data["words"], data["counts"], data["syn0"], data["syn1"],
                     data["config"], data["train_state"],
                     extra_metadata={"vocab_lineage": chain})
    # a checkpoint with a lineage chain (continual training) resumes, and its saves
    # keep the chain
    grown = TWord2Vec.resume(lineage, sents, device="cpu")
    assert grown.train_state.finished
    assert tckpt.load_model_header(lineage)["vocab_lineage"] == chain
    # the same checkpoint without the chain resumes
    model = TWord2Vec.resume(ck, sents, encode_cache_dir=str(tmp_path / "cache"),
                             device="cpu")
    assert model.train_state.finished
    assert TConfig(**knobs).to_dict() == JConfig(**knobs).to_dict()
