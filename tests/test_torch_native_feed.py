"""The port's host data plane against the JAX package's: the native C++ pair generator,
the ordered worker pool, and the trainer's producer thread.

Integer streams are compared bit for bit. CPU fits with the producer on and off, at 1
and 4 feed workers, from either generator, must give the same parameters bit for bit:
the CPU step is deterministic, and every knob here changes only where and when the same
chunks are assembled. g++ builds the native generator here; the staging copies to the
card are held by tests/test_torch_kernel.py (``cuda``-marked), which skips without a
GPU."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data import native as tnative
from glint_word2vec_torch.data import pipeline as tp
from glint_word2vec_torch.data.vocab import Vocabulary as TVocab
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.train.trainer import NonFiniteParamsError, Trainer
from glint_word2vec_tpu.data import native as jnative
from glint_word2vec_tpu.data import pipeline as jp
from glint_word2vec_tpu.data.vocab import Vocabulary as JVocab


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


REPO = Path(__file__).resolve().parent.parent
FEED_THREADS = ("glint-batch-producer", "glint-feed-worker")


def _zipf_vocab(V=400, seed=0):
    counts = (1e5 / np.arange(1, V + 1)).astype(np.int64) + 1
    words = [f"w{i}" for i in range(V)]
    return (TVocab.from_words_and_counts(words, counts),
            JVocab.from_words_and_counts(words, counts))


def _sentences(V=400, n=1500, seed=1, max_len=70):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, rng.integers(1, max_len)).astype(np.int32)
            for _ in range(n)]


def _feed_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(FEED_THREADS) and t.is_alive()]


def _assert_no_feed_threads(timeout=10.0):
    deadline = time.monotonic() + timeout
    while _feed_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _feed_threads() == []


@pytest.fixture(scope="module")
def both_native():
    assert tnative.native_available(), "g++ must build the port's pair generator here"
    assert jnative.native_available()


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "symmetric"])
@pytest.mark.parametrize("window", [1, 5, 12])
def test_block_pairs_native_is_bit_identical(both_native, window, legacy, threads):
    """One slab through the port's native and numpy generators and the JAX package's
    two: the same (centers, contexts, clock, kept), bit for bit; the last cases with a
    position key past 2^32."""
    sents = _sentences(seed=window)
    tokens = np.concatenate(sents)
    lengths = np.asarray([s.shape[0] for s in sents], np.int64)
    rng = np.random.default_rng(window + threads)
    keep = rng.uniform(0.2, 1.0, 400).astype(np.float32)
    for token_base in (0, 12345, (1 << 32) + 777):
        args = (tokens, lengths, keep, window, 9, 2, 0, token_base, legacy)
        want = jp._block_pairs(*args)
        outs = {"port native": tnative.block_pairs_native(*args, n_threads=threads),
                "port numpy": tp._block_pairs(*args),
                "jax native": jnative.block_pairs_native(*args, n_threads=threads)}
        for name, got in outs.items():
            for g, w in zip(got[:3], want[:3]):
                assert g.dtype == w.dtype and np.array_equal(g, w), (name, token_base)
            assert got[3] == want[3], name
        if window > 1:
            assert want[0].shape[0] > 1000  # the slab emits pairs


def _batches(gen):
    return [{k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in vars(b).items()} for b in gen]


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_epoch_batches_match_the_jax_feed(both_native, backend, workers):
    tv, jv = _zipf_vocab()
    sents = _sentences()
    kw = dict(pairs_per_batch=512, window=5, subsample_ratio=1e-3, seed=7, iteration=2,
              block_words=6000, backend=backend, producer_workers=workers)
    got = _batches(tp.epoch_batches(sents, tv, **kw))
    _assert_same_batches(got, _batches(jp.epoch_batches(sents, jv, **kw)))
    # and the serial numpy stream of either package
    kw.update(backend="numpy", producer_workers=1)
    _assert_same_batches(got, _batches(jp.epoch_batches(sents, jv, **kw)))


@pytest.mark.parametrize("workers", [1, 4])
def test_epoch_batches_cbow_match_the_jax_feed(workers):
    tv, jv = _zipf_vocab()
    sents = _sentences(seed=3)
    kw = dict(pairs_per_batch=256, window=4, subsample_ratio=1e-3, seed=5, iteration=1,
              block_words=5000, producer_workers=workers)
    got = _batches(tp.epoch_batches_cbow(sents, tv, **kw))
    _assert_same_batches(got, _batches(jp.epoch_batches_cbow(sents, jv, **kw)))
    kw.update(producer_workers=1)
    _assert_same_batches(got, _batches(jp.epoch_batches_cbow(sents, jv, **kw)))


def test_backend_auto_takes_the_native_generator(both_native, monkeypatch):
    tv, _ = _zipf_vocab()
    calls = []
    real = tnative.block_pairs_native
    monkeypatch.setattr(tnative, "block_pairs_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    n = sum(1 for _ in tp.epoch_batches(_sentences(), tv, pairs_per_batch=512,
                                        window=5, block_words=6000))
    assert n > 5 and len(calls) > 1
    with pytest.raises(ValueError, match="backend"):
        next(tp.epoch_batches(_sentences(), tv, pairs_per_batch=512, window=5,
                              backend="cxx"))


def test_disable_native_forces_numpy():
    """``GLINT_DISABLE_NATIVE=1``: no library loads, ``auto`` feeds numpy, the trainer
    reports it, and asking for the native generator raises."""
    code = ("import os; from glint_word2vec_torch.data import native\n"
            "from glint_word2vec_torch import Vocabulary, Word2VecConfig\n"
            "from glint_word2vec_torch.train.trainer import Trainer\n"
            "assert not native.native_available() and native.loaded_library() is None\n"
            "v = Vocabulary.from_words_and_counts(['a', 'b'], [3, 2])\n"
            "cfg = Word2VecConfig(vector_size=8, pairs_per_batch=64, min_count=1)\n"
            "assert Trainer(cfg, v, device='cpu').feed_backend == 'numpy'\n"
            "try:\n"
            "    Trainer(cfg, v, device='cpu', feed_backend='native')\n"
            "except RuntimeError:\n"
            "    print('refused')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), GLINT_DISABLE_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0 and r.stdout.strip() == "refused", r.stdout + r.stderr


def test_ordered_pool_map_keeps_order_at_any_worker_count():
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.004, 60)

    def job(i):
        time.sleep(delays[i])  # later jobs often finish first
        return i * i

    for workers in (1, 2, 4, 16):
        assert list(tp.ordered_pool_map(job, range(60), workers)) == [
            i * i for i in range(60)]
    _assert_no_feed_threads()


def test_ordered_pool_map_relays_exceptions():
    def job(i):
        if i == 7:
            raise KeyError("job 7")
        return i

    got = []
    with pytest.raises(KeyError, match="job 7"):
        for r in tp.ordered_pool_map(job, range(30), 4):
            got.append(r)
    assert got == list(range(7))
    _assert_no_feed_threads()


def test_ordered_pool_map_shuts_down_when_abandoned():
    started = []

    def jobs():
        for i in range(10_000):
            started.append(i)
            yield i

    gen = tp.ordered_pool_map(lambda i: time.sleep(0.002) or i, jobs(), 4, ahead=2)
    assert [next(gen) for _ in range(5)] == list(range(5))
    gen.close()
    _assert_no_feed_threads()
    assert len(started) <= 5 + 4 + 2  # bounded look-ahead, and nothing after close


def _fit_corpus(seed=4, n_words=300, n_sent=200, length=20):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    sents = [[words[j] for j in rng.choice(n_words, size=length, p=p)]
             for _ in range(n_sent)]
    vocab = t_build_vocab(sents, 1)
    return vocab, tp.encode_sentences(sents, vocab)


@pytest.mark.parametrize("path,extra", [
    ("shared", dict(negative_pool=64)), ("per_pair", dict()),
    ("cbow_pool", dict(cbow=True, negative_pool=64)), ("cbow_per_example", dict(cbow=True)),
])
def test_cpu_fits_are_bit_identical_across_the_feed_knobs(path, extra):
    vocab, enc = _fit_corpus()
    base = dict(vector_size=16, pairs_per_batch=256, steps_per_dispatch=2,
                num_iterations=2, subsample_ratio=1e-3, allow_unstable=True, seed=5,
                min_count=1, window=3, heartbeat_every_steps=3, **extra)
    rng = np.random.default_rng(2)
    init = (rng.uniform(-0.03, 0.03, (vocab.size, 16)).astype(np.float32),
            rng.normal(0, 0.01, (vocab.size, 16)).astype(np.float32))
    backends = ("numpy",) if extra.get("cbow") else ("numpy", "native")
    runs = {}
    for prefetch in (0, 8):
        for workers in (1, 4):
            for backend in backends:
                t = Trainer(TConfig(prefetch_chunks=prefetch, producer_workers=workers,
                                    **base), vocab, params=init, device="cpu",
                            feed_backend=backend)
                t.fit(enc)
                assert t.feed_backend == backend
                assert t.host_wait_time > 0 and t.dispatch_time > 0
                runs[(prefetch, workers, backend)] = (
                    t.params, t.global_step, t.pairs_trained,
                    [(h.global_step, h.alpha, h.loss) for h in t.heartbeats])
    ref = runs[(0, 1, "numpy")]
    assert ref[1] >= 8  # >= 4 chunks
    for key, (params, steps, pairs, hb) in runs.items():
        assert (steps, pairs, hb) == ref[1:], key
        assert torch.equal(params.syn0, ref[0].syn0), key
        assert torch.equal(params.syn1, ref[0].syn1), key
    _assert_no_feed_threads()


def test_auto_feed_resolves_as_the_jax_package():
    vocab, _ = _fit_corpus(n_sent=20)
    cfg = TConfig(vector_size=8, pairs_per_batch=256, min_count=1)
    assert Trainer(cfg, vocab, device="cpu").feed_backend == "native"
    cbow = TConfig(vector_size=8, pairs_per_batch=256, min_count=1, cbow=True)
    assert Trainer(cbow, vocab, device="cpu").feed_backend == "numpy"
    with pytest.raises(ValueError, match="no native CBOW"):
        Trainer(cbow, vocab, device="cpu", feed_backend="native")
    with pytest.raises(ValueError, match="backend must be one of"):
        Trainer(cfg, vocab, device="cpu", feed_backend="gpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        Trainer(cbow, vocab, device="cpu", feed_backend="gpu")


@pytest.mark.parametrize("fault", ["step", "nonfinite", "checkpoint"])
@pytest.mark.parametrize("workers", [1, 4])
def test_producer_closes_after_a_raised_step(tmp_path, monkeypatch, fault, workers):
    """A step that raises, a NaN caught by the ``halt`` guard, and a checkpoint save
    that fails each end the fit with their error, and no feed thread is left."""
    vocab, enc = _fit_corpus(n_sent=400)
    cfg = TConfig(vector_size=16, pairs_per_batch=128, negative_pool=32,
                  steps_per_dispatch=2, num_iterations=3, subsample_ratio=1e-3,
                  allow_unstable=True, min_count=1, window=3, heartbeat_every_steps=2,
                  prefetch_chunks=2, producer_workers=workers)
    t = Trainer(cfg, vocab, device="cpu")
    real_run = t._run_chunk
    calls = []

    def run_chunk(chunk):
        calls.append(1)
        out = real_run(chunk)
        if len(calls) == 3:
            if fault == "step":
                raise RuntimeError("step failed")
            if fault == "nonfinite":
                t.params.syn0[1, 1] = float("nan")
        return out

    def failing_save(path):
        raise OSError("disk gone")

    monkeypatch.setattr(t, "_run_chunk", run_chunk)
    kwargs = {}
    if fault == "checkpoint":
        monkeypatch.setattr(t, "save_checkpoint", failing_save)
        kwargs = dict(checkpoint_path=str(tmp_path / "ck"), checkpoint_every_steps=6)
    want = {"step": RuntimeError, "nonfinite": NonFiniteParamsError,
            "checkpoint": OSError}[fault]
    with pytest.raises(want):
        t.fit(enc, **kwargs)
    assert 3 <= len(calls) < 20  # stopped early, with the producer ahead of it
    _assert_no_feed_threads()
