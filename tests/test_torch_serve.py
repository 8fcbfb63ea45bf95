"""The port's serving tier (glint_word2vec_torch/serve/) on the CPU, held against the
JAX package's (glint_word2vec_tpu/serve/):

- the cases of tests/test_serve.py, each on the port with ``device="cpu"``: the
  micro-batcher, the decorrelated-jitter backoff, the IVF index, the model's ANN
  entry, the lease-counted handle, and the assembled EmbeddingService (exact arm, hot
  reload, watcher, telemetry, gauges);
- index equality: the IVF build and both quantized builds equal the JAX package's bit
  for bit on the same seeded matrix, and ``search`` / ``measure_recall`` agree;
- model routing: ``find_synonyms_batch(ann=True)`` gives the same lists in both;
- cross-package serving: a checkpoint written by either package's trainer is served
  by the other's service with the same synonyms;
- the shared helpers (``serve_prometheus_text``, ``decorrelated_jitter``) and the
  trainer's ``publish`` record;
- the JSON-lines CLI (``python -m glint_word2vec_torch.serve_checkpoint``) and the
  bench (``python -m glint_word2vec_torch.servebench``) as subprocesses.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import Vocabulary, build_vocab
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.obs.schema import validate_file, validate_record
from glint_word2vec_torch.obs.statusd import serve_prometheus_text
from glint_word2vec_torch.serve import (
    BatchingScheduler,
    EmbeddingService,
    ServerOverloaded,
    ServiceClosed,
    ServingHandle,
    build_ivf,
    decorrelated_jitter,
    load_with_retry,
)
from glint_word2vec_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"


def clustered_matrix(v=3000, d=32, clusters=40, seed=0, noise=0.35):
    """tests/test_serve.py's synthetic geometry: tight unit-centroid cells."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((clusters, d)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    return (cents[rng.integers(0, clusters, v)]
            + noise * rng.standard_normal((v, d)).astype(np.float32)
            / np.sqrt(d))


def make_model(v=3000, d=32, seed=0):
    m = clustered_matrix(v, d, seed=seed)
    vocab = Vocabulary.from_words_and_counts(
        [f"w{i}" for i in range(v)], np.ones(v, np.int64))
    return Word2VecModel(vocab, m, device=CPU)


# -- batcher ---------------------------------------------------------------------------


def test_batcher_coalesces_concurrent_submits():
    sizes = []

    def handler(batch):
        sizes.append(len(batch))
        time.sleep(0.005)  # hold the worker so submitters pile up
        return [x * 2 for x in batch]

    b = BatchingScheduler(handler, max_batch=16, max_delay_ms=5.0,
                          max_queue=128).start()
    try:
        results = {}

        def client(i):
            results[i] = b.submit(i)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == {i: i * 2 for i in range(48)}
        assert sum(sizes) == 48
        assert max(sizes) > 1, f"no coalescing happened ({sizes})"
        st = b.stats()
        assert st["submitted"] == st["completed"] == 48
        assert st["errors"] == st["refused"] == 0
        assert st["batches"] == len(sizes)
        assert st["latency_ms"]["n"] == 48
    finally:
        b.stop()


def test_batcher_deadline_flushes_lone_request():
    b = BatchingScheduler(lambda batch: [len(batch)], max_batch=1024,
                          max_delay_ms=20.0, max_queue=8).start()
    try:
        t0 = time.monotonic()
        assert b.submit("x") == 1  # a lone request must not wait forever
        assert time.monotonic() - t0 < 5.0
    finally:
        b.stop()


def test_batcher_backpressure_refuses_fast():
    gate = threading.Event()

    def handler(batch):
        gate.wait(30)
        return batch

    b = BatchingScheduler(handler, max_batch=1, max_delay_ms=0.0,
                          max_queue=4).start()
    try:
        threads = []
        # 1 in flight inside the handler + 4 filling the queue
        for _ in range(5):
            t = threading.Thread(target=lambda: b.submit(1))
            t.start()
            threads.append(t)
        deadline = time.monotonic() + 5
        while b.stats()["queue_depth"] < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        t0 = time.monotonic()
        with pytest.raises(ServerOverloaded):
            b.submit(2)
        assert time.monotonic() - t0 < 1.0, "refusal was not fast"
        assert b.stats()["refused"] == 1
        gate.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        gate.set()
        b.stop()


def test_batcher_per_request_errors_do_not_fail_the_batch():
    def handler(batch):
        return [ValueError(f"bad {x}") if x < 0 else x for x in batch]

    b = BatchingScheduler(handler, max_batch=8, max_delay_ms=2.0,
                          max_queue=32).start()
    try:
        assert b.submit(7) == 7
        with pytest.raises(ValueError, match="bad -3"):
            b.submit(-3)
        assert b.submit(9) == 9
        st = b.stats()
        assert st["errors"] == 1 and st["completed"] == 2
    finally:
        b.stop()


def test_batcher_handler_exception_reaches_every_caller():
    def handler(batch):
        raise RuntimeError("kaboom")

    b = BatchingScheduler(handler, max_batch=4, max_delay_ms=1.0,
                          max_queue=8).start()
    try:
        with pytest.raises(RuntimeError, match="kaboom"):
            b.submit(1)
    finally:
        b.stop()
    with pytest.raises(RuntimeError):
        b.submit(2)  # a stopped scheduler refuses new work


def test_batcher_submit_during_and_after_shutdown_raises_typed():
    """A submit racing stop() gets the typed ServiceClosed (a RuntimeError), during
    the drain and after it; the admitted request is still served."""
    gate = threading.Event()

    def handler(batch):
        gate.wait(30)
        return batch

    b = BatchingScheduler(handler, max_batch=1, max_delay_ms=0.0,
                          max_queue=8).start()
    admitted = b.submit_async(1)  # in flight when stop() lands
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    try:
        deadline = time.monotonic() + 5
        while not b._stopping and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(ServiceClosed):
            b.submit(2)
        gate.set()
        stopper.join(timeout=30)
        with pytest.raises(ServiceClosed):
            b.submit(3)
        assert b.wait(admitted, timeout=5) == 1
    finally:
        gate.set()
        stopper.join(timeout=5)


def test_overload_carries_retry_after_hint():
    """ServerOverloaded carries retry_after_s = queued batches x the observed (EWMA)
    batch service time."""
    gate = threading.Event()
    first_done = threading.Event()

    def handler(batch):
        if first_done.is_set():
            gate.wait(30)
        else:
            time.sleep(0.05)  # a measured first batch: EWMA ~= 50 ms
            first_done.set()
        return batch

    b = BatchingScheduler(handler, max_batch=1, max_delay_ms=0.0,
                          max_queue=2).start()
    try:
        assert b.submit(0) == 0  # establishes the EWMA
        assert abs(b.stats()["batch_service_s"] - 0.05) < 0.04
        threads = [threading.Thread(target=lambda: b.submit(1)) for _ in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5
        while b.stats()["queue_depth"] < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(ServerOverloaded) as ei:
            b.submit(9)
        hint = ei.value.retry_after_s
        assert hint is not None and hint > 0
        assert hint < 2.0, f"hint implausibly large: {hint}"
        gate.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        gate.set()
        b.stop()


def test_overload_hint_is_none_before_first_batch():
    gate = threading.Event()
    b = BatchingScheduler(lambda batch: (gate.wait(30), batch)[1],
                          max_batch=1, max_delay_ms=0.0, max_queue=1).start()
    try:
        t = threading.Thread(target=lambda: b.submit(1))
        t.start()
        t2 = threading.Thread(target=lambda: b.submit(2))
        t2.start()
        deadline = time.monotonic() + 5
        while b.stats()["queue_depth"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(ServerOverloaded) as ei:
            b.submit(3)
        assert ei.value.retry_after_s is None  # no measured batch yet
        gate.set()
        t.join(timeout=30)
        t2.join(timeout=30)
    finally:
        gate.set()
        b.stop()


# -- decorrelated-jitter backoff -------------------------------------------------------


def test_decorrelated_jitter_seeded_sequence():
    a_gen = decorrelated_jitter(0.25, 2.0, np.random.default_rng(3))
    a = [next(a_gen) for _ in range(6)]
    b_gen = decorrelated_jitter(0.25, 2.0, np.random.default_rng(3))
    b = [next(b_gen) for _ in range(6)]
    assert a == b, "seeded jitter must be reproducible"
    c_gen = decorrelated_jitter(0.25, 2.0, np.random.default_rng(4))
    c = [next(c_gen) for _ in range(6)]
    assert a != c, "different seeds must decorrelate"
    for d in a + c:
        assert 0.25 <= d <= 2.0
    assert len(set(a)) > 1


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_decorrelated_jitter_matches_the_jax_package(seed):
    from glint_word2vec_tpu.serve.reload import decorrelated_jitter as jax_jitter
    got = decorrelated_jitter(0.25, 2.0, np.random.default_rng(seed))
    want = jax_jitter(0.25, 2.0, np.random.default_rng(seed))
    assert [next(got) for _ in range(12)] == [next(want) for _ in range(12)]


def test_load_with_retry_backoff_uses_seeded_jitter(tmp_path, monkeypatch):
    slept = []
    monkeypatch.setattr("glint_word2vec_torch.serve.reload.time.sleep", slept.append)
    with pytest.raises(FileNotFoundError):
        load_with_retry(str(tmp_path / "never-published"), attempts=5, delay=0.25,
                        max_delay=2.0, rng=np.random.default_rng(11), device=CPU)
    want_gen = decorrelated_jitter(0.25, 2.0, np.random.default_rng(11))
    want = [next(want_gen) for _ in range(4)]  # attempts-1 sleeps
    assert slept == want
    assert len(set(slept)) > 1


# -- ANN index -------------------------------------------------------------------------


def test_ivf_build_is_deterministic():
    m = clustered_matrix()
    a = build_ivf(m, seed=3, measure_recall=False)
    b = build_ivf(m, seed=3, measure_recall=False)
    np.testing.assert_array_equal(a._centroids, b._centroids)
    np.testing.assert_array_equal(a._ids, b._ids)
    c = build_ivf(m, seed=4, measure_recall=False)
    assert not np.array_equal(a._centroids, c._centroids)


def test_ivf_full_probe_matches_exact_oracle():
    m = clustered_matrix(v=800, d=16)
    idx = build_ivf(m, seed=0, measure_recall=False)
    normed = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)
    q = normed[:8]
    s, ids = idx.search(q, 5, nprobe=idx.num_centroids)
    exact = q @ normed.T
    for r in range(8):
        want = np.argsort(-exact[r], kind="stable")[:5]
        assert set(ids[r]) == set(want), "full probe must equal exact scan"


def test_ivf_recall_on_clustered_geometry():
    idx = build_ivf(clustered_matrix(v=5000, d=32), seed=0)
    assert idx.stats["recall_at_10"] >= 0.95
    full = idx.measure_recall(np.arange(64), k=10, nprobe=idx.num_centroids)
    assert full == 1.0


def test_ivf_small_cells_still_fill_topk():
    m = clustered_matrix(v=30, d=8, clusters=5)
    idx = build_ivf(m, seed=0, measure_recall=False)
    s, ids = idx.search(m[:4], 6, nprobe=1)
    assert (ids >= 0).all(), f"short result at tiny cells: {ids}"


def test_ivf_zero_norm_rows_never_surface():
    m = clustered_matrix(v=200, d=16)
    m[50] = 0.0
    idx = build_ivf(m, seed=0, measure_recall=False)
    _, ids = idx.search(m[:16], 10, nprobe=idx.num_centroids)
    assert 50 not in set(ids.ravel().tolist())


def _storage_arrays(ix):
    st = ix._storage
    if st.kind == "f32":
        return {"packed": st._packed}
    if st.kind == "int8":
        return {"codes": st._codes, "scales": st._scales}
    return {"codes": st._codes, "codebooks": st._codebooks}


@pytest.mark.parametrize("quant", ["f32", "int8", "pq"])
def test_ivf_builds_bit_identical_to_the_jax_package(quant):
    """Same numpy matrix and seed: the same centroids, offsets, packed order, codes,
    scales and codebooks, bit for bit, and the same stats (build time aside)."""
    from glint_word2vec_tpu.serve.ann import build_ivf as jax_build_ivf
    m = clustered_matrix(v=2500, d=24, seed=21)
    m[7] = 0.0  # a zero row takes the same path in both
    kw = dict(seed=5, quant=quant, recall_floor=0.0)
    mine, ref = build_ivf(m, **kw), jax_build_ivf(m, **kw)
    for name in ("_centroids", "_offsets", "_ids", "_row_pos"):
        got, want = getattr(mine, name), getattr(ref, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name, arr in _storage_arrays(ref).items():
        got = _storage_arrays(mine)[name]
        assert got.dtype == arr.dtype and np.array_equal(got, arr), name
    drop = ("build_seconds",)
    assert ({k: v for k, v in mine.stats.items() if k not in drop}
            == {k: v for k, v in ref.stats.items() if k not in drop})


@pytest.mark.parametrize("quant", ["f32", "int8", "pq"])
def test_search_and_recall_match_the_jax_package(quant):
    from glint_word2vec_tpu.serve.ann import build_ivf as jax_build_ivf
    m = clustered_matrix(v=2000, d=16, seed=22)
    kw = dict(seed=1, quant=quant, recall_floor=0.0, measure_recall=False)
    mine, ref = build_ivf(m, **kw), jax_build_ivf(m, **kw)
    q = np.random.default_rng(3).standard_normal((12, 16)).astype(np.float32)
    for nprobe in (None, 1, mine.num_centroids):
        s, i = mine.search(q, 10, nprobe)
        rs, ri = ref.search(q, 10, nprobe)
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(s, rs, atol=1e-6)
    rows = np.arange(0, 2000, 37)
    assert mine.measure_recall(rows, k=10) == ref.measure_recall(rows, k=10)


# -- model ANN entry -------------------------------------------------------------------


def test_model_ann_routing_and_parity():
    model = make_model()
    with pytest.raises(RuntimeError, match="no index attached"):
        model.find_synonyms_batch(["w0"], 5, ann=True)
    index = build_ivf(model.syn0.cpu().numpy(), seed=0)
    model.attach_ann(index)
    assert model.ann is index
    exact = model.find_synonyms_batch(["w0", "w7"], 8)
    ann_full = model.find_synonyms_batch(["w0", "w7"], 8, ann=True,
                                         nprobe=index.num_centroids)
    assert ([[w for w, _ in row] for row in ann_full]
            == [[w for w, _ in row] for row in exact])
    for row_a, row_e in zip(ann_full, exact):
        np.testing.assert_allclose([s for _, s in row_a], [s for _, s in row_e],
                                   rtol=1e-5)
    ann = model.find_synonyms_batch(["w0"], 10, ann=True)
    assert len(ann[0]) == 10 and "w0" not in [w for w, _ in ann[0]]
    with pytest.raises(ValueError, match="stale index"):
        model.attach_ann(build_ivf(clustered_matrix(v=100, d=32), seed=0,
                                   measure_recall=False))
    model.stop()
    assert model.ann is None


@pytest.mark.parametrize("quant", ["f32", "int8", "pq"])
def test_model_ann_lists_match_the_jax_package(quant):
    """The parameters cross by interop.params_from_numpy; each package builds its own
    index from its model's matrix; ann=True gives the same lists (words equal, scores
    within 1e-6) for word and vector queries."""
    from glint_word2vec_tpu.data.vocab import Vocabulary as JVocab
    from glint_word2vec_tpu.models.word2vec import Word2VecModel as JModel
    from glint_word2vec_tpu.serve.ann import build_ivf as jax_build_ivf

    from glint_word2vec_torch.interop import params_from_numpy

    v, d = 1500, 24
    m = clustered_matrix(v, d, seed=23)
    words = [f"w{i}" for i in range(v)]
    counts = np.ones(v, np.int64)
    jmodel = JModel(JVocab.from_words_and_counts(words, counts), jnp.asarray(m))
    tmodel = Word2VecModel(Vocabulary.from_words_and_counts(words, counts),
                           params_from_numpy(m, m, device=CPU).syn0, device=CPU)
    kw = dict(seed=2, quant=quant, recall_floor=0.0)
    jmodel.attach_ann(jax_build_ivf(np.asarray(jmodel.syn0), **kw))
    tmodel.attach_ann(build_ivf(tmodel.syn0.cpu().numpy(), **kw))
    queries = ["w0", "w5", "w1499", m[11] * 3.0, m[40] - m[41]]
    for nprobe in (None, 2):
        got = tmodel.find_synonyms_batch(queries, 7, ann=True, nprobe=nprobe)
        want = jmodel.find_synonyms_batch(queries, 7, ann=True, nprobe=nprobe)
        assert [[w for w, _ in r] for r in got] == [[w for w, _ in r] for r in want]
        for rg, rw in zip(got, want):
            np.testing.assert_allclose([s for _, s in rg], [s for _, s in rw],
                                       atol=1e-6)


# -- serving handle --------------------------------------------------------------------


def test_handle_swap_drains_leases_before_release():
    old, new = make_model(v=100, d=8, seed=1), make_model(v=100, d=8, seed=2)
    h = ServingHandle(old)
    with h.lease() as (m, _):
        assert m is old
        h.swap(new)
        # the in-flight lease still serves the OLD model, un-released
        assert m.num_words == 100 and not m._stopped
        assert h.models_released == 0
        with h.lease() as (m2, _):
            assert m2 is new
    assert h.models_released == 1 and old._stopped and not new._stopped
    h.stop()
    assert new._stopped and h.models_released == 2
    with pytest.raises(RuntimeError):
        with h.lease():
            pass


# -- the assembled service -------------------------------------------------------------


def _tiny_corpus(seed, n=120):
    rng = np.random.default_rng(seed)
    return [[f"w{j}" for j in rng.integers(0, 40, 12)] for _ in range(n)]


def _tiny_config(seed, **kw):
    return dict(vector_size=16, min_count=1, pairs_per_batch=128, num_iterations=1,
                window=2, negatives=3, negative_pool=8, steps_per_dispatch=2,
                seed=seed, **kw)


def _train_tiny(tmp_path, seed=9, n=120, **kw):
    sents = _tiny_corpus(seed, n)
    vocab = build_vocab(sents, min_count=1)
    trainer = Trainer(Word2VecConfig(**_tiny_config(seed, **kw)), vocab, device=CPU)
    trainer.fit(encode_sentences(sents, vocab, 1000))
    ck = str(tmp_path / "model")
    trainer.save_checkpoint(ck)
    return trainer, vocab, ck, sents


def test_service_exact_arm_matches_model(tmp_path):
    trainer, vocab, ck, _ = _train_tiny(tmp_path)
    local = Word2VecModel.load(ck, device=CPU)
    want = local.find_synonyms("w0", 5)
    svc = EmbeddingService(checkpoint=ck, ann=False, device=CPU)
    try:
        got = svc.synonyms("w0", 5)
        assert [w for w, _ in got] == [w for w, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=1e-5)
        np.testing.assert_allclose(svc.vector("w1"), local.transform("w1"),
                                   rtol=1e-6)
        batch = svc.synonyms_batch(["w0", "w1", "w2"], 5)
        assert len(batch) == 3 and all(len(r) == 5 for r in batch)
        with pytest.raises(KeyError, match="not in vocabulary"):
            svc.synonyms("nope", 5)
        info = svc.info()
        assert info["num_words"] == vocab.size and info["finished"]
    finally:
        svc.close()
    local.stop()


def test_service_reload_and_telemetry(tmp_path):
    trainer, vocab, ck, sents = _train_tiny(tmp_path)
    log = str(tmp_path / "serve.jsonl")
    svc = EmbeddingService(checkpoint=ck, ann=True, telemetry_path=log, device=CPU)
    try:
        assert len(svc.synonyms("w0", 5)) == 5
        trainer.fit(encode_sentences(sents, vocab, 1000))
        trainer.save_checkpoint(ck)
        model = svc.reload_now()
        assert model.num_words == vocab.size
        assert svc.stats()["reloads"] == 1
        assert svc.stats()["models_released"] == 1  # old tensors gone
        assert len(svc.synonyms("w0", 5)) == 5
        svc.emit_stats()
    finally:
        svc.close()
    summary = validate_file(log)
    assert summary["ok"], summary["errors"][:3]
    kinds = summary["kinds"]
    assert kinds.get("serve_start") == 1
    assert kinds.get("serve_reload") == 1
    assert kinds.get("serve_stats") == 1
    assert kinds.get("serve_end") == 1
    from glint_word2vec_tpu.obs.schema import validate_file as jax_validate_file
    assert jax_validate_file(log)["ok"]
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    start = next(r for r in recs if r["kind"] == "serve_start")
    assert start["ann"]["centroids"] >= 1


def test_service_watcher_hot_reloads(tmp_path):
    trainer, vocab, ck, sents = _train_tiny(tmp_path, seed=11)
    svc = EmbeddingService(checkpoint=ck, ann=True, watch=True, reload_poll_s=0.05,
                           device=CPU)
    try:
        trainer.fit(encode_sentences(sents, vocab, 1000))
        trainer.save_checkpoint(ck)  # the publish signal
        deadline = time.monotonic() + 10
        while svc.stats()["reloads"] < 1 and time.monotonic() < deadline:
            assert len(svc.synonyms("w0", 5)) == 5  # serving never stops
            time.sleep(0.02)
        assert svc.stats()["reloads"] >= 1, "watcher never saw the publish"
        assert svc.stats()["models_released"] >= 1
        want = Word2VecModel.load(ck, device=CPU).find_synonyms("w0", 5)
        assert ([w for w, _ in svc.synonyms("w0", 5)] == [w for w, _ in want]
                or svc.info()["ann"] is not None)
    finally:
        svc.close()


def test_watcher_sees_publish_landing_during_boot_load(tmp_path, monkeypatch):
    """The publish signature is captured BEFORE the initial load: a publish landing
    inside that window still fires the watcher."""
    trainer, vocab, ck, sents = _train_tiny(tmp_path, seed=13)
    import glint_word2vec_torch.serve.service as service_mod
    real_load = service_mod.load_with_retry

    def slow_load_with_publish(path, plan=None, **kw):
        model = real_load(path, plan=plan, **kw)
        trainer.save_checkpoint(ck)  # the trainer publishes during the boot load
        return model

    monkeypatch.setattr(service_mod, "load_with_retry", slow_load_with_publish)
    svc = EmbeddingService(checkpoint=ck, ann=False, watch=True, reload_poll_s=0.05,
                           device=CPU)
    monkeypatch.setattr(service_mod, "load_with_retry", real_load)
    try:
        deadline = time.monotonic() + 10
        while svc.stats()["reloads"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.stats()["reloads"] >= 1, "publish during the boot load was swallowed"
    finally:
        svc.close()


def test_watcher_survives_delete_then_recreate(tmp_path):
    trainer, vocab, ck, sents = _train_tiny(tmp_path, seed=17)
    svc = EmbeddingService(checkpoint=ck, ann=False, watch=True, reload_poll_s=0.05,
                           device=CPU)
    try:
        assert len(svc.synonyms("w0", 5)) == 5
        shutil.rmtree(ck)  # the publish path vanishes mid-watch
        time.sleep(0.3)
        assert len(svc.synonyms("w0", 5)) == 5
        assert svc.stats()["reloads"] == 0
        trainer.save_checkpoint(ck)  # recreated: a fresh publish identity
        deadline = time.monotonic() + 15
        while svc.stats()["reloads"] < 1 and time.monotonic() < deadline:
            assert len(svc.synonyms("w0", 5)) == 5
            time.sleep(0.02)
        assert svc.stats()["reloads"] >= 1
        assert len(svc.synonyms("w0", 5)) == 5
    finally:
        svc.close()


def test_watcher_survives_torn_publish_metadata_before_arrays(tmp_path):
    """metadata.json appearing BEFORE its arrays (a non-atomic copy) ends in a served
    model, never a crash and never a torn model served."""
    trainer, vocab, ck, sents = _train_tiny(tmp_path, seed=19)
    trainer.fit(encode_sentences(sents, vocab, 1000))
    staging = str(tmp_path / "staged")
    trainer.save_checkpoint(staging)  # a complete, newer publish to tear apart
    want_new = Word2VecModel.load(staging, device=CPU).find_synonyms("w0", 5)
    svc = EmbeddingService(checkpoint=ck, ann=False, watch=True, reload_poll_s=0.05,
                           device=CPU)
    try:
        want_old = svc.synonyms("w0", 5)
        shutil.rmtree(ck)
        os.makedirs(ck)
        for f in ("metadata.json", "words", "counts.npy"):
            shutil.copy2(os.path.join(staging, f), os.path.join(ck, f))
        time.sleep(0.4)  # the watcher fires into the torn window
        assert svc.synonyms("w0", 5) == want_old  # the old model still serves
        for f in ("syn0.npy", "syn1.npy"):
            shutil.copy2(os.path.join(staging, f), os.path.join(ck, f))
        deadline = time.monotonic() + 30
        while svc.stats()["reloads"] < 1 and time.monotonic() < deadline:
            assert svc.synonyms("w0", 5) in (want_old, want_new)
            time.sleep(0.02)
        assert svc.stats()["reloads"] >= 1, "torn publish never healed"
        got = svc.synonyms("w0", 5)
        assert [w for w, _ in got] == [w for w, _ in want_new]
    finally:
        svc.close()


def test_stats_carry_served_publish_generation(tmp_path):
    trainer, vocab, ck, sents = _train_tiny(tmp_path, seed=23)
    svc = EmbeddingService(checkpoint=ck, ann=False, device=CPU)
    try:
        sig0 = svc.stats()["publish_sig"]
        assert sig0
        trainer.save_checkpoint(ck)
        svc.reload_now()
        sig1 = svc.stats()["publish_sig"]
        assert sig1 and sig1 != sig0
    finally:
        svc.close()
    mem = EmbeddingService(model=make_model(v=50, d=8), ann=False)
    try:
        assert mem.stats()["publish_sig"] is None
    finally:
        mem.close()


def test_failed_init_does_not_leak_threads_or_model():
    import socket
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    model = make_model(v=100, d=8)
    try:
        with pytest.raises(OSError):
            EmbeddingService(model=model, ann=False, status_port=port)
        deadline = time.monotonic() + 5
        while (any(t.name == "glint-serve-batcher" for t in threading.enumerate())
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert not any(t.name == "glint-serve-batcher"
                       for t in threading.enumerate())
        assert not model._stopped  # a caller-owned model stays alive
        with pytest.raises(ValueError, match="watch=True needs"):
            EmbeddingService(model=model, watch=True)
    finally:
        blocker.close()
        model.stop()


def test_serve_record_kinds_validate():
    base = {"schema": 1, "t": 0.0}
    ok = [
        {**base, "kind": "serve_start", "checkpoint": "/ck",
         "vocab_size": 10, "vector_size": 4, "ann": {"centroids": 2}},
        {**base, "kind": "serve_reload", "vocab_size": 10, "reloads": 1,
         "load_seconds": 0.5},
        {**base, "kind": "serve_stats", "submitted": 5, "refused": 0,
         "batches": 2, "queue_depth": 0, "reloads": 1,
         "latency_ms": {"p50": 1.0}, "occupancy_mean": 2.5},
        {**base, "kind": "serve_end", "submitted": 5, "refused": 0, "reloads": 1},
    ]
    for rec in ok:
        assert validate_record(rec) == [], rec["kind"]
    assert validate_record({**base, "kind": "serve_stats", "submitted": 5})
    assert validate_record({**base, "kind": "serve_start", "checkpoint": "/ck",
                            "vocab_size": 10, "vector_size": 4, "ann": "x"})


_SNAP = {"status": "serving", "submitted": 12, "refused": 1, "completed": 11,
         "errors": 0, "batches": 4, "queue_depth": 2, "occupancy_mean": 3.0,
         "reloads": 2, "models_released": 2, "vocab_size": 1000,
         "load_seconds": 0.4,
         "latency_ms": {"p50": 1.5, "p95": 3.0, "p99": 4.5, "n": 11},
         "ann": {"recall_at_10": 0.99, "nprobe": 8, "centroids": 64,
                 "build_seconds": 0.2, "index_bytes": 123456,
                 "bytes_per_vector": 36.5}}


def test_serve_prometheus_rendering():
    text = serve_prometheus_text(_SNAP)
    for needle in ("glint_serve_up 1", "glint_serve_submitted_total 12",
                   "glint_serve_refused_total 1", "glint_serve_queue_depth 2",
                   'glint_serve_latency_ms{quantile="p99"} 4.5',
                   "glint_serve_ann_recall_at_10 0.99",
                   "glint_serve_reloads_total 2"):
        assert needle in text, f"{needle!r} missing from:\n{text}"
    assert "glint_serve_up 0" in serve_prometheus_text({"status": "closed"})


@pytest.mark.parametrize("snap", [_SNAP, {"status": "closed"},
                                  {**_SNAP, "ann": None, "latency_ms": None}],
                         ids=["serving", "closed", "no-index"])
def test_serve_prometheus_text_matches_the_jax_package(snap):
    from glint_word2vec_tpu.obs.statusd import serve_prometheus_text as jax_text
    assert serve_prometheus_text(snap) == jax_text(snap)


def test_service_status_endpoint_serves_glint_serve_gauges():
    import urllib.request
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    svc = EmbeddingService(model=make_model(v=300, d=8), ann=True, status_port=port)
    try:
        svc.synonyms("w0", 3)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "glint_serve_up 1" in text and "glint_serve_ann_centroids" in text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/status.json",
                                    timeout=10) as r:
            assert json.loads(r.read())["status"] == "serving"
    finally:
        svc.close()


def test_trainer_save_emits_publish_record(tmp_path):
    """A save with telemetry on writes the ``publish`` record whose publish_sig the
    serving tier records, and the run log validates under both packages' schemas."""
    from glint_word2vec_tpu.obs.schema import validate_file as jax_validate_file
    from glint_word2vec_torch.serve.reload import (publish_signature,
                                                   publish_signature_str)
    log = str(tmp_path / "run.jsonl")
    trainer, vocab, ck, _ = _train_tiny(tmp_path, seed=29, telemetry_path=log)
    sig = publish_signature_str(publish_signature(ck))
    trainer._telemetry.close()
    recs = [json.loads(x) for x in open(log)]
    pubs = [r for r in recs if r["kind"] == "publish"]
    assert [(p["publish_sig"], p["checkpoint"], p["publisher"]) for p in pubs] == [
        (sig, ck, "trainer")]
    assert validate_file(log)["ok"] and jax_validate_file(log)["ok"]
    svc = EmbeddingService(checkpoint=ck, ann=False, device=CPU)
    try:
        assert svc.stats()["publish_sig"] == sig
    finally:
        svc.close()


def test_service_defaults_to_the_card(tmp_path):
    """Without ``device`` the service loads onto the card: with no card visible it
    raises, never falls back to the CPU."""
    _, _, ck, _ = _train_tiny(tmp_path, seed=31)
    if torch.cuda.is_available():
        svc = EmbeddingService(checkpoint=ck, ann=False)
        try:
            assert svc.stats()["vocab_size"] > 0
        finally:
            svc.close()
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbeddingService(checkpoint=ck, ann=False)
    assert not any(t.name == "glint-serve-batcher" for t in threading.enumerate())


# -- cross-package serving -------------------------------------------------------------


def _jax_train_tiny(tmp_path, seed):
    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    from glint_word2vec_tpu.data.pipeline import encode_sentences as j_encode
    from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
    from glint_word2vec_tpu.train.trainer import Trainer as JTrainer
    sents = _tiny_corpus(seed)
    vocab = j_build_vocab(sents, min_count=1)
    trainer = JTrainer(JConfig(**_tiny_config(seed)), vocab)
    trainer.fit(j_encode(sents, vocab, 1000))
    ck = str(tmp_path / "jax_model")
    trainer.save_checkpoint(ck)
    return ck


def _assert_same_lists(got, want, atol=1e-5):
    assert [[w for w, _ in r] for r in got] == [[w for w, _ in r] for r in want]
    for rg, rw in zip(got, want):
        np.testing.assert_allclose([s for _, s in rg], [s for _, s in rw], atol=atol)


@pytest.mark.parametrize("ann", [False, True], ids=["exact", "ann"])
def test_jax_checkpoint_served_by_the_port(tmp_path, ann):
    from glint_word2vec_tpu.serve import EmbeddingService as JService
    ck = _jax_train_tiny(tmp_path, seed=37)
    words = [f"w{i}" for i in range(0, 40, 3)]
    ref = JService(checkpoint=ck, ann=ann)
    try:
        want = ref.synonyms_batch(words, 6)
    finally:
        ref.close()
    svc = EmbeddingService(checkpoint=ck, ann=ann, device=CPU)
    try:
        _assert_same_lists(svc.synonyms_batch(words, 6), want)
    finally:
        svc.close()


@pytest.mark.parametrize("ann", [False, True], ids=["exact", "ann"])
def test_port_checkpoint_served_by_the_jax_package(tmp_path, ann):
    from glint_word2vec_tpu.serve import EmbeddingService as JService
    _, _, ck, _ = _train_tiny(tmp_path, seed=41)
    words = [f"w{i}" for i in range(1, 40, 3)]
    svc = EmbeddingService(checkpoint=ck, ann=ann, device=CPU)
    try:
        got = svc.synonyms_batch(words, 6)
    finally:
        svc.close()
    ref = JService(checkpoint=ck, ann=ann)
    try:
        _assert_same_lists(got, ref.synonyms_batch(words, 6))
    finally:
        ref.close()


# -- the CLI and the bench -------------------------------------------------------------


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return env


class _Server:
    """``python -m glint_word2vec_torch.serve_checkpoint`` as a child process."""

    def __init__(self, path, *extra, errfile):
        self._errf = open(errfile, "w")
        self._errpath = errfile
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "glint_word2vec_torch.serve_checkpoint", path,
             *extra], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._errf, text=True, env=_env(), cwd=str(REPO))
        line = self.proc.stdout.readline()
        try:
            self.ready = json.loads(line)
        except json.JSONDecodeError:
            self._errf.flush()
            raise AssertionError("server died at startup; stderr tail:\n"
                                 + open(errfile).read()[-3000:]) from None

    def ask(self, **req):
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()
        return json.loads(self.proc.stdout.readline())

    def close(self):
        try:
            bye = self.ask(op="quit")
        except Exception:  # noqa: BLE001 — the exit code below is the verdict
            bye = None
        rc = self.proc.wait(timeout=60)
        self._errf.close()
        return bye, rc


def test_cli_serves_the_json_lines_protocol(tmp_path):
    """The counterpart of tests/test_mode_b_serving.py on the port: a second process
    serves the checkpoint (with the IVF arm) and picks up a newer one with reload."""
    trainer, vocab, ck, sents = _train_tiny(tmp_path, seed=43)
    local = Word2VecModel.load(ck, device=CPU)
    srv = _Server(ck, "--ann", "--device", "cpu", errfile=str(tmp_path / "err"))
    try:
        assert srv.ready == {"ready": True, "num_words": vocab.size,
                             "vector_size": 16}
        info = srv.ask(op="info", id=7)
        assert info["num_words"] == vocab.size and info["id"] == 7
        got = srv.ask(op="synonyms", word="w0", num=5)["synonyms"]
        assert len(got) == 5 and "w0" not in [w for w, _ in got]
        # the server's IVF arm is this index: the same matrix, seed and knobs
        local.attach_ann(build_ivf(local.syn0.cpu().numpy(), seed=0))
        want = local.find_synonyms_batch(["w0", "w1"], 5, ann=True)
        batch = srv.ask(op="synonyms_batch", words=["w0", "w1"], num=5)["synonyms"]
        assert [[tuple(x) for x in r] for r in batch] == want
        vec = srv.ask(op="vector", word="w1")["vector"]
        np.testing.assert_allclose(vec, local.transform("w1"), rtol=1e-6)
        sv = srv.ask(op="synonyms_vec", vector=local.transform("w2").tolist(), num=3)
        assert sv["synonyms"][0][0] == "w2"
        err = srv.ask(op="synonyms", word="nope", num=5, id="q9")
        assert err["error_type"] == "KeyError" and err["id"] == "q9"
        assert srv.ask(op="bogus")["error_type"] == "ValueError"
        trainer.fit(encode_sentences(_tiny_corpus(5), vocab, 1000))
        trainer.save_checkpoint(ck)
        assert srv.ask(op="reload") == {"reloaded": True, "num_words": vocab.size}
        st = srv.ask(op="stats")
        assert st["reloads"] == 1 and st["models_released"] == 1
        assert st["ann"]["centroids"] >= 1 and st["publish_sig"]
    finally:
        bye, rc = srv.close()
    assert bye == {"bye": True} and rc == 0


def test_cli_refuses_mesh_and_defaults_to_the_card(tmp_path):
    """``--mesh`` is ported: ``--mesh 1x2 --device cpu`` serves from two ranks (rank 0
    starts its follower) and ``quit`` ends both with exit 0; a malformed mesh is
    refused by name. Without ``--device`` the CLI wants the card."""
    _, _, ck, _ = _train_tiny(tmp_path, seed=47)
    r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.serve_checkpoint",
                        ck, "--mesh", "1x2", "--device", "cpu"], input='{"op": "quit"}\n',
                       capture_output=True, text=True, env=_env(), cwd=str(REPO),
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(x) for x in r.stdout.splitlines()]
    assert lines[0]["ready"] and lines[-1] == {"bye": True}
    r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.serve_checkpoint",
                        ck, "--mesh", "1x", "--device", "cpu"], input="",
                       capture_output=True, text=True, env=_env(), cwd=str(REPO),
                       timeout=120)
    assert r.returncode != 0 and "--mesh" in r.stderr
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.serve_checkpoint",
                        ck], input='{"op": "quit"}\n', capture_output=True, text=True,
                       env=_env(), cwd=str(REPO), timeout=120)
    assert r.returncode != 0 and "device='cpu'" in r.stderr and r.stdout == ""


def test_servebench_smoke_prints_one_json_line():
    r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.servebench",
                        "--smoke", "--device", "cpu", "--shard-native", "--vocab",
                        "3000", "--duration", "0.3", "--per-query", "4"],
                       capture_output=True, text=True, env=_env(), cwd=str(REPO),
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["device"] == "cpu" and res["vocab_size"] == 3000
    assert res["shard_native_parity"] is True
    for arm in ("exact", "ann", "int8", "pq"):
        assert res[f"{arm}_qps"] > 0
    assert res["pq_index_bytes"] < res["int8_index_bytes"] < res["ann_index_bytes"]
    # the fleet tier: N=1 against N=3 in-process replicas behind the router, and the
    # hedge A/B under an injected straggler on replica 0
    r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.servebench",
                        "--fleet", "--device", "cpu", "--smoke", "--vocab", "3000",
                        "--duration", "0.3", "--per-query", "4"], capture_output=True,
                       text=True, env={**_env(), "OMP_NUM_THREADS": "1"}, cwd=str(REPO),
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["fleet_replicas"] == 3 and res["fleet_vocab"] == 8000
    for n in (1, 3):
        for arm in ("exact", "ann"):
            assert res[f"fleet{n}_{arm}_qps"] > 0
            assert res[f"fleet{n}_{arm}_p99_ms"] > 0
    assert res["fleet_failed"] == 0
    assert res["fleet_hedges"] >= 1 and res["fleet_straggle"] == "r0:1/3x40.0ms"
    assert res["fleet_hedge_off_p99_ms"] > 0 and res["fleet_hedge_on_p99_ms"] > 0
    assert "not a fleet's capacity" in res["fleet_capacity_note"]


# -- the serving knobs -----------------------------------------------------------------


@pytest.mark.parametrize("knob,value", [
    ("serve_max_batch", 0), ("serve_max_delay_ms", -1.0), ("serve_queue_depth", 0),
    ("serve_ann_centroids", -1), ("serve_ann_nprobe", -1), ("serve_ann_quant", "fp16"),
    ("serve_ann_pq_m", -1), ("serve_ann_rerank", -2), ("serve_ann_recall_floor", 1.5),
    ("serve_ann_max_densify_bytes", -1), ("serve_reload_poll_s", 0.0),
])
def test_serving_knob_checks_match_the_jax_package(knob, value):
    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    with pytest.raises(ValueError) as want:
        JConfig(**{knob: value})
    with pytest.raises(ValueError) as got:
        Word2VecConfig(**{knob: value})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knob,value", [
    ("serve_max_batch", 16), ("serve_max_delay_ms", 0.0), ("serve_queue_depth", 32),
    ("serve_ann_centroids", 64), ("serve_ann_nprobe", 4), ("serve_ann_quant", "int8"),
    ("serve_ann_pq_m", 8), ("serve_ann_rerank", -1), ("serve_ann_recall_floor", 0.0),
    ("serve_ann_max_densify_bytes", 0), ("serve_reload_poll_s", 0.05),
])
def test_serving_knobs_travel_with_the_checkpoint(tmp_path, knob, value):
    """Each accepted knob is the service's default when it comes in the checkpoint."""
    from glint_word2vec_torch.serve.service import _knob
    ck = str(tmp_path / "ck")
    cfg = Word2VecConfig(vector_size=8, min_count=1, **{knob: value})
    Word2VecModel(Vocabulary.from_words_and_counts(["a", "b"], [2, 1]),
                  np.eye(2, 8, dtype=np.float32), config=cfg, device=CPU).save(ck)
    assert _knob(Word2VecModel.load(ck, device=CPU), knob, None) == value


@pytest.mark.parametrize("knob,value", [
    ("serve_fleet_replicas", 0), ("serve_fleet_probe_s", 0.0),
    ("serve_fleet_breaker_failures", 0), ("serve_fleet_breaker_reset_s", -1.0),
    ("serve_fleet_hedge_ms", -2.0), ("serve_fleet_retry_deadline_s", 0.0),
])
def test_fleet_knobs_stay_refused_by_name(knob, value):
    """The fleet's knobs are ported: a bad value is refused by the knob's name, with the
    JAX config's message (a good one is accepted: test_torch_isolation.py)."""
    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    with pytest.raises(ValueError, match=knob) as want:
        JConfig(**{knob: value})
    with pytest.raises(ValueError, match=knob) as got:
        Word2VecConfig(**{knob: value})
    assert str(got.value) == str(want.value)
