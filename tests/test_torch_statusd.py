"""The port's live status endpoint against the JAX package's: the Prometheus text of
one snapshot dict is identical in both; the server answers its four routes on
localhost; a fit with ``status_port`` serves a rising ``global_step`` while it runs,
and stops its thread at the fit's end; the snapshot holds the JAX trainer's keys and
host values only."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab
from glint_word2vec_torch.obs import statusd as tstatusd
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.obs import statusd as jstatusd


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The toy's tensors are tiny: one intra-op thread runs them several times faster
    than a pool, and a pool oversubscribes the cores when pytest runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SNAPS = [
    {},
    {"global_step": 12, "words": 300, "pairs_trained": 1.5e6, "pairs_per_sec": None,
     "alpha": 0.025, "lr_scale": 1.0, "recoveries": 0, "rollbacks": 0,
     "watchdog_fires": 0, "heartbeats": 0, "host_wait_s_total": 0.0,
     "dispatch_s_total": 0.25, "status": "idle", "norms": None, "phases": {}},
    {"global_step": 4194310, "words": 1234567, "pairs_trained": 9.87654321e9,
     "pairs_per_sec": 8.5e6, "alpha": 0.0125, "lr_scale": 0.5, "recoveries": 1,
     "rollbacks": 2, "watchdog_fires": 3, "heartbeats": 7, "host_wait_s_total": 1.234,
     "dispatch_s_total": 5.678, "status": "running",
     "norms": {"finite": True, "update_mag": 0.01,
               "syn0": {"max_norm": 123.5, "mean_norm": 3.25, "p99_norm": 9.51,
                        "frac_over": 0.015},
               "syn1": {"max_norm": 0.5, "mean_norm": 0.125}},
     "phases": {"dispatch": {"count": 40, "total_s": 1.5, "p99_s": 0.0625},
                "device_block": {"count": 4, "total_s": 0.25, "p99_s": 0.125}}},
    {"global_step": 3, "status": "running", "rollbacks": True, "alpha": float("nan")},
]


@pytest.mark.parametrize("snap", SNAPS, ids=["empty", "idle", "recovered", "odd"])
def test_prometheus_text_matches(snap):
    assert tstatusd.prometheus_text(snap) == jstatusd.prometheus_text(snap)


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_server_routes():
    snap = SNAPS[2]
    srv = tstatusd.StatusServer(0, lambda: snap).start()
    try:
        code, ctype, body = _get(srv.port, "/status.json")
        assert code == 200 and ctype == "application/json" and json.loads(body) == snap
        assert json.loads(_get(srv.port, "/")[2]) == snap
        code, ctype, body = _get(srv.port, "/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert body == jstatusd.prometheus_text(snap)
        assert _get(srv.port, "/healthz")[::2] == (200, "ok\n")
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.port, "/nope")
        assert e.value.code == 404
    finally:
        assert srv.stop() == 0
    assert srv.port == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _toy_trainer(**knobs):
    rng = np.random.default_rng(0)
    sents = [[f"w{i}" for i in rng.integers(0, 30, 20)] for _ in range(250)]
    vocab = build_vocab(sents, min_count=1)
    cfg = TConfig(vector_size=8, pairs_per_batch=128, window=3, num_iterations=2,
                  steps_per_dispatch=2, heartbeat_every_steps=2, subsample_ratio=0.0,
                  prefetch_chunks=0, seed=1, **knobs)
    return TTrainer(cfg, vocab, device="cpu"), encode_sentences(sents, vocab, 1000)


def _statusd_threads():
    return [t for t in threading.enumerate() if t.name == "glint-statusd"]


def test_fit_serves_its_status():
    """A poller sees HTTP 200 and a rising global_step while the fit runs; the
    endpoint is gone after it, and a fit without status_port starts no thread."""
    port = _free_port()
    trainer, enc = _toy_trainer(status_port=port, norm_watch="warn")
    seen, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            try:
                code, _, body = _get(port, "/status.json")
                snap = json.loads(body)
                code_m, _, metrics = _get(port, "/metrics")
                seen.append((code, code_m, snap["global_step"], snap["status"],
                             "glint_global_step" in metrics))
            except OSError:
                pass
            time.sleep(0.01)

    real = trainer._run_chunk

    def slow_chunk(chunk):  # room for the poller between the rounds
        time.sleep(0.02)
        return real(chunk)

    trainer._run_chunk = slow_chunk
    th = threading.Thread(target=poll, daemon=True)
    th.start()
    trainer.fit(enc)
    stop.set()
    th.join(timeout=10)
    assert not th.is_alive()
    running = [s for s in seen if s[3] == "running"]
    assert running and all(s[0] == s[1] == 200 and s[4] for s in running)
    steps = [s[2] for s in running]
    assert steps == sorted(steps) and steps[-1] > steps[0]
    assert trainer._statusd is None and not _statusd_threads()
    with pytest.raises(OSError):
        _get(port, "/healthz")
    plain, enc = _toy_trainer()
    plain.fit(enc)
    assert plain._statusd is None and not _statusd_threads()


def test_snapshot_keys_match_the_jax_trainer():
    """The same gauge keys as the JAX trainer's snapshot, and only host values."""
    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
    from glint_word2vec_tpu.train.trainer import Trainer as JTrainer
    trainer, enc = _toy_trainer(norm_watch="warn")
    trainer.fit(enc)
    snap = trainer.status_snapshot()
    rng = np.random.default_rng(0)
    sents = [[f"w{i}" for i in rng.integers(0, 30, 20)] for _ in range(250)]
    jt = JTrainer(JConfig(vector_size=8, pairs_per_batch=128, window=3, seed=1),
                  j_build_vocab(sents, 1))
    assert snap.keys() == jt.status_snapshot().keys()
    assert json.loads(json.dumps(snap)) == snap
    assert snap["status"] == "idle" and snap["global_step"] == trainer.global_step
    assert snap["norms"] == trainer.heartbeats[-1].norms
