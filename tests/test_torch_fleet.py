"""The port's serving fleet (``glint_word2vec_torch/serve/fleet.py``) on the CPU, held
against the JAX package's (``glint_word2vec_tpu/serve/fleet.py``).

Ported from ``tests/test_fleet.py``, each case on the port with ``device="cpu"``:

- the circuit breaker's state machine (closed -> open -> half-open -> closed, a failed
  trial reopening, the transition history);
- the router's policies over scripted replicas (no processes): retry elsewhere on a
  failure, ``ServerOverloaded`` as "retry elsewhere, not here", the fast refusal when
  every replica is saturated, bulk shedding first, hedging (first response wins, a dead
  hedge target blamed and not the primary), client errors propagating without retries,
  the deadline-bounded ``NoHealthyReplicas``, draining;
- the ``fleet_*`` record kinds and ``fleet_prometheus_text``;
- an adopted in-process fleet end to end, and one replica process on the JSON-lines
  protocol (id echo, the ``publish_sig`` staleness channel, the breaker opening on a
  SIGKILL).

Parity with the JAX package: the breaker's transitions on one scripted sequence, the
Prometheus text of one snapshot, and ``fleet_knobs_from_checkpoint`` on one checkpoint.
What differs by design is pinned: a replica is ``python -m
glint_word2vec_torch.serve_checkpoint ... --device D`` (the JAX package runs its
``tools/`` script under ``JAX_PLATFORMS=cpu``), and a replica that cannot reach its
device fails the spawn instead of serving from elsewhere. The fleet-kill drill itself
(``python -m glint_word2vec_torch.fleet_run --smoke --device cpu``) runs here as a
subprocess and as the ``fleet-kill`` phase of the chaos drill (tests/test_torch_chaos.py).
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.obs.schema import validate_file, validate_record
from glint_word2vec_torch.obs.statusd import fleet_prometheus_text
from glint_word2vec_torch.serve import (
    CircuitBreaker,
    EmbeddingService,
    FleetOverloaded,
    FleetRouter,
    NoHealthyReplicas,
    ReplicaSet,
    fleet_knobs_from_checkpoint,
)
from glint_word2vec_torch.serve.fleet import FleetTicket, ReplicaError, SubprocessReplica

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this file runs: its fits and services are tiny, and
    they share the host with the other test files' workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_model(v=200, d=16, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((v, d)).astype(np.float32)
    vocab = Vocabulary.from_words_and_counts(
        [f"w{i}" for i in range(v)], np.ones(v, np.int64))
    return Word2VecModel(vocab, m, device=CPU)


# -- circuit breaker -------------------------------------------------------------------


def test_breaker_state_machine():
    b = CircuitBreaker(fail_threshold=2, reset_s=0.05)
    assert b.state == "closed" and b.allows_traffic()
    b.record_failure("one")
    assert b.state == "closed"  # below threshold
    b.record_success()
    b.record_failure("one")  # success reset the consecutive count
    assert b.state == "closed"
    b.record_failure("two")
    assert b.state == "open" and not b.allows_traffic()
    assert not b.probe_due()  # cooldown running
    time.sleep(0.06)
    assert b.probe_due() and b.begin_probe()
    assert b.state == "half-open" and not b.allows_traffic()
    assert not b.begin_probe()  # one trial holds the half-open slot
    b.record_failure("trial failed")
    assert b.state == "open"  # trial failure reopens + re-arms cooldown
    assert not b.probe_due()
    time.sleep(0.06)
    assert b.begin_probe()
    b.record_success()
    assert b.state == "closed" and b.allows_traffic()
    states = [(f, t) for f, t, _ in b.transitions]
    assert states == [("closed", "open"), ("open", "half-open"),
                      ("half-open", "open"), ("open", "half-open"),
                      ("half-open", "closed")]


def test_breaker_validation():
    with pytest.raises(ValueError, match="fail_threshold"):
        CircuitBreaker(fail_threshold=0)
    with pytest.raises(ValueError, match="reset_s"):
        CircuitBreaker(reset_s=0.0)


def test_breaker_transitions_match_the_jax_package():
    """One scripted sequence of outcomes and cooldowns through both breakers: the same
    states after every event, and the same (from, to, reason) history."""
    from glint_word2vec_tpu.serve.fleet import CircuitBreaker as JBreaker

    script = ["fail", "ok", "fail", "fail", "fail", "probe", "wait", "probe",
              "probe", "fail", "wait", "probe", "ok", "fail", "fail", "fail", "wait",
              "probe", "ok", "ok"]
    seen = {}
    for name, cls in (("jax", JBreaker), ("torch", CircuitBreaker)):
        fired = []
        b = cls(fail_threshold=3, reset_s=0.3,
                on_transition=lambda f, t, r, fired=fired: fired.append((f, t, r)))
        states = []
        for i, ev in enumerate(script):
            if ev == "fail":
                b.record_failure(f"event {i}")
            elif ev == "ok":
                b.record_success()
            elif ev == "probe":
                states.append(("probe", b.begin_probe()))
            else:
                time.sleep(0.35)
            states.append((b.state, b.allows_traffic(), b.probe_due()))
        seen[name] = (states, b.transitions_snapshot(), fired)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1] == seen["torch"][2]  # the callback saw each transition


# -- router policies over scripted replicas --------------------------------------------


class FakeReplica:
    """A scripted replica on the fleet's client surface: ``behavior`` maps a request
    dict to a wire-shaped response (or raises); ``delay_s`` resolves the ticket late
    on a timer (the hedging tests' slow replica)."""

    def __init__(self, name, behavior, delay_s=0.0):
        self.name = name
        self.behavior = behavior
        self.delay_s = delay_s
        self.calls = []
        self.restarts = 0
        self._alive = True

    def start(self):
        return self

    def alive(self):
        return self._alive

    @property
    def pid(self):
        return None

    def submit(self, req):
        self.calls.append(req)
        t = FleetTicket(len(self.calls))
        resp = self.behavior(req)
        if self.delay_s:
            threading.Timer(self.delay_s, t.resolve, args=(resp,)).start()
        else:
            t.resolve(resp)
        return t

    def wait(self, ticket, timeout):
        if not ticket.done.wait(timeout):
            raise TimeoutError(f"{self.name}: no response")
        return ticket.response

    def abandon(self, ticket):
        pass

    def kill(self):
        self._alive = False

    def close(self):
        self._alive = False


def ok_syn(req):
    if req.get("op") == "stats":
        return {"publish_sig": "sig-1"}
    n = int(req.get("num", 10))
    return {"synonyms": [[f"s{i}", 0.5] for i in range(n)]}


def failing(req):
    raise ReplicaError("scripted failure")


def overloaded(req):
    if req.get("op") == "stats":
        return {"publish_sig": "sig-1"}
    return {"error": "ServerOverloaded: admission queue full",
            "error_type": "ServerOverloaded", "retry_after_s": 0.5}


def _router(replicas, **kw):
    kw.setdefault("probe_s", 30.0)  # keep the prober out of the way
    kw.setdefault("retry_deadline_s", 5.0)
    kw.setdefault("hedge_ms", 0.0)
    return FleetRouter(ReplicaSet(replicas, can_respawn=False), **kw)


def test_router_retries_elsewhere_and_breaker_opens():
    bad, good = FakeReplica("r0", failing), FakeReplica("r1", ok_syn)
    router = _router([bad, good], breaker_failures=2)
    try:
        for _ in range(4):
            assert len(router.synonyms("w0", 5)) == 5  # never fails
        st = router.stats()
        assert st["failures"] == 0
        assert st["retries"] >= 2  # failed attempts retried elsewhere
        # the failing replica's breaker opened after the threshold; it is no longer
        # picked at all
        assert router.breaker_states()["r0"] == "open"
        calls_after_open = len(bad.calls)
        router.synonyms("w0", 5)
        assert len(bad.calls) == calls_after_open
    finally:
        router.close(close_replicas=False)


def test_router_saturated_retries_elsewhere_without_breaker_blame():
    sat, good = FakeReplica("r0", overloaded), FakeReplica("r1", ok_syn)
    router = _router([sat, good])
    try:
        for _ in range(4):
            assert len(router.synonyms("w0", 5)) == 5
        # ServerOverloaded is not a breaker failure: healthy, just full
        assert router.breaker_states()["r0"] == "closed"
        assert router.stats()["failures"] == 0
    finally:
        router.close(close_replicas=False)


def test_router_all_saturated_refuses_fast_with_hint():
    router = _router([FakeReplica("r0", overloaded), FakeReplica("r1", overloaded)])
    try:
        t0 = time.monotonic()
        with pytest.raises(FleetOverloaded) as ei:
            router.synonyms("w0", 5)
        assert time.monotonic() - t0 < 1.0, "refusal was not fast"
        assert ei.value.retry_after_s == 0.5  # the fleet's minimum hint
        assert router.stats()["shed_single"] == 1
    finally:
        router.close(close_replicas=False)


def test_router_bulk_sheds_before_single():
    router = _router([FakeReplica("r0", ok_syn), FakeReplica("r1", ok_syn)])
    try:
        # one replica under saturation pressure: bulk is shed first
        router._replicas[0].saturated_until = time.monotonic() + 10
        router._replicas[0].retry_after_s = 0.3
        with pytest.raises(FleetOverloaded):
            router.synonyms_batch(["w0", "w1"], 5)
        assert router.stats()["shed_bulk"] == 1
        # ...while single queries still flow through the other
        assert len(router.synonyms("w0", 5)) == 5
        assert router.stats()["shed_single"] == 0
    finally:
        router.close(close_replicas=False)


def test_router_hedges_to_second_replica_first_wins():
    slow = FakeReplica("r0", ok_syn, delay_s=0.4)
    fast = FakeReplica("r1", ok_syn)
    router = _router([slow, fast], hedge_ms=20.0)
    try:
        # force the slow replica primary: the fast one reads as degraded
        router._replicas[1].degraded = True
        t0 = time.monotonic()
        res = router.synonyms("w0", 5)
        dt = time.monotonic() - t0
        assert len(res) == 5
        assert dt < 0.3, f"hedge did not cut the slow primary ({dt:.3f}s)"
        st = router.stats()
        assert st["hedges"] == 1 and st["hedge_wins"] == 1
        assert [r["op"] for r in fast.calls if r["op"] == "synonyms"], \
            "second replica never saw the hedged request"
    finally:
        router.close(close_replicas=False)


def test_hedge_failure_blames_the_answering_replica_not_the_primary():
    """A hedged attempt whose hedge target dies feeds the hedge target's breaker and
    lets the slow but healthy primary still win."""

    class DeadOnWait(FakeReplica):
        def wait(self, ticket, timeout):
            if ticket.response and "synonyms" in ticket.response:
                raise ReplicaError(f"{self.name}: process exited mid-request")
            return super().wait(ticket, timeout)

    slow = FakeReplica("r0", ok_syn, delay_s=0.3)
    dead = DeadOnWait("r1", ok_syn)
    router = _router([slow, dead], hedge_ms=20.0, breaker_failures=3)
    try:
        router._replicas[1].degraded = True  # force r0 primary
        res = router.synonyms("w0", 5)  # the hedge goes to r1, r1 dies
        assert len(res) == 5, "slow primary must still win the attempt"
        st = router.stats()
        assert st["hedges"] == 1 and st["failures"] == 0
        assert router._replicas[1].breaker._consecutive == 1
        assert router._replicas[0].breaker._consecutive == 0
        assert router.breaker_states()["r0"] == "closed"
    finally:
        router.close(close_replicas=False)


def test_router_client_errors_propagate_without_retry():
    def oov(req):
        if req.get("op") == "stats":
            return {}
        return {"error": "KeyError: 'nope not in vocabulary'", "error_type": "KeyError"}

    router = _router([FakeReplica("r0", oov), FakeReplica("r1", oov)])
    try:
        with pytest.raises(KeyError, match="not in vocabulary"):
            router.synonyms("nope", 5)
        st = router.stats()
        # the caller's own error burns neither retries nor breaker health
        assert st["retries"] == 0
        assert router.breaker_states() == {"r0": "closed", "r1": "closed"}
    finally:
        router.close(close_replicas=False)


def test_router_deadline_bounds_total_failure():
    router = _router([FakeReplica("r0", failing), FakeReplica("r1", failing)],
                     breaker_failures=1, retry_deadline_s=0.6)
    try:
        t0 = time.monotonic()
        with pytest.raises(NoHealthyReplicas):
            router.synonyms("w0", 5)
        dt = time.monotonic() - t0
        assert 0.4 < dt < 3.0, f"deadline not honored ({dt:.2f}s)"
        assert router.stats()["failures"] == 1
    finally:
        router.close(close_replicas=False)


def test_router_drain_excludes_replica_from_picks():
    a, b = FakeReplica("r0", ok_syn), FakeReplica("r1", ok_syn)
    router = _router([a, b])
    try:
        router._replicas[0].draining = True
        for _ in range(3):
            router.synonyms("w0", 5)
        assert not [r for r in a.calls if r["op"] == "synonyms"], \
            "draining replica still received traffic"
    finally:
        router.close(close_replicas=False)


# -- telemetry schema and prometheus ---------------------------------------------------


def test_fleet_record_kinds_validate():
    base = {"schema": 1, "t": 0.0}
    ok = [
        {**base, "kind": "fleet_start", "replicas": 3, "checkpoint": "/ck"},
        {**base, "kind": "fleet_breaker", "replica": "r0",
         "from_state": "closed", "to_state": "open", "reason": "dead"},
        {**base, "kind": "fleet_reload", "publishes": 1, "min_serving": 2,
         "replicas": 3, "seconds": 1.5},
        {**base, "kind": "fleet_stats", "queries": 10, "failures": 0,
         "retries": 1, "hedges": 2, "hedge_wins": 1, "shed": 0,
         "healthy": 3, "degraded": 0, "latency_ms": {"p50": 1.0}},
        {**base, "kind": "fleet_end", "queries": 10, "failures": 0},
    ]
    for rec in ok:
        assert validate_record(rec) == [], rec["kind"]
    bad = {**base, "kind": "fleet_stats", "queries": 10}
    assert validate_record(bad), "missing required fields must fail"


SNAP = {
    "status": "serving", "queries": 100, "failures": 0, "retries": 3,
    "hedges": 5, "hedge_wins": 4, "shed_single": 0, "shed_bulk": 1,
    "reload_rounds": 2, "healthy": 2, "degraded": 1,
    "min_serving_during_reloads": 2,
    "latency_ms": {"p50": 1.0, "p95": 2.0, "p99": 3.0, "n": 100},
    "replicas": {
        "r0": {"state": "closed", "alive": True, "degraded": False,
               "in_flight": 1, "restarts": 0, "reloads": 2,
               "stats": {"submitted": 50, "queue_depth": 0,
                         "latency_ms": {"p50": 0.9},
                         "ann": {"recall_at_10": 0.99, "index_bytes": 4096}}},
        "r1": {"state": "open", "alive": False, "degraded": True,
               "in_flight": 0, "restarts": 1, "reloads": 1,
               "stats": {"ann": {"index_bytes": 1024}}},
        "r2": {"state": "half-open", "alive": True, "degraded": False,
               "in_flight": 0, "restarts": 0, "reloads": 2, "stats": None},
    },
}


def test_fleet_prometheus_rendering():
    text = fleet_prometheus_text(SNAP)
    for needle in (
            "glint_serve_fleet_up 1",
            "glint_serve_fleet_queries_total 100",
            "glint_serve_fleet_hedges_total 5",
            "glint_serve_fleet_healthy 2",
            "glint_serve_fleet_min_serving_during_reloads 2",
            'glint_serve_fleet_latency_ms{quantile="p99"} 3',
            'glint_serve_fleet_breaker_state{replica="r0"} 0',
            'glint_serve_fleet_breaker_state{replica="r1"} 2',
            'glint_serve_fleet_breaker_state{replica="r2"} 1',
            'glint_serve_up{replica="r0"} 1',
            'glint_serve_up{replica="r1"} 0',
            'glint_serve_submitted_total{replica="r0"} 50',
            'glint_serve_latency_ms{replica="r0",quantile="p50"} 0.9',
            'glint_serve_ann_recall_at_10{replica="r0"} 0.99',
            "glint_serve_fleet_index_bytes 5120"):
        assert needle in text, f"{needle!r} missing from:\n{text}"
    # the text format forbids a second TYPE line per metric name
    type_lines = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
    assert len(type_lines) == len(set(type_lines))


@pytest.mark.parametrize("status", ["serving", "closed"])
def test_fleet_prometheus_text_matches_the_jax_package(status):
    """The same snapshot (SLO block included) renders to the same text in both
    packages."""
    from glint_word2vec_tpu.obs.slo import SloObjectives as JObjectives
    from glint_word2vec_tpu.obs.slo import SloTracker as JTracker
    from glint_word2vec_tpu.obs.statusd import fleet_prometheus_text as jax_text

    tr = JTracker(JObjectives(availability=0.9, latency_ms=100.0,
                              short_window_s=60, long_window_s=600))
    for i in range(20):
        tr.note(i % 7 != 0, latency_s=0.001 * i)
    snap = {**SNAP, "status": status, "slo": tr.snapshot(now=1e12)}
    assert fleet_prometheus_text(snap) == jax_text(snap)


# -- the adopted in-process fleet end to end -------------------------------------------


def test_adopted_fleet_parity_and_stats(tmp_path):
    models = [make_model(seed=7) for _ in range(2)]
    want = models[0].find_synonyms("w0", 5)
    svcs = [EmbeddingService(model=m, ann=False) for m in models]
    log = str(tmp_path / "fleet.jsonl")
    router = FleetRouter(ReplicaSet.adopt(svcs), probe_s=0.1, hedge_ms=0.0,
                         retry_deadline_s=10.0, telemetry_path=log)
    try:
        got = router.synonyms("w0", 5)
        assert [w for w, _ in got] == [w for w, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=1e-5)
        rows = router.synonyms_batch(["w1", "w2"], 4)
        assert len(rows) == 2 and all(len(r) == 4 for r in rows)
        with pytest.raises(KeyError):
            router.synonyms("nope", 5)
        deadline = time.monotonic() + 5
        while (any(r["stats"] is None for r in router.stats()["replicas"].values())
               and time.monotonic() < deadline):
            time.sleep(0.02)
        st = router.stats()
        assert st["healthy"] == 2 and st["failures"] == 0
        for rep in st["replicas"].values():
            assert rep["state"] == "closed"
            assert rep["stats"] is not None, "probe never cached stats"
            assert rep["stats"]["device"] == "cpu"
        router.emit_stats()
    finally:
        router.close()  # closes the services; caller-owned models survive
    summary = validate_file(log)
    assert summary["ok"], summary["errors"][:3]
    kinds = summary["kinds"]
    assert kinds.get("fleet_start") == 1
    assert kinds.get("fleet_stats") == 1
    assert kinds.get("fleet_end") == 1
    for m in models:
        m.stop()


def test_adopted_fleet_survives_one_replica_closing():
    models = [make_model(seed=s) for s in range(2)]
    svcs = [EmbeddingService(model=m, ann=False) for m in models]
    router = FleetRouter(ReplicaSet.adopt(svcs), probe_s=0.05, hedge_ms=0.0,
                         breaker_failures=2, retry_deadline_s=10.0)
    try:
        assert len(router.synonyms("w0", 5)) == 5
        svcs[0].close()  # the replica "dies" (the ServiceClosed surface)
        deadline = time.monotonic() + 10
        while (router.breaker_states()["r0"] != "open"
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert router.breaker_states()["r0"] == "open"
        for _ in range(3):  # traffic keeps flowing on the survivor
            assert len(router.synonyms("w0", 5)) == 5
        assert router.stats()["failures"] == 0
    finally:
        router.close()
        for m in models:
            m.stop()


# -- replica processes -----------------------------------------------------------------


def _train_tiny_ck(tmp_path, seed=9, **cfg_kw):
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.train.trainer import Trainer
    rng = np.random.default_rng(seed)
    sents = [[f"w{j}" for j in rng.integers(0, 30, 12)] for _ in range(80)]
    vocab = build_vocab(sents, min_count=1)
    cfg = Word2VecConfig(vector_size=8, min_count=1, pairs_per_batch=128,
                         num_iterations=1, window=2, negatives=3,
                         negative_pool=8, steps_per_dispatch=2, seed=seed, **cfg_kw)
    trainer = Trainer(cfg, vocab, device=CPU)
    trainer.fit(encode_sentences(sents, vocab, cfg.max_sentence_length))
    ck = str(tmp_path / "model")
    trainer.save_checkpoint(ck)
    return ck


def test_subprocess_replica_protocol_and_kill(tmp_path):
    """One real replica process: the id-echoed JSON-lines protocol, the publish_sig
    staleness channel filled by probes, and the breaker opening when the process is
    SIGKILLed."""
    ck = _train_tiny_ck(tmp_path)
    rs = ReplicaSet.spawn(ck, 1, stderr_dir=str(tmp_path), device=CPU)
    # breaker_failures=1: the first dead-process probe opens the breaker (at 2 the
    # prober may restart and trial-heal the replica before a second failure accrues)
    router = FleetRouter(rs, checkpoint=ck, probe_s=0.1, breaker_failures=1,
                         breaker_reset_s=0.5, hedge_ms=0.0, retry_deadline_s=5.0,
                         rolling_reload=False)
    try:
        res = router.synonyms("w0", 5)
        assert len(res) == 5 and all(np.isfinite(s) for _, s in res)
        with pytest.raises(KeyError):
            router.synonyms("definitely-not-a-word", 5)
        deadline = time.monotonic() + 10
        while (router.stats()["replicas"]["r0"]["publish_sig"] is None
               and time.monotonic() < deadline):
            time.sleep(0.05)
        rep = router.stats()["replicas"]["r0"]
        assert rep["publish_sig"], "probe never filled the served publish generation"
        assert not rep["degraded"], "freshly booted replica read as stale"
        assert rep["stats"]["device"] == "cpu"
        # on the transition history, not the state: the prober may restart and
        # trial-close the replica faster than a poll of the state
        rs.replicas[0].kill()
        deadline = time.monotonic() + 20
        opened = False
        while time.monotonic() < deadline:
            trans = router.breaker_transitions("r0")
            if any((f, t) == ("closed", "open") for f, t, _ in trans):
                opened = True
                break
            time.sleep(0.05)
        assert opened, (f"breaker never opened on the killed replica "
                        f"(transitions {router.breaker_transitions('r0')})")
    finally:
        router.close()


def test_replica_command_is_the_ports_cli(monkeypatch, tmp_path):
    """By design the replica is the port's module CLI on its device, importing the
    package from the repository (PYTHONPATH), with no JAX_PLATFORMS."""
    seen = {}

    class FakePopen:
        def __init__(self, cmd, **kw):
            seen["cmd"], seen["env"] = cmd, kw["env"]
            self.stdout = iter(())
            self.pid = 1

        def poll(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    r = SubprocessReplica("r0", "/ck", ann=True, nprobe=4,
                          telemetry_path=str(tmp_path / "r0.jsonl"))
    r.start()
    r.close()
    assert seen["cmd"][1:] == [
        "-m", "glint_word2vec_torch.serve_checkpoint", "/ck", "--device", "cuda",
        "--ann", "--nprobe", "4", "--telemetry", str(tmp_path / "r0.jsonl"),
        "--process-name", "r0"]
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == str(REPO)
    assert "JAX_PLATFORMS" not in seen["env"]
    SubprocessReplica("r1", "/ck", device="cpu").start().close()
    assert seen["cmd"][-2:] == ["--device", "cpu"]


def test_replica_without_its_device_fails_the_spawn(tmp_path):
    """No fallback: a replica that cannot reach the card exits before it is ready, and
    the spawn says so at once instead of serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the replica would reach it")
    ck = _train_tiny_ck(tmp_path)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited before it was ready"):
        ReplicaSet.spawn(ck, 2, stderr_dir=str(tmp_path), device="cuda",
                         ready_timeout=120.0)
    assert time.monotonic() - t0 < 60
    err = (tmp_path / "replica-0.log").read_text()
    assert "device='cpu'" in err, err[-2000:]


def test_fleet_knobs_travel_with_the_checkpoint(tmp_path):
    """The serve_fleet_* knobs resolve from a checkpoint (override, else the config's
    field) the same way in both packages."""
    from glint_word2vec_tpu.serve.fleet import fleet_knobs_from_checkpoint as jax_knobs
    ck = _train_tiny_ck(tmp_path, serve_fleet_replicas=2, serve_fleet_probe_s=0.25,
                        serve_fleet_breaker_failures=4, serve_fleet_hedge_ms=0.0)
    got = fleet_knobs_from_checkpoint(ck)
    assert got == {"replicas": 2, "probe_s": 0.25, "breaker_failures": 4,
                   "breaker_reset_s": 2.0, "hedge_ms": 0.0, "retry_deadline_s": 10.0}
    assert got == jax_knobs(ck)
    assert fleet_knobs_from_checkpoint(ck, replicas=5, hedge_ms=7.0) == jax_knobs(
        ck, replicas=5, hedge_ms=7.0)


def test_fleet_run_smoke_prints_one_json_line(tmp_path):
    """The fleet-kill drill end to end on the CPU: three replica processes, a SIGKILL
    mid-storm, the rolling reloads, the SIGTERM dump and the collector leg."""
    # one intra-op thread in each process of the tree: its replicas and workers run
    # beside the other test files' workers, and their tensors are small
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.fleet_run",
                        "--smoke", "--device", "cpu", "--workdir", str(tmp_path)],
                       capture_output=True, text=True, env=env, cwd=str(REPO),
                       timeout=300)
    lines = r.stdout.strip().splitlines()
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["ok"] and res["device"] == "cpu" and res["failed_queries"] == 0
    assert res["min_serving_during_reloads"] >= 2 and res["reload_rounds"] >= 3
    assert set(res["drained_reloads"]) == {"r0", "r1", "r2"}
    assert min(res["drained_reloads"].values()) >= 3
    assert res["breaker_transitions"][0] == "closed->open"
    assert res["breaker_transitions"][-1] == "half-open->closed"
    assert res["slo_within_budget"] and res["collector"]["slo_within_budget"]
    assert {"r0", "r1", "r2", "trainer"} <= set(res["collector"]["processes"])
    assert res["collector"]["retried_traces"] >= 1
