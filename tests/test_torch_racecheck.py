"""The port's lock-discipline run-time check (``glint_word2vec_torch.racecheck`` over
``glint_word2vec_torch.lockcheck``), ported from ``tests/test_racecheck.py`` on the CPU:
the wrappers detect what they claim (rank inversions, a plain lock taken again, a
reentrant rlock tolerated, a condition wait held while blocking, the seeded perturber),
checking off costs nothing (raw primitive types, no wrapper objects), the racecheck smoke
passes end to end as a subprocess, the status scrape, flight-recorder dump and sink
rotation triple survives three concurrent hammer threads, and shutdown is clean (close
twice, close with queries in flight, leaked threads surfaced) for the service and the
fleet; and the report carries the static cross-check against graftlint's R9 graph of
the port."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import lockcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture()
def checked():
    """Enable instrumentation for one test, restore the off default after."""
    lockcheck.configure(enabled=True, seed=7, perturb=0.0)
    lockcheck.reset()
    yield lockcheck
    lockcheck.configure(enabled=False, perturb=0.0)
    lockcheck.reset()


# -- zero cost off ---------------------------------------------------------------------


def test_off_mode_returns_raw_primitives_and_allocates_nothing():
    assert not lockcheck.enabled()
    before = lockcheck.wrappers_allocated()
    assert type(lockcheck.make_lock("serve.handle")) is type(threading.Lock())
    assert type(lockcheck.make_rlock("obs.sink")) is type(threading.RLock())
    assert isinstance(lockcheck.make_condition("serve.batcher.cv"),
                      threading.Condition)
    assert lockcheck.wrappers_allocated() == before


# -- the wrappers ----------------------------------------------------------------------


def test_unregistered_name_refused_when_checking(checked):
    with pytest.raises(KeyError, match="LOCK_TABLE"):
        checked.make_lock("no.such.lock")
    with pytest.raises(ValueError, match="kind"):
        checked.make_rlock("serve.handle")  # registered as plain lock


def test_rank_inversion_detected_and_ordered_nesting_clean(checked):
    outer = checked.make_lock("fleet.router")     # rank 30
    inner = checked.make_rlock("obs.sink")        # rank 90
    with outer:
        with inner:
            pass
    rep = checked.report()
    assert rep["inversions"] == []
    assert "fleet.router->obs.sink" in rep["edges"]
    with inner:
        with outer:  # rank 30 while holding rank 90: inversion
            pass
    rep = checked.report()
    assert any(i["kind"] == "rank-inversion"
               and i["held"] == "obs.sink"
               and i["acquiring"] == "fleet.router"
               for i in rep["inversions"]), rep


def test_rlock_reentry_tolerated_lock_reentry_flagged(checked):
    r = checked.make_rlock("obs.blackbox")
    with r:
        with r:  # reentrant rlock: no self-edge, no finding
            pass
    assert checked.report()["inversions"] == []
    lk = checked.make_lock("serve.handle")
    lk.acquire()
    try:
        # a second blocking acquire would deadlock the test; the checker
        # must flag the attempt even through the non-blocking path once
        # the lock shows up as held by this thread
        got = lk.acquire(blocking=False)
        assert not got
    finally:
        lk.release()


def test_condition_wait_counts_held_while_blocking(checked):
    guard = checked.make_lock("fleet.router")
    cv = checked.make_condition("serve.batcher.cv")

    def waiter():
        with guard:          # holding one lock...
            with cv:
                cv.wait(timeout=0.05)   # ...while blocking on another

    t = threading.Thread(target=waiter)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    rep = checked.report()
    assert rep["held_while_blocking"] >= 1
    assert "fleet.router->serve.batcher.cv" in \
        rep["held_while_blocking_pairs"]


def test_perturber_is_seeded_and_counts_yields(checked):
    checked.configure(perturb=1.0, seed=3)
    lk = checked.make_lock("serve.handle")
    for _ in range(10):
        with lk:
            pass
    rep = checked.report()
    assert rep["perturb_yields"] >= 10


# -- the tool (tier-1 smoke wiring) ----------------------------------------------------


def test_racecheck_smoke_subprocess_one_json_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("GLINT_LOCKCHECK", None)  # the tool owns enabling
    proc = subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.racecheck", "--smoke", "--device",
         "cpu", "--duration", "0.8", "--perturb", "0.05", "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=420, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout  # one JSON line
    payload = json.loads(lines[0])
    assert payload["ok"] and payload["tool"] == "racecheck"
    assert payload["device"] == "cpu" and payload["mode"] == "smoke"
    assert payload["zero_cost"]["wrappers_allocated"] == 0
    assert payload["zero_cost"]["raw_types"]
    assert payload["lockcheck"]["acquisitions"] > 0
    assert payload["lockcheck"]["inversions"] == []
    assert payload["inversions_unbaselined"] == []
    assert payload["lockcheck"]["reloads_observed"] >= 1
    # the static cross-check over the port's graftlint R9 graph, in the JAX keys
    assert isinstance(payload["static_edges"], list)
    assert payload["edges_unexplained"] == sorted(
        set(payload["lockcheck"]["edges"]) - set(payload["static_edges"]))


def test_static_cross_check_reports_a_nesting_the_graph_cannot_see(checked):
    """A nesting made through a stored closure runs (the rank gate passes it: the ranks
    increase) but is no edge of the static R9 graph, so it is reported as unexplained;
    an edge of the static graph would not be."""
    from glint_word2vec_torch import racecheck

    outer = checked.make_lock("data.native.load")   # rank 10
    inner = checked.make_lock("fleet.breaker")      # rank 40
    callbacks = {"on_load": lambda: inner.acquire() and inner.release()}
    with outer:
        callbacks["on_load"]()
    rep = checked.report()
    assert rep["inversions"] == [] and "data.native.load->fleet.breaker" in rep["edges"]
    cross = racecheck._static_cross_check(rep["edges"])
    assert "data.native.load->fleet.breaker" not in cross["static_edges"]
    assert "data.native.load->fleet.breaker" in cross["edges_unexplained"]
    known = racecheck._static_cross_check(cross["static_edges"])
    assert known["edges_unexplained"] == []


# -- satellite 3: the scrape + dump + rotation triple ----------------------------------


def test_concurrent_scrape_dump_rotation_triple(tmp_path):
    """statusd scrape + blackbox dump + sink rotation hammering the same
    rings from three threads (seeded, bounded): no exception anywhere, the
    scrape stays parseable, the rotated telemetry stays schema-valid."""
    import urllib.request

    from glint_word2vec_torch.obs.blackbox import FlightRecorder
    from glint_word2vec_torch.obs.schema import validate_record
    from glint_word2vec_torch.obs.sink import TelemetrySink
    from glint_word2vec_torch.obs.statusd import StatusServer

    tele = str(tmp_path / "t.jsonl")
    sink = TelemetrySink(tele, rotate_bytes=2048)  # tiny: force rotations
    sink.emit("run_start", config={}, host={})
    rec = FlightRecorder(tele + ".blackbox.json", ring=64)
    srv = StatusServer(0, lambda: {"status": "running", "global_step": 1,
                                   "heartbeats": 2}).start()
    errors = []
    stop = threading.Event()
    rng = np.random.default_rng(11)

    def guard(fn):
        def run():
            try:
                while not stop.is_set():
                    fn()
            except Exception as e:  # noqa: BLE001 — any raise fails
                errors.append(f"{type(e).__name__}: {e}")
        return run

    def scrape():
        urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/status.json", timeout=5).read()

    def dump():
        rec.observe("heartbeat", {"schema": 1, "t": 0.0, "kind": "heartbeat",
                                  "step": 1})
        rec.dump({"kind": "test"})

    def rotate():
        sink.emit("heartbeat", step=int(rng.integers(0, 100)), words=64,
                  alpha=0.025, loss=0.1, mean_f_pos=0.5,
                  pairs_per_sec=1000.0, host_wait_s=0.0, dispatch_s=0.0)

    threads = [threading.Thread(target=guard(f))
               for f in (scrape, dump, rotate)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    srv.stop()
    sink.close()
    assert errors == [], errors
    rotated = [p for p in os.listdir(tmp_path) if ".jsonl." in p]
    assert rotated, "rotate_bytes=2048 never rotated under the hammer"
    with open(tele, "r", encoding="utf-8") as f:
        for line in f:
            rec_obj = json.loads(line)
            assert validate_record(rec_obj) == [], rec_obj
    with open(tele + ".blackbox.json", "r", encoding="utf-8") as f:
        assert json.load(f)["cause"]["kind"] == "test"


# -- satellite 1: shutdown hygiene -----------------------------------------------------


def _toy_service(**kw):
    from glint_word2vec_torch.data.vocab import Vocabulary
    from glint_word2vec_torch.models.word2vec import Word2VecModel
    from glint_word2vec_torch.serve import EmbeddingService

    v, d = 50, 8
    vocab = Vocabulary.from_words_and_counts(
        [f"w{i}" for i in range(v)], np.ones(v, np.int64))
    m = np.random.default_rng(0).standard_normal((v, d)).astype(np.float32)
    model = Word2VecModel(vocab, m, device="cpu")
    return EmbeddingService(model=model, ann=False, device="cpu", **kw)


def test_service_close_twice_and_stats_surface_leaks():
    svc = _toy_service()
    assert svc.stats()["leaked_threads"] == 0
    assert svc.close() == 0
    assert svc.close() == 0  # idempotent, same answer


def test_service_close_during_inflight():
    """Queries in flight when close() lands must not wedge the shutdown:
    the batcher drains admitted work, close joins within its bound, and
    no thread leaks."""
    svc = _toy_service(max_batch=4, max_delay_ms=20.0)
    results, errs = [], []

    def q():
        try:
            results.append(svc.vector("w1", timeout=30.0))
        except Exception as e:  # noqa: BLE001 — refusal after close is fine
            errs.append(type(e).__name__)

    threads = [threading.Thread(target=q) for _ in range(8)]
    for t in threads:
        t.start()
    leaked = svc.close()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert leaked == 0
    # every in-flight query either completed or was refused — none hung
    assert len(results) + len(errs) == 8


def test_fleet_close_twice_and_leak_surfacing():
    from glint_word2vec_torch.serve import FleetRouter, ReplicaSet

    services = [_toy_service() for _ in range(2)]
    rset = ReplicaSet.adopt(services)
    router = FleetRouter(rset, probe_s=0.05)
    try:
        assert router.stats()["leaked_threads"] == 0
        for rstats in router.stats()["replicas"].values():
            assert rstats["leaked_threads"] == 0
    finally:
        router.close()
        router.close()  # idempotent
    assert router.stats()["leaked_threads"] == 0
