"""The port's fleet observability plane on the CPU (``glint_word2vec_torch/obs/slo.py``,
``obs/collect.py``, the fleet router's trace spans), held against the JAX package's.

Ported from ``tests/test_trace_collect.py``, each case on the port with
``device="cpu"``:

- the schema round trip of ``trace_span`` / ``publish`` / ``fleet_slo`` and the clock
  anchor's fields;
- the SLO burn math: the tracker's sampling, multi-window burn rates, the within-budget
  predicate;
- trace propagation through an adopted in-process fleet, requests byte-identical when
  tracing is off, ``trace_sample`` thinning, a hedge loser ``abandoned`` and never
  ``failed``;
- the collector over out-of-order, clock-skewed, restart-epoch fixtures, publish chains,
  the offline SLO recompute, the Perfetto export and the slowest-K exemplars;
- ``glint_word2vec_torch.run_report``'s fleet mode: each process's status, a dump
  folded in, the verdict reddened by an ``error`` end and not by a torn tail.

Parity with the JAX package: ``burn_rates_from_samples`` and ``SloTracker`` on the same
seeded samples, and ``collect`` (timeline order, SLO, summary, Perfetto document) on one
set of artifacts that a port fleet left behind.
"""

import json
import time

import numpy as np
import pytest

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.obs.collect import (
    build_timeline,
    collect,
    export_perfetto,
    load_process_logs,
    recompute_slo,
)
from glint_word2vec_torch.obs.schema import (
    SCHEMA_VERSION,
    validate_file,
    validate_record,
)
from glint_word2vec_torch.obs.sink import TelemetrySink
from glint_word2vec_torch.obs.slo import (
    SloObjectives,
    SloTracker,
    burn_rates_from_samples,
    flatten_burn,
)
from glint_word2vec_torch.obs.trace import (
    SpanEmitter,
    clock_anchor,
    new_span_id,
    new_trace_id,
    wire_context,
)
from glint_word2vec_torch.serve.fleet import FleetRouter, FleetTicket, ReplicaSet
from glint_word2vec_torch.serve.service import EmbeddingService


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


def make_model(v=60, d=8, seed=0):
    rng = np.random.default_rng(seed)
    vocab = Vocabulary.from_words_and_counts(
        [f"w{i}" for i in range(v)], np.ones(v, np.int64))
    return Word2VecModel(vocab, rng.standard_normal((v, d)).astype(np.float32),
                         device="cpu")


# -- schema round-trip ------------------------------------------------------------------


def test_new_kinds_roundtrip_schema_valid(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with TelemetrySink(path) as sink:
        em = SpanEmitter(sink, "router-test")
        tid = new_trace_id()
        root = em.emit(tid, "fleet_query", 1_000, 2_000_000,
                       outcome="ok", op="synonyms")
        em.emit(tid, "attempt", 1_100, 1_500_000, parent=root,
                replica="r0", outcome="failed")
        sink.emit("publish", publish_sig="1-2-3", checkpoint="/ck",
                  step=7, publisher="trainer")
        sink.emit("fleet_slo", objective=0.999, availability=1.0,
                  samples=10, burn_short=0.0, burn_long=None,
                  latency_good_fraction=0.99)
        sink.emit("fleet_start", replicas=3, checkpoint="/ck",
                  process="router-test", **clock_anchor())
    v = validate_file(path)
    assert v["ok"], v["errors"]
    assert v["kinds"] == {"trace_span": 2, "publish": 1, "fleet_slo": 1,
                          "fleet_start": 1}


def test_schema_rejects_bad_span_and_anchor_types():
    base = {"schema": SCHEMA_VERSION, "t": 1.0}
    good = {**base, "kind": "trace_span", "trace_id": "t1", "span": "s1",
            "name": "attempt", "mono_ns": 5, "dur_ns": 2}
    assert validate_record(good) == []
    assert validate_record({**good, "mono_ns": "5"})  # required, wrong type
    assert validate_record({**good, "outcome": 3})    # optional, wrong type
    anchor_bad = {**base, "kind": "run_start", "run_id": "r",
                  "vocab_size": 1, "mesh": [1, 1], "config": {},
                  "wall_ns": 1.5}  # anchor fields are ints, not floats
    assert any("wall_ns" in e for e in validate_record(anchor_bad))


def test_clock_anchor_and_ids():
    a = clock_anchor()
    assert isinstance(a["wall_ns"], int) and isinstance(a["mono_ns"], int)
    assert new_trace_id() != new_trace_id()
    assert new_span_id().startswith("s")
    assert wire_context("t", "s") == {"tid": "t", "ps": "s"}


# -- SLO math ---------------------------------------------------------------------------


def test_slo_objectives_validation():
    with pytest.raises(ValueError, match="availability"):
        SloObjectives(availability=1.0)
    with pytest.raises(ValueError, match="latency_ms"):
        SloObjectives(latency_ms=0)
    with pytest.raises(ValueError, match="windows"):
        SloObjectives(short_window_s=100, long_window_s=10)


def test_burn_rates_window_math():
    # 10 samples over the last 100 s, 2 bad inside the 50 s window, none
    # inside 10 s; objective 0.9 -> budget 0.1
    now = 1000.0
    samples = [(now - 95 + 10 * i, True) for i in range(10)]
    samples[7] = (samples[7][0], False)  # t = 975 -> inside 50 s
    samples[8] = (samples[8][0], False)  # t = 985 -> inside 50 s
    out = burn_rates_from_samples(samples, now, 0.9,
                                  [("w10", 10.0), ("w50", 50.0)])
    assert out["w10"]["samples"] == 1 and out["w10"]["bad"] == 0
    assert out["w10"]["burn_rate"] == 0.0
    assert out["w50"]["samples"] == 5 and out["w50"]["bad"] == 2
    assert out["w50"]["burn_rate"] == pytest.approx(4.0)  # 0.4 / 0.1
    # empty window: burn 0.0 with samples 0 (silence != health, but burns
    # no budget)
    empty = burn_rates_from_samples([], now, 0.9, [("w", 10.0)])
    assert empty["w"] == {"window_s": 10.0, "samples": 0, "bad": 0,
                          "bad_fraction": 0.0, "burn_rate": 0.0}


def test_slo_tracker_within_budget_flip():
    tr = SloTracker(SloObjectives(availability=0.9, latency_ms=100.0,
                                  short_window_s=60, long_window_s=600))
    for _ in range(50):
        tr.note(True, latency_s=0.01)
    snap = tr.snapshot()
    assert snap["availability"] == 1.0
    assert snap["latency_good_fraction"] == 1.0
    assert tr.within_budget(snap)
    for _ in range(20):
        tr.note(False)  # 20/70 bad >> the 10% budget
    snap = tr.snapshot()
    assert not tr.within_budget(snap)
    assert snap["budget_remaining"] < 0  # blown, not just spent
    flat = flatten_burn(snap)
    assert flat["samples"] == 70 and flat["burn_short"] > 1.0


def test_slo_latency_conditioned_on_answered():
    tr = SloTracker(SloObjectives(availability=0.5, latency_ms=100.0,
                                  latency_target=0.5))
    tr.note(True, latency_s=0.01)   # answered fast
    tr.note(True, latency_s=5.0)    # answered slow
    tr.note(False)                  # unanswered: not a latency sample
    snap = tr.snapshot()
    assert snap["latency_good_fraction"] == 0.5  # of the 2 ANSWERED
    assert snap["availability"] == pytest.approx(2 / 3)


# -- fake-replica router tests (trace wire + hedging) -----------------------------------


class FakeReplica:
    """Scripted replica on the fleet client surface (test_fleet.py's
    shape): behavior maps request -> response dict; delay_s resolves late
    so hedges fire."""

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
        import threading
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


def _spans(path):
    with open(path) as f:
        return [json.loads(line) for line in f
                if json.loads(line).get("kind") == "trace_span"]


def test_untraced_requests_cross_the_wire_byte_identical():
    reps = [FakeReplica("r0", ok_syn), FakeReplica("r1", ok_syn)]
    router = FleetRouter(ReplicaSet(reps, can_respawn=False), probe_s=30.0,
                         hedge_ms=0.0, retry_deadline_s=5.0)
    try:
        router.synonyms("w0", 5)
        syn = [r for r in reps[0].calls + reps[1].calls
               if r.get("op") == "synonyms"]
        assert syn and all("trace" not in r for r in syn), \
            "tracing-off requests must carry no trace context"
    finally:
        router.close(close_replicas=False)


def test_traced_requests_carry_wire_context(tmp_path):
    path = str(tmp_path / "router.jsonl")
    reps = [FakeReplica("r0", ok_syn), FakeReplica("r1", ok_syn)]
    router = FleetRouter(ReplicaSet(reps, can_respawn=False), probe_s=30.0,
                         hedge_ms=0.0, retry_deadline_s=5.0,
                         telemetry_path=path)
    try:
        router.synonyms("w0", 5)
        syn = [r for r in reps[0].calls + reps[1].calls
               if r.get("op") == "synonyms"]
        assert syn and all(
            set(r["trace"]) == {"tid", "ps"} for r in syn)
    finally:
        router.close(close_replicas=False)
    spans = _spans(path)
    root = [s for s in spans if s["name"] == "fleet_query"]
    att = [s for s in spans if s["name"] == "attempt"]
    assert len(root) == 1 and root[0]["outcome"] == "ok"
    assert len(att) == 1 and att[0]["parent"] == root[0]["span"]
    # the wire context's parent span IS the attempt span id
    assert syn[0]["trace"]["ps"] == att[0]["span"]
    assert syn[0]["trace"]["tid"] == root[0]["trace_id"]


def test_trace_sample_thins_traces(tmp_path):
    path = str(tmp_path / "router.jsonl")
    reps = [FakeReplica("r0", ok_syn)]
    router = FleetRouter(ReplicaSet(reps, can_respawn=False), probe_s=30.0,
                         hedge_ms=0.0, retry_deadline_s=5.0,
                         telemetry_path=path, trace_sample=4)
    try:
        for _ in range(8):
            router.synonyms("w0", 5)
    finally:
        router.close(close_replicas=False)
    spans = _spans(path)
    assert len([s for s in spans if s["name"] == "fleet_query"]) == 2
    with pytest.raises(ValueError, match="trace_sample"):
        FleetRouter(ReplicaSet([FakeReplica("r0", ok_syn)],
                               can_respawn=False), trace_sample=0)


def test_hedge_loser_is_abandoned_not_failed(tmp_path):
    path = str(tmp_path / "router.jsonl")
    slow = FakeReplica("r0", ok_syn, delay_s=0.4)
    fast = FakeReplica("r1", ok_syn)
    router = FleetRouter(ReplicaSet([slow, fast], can_respawn=False),
                         probe_s=30.0, hedge_ms=20.0, retry_deadline_s=5.0,
                         telemetry_path=path)
    try:
        router._replicas[1].degraded = True  # force the slow primary
        assert len(router.synonyms("w0", 5)) == 5
        assert router.stats()["hedge_wins"] == 1
    finally:
        router.close(close_replicas=False)
    att = {s["replica"]: s["outcome"] for s in _spans(path)
           if s["name"] == "attempt"}
    # the slow-but-healthy primary lost the race: ABANDONED on the
    # timeline — "failed" would read as a sick replica in every review
    assert att == {"r0": "abandoned", "r1": "win"}


def test_hedge_target_dead_at_submit_gets_failed_span(tmp_path):
    path = str(tmp_path / "router.jsonl")

    def dead_at_submit(req):
        from glint_word2vec_torch.serve.fleet import ReplicaError
        if req.get("op") == "synonyms":
            raise ReplicaError("dead at submit")
        return {"publish_sig": "sig-1"}

    slow = FakeReplica("r0", ok_syn, delay_s=0.4)
    dead = FakeReplica("r1", dead_at_submit)
    router = FleetRouter(ReplicaSet([slow, dead], can_respawn=False),
                         probe_s=30.0, hedge_ms=20.0, retry_deadline_s=5.0,
                         telemetry_path=path)
    try:
        router._replicas[1].degraded = True  # force the slow primary
        assert len(router.synonyms("w0", 5)) == 5
        assert router.stats()["failures"] == 0
    finally:
        router.close(close_replicas=False)
    att = {s["replica"]: s["outcome"] for s in _spans(path)
           if s["name"] == "attempt"}
    # the hedge touched the dead replica: the timeline must show it (the
    # mirror of the primary's dead-at-submit failed span)
    assert att == {"r0": "ok", "r1": "failed"}


def test_failed_attempt_and_retry_share_one_trace(tmp_path):
    path = str(tmp_path / "router.jsonl")

    def dying(req):
        from glint_word2vec_torch.serve.fleet import ReplicaError
        if req.get("op") == "synonyms":
            raise ReplicaError("scripted death")
        return {"publish_sig": "sig-1"}

    reps = [FakeReplica("r0", dying), FakeReplica("r1", ok_syn)]
    router = FleetRouter(ReplicaSet(reps, can_respawn=False), probe_s=30.0,
                         hedge_ms=0.0, retry_deadline_s=5.0,
                         breaker_failures=5, telemetry_path=path)
    try:
        router._replicas[1].degraded = True  # force r0 first
        assert len(router.synonyms("w0", 5)) == 5
        assert router.stats()["failures"] == 0
    finally:
        router.close(close_replicas=False)
    spans = _spans(path)
    tids = {s["trace_id"] for s in spans}
    assert len(tids) == 1, "retry must stay inside the SAME trace"
    att = sorted((s["replica"], s["outcome"]) for s in spans
                 if s["name"] == "attempt")
    assert att == [("r0", "failed"), ("r1", "ok")]


# -- propagation through an in-process adopted fleet ------------------------------------


def test_adopted_fleet_cross_process_span_propagation(tmp_path):
    model = make_model()
    svcs = [EmbeddingService(model=model, ann=False,
                             telemetry_path=str(tmp_path / f"r{i}.jsonl"),
                             process_name=f"r{i}") for i in range(2)]
    # container-tolerant latency objective: the FIRST query pays the jit
    # compile (hundreds of ms) — at 7 samples one slow query would blow a
    # 250 ms p99 budget, which is the SLO working, not the test's subject
    lax = SloObjectives(availability=0.999, latency_ms=60_000.0)
    router = FleetRouter(ReplicaSet.adopt(svcs), probe_s=30.0, hedge_ms=0.0,
                         retry_deadline_s=10.0, slo=lax,
                         telemetry_path=str(tmp_path / "router.jsonl"))
    try:
        for i in range(6):
            assert len(router.synonyms(f"w{i}", 5)) == 5
        assert len(router.synonyms_batch(["w1", "w2"], 3)) == 2
        assert router.slo_within_budget()
    finally:
        router.close()  # closes the adopted services too
    timeline, summary = collect([str(tmp_path)], objectives=lax)
    # every router trace reassembles with replica-side children: the
    # context crossed the in-process "wire" exactly like the subprocess one
    cross = [t for t in timeline["traces"].values()
             if len({s["_process"] for s in t["spans"]}) >= 2]
    assert len(cross) == len(timeline["traces"]) >= 7
    for t in timeline["traces"].values():
        names = [s["name"] for s in t["spans"]]
        assert "fleet_query" in names and "attempt" in names
        assert "queue_wait" in names and "batch_service" in names
        assert "exact_scan" in names
        att = next(s for s in t["spans"] if s["name"] == "attempt")
        # replica-side children parent to the attempt span id that rode
        # the request
        for s in t["spans"]:
            if s["name"] in ("queue_wait", "batch_service", "exact_scan"):
                assert s["parent"] == att["span"]
                assert s["_process"] in ("r0", "r1")
    assert summary["slo"]["within_budget"]
    assert summary["attempt_outcomes"] == {
        "ok": len(timeline["traces"])}


# -- the collector on crafted fixtures --------------------------------------------------


def _rec(kind, t=0.0, **fields):
    return json.dumps({"schema": SCHEMA_VERSION, "kind": kind, "t": t,
                       **fields})


def _write(path, lines):
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


WALL0 = 1_700_000_000_000_000_000  # ns


def test_collector_aligns_skewed_clocks_and_out_of_order_files(tmp_path):
    # router: anchor at WALL0 with mono base 500 s
    rm = 500_000_000_000
    # replica: same wall instant, WILDLY different monotonic base (9e15),
    # i.e. a host booted much earlier — alignment must come from the
    # anchor, never from comparing raw monotonic values
    pm = 9_000_000_000_000_000
    router_lines = [
        _rec("fleet_start", t=WALL0 / 1e9, replicas=1, checkpoint="/ck",
             process="router", wall_ns=WALL0, mono_ns=rm),
        # spans written OUT OF ORDER (thread interleaving): attempt line
        # lands before its root
        _rec("trace_span", t=0, trace_id="t1", span="a1", name="attempt",
             parent="q1", mono_ns=rm + 10_000_000, dur_ns=80_000_000,
             replica="r0", outcome="ok", process="router"),
        _rec("trace_span", t=0, trace_id="t1", span="q1",
             name="fleet_query", mono_ns=rm + 5_000_000,
             dur_ns=90_000_000, outcome="ok", op="synonyms",
             process="router"),
    ]
    replica_lines = [
        _rec("serve_start", t=WALL0 / 1e9, checkpoint="/ck", vocab_size=9,
             vector_size=4, process="r0", wall_ns=WALL0, mono_ns=pm),
        _rec("trace_span", t=0, trace_id="t1", span="b1",
             name="batch_service", parent="a1",
             mono_ns=pm + 30_000_000, dur_ns=40_000_000, process="r0"),
        _rec("trace_span", t=0, trace_id="t1", span="w1",
             name="queue_wait", parent="a1", mono_ns=pm + 12_000_000,
             dur_ns=18_000_000, process="r0"),
    ]
    _write(str(tmp_path / "router.jsonl"), router_lines)
    _write(str(tmp_path / "r0.jsonl"), replica_lines)
    timeline = build_timeline(load_process_logs([str(tmp_path)]))
    t1 = timeline["traces"]["t1"]
    order = [(s["name"], s["_wall_ns"] - WALL0) for s in t1["spans"]]
    # merged causal order across BOTH processes, on the fleet wall clock
    assert order == [("fleet_query", 5_000_000), ("attempt", 10_000_000),
                     ("queue_wait", 12_000_000),
                     ("batch_service", 30_000_000)]
    assert t1["root"]["span"] == "q1" and t1["dur_ns"] == 90_000_000


def test_collector_reanchors_across_process_restart(tmp_path):
    # one sink file, TWO anchor epochs: the respawned replica appends with
    # a fresh (smaller!) monotonic base — each span must align through the
    # most recent anchor above it in file order
    m1, m2 = 7_000_000_000_000, 3_000_000_000
    lines = [
        _rec("serve_start", t=WALL0 / 1e9, checkpoint="/ck", vocab_size=9,
             vector_size=4, process="r0", wall_ns=WALL0, mono_ns=m1),
        _rec("trace_span", t=0, trace_id="t1", span="s1", name="queue_wait",
             mono_ns=m1 + 1_000_000, dur_ns=500, process="r0"),
        _rec("serve_start", t=(WALL0 + 60_000_000_000) / 1e9,
             checkpoint="/ck", vocab_size=9, vector_size=4, process="r0",
             wall_ns=WALL0 + 60_000_000_000, mono_ns=m2),
        _rec("trace_span", t=0, trace_id="t2", span="s2", name="queue_wait",
             mono_ns=m2 + 2_000_000, dur_ns=500, process="r0"),
    ]
    _write(str(tmp_path / "r0.jsonl"), lines)
    timeline = build_timeline(load_process_logs([str(tmp_path)]))
    w1 = timeline["traces"]["t1"]["spans"][0]["_wall_ns"]
    w2 = timeline["traces"]["t2"]["spans"][0]["_wall_ns"]
    assert w1 == WALL0 + 1_000_000
    assert w2 == WALL0 + 60_002_000_000  # the SECOND epoch's anchor


def test_collector_publish_chain_joins_by_sig(tmp_path):
    sig = "111-22-333"
    _write(str(tmp_path / "trainer.jsonl"), [
        _rec("run_start", t=100.0, run_id="r", vocab_size=9, mesh=[1, 1],
             config={}),
        _rec("publish", t=101.0, publish_sig=sig, checkpoint="/ck", step=5,
             publisher="trainer"),
    ])
    _write(str(tmp_path / "r0.jsonl"), [
        _rec("serve_start", t=100.5, checkpoint="/ck", vocab_size=9,
             vector_size=4, process="r0"),
        _rec("serve_reload", t=102.0, vocab_size=9, reloads=1,
             load_seconds=0.1, publish_sig=sig),
    ])
    _write(str(tmp_path / "router.jsonl"), [
        _rec("fleet_start", t=100.2, replicas=1, checkpoint="/ck",
             process="router"),
        _rec("fleet_reload", t=103.0, publishes=1, min_serving=1,
             replicas=1, seconds=0.5, publish_sig=sig),
    ])
    timeline = build_timeline(load_process_logs([str(tmp_path)]))
    chain = timeline["publish_chains"][sig]
    assert [(e["kind"], e["_process"]) for e in chain] == [
        ("publish", "trainer"), ("serve_reload", "r0"),
        ("fleet_reload", "router")]


def test_collector_offline_slo_flags_blown_budget(tmp_path):
    lines = [_rec("fleet_start", t=100.0, replicas=1, checkpoint="/ck",
                  process="router", wall_ns=100_000_000_000,
                  mono_ns=1_000)]
    for i in range(10):
        lines.append(_rec(
            "trace_span", t=0, trace_id=f"t{i}", span=f"q{i}",
            name="fleet_query", mono_ns=1_000 + i * 1_000_000_000,
            dur_ns=2_000_000, op="synonyms",
            outcome="failed" if i < 2 else "ok", process="router"))
    _write(str(tmp_path / "router.jsonl"), lines)
    timeline = build_timeline(load_process_logs([str(tmp_path)]))
    slo = recompute_slo(timeline, SloObjectives(
        availability=0.999, short_window_s=60, long_window_s=600))
    assert slo["samples"] == 10 and slo["bad"] == 2
    assert slo["availability"] == 0.8
    assert not slo["within_budget"]
    # the same artifacts pass a lax objective: the gate is the objective's
    tolerant = recompute_slo(timeline, SloObjectives(
        availability=0.5, short_window_s=60, long_window_s=600))
    assert tolerant["within_budget"]


def test_collector_exports_perfetto_and_exemplars(tmp_path):
    model = make_model()
    svc = EmbeddingService(model=model, ann=False,
                           telemetry_path=str(tmp_path / "r0.jsonl"),
                           process_name="r0")
    router = FleetRouter(ReplicaSet.adopt([svc]), probe_s=30.0,
                         hedge_ms=0.0, retry_deadline_s=10.0,
                         telemetry_path=str(tmp_path / "router.jsonl"))
    try:
        for i in range(5):
            router.synonyms(f"w{i}", 5)
    finally:
        router.close()
    timeline, summary = collect([str(tmp_path)], slowest=3)
    assert len(summary["slowest"]) == 3
    # exemplars are sorted slowest-first and carry the full breakdown
    durs = [e["dur_ms"] for e in summary["slowest"]]
    assert durs == sorted(durs, reverse=True)
    assert all(len(e["spans"]) >= 4 for e in summary["slowest"])
    out = str(tmp_path / "timeline.json")
    n = export_perfetto(timeline, out)
    with open(out) as f:
        doc = json.load(f)
    assert n == len(doc["traceEvents"])
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert procs == {"r0", *{p for p in timeline["processes"]
                             if p.startswith("router")}}
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert xs and all(e["dur"] >= 0 and "trace_id" in e["args"]
                      for e in xs)


# -- statusd SLO gauges -----------------------------------------------------------------


def test_fleet_prometheus_renders_slo_gauges():
    from glint_word2vec_torch.obs.statusd import fleet_prometheus_text
    tr = SloTracker(SloObjectives(availability=0.9, latency_ms=100.0,
                                  short_window_s=60, long_window_s=600))
    for i in range(10):
        tr.note(i != 0, latency_s=0.01)  # one unanswered of ten
    snap = {"status": "serving", "queries": 10, "failures": 1,
            "replicas": {}, "slo": tr.snapshot()}
    text = fleet_prometheus_text(snap)
    for needle in (
            "glint_serve_fleet_slo_availability_objective 0.9",
            "glint_serve_fleet_slo_availability 0.9",
            "glint_serve_fleet_slo_samples_total 10",
            'glint_serve_fleet_slo_burn_rate{sli="availability",'
            'window="short"}',
            'glint_serve_fleet_slo_burn_rate{sli="latency",'
            'window="long"}',
            "glint_serve_fleet_slo_budget_remaining"):
        assert needle in text, f"{needle!r} missing from:\n{text}"
    type_lines = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
    assert len(type_lines) == len(set(type_lines))


def test_validate_file_tolerates_torn_tail_only(tmp_path):
    good = _rec("serve_start", t=1.0, checkpoint="/ck", vocab_size=9,
                vector_size=4)
    # SIGKILL mid-flush: a half-written FINAL line
    torn = str(tmp_path / "torn.jsonl")
    with open(torn, "w", encoding="utf-8") as f:
        f.write(good + "\n" + good[: len(good) // 2])
    assert not validate_file(torn)["ok"]  # strict: still an error
    v = validate_file(torn, tolerate_torn_tail=True)
    assert v["ok"] and v["torn_tail"] and not v["errors"]
    # mid-file garbage is CORRUPTION, not a torn tail — fails either way
    midbad = str(tmp_path / "midbad.jsonl")
    with open(midbad, "w", encoding="utf-8") as f:
        f.write(good[: len(good) // 2] + "\n" + good + "\n")
    assert not validate_file(midbad, tolerate_torn_tail=True)["ok"]
    # fleet-mode run_report rides the same tolerance: a torn-tail replica sink must not
    # redden the verdict (the drill kills replicas mid-write)
    from glint_word2vec_torch.run_report import summarize_fleet
    rep = summarize_fleet([torn])
    assert rep["ok"] and rep["processes"]["torn"]["schema_valid"]


# -- run_report fleet mode --------------------------------------------------------------


def test_run_report_fleet_mode(tmp_path):
    from glint_word2vec_torch.obs.blackbox import FlightRecorder
    from glint_word2vec_torch.run_report import summarize_fleet
    ok_log = str(tmp_path / "r0.jsonl")
    _write(ok_log, [
        _rec("serve_start", t=1.0, checkpoint="/ck", vocab_size=9, vector_size=4),
        _rec("serve_end", t=2.0, submitted=5, refused=0, reloads=0),
    ])
    dead_log = str(tmp_path / "r1.jsonl")
    _write(dead_log, [
        _rec("serve_start", t=1.0, checkpoint="/ck", vocab_size=9, vector_size=4),
    ])
    # the dead replica left a flight-recorder dump (the SIGTERM shape)
    fr = FlightRecorder(dead_log + ".blackbox.json")
    fr.begin_run("r1")
    fr.dump(cause=FlightRecorder.signal_cause(15))
    rep = summarize_fleet([ok_log, dead_log])
    assert rep["ok"] and rep["mode"] == "fleet"
    assert rep["processes"]["r0"]["status"] == "ok"
    assert rep["processes"]["r1"]["status"] == "truncated"
    assert rep["processes"]["r1"]["dumped"]
    assert rep["processes"]["r1"]["cause"] == "signal"
    assert rep["merged"]["logs"] == 2 and rep["merged"]["dumps"] == 1
    assert rep["merged"]["schema_valid"]


def test_run_report_fleet_mode_gates_on_error_status(tmp_path):
    # a trainer whose run ended "error" reddens the fleet's verdict; "truncated" (the
    # SIGKILL teardown) is tolerated, an explicit error is not
    from glint_word2vec_torch.run_report import summarize_fleet
    bad = str(tmp_path / "trainer.jsonl")
    _write(bad, [
        _rec("run_start", t=1.0, run_id="r", vocab_size=9, mesh=[1, 1], config={}),
        _rec("run_end", t=2.0, run_id="r", status="error", steps=3, pairs_trained=10,
             wall_seconds=1.0),
    ])
    rep = summarize_fleet([bad])
    assert not rep["ok"]
    assert not rep["processes"]["trainer"]["ok"]
    assert rep["processes"]["trainer"]["status"] == "error"


def test_collector_keeps_rotated_only_logs(tmp_path):
    # killed between rotate and the lazy reopen: ONLY x.jsonl.1 remains —
    # the process must still appear on the merged timeline
    _write(str(tmp_path / "r0.jsonl.1"), [
        _rec("serve_start", t=WALL0 / 1e9, checkpoint="/ck", vocab_size=9,
             vector_size=4, process="r0", wall_ns=WALL0, mono_ns=1_000),
        _rec("trace_span", t=0, trace_id="t1", span="s1", name="queue_wait",
             mono_ns=1_000 + 2_000_000, dur_ns=500, process="r0"),
    ])
    timeline = build_timeline(load_process_logs([str(tmp_path)]))
    assert "r0" in timeline["processes"]
    span = timeline["traces"]["t1"]["spans"][0]
    assert span["_wall_ns"] == WALL0 + 2_000_000


# -- parity with the JAX package ----------------------------------------------------------


def _seeded_samples(seed, n=400, span_s=900.0):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, span_s, n))
    ok = rng.random(n) > 0.03
    return [(float(t), bool(g)) for t, g in zip(times, ok)], float(times[-1]) + 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burn_rates_match_the_jax_package(seed):
    from glint_word2vec_tpu.obs.slo import burn_rates_from_samples as jax_burn
    samples, now = _seeded_samples(seed)
    for objective in (0.9, 0.99, 0.999):
        windows = [("w10", 10.0), ("short", 300.0), ("long", 3600.0)]
        assert burn_rates_from_samples(samples, now, objective, windows) == \
            jax_burn(samples, now, objective, windows)


def test_slo_tracker_matches_the_jax_package(monkeypatch):
    """The same outcomes at the same (scripted) monotonic times give the same snapshot,
    flattened record, gauge lines and budget verdict."""
    from glint_word2vec_tpu.obs.slo import SloObjectives as JObjectives
    from glint_word2vec_tpu.obs.slo import SloTracker as JTracker
    from glint_word2vec_tpu.obs.slo import flatten_burn as jax_flatten
    from glint_word2vec_tpu.obs.slo import slo_gauge_lines as jax_gauges
    from glint_word2vec_torch.obs.slo import slo_gauge_lines

    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    kw = dict(availability=0.99, latency_ms=50.0, latency_target=0.95,
              short_window_s=60.0, long_window_s=600.0)
    mine, theirs = SloTracker(SloObjectives(**kw), ring=256), JTracker(
        JObjectives(**kw), ring=256)
    rng = np.random.default_rng(5)
    snaps = []
    for i in range(600):
        clock[0] += float(rng.exponential(1.5))
        ok = bool(rng.random() > 0.02)
        lat = float(rng.exponential(0.03)) if ok else None
        mine.note(ok, lat)
        theirs.note(ok, lat)
        if i % 97 == 0:
            snaps.append((mine.snapshot(), theirs.snapshot()))
    snaps.append((mine.snapshot(), theirs.snapshot()))
    for a, b in snaps:
        assert a == b
        assert flatten_burn(a) == jax_flatten(b)
        assert mine.within_budget(a) == theirs.within_budget(b)
        got, want = [], []
        slo_gauge_lines(lambda *g: got.append(g), a)
        jax_gauges(lambda *g: want.append(g), b)
        assert got == want


def test_collect_matches_the_jax_package(tmp_path):
    """One set of artifacts a port fleet left behind (router and replica sinks with
    trace spans, a publish chain, a blackbox dump), merged by both collectors: the same
    timeline order, traces, SLO, summary and Perfetto document."""
    from glint_word2vec_tpu.obs.collect import collect as jax_collect
    from glint_word2vec_tpu.obs.collect import export_perfetto as jax_perfetto
    from glint_word2vec_torch.obs.blackbox import FlightRecorder

    model = make_model()
    svcs = [EmbeddingService(model=model, ann=False,
                             telemetry_path=str(tmp_path / f"r{i}.jsonl"),
                             process_name=f"r{i}") for i in range(2)]
    router = FleetRouter(ReplicaSet.adopt(svcs), probe_s=30.0, hedge_ms=0.0,
                         retry_deadline_s=10.0,
                         telemetry_path=str(tmp_path / "router.jsonl"))
    try:
        for i in range(8):
            router.synonyms(f"w{i}", 5)
        router.synonyms_batch(["w1", "w2"], 3)
        with pytest.raises(KeyError):
            router.synonyms("nope", 3)
        router.emit_stats()
    finally:
        router.close()
    sig = "111-22-333"
    with open(tmp_path / "trainer.jsonl", "w", encoding="utf-8") as f:
        f.write(_rec("publish", t=time.time(), publish_sig=sig, checkpoint="/ck",
                     step=5, publisher="trainer") + "\n")
    with open(tmp_path / "r0.jsonl", "a", encoding="utf-8") as f:
        f.write(_rec("serve_reload", t=time.time() + 1, vocab_size=60, reloads=1,
                     load_seconds=0.1, publish_sig=sig) + "\n")
    fr = FlightRecorder(str(tmp_path / "r1.jsonl.blackbox.json"))
    fr.begin_run("r1")
    fr.dump(cause=FlightRecorder.signal_cause(15))
    lax = SloObjectives(availability=0.9, latency_ms=60_000.0)

    from glint_word2vec_tpu.obs.slo import SloObjectives as JObjectives
    mine_tl, mine = collect([str(tmp_path)], objectives=lax, slowest=3)
    jax_tl, theirs = jax_collect([str(tmp_path)], slowest=3, objectives=JObjectives(
        availability=0.9, latency_ms=60_000.0))
    assert mine == theirs
    assert [(e["kind"], e["_process"], e["_wall_ns"]) for e in mine_tl["events"]] == \
        [(e["kind"], e["_process"], e["_wall_ns"]) for e in jax_tl["events"]]
    assert {tid: [s["span"] for s in t["spans"]] for tid, t in mine_tl["traces"].items()} \
        == {tid: [s["span"] for s in t["spans"]] for tid, t in jax_tl["traces"].items()}
    assert mine_tl["publish_chains"].keys() == jax_tl["publish_chains"].keys() == {sig}
    assert mine["slo"]["samples"] == 10 and mine["blackboxes"] == [
        {"process": "r1", "cause": "signal"}]
    a, b = tmp_path / "mine.json", tmp_path / "jax.json"
    assert export_perfetto(mine_tl, str(a)) == jax_perfetto(jax_tl, str(b))
    assert json.loads(a.read_text()) == json.loads(b.read_text())


def test_obs_collect_cli_gates(tmp_path):
    """``python -m glint_word2vec_torch.obs_collect``: one JSON line, the two files
    under ``--out``, and ``--gate`` failing on a blown burn window."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    lines = [_rec("fleet_start", t=100.0, replicas=1, checkpoint="/ck",
                  process="router", wall_ns=100_000_000_000, mono_ns=1_000)]
    for i in range(10):
        lines.append(_rec(
            "trace_span", t=0, trace_id=f"t{i}", span=f"q{i}", name="fleet_query",
            mono_ns=1_000 + i * 1_000_000_000, dur_ns=2_000_000, op="synonyms",
            outcome="failed" if i < 2 else "ok", process="router"))
    _write(str(tmp_path / "router.jsonl"), lines)
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = tmp_path / "out"

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "glint_word2vec_torch.obs_collect",
             str(tmp_path / "router.jsonl"), "--out", str(out), *extra],
            capture_output=True, text=True, env=env, cwd=str(repo), timeout=120)

    r = run("--gate")
    assert r.returncode == 1, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(r.stdout.strip().splitlines()) == 1
    assert not res["ok"] and res["schema_valid"] and res["slo"]["bad"] == 2
    assert (out / "timeline.perfetto.json").exists()
    assert (out / "fleet-summary.json").exists()
    r = run("--gate", "--slo-availability", "0.5")
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout)["ok"]
