"""The serving fleet's CLI, ported from ``tools/fleet_run.py``: N replica processes
behind a :class:`~glint_word2vec_torch.serve.fleet.FleetRouter` (health probes, circuit
breakers, hedged retries, the rolling reload) off one checkpoint publish path.

Stdout carries one JSON line; progress goes to stderr.

Usage::

    # serve a fleet: N replicas of python -m glint_word2vec_torch.serve_checkpoint and
    # the router, until --duration expires (0 = until SIGINT)
    python -m glint_word2vec_torch.fleet_run --checkpoint CK [--replicas N] [--ann]
        [--status-port P] [--telemetry PATH] [--duration S] [--device cuda|cpu]

    # the fleet-kill drill: a small fit -> N replica processes -> a query storm ->
    # SIGKILL one replica, stopped until an attempt is in flight on it (its breaker
    # opens, no client query fails, the replica restarts, its breaker goes half-open
    # then closed) -> a storm of 3 publishes
    # (capacity never below N-1, every reload issued to a drained replica) -> SIGTERM
    # one replica (a valid flight-recorder dump) -> the SLO within budget -> the
    # collector merges every artifact into one timeline
    python -m glint_word2vec_torch.fleet_run --smoke [--device cpu]

The replicas run on ``--device`` (the card by default); on one card they share it, so
the drill's queries per second check function, not fleet capacity. Exit code 0 iff the
run (or every assertion of the drill) passed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _train_checkpoint(workdir: str, n_sentences: int, device: str, seed: int = 4):
    """A small trained checkpoint for the drill (30 words, enough structure to answer
    top-5). The trainer's telemetry is on: its sink carries the clock anchor and one
    ``publish`` record per save, the trainer's half of every publish chain."""
    import numpy as np

    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.train.trainer import Trainer

    rng = np.random.default_rng(seed)
    sents = [[f"w{i}" for i in rng.integers(0, 30, 20)]
             for _ in range(n_sentences)]
    cfg = Word2VecConfig(
        vector_size=8, pairs_per_batch=128, window=3, num_iterations=1,
        steps_per_dispatch=2, heartbeat_every_steps=4, subsample_ratio=0.0,
        prefetch_chunks=0, seed=1, min_count=1,
        telemetry_path=os.path.join(workdir, "trainer.jsonl"))
    vocab = build_vocab(sents, min_count=1)
    trainer = Trainer(cfg, vocab, device=device)
    trainer.fit(encode_sentences(sents, vocab, cfg.max_sentence_length))
    ck = os.path.join(workdir, "publish", "ck")
    trainer.save_checkpoint(ck)
    return ck, trainer, vocab


# how long the drill waits, with the victim stopped, for the router to send it an
# attempt; the storm sends one within milliseconds
KILL_WAIT_S = 5.0
# the interpreter's thread switch interval while the drill stops and kills the victim:
# the poll, the kill and the replica reader's end of file must each get the GIL within
# a fraction of the router's hedge delay (at least 2 ms), where the default is 5 ms
KILL_SWITCH_S = 1e-4


def _kill_with_attempt_in_flight(router, victim) -> int:
    """SIGSTOP the victim, and SIGKILL it as soon as the router counts an attempt in
    flight on it (the stopped process cannot answer one): the attempt ends ``failed``
    and is retried elsewhere under its trace id, the trace the collector leg asserts.
    The stop, the poll and the kill run at a short thread switch interval, so that the
    kill lands well inside the router's hedge delay and the attempt is not first lost
    to a hedge. Returns the attempts in flight at the kill; raises AssertionError, the
    victim resumed, when no attempt comes in :data:`KILL_WAIT_S`."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(KILL_SWITCH_S)
    try:
        os.kill(victim.pid, signal.SIGSTOP)
        deadline = time.monotonic() + KILL_WAIT_S
        while time.monotonic() < deadline:
            n = router.in_flight()[victim.name]
            if n > 0:
                victim.kill()
                time.sleep(0.05)  # the replica's reader meets the end of its pipe
                return n
            time.sleep(0.0002)
        os.kill(victim.pid, signal.SIGCONT)
        raise AssertionError(
            f"no attempt in flight on the stopped replica {victim.name} within "
            f"{KILL_WAIT_S:.0f} s: the kill would land on no attempt")
    finally:
        sys.setswitchinterval(switch)


def run_smoke(workdir: str, n_sentences: int = 300, replicas: int = 3,
              device: str = "cuda", checkpoint: Optional[str] = None,
              publish: Optional[Callable[[], None]] = None,
              words: Optional[Sequence[str]] = None,
              check: Optional[Callable[[str, list], Optional[str]]] = None,
              clients: int = 3, num: int = 5,
              ready_timeout: float = 180.0) -> dict:
    """The fleet-kill drill (the chaos drill's ``fleet-kill`` phase runs it too).
    Returns the report dict; raises AssertionError naming the first broken invariant.

    By default it trains a small checkpoint on ``device`` and publishes by saving that
    trainer again. A caller may serve its own ``checkpoint`` instead: ``publish()`` then
    writes the next publish to that path (and its ``publish`` record to a sink under
    ``workdir``, for the collector's publish chain), ``words`` are the query words and
    ``check(word, result)`` returns an error string for a wrong answer (None if
    right)."""
    import threading

    import numpy as np

    from glint_word2vec_torch.obs.collect import collect
    from glint_word2vec_torch.obs.schema import validate_blackbox_file, validate_file
    from glint_word2vec_torch.obs.slo import SloObjectives
    from glint_word2vec_torch.serve.fleet import CircuitBreaker, FleetRouter, ReplicaSet

    t_start = time.monotonic()
    if checkpoint is None:
        ck, trainer, vocab = _train_checkpoint(workdir, n_sentences, device)
        words = [f"w{i}" for i in range(30)]

        def publish() -> None:  # an atomic save: a fresh inode and mtime, no refit
            trainer.save_checkpoint(ck)

        log(f"[fleet] checkpoint ready: V={vocab.size}")
    else:
        ck = checkpoint
        if publish is None or not words:
            raise ValueError("a caller's checkpoint needs publish= and words=")
    known = set(words)

    def default_check(word: str, res: list) -> Optional[str]:
        if len(res) != num or not all(np.isfinite(s) for _, s in res):
            return f"bad result for {word}: {res}"
        if checkpoint is None and not all(w in known for w, _ in res):
            return f"unknown word in the result for {word}: {res}"
        return None

    check = check or default_check
    telemetry = os.path.join(workdir, "fleet.jsonl")
    # telemetry_dir arms each replica's sink, trace spans and flight recorder: the
    # artifacts the collector leg below merges into one timeline
    t0 = time.monotonic()
    rs = ReplicaSet.spawn(ck, replicas, stderr_dir=workdir, telemetry_dir=workdir,
                          device=device, ready_timeout=ready_timeout)
    start_s = time.monotonic() - t0
    log(f"[fleet] {replicas} replicas ready on {device} in {start_s:.1f}s "
        f"(pids {[r.pid for r in rs.replicas]})")
    # the drill's SLO: production math, seconds-scale windows and a latency bound for a
    # small shared host under the storm
    slo_objectives = SloObjectives(
        availability=0.999, latency_ms=2000.0, latency_target=0.99,
        short_window_s=30.0, long_window_s=300.0)
    router = FleetRouter(
        rs, checkpoint=ck, probe_s=0.1, breaker_failures=2,
        breaker_reset_s=0.5, retry_deadline_s=60.0, attempt_timeout_s=5.0,
        reload_timeout_s=max(300.0, ready_timeout),
        telemetry_path=telemetry, slo=slo_objectives)

    query_errs: List[str] = []
    queries = [0]
    storm_on = threading.Event()
    storm_on.set()

    def storm(ci: int) -> None:
        i = 0
        while storm_on.is_set() or i == 0:
            i += 1
            word = words[(ci * 7 + i) % len(words)]
            try:
                err = check(word, router.synonyms(word, num))
                if err:
                    query_errs.append(err)
            except Exception as e:  # noqa: BLE001 — any raise is the failure
                query_errs.append(f"{type(e).__name__}: {e}")
            queries[0] += 1

    storm_threads = [threading.Thread(target=storm, args=(c,)) for c in range(clients)]
    for c in storm_threads:
        c.start()
    reload_s: List[float] = []
    restart_s = None
    try:
        # let the storm and the probes settle, so the breakers are warm
        time.sleep(1.0)
        assert not query_errs, f"pre-kill failures: {query_errs[0]}"

        # --- 1. the kill: SIGKILL one replica with an attempt in flight on it ---------
        victim = rs.replicas[0]
        old_pid = victim.pid
        t_kill = time.monotonic()
        in_flight = _kill_with_attempt_in_flight(router, victim)
        log(f"[fleet] SIGKILLed replica {victim.name} (pid {old_pid}, stopped with "
            f"{in_flight} attempt(s) in flight on it)")
        # on the transition history, not the state: the prober can restart and
        # trial-close faster than a poll of the state
        deadline = time.monotonic() + 30
        while (not any((f, t) == ("closed", "open") for f, t, _
                       in router.breaker_transitions(victim.name))
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert any((f, t) == ("closed", "open") for f, t, _
                   in router.breaker_transitions(victim.name)), \
            (f"breaker never opened on the killed replica (transitions "
             f"{router.breaker_transitions(victim.name)})")
        log("[fleet] breaker OPEN on the victim; the storm goes on on "
            f"{replicas - 1} replicas")

        # --- 2. recovery: restart -> half-open trial -> closed ------------------------
        deadline = time.monotonic() + 120 + ready_timeout
        while (router.breaker_states()[victim.name] != CircuitBreaker.CLOSED
               and time.monotonic() < deadline):
            time.sleep(0.05)
        restart_s = time.monotonic() - t_kill
        assert router.breaker_states()[victim.name] == CircuitBreaker.CLOSED, \
            (f"killed replica never recovered to CLOSED "
             f"(state {router.breaker_states()[victim.name]}, "
             f"alive {victim.alive()})")
        assert victim.alive() and victim.pid != old_pid, \
            "victim was not respawned as a new process"
        trans = router.breaker_transitions(victim.name)
        states = [t[1] for t in trans]
        assert "open" in states and "half-open" in states, \
            f"breaker skipped states: {trans}"
        last_closed = max(i for i, s in enumerate(states) if s == "closed")
        assert trans[last_closed][0] == "half-open", \
            f"final close did not come from the half-open trial: {trans}"
        log(f"[fleet] victim recovered in {restart_s:.1f}s (pid {victim.pid}); "
            f"breaker transitions: {[f'{a}->{b}' for a, b, _ in trans]}")
        assert not query_errs, \
            f"{len(query_errs)} failed queries across the kill " \
            f"(first: {query_errs[0]})"

        # --- 3. the rolling-reload storm: 3 publishes, capacity >= N-1 ----------------
        publishes = 3
        for p in range(publishes):
            rounds_before = router.stats()["reload_rounds"]
            t_pub = time.monotonic()
            publish()
            deadline = time.monotonic() + 90 + replicas * ready_timeout
            while (router.stats()["reload_rounds"] <= rounds_before
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert router.stats()["reload_rounds"] > rounds_before, \
                f"rolling reload round {p + 1} never ran"
            reload_s.append(round(time.monotonic() - t_pub, 3))
            log(f"[fleet] rolling reload round {p + 1} done in {reload_s[-1]}s "
                "(publish and round)")
        st = router.stats()
        assert st["reload_rounds"] >= publishes, \
            f"only {st['reload_rounds']} rolling rounds for {publishes} publishes"
        assert st["min_serving_during_reloads"] >= replicas - 1, \
            (f"fleet capacity dropped below N-1 during rolling reload "
             f"(min serving {st['min_serving_during_reloads']})")
        for name, rep in st["replicas"].items():
            assert rep["reloads"] >= publishes, \
                f"replica {name} reloaded only {rep['reloads']}x " \
                f"for {publishes} publishes"
            # every reload was issued after the router drained that replica
            assert rep["drained_reloads"] == rep["reloads"], \
                (f"replica {name}: {rep['reloads']} reloads but only "
                 f"{rep['drained_reloads']} were drain-first")
        assert not query_errs, \
            f"{len(query_errs)} failed queries across the reload storm " \
            f"(first: {query_errs[0]})"

        # --- 4. the graceful kill: SIGTERM leaves a flight-recorder dump --------------
        victim2 = rs.replicas[1]
        dump_path = f"{victim2.telemetry_path}.blackbox.json"
        log(f"[fleet] SIGTERM replica {victim2.name} (pid {victim2.pid})")
        victim2.terminate()
        deadline = time.monotonic() + 30
        while not os.path.exists(dump_path) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert os.path.exists(dump_path), \
            f"SIGTERM'd replica left no flight-recorder dump at {dump_path}"
        dump = validate_blackbox_file(dump_path)
        assert dump["ok"], f"the SIGTERM dump is not schema-valid: {dump['errors'][:3]}"
        # the prober respawns it, so close() tears down a whole fleet
        deadline = time.monotonic() + 60
        while not victim2.alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim2.alive(), "SIGTERM'd replica was never respawned"
        assert not query_errs, \
            f"{len(query_errs)} failed queries across the graceful kill " \
            f"(first: {query_errs[0]})"
    finally:
        storm_on.clear()
        for c in storm_threads:
            c.join()
        stats = router.stats()
        slo = router.slo_snapshot()
        slo_ok = router.slo_within_budget()
        router.close()
    assert not query_errs, f"failed queries: {query_errs[0]}"
    assert stats["failures"] == 0, \
        f"{stats['failures']} requests exhausted the retry deadline"
    assert stats["shed_single"] == 0, \
        f"{stats['shed_single']} single queries shed (the drill never saturates a replica)"
    assert queries[0] >= 100, \
        f"storm too thin ({queries[0]} queries) to prove overlap"
    summary = validate_file(telemetry)
    assert summary["ok"], f"fleet telemetry not schema-valid: {summary['errors'][:3]}"
    kinds = summary["kinds"]
    assert kinds.get("fleet_start") == 1 and kinds.get("fleet_end") == 1
    assert kinds.get("fleet_breaker", 0) >= 2, \
        f"breaker transitions missing from telemetry ({kinds})"
    assert kinds.get("fleet_reload", 0) >= publishes
    assert kinds.get("trace_span", 0) >= queries[0], \
        (f"router emitted {kinds.get('trace_span', 0)} spans for "
         f"{queries[0]} queries — trace propagation is off")
    assert kinds.get("fleet_slo", 0) >= 1, "no fleet_slo record"

    # --- 5. the SLO verdict: "zero failed queries" as a measured objective ------------
    assert slo["samples"] >= queries[0] - 3 * replicas, \
        f"SLO tracker missed queries ({slo['samples']}/{queries[0]})"
    assert slo_ok, f"SLO burn over budget across the storm: {slo}"

    # --- 6. the collector leg: merge every artifact the drill left (the router's sink,
    # the N replicas' sinks, the publisher's, the SIGTERM dump) into one timeline
    timeline, merged = collect([workdir], objectives=slo_objectives)
    assert len(merged["processes"]) >= replicas + 2, \
        (f"collector saw only {merged['processes']} — expected router + "
         f"{replicas} replicas + the publisher")
    # a retried query's trace: the failed attempt on the SIGKILLed replica and the
    # success elsewhere, under one trace id
    retried = [
        t for t in timeline["traces"].values()
        if any(s.get("name") == "attempt" and s.get("outcome") == "failed"
               and s.get("replica") == victim.name for s in t["spans"])
        and any(s.get("name") == "attempt" and s.get("outcome") in ("ok", "win")
                and s.get("replica") != victim.name for s in t["spans"])]
    assert retried, \
        "no merged trace shows failed-attempt-on-victim + success-elsewhere"
    # replica-side children crossed the wire
    cross = [t for t in timeline["traces"].values()
             if len({s["_process"] for s in t["spans"]}) >= 2]
    assert cross, "no trace carries spans from more than one process"
    bstates = [(e.get("from_state"), e.get("to_state"))
               for e in timeline["events"] if e["kind"] == "fleet_breaker"]
    assert ("closed", "open") in bstates and ("half-open", "closed") in bstates, \
        f"breaker story incomplete on the merged timeline: {bstates}"
    # the publish chain: a publish record joined to the fleet's reloads by publish_sig
    chained = [sig for sig, evs in timeline["publish_chains"].items()
               if {"publish"} & {e["kind"] for e in evs}
               and {"fleet_reload", "serve_reload"} & {e["kind"] for e in evs}]
    assert chained, \
        f"no publish_sig joins a save to a reload ({list(timeline['publish_chains'])})"
    assert any(b["cause"].get("kind") == "signal" for b in timeline["blackboxes"]), \
        f"no signal-cause blackbox in {merged['blackboxes']}"
    assert merged["slo"]["within_budget"], \
        f"offline SLO burn over budget: {merged['slo']}"

    victim_stats = stats["replicas"]["r0"]
    return {
        "ok": True,
        "device": device,
        "replicas": replicas,
        "clients": clients,
        "start_s": round(start_s, 3),
        "victim_recovery_s": round(restart_s, 3),
        "reload_round_s": reload_s,
        "queries": queries[0],
        "failed_queries": 0,
        "retries": stats["retries"],
        "hedges": stats["hedges"],
        "hedge_wins": stats["hedge_wins"],
        "victim_restarts": victim_stats["restarts"],
        "breaker_transitions": [f"{a}->{b}" for a, b, _ in trans],
        "reload_rounds": stats["reload_rounds"],
        "min_serving_during_reloads": stats["min_serving_during_reloads"],
        "drained_reloads": {n: r["drained_reloads"]
                            for n, r in stats["replicas"].items()},
        "sigterm_dump": {"path": os.path.basename(dump_path), "schema_valid": dump["ok"]},
        "telemetry_kinds": kinds,
        "slo": {k: slo[k] for k in ("samples", "availability", "budget_remaining")},
        "slo_within_budget": bool(slo_ok),
        "collector": {
            "processes": merged["processes"],
            "traces": merged["traces"],
            "spans": merged["spans"],
            "attempt_outcomes": merged["attempt_outcomes"],
            "retried_traces": len(retried),
            "publish_chains": len(chained),
            "blackboxes": merged["blackboxes"],
            "slo_within_budget": merged["slo"]["within_budget"],
        },
        "seconds": round(time.monotonic() - t_start, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.fleet_run",
                                 description=__doc__.split("\n", 1)[0])
    ap.add_argument("--checkpoint", default="",
                    help="publish path the replicas serve and the router watches for "
                         "rolling reloads")
    ap.add_argument("--replicas", type=int, default=None,
                    help="fleet size (default: the checkpoint's serve_fleet_replicas)")
    ap.add_argument("--ann", action="store_true", help="replicas serve the IVF arm")
    ap.add_argument("--status-port", type=int, default=0,
                    help="> 0: serve the fleet's glint_serve_* gauges on "
                         "127.0.0.1:<port>")
    ap.add_argument("--telemetry", default="",
                    help="write fleet_* telemetry records here (JSONL)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="serve this many seconds, then exit (0 = until SIGINT)")
    ap.add_argument("--device", default="cuda",
                    help="where the replicas load the model and run the exact arm "
                         "(default the card; 'cpu' runs the plain versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the fleet-kill drill in a temporary directory")
    ap.add_argument("--smoke-replicas", type=int, default=3)
    ap.add_argument("--sentences", type=int, default=300)
    ap.add_argument("--workdir", default="",
                    help="--smoke working directory (default: a fresh temporary one)")
    args = ap.parse_args(argv)

    # one JSON line leaves this function on every path
    if args.smoke:
        workdir = args.workdir or tempfile.mkdtemp(prefix="glint_fleet_")
        os.makedirs(workdir, exist_ok=True)
        try:
            out, rc = run_smoke(workdir, args.sentences, args.smoke_replicas,
                                device=args.device), 0
        except AssertionError as e:
            out, rc = {"ok": False, "error": str(e)}, 1
        except Exception as e:  # noqa: BLE001 — the one-JSON-line contract
            out, rc = {"ok": False, "error": f"{type(e).__name__}: {e}"}, 1
        finally:
            if not args.workdir:
                shutil.rmtree(workdir, ignore_errors=True)
    else:
        if not args.checkpoint:
            ap.error("--checkpoint is required (or use --smoke)")
        from glint_word2vec_torch.serve.fleet import (
            FleetRouter, ReplicaSet, fleet_knobs_from_checkpoint)
        knobs = fleet_knobs_from_checkpoint(args.checkpoint, replicas=args.replicas)
        n = knobs.pop("replicas")
        log(f"[fleet] spawning {n} replicas on {args.checkpoint} ({args.device})")
        rs = ReplicaSet.spawn(args.checkpoint, n, ann=args.ann, device=args.device)
        router = FleetRouter(
            rs, checkpoint=args.checkpoint, telemetry_path=args.telemetry,
            status_port=args.status_port, **knobs)
        log("[fleet] serving; Ctrl-C to stop"
            + (f" (auto-stop in {args.duration:g}s)" if args.duration else ""))
        try:
            if args.duration:
                time.sleep(args.duration)
            else:
                while True:
                    time.sleep(3600)
        except KeyboardInterrupt:
            log("[fleet] stopping")
        finally:
            stats = router.stats()
            router.close()
        out, rc = {"ok": True, "replicas": n, "device": args.device, **{
            k: stats[k] for k in ("queries", "failures", "retries", "hedges",
                                  "reload_rounds", "healthy")}}, 0
    print(json.dumps(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
