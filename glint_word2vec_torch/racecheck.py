"""The lock-discipline run-time check, ported from ``tools/racecheck.py``: the
concurrent serving and observability stack run under the checked lock wrappers of
:mod:`.lockcheck` (``GLINT_LOCKCHECK=1``) with a seeded schedule perturber, gated on the
executed evidence:

- every acquisition-order edge taken is recorded per thread;
- a rank inversion against :data:`.lockcheck.LOCK_TABLE` is a finding, and the gate is
  zero inversions beyond the committed baseline (``racecheck_baseline.json`` beside this
  module, normally empty);
- held-while-blocking windows (a thread blocking while it holds another lock) are
  counted and reported;
- checking off is shown to cost nothing first, in the same process: the factories must
  return the raw ``threading`` primitives (no wrapper allocated), and an interleaved
  min-of-k A/B of a factory-made lock against a raw one must sit below 1.25x.

``--smoke`` builds an in-process stack on ``--device`` (a batcher, the reload watcher,
the status endpoint and a telemetry sink, serving a toy model) and hammers it from query,
scrape, dump and publish threads for a bounded, seeded burst. The full run then drives
the chaos drill's ``serve-reload`` and ``fleet-kill`` phases with checking on, exported
to the replica processes through the environment.

The report also carries the static cross-check: ``static_edges``, the acquisition
graph of the port's graftlint R9 (:mod:`.graftlint.concurrency`), and
``edges_unexplained``, the edges the schedule executed that the static graph did not
predict (a nesting through a stored closure, say). It is informational, as in the JAX
tool: the rank gate judges every executed edge either way.

Stdout carries exactly one JSON line; exit code 0 iff ok. ``--device`` defaults to
``cuda`` and fails without a card; the CPU runs only when asked for.

Usage::

    python -m glint_word2vec_torch.racecheck [--smoke] [--device cuda|cpu]
        [--seed N] [--perturb P] [--duration S] [--sentences N] [--workdir DIR]
        [--baseline FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import threading
import time
import urllib.request

BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "racecheck_baseline.json")

# parity threshold for the off-mode A/B: the factories return the raw primitive, so
# the true ratio is 1.0; min-of-k still jitters a few percent on a busy host, and
# anything under 1.25x is indistinguishable from running the same loop twice. A wrapper
# would cost 3-10x.
_ZERO_COST_RATIO = 1.25


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _zero_cost_probe() -> dict:
    """With checking off (the process default), the factories must hand back raw
    primitives (the same types, no wrappers) and cost the same."""
    from glint_word2vec_torch import lockcheck

    raw_types = (
        type(lockcheck.make_lock("serve.handle"))  # graftlint: disable=R9 -- off-mode probe: off-site construction is the test
        is type(threading.Lock())  # graftlint: disable=R9 -- the raw type compared
        and type(lockcheck.make_rlock("obs.sink"))  # graftlint: disable=R9 -- off-mode probe: off-site construction is the test
        is type(threading.RLock())  # graftlint: disable=R9 -- the raw type compared
        and isinstance(
            lockcheck.make_condition("serve.batcher.cv"),  # graftlint: disable=R9 -- off-mode probe: off-site construction is the test
            threading.Condition))

    def bench(lk, n: int = 20000) -> int:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with lk:
                pass
        return time.perf_counter_ns() - t0

    raw = threading.Lock()  # graftlint: disable=R9 -- raw primitive is the A/B control
    made = lockcheck.make_lock("serve.handle")  # graftlint: disable=R9 -- off-mode probe: off-site construction is the test
    bench(raw), bench(made)  # warm both code paths before timing
    # in turns (raw, made, made, raw, ...), so a change of the host's speed during the
    # probe (a busy neighbour, a clock step) reaches both sides alike
    times: dict = {"raw": [], "made": []}
    for i in range(8):
        for name in (("raw", "made") if i % 2 == 0 else ("made", "raw")):
            times[name].append(bench(raw if name == "raw" else made))
    a, b = min(times["raw"]), min(times["made"])
    ratio = b / a if a else float("inf")
    return {
        "raw_types": raw_types,
        "wrappers_allocated": lockcheck.wrappers_allocated(),
        "ns_raw_min": a, "ns_factory_min": b,
        "ratio": round(ratio, 3),
        "ok": (raw_types and lockcheck.wrappers_allocated() == 0
               and ratio < _ZERO_COST_RATIO),
    }


def _smoke_stack(workdir: str, seed: int, perturb: float, duration_s: float,
                 device: str) -> dict:
    """Build the batcher, reload, status and sink stack with checking on and hammer it
    from four threads: queries, status scrapes, flight-recorder dumps with stats
    records, and checkpoint publishes (hot reloads)."""
    from glint_word2vec_torch import lockcheck

    lockcheck.configure(enabled=True, seed=seed, perturb=perturb)
    lockcheck.reset()

    from glint_word2vec_torch.chaos_run import toy_config, toy_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.serve import EmbeddingService
    from glint_word2vec_torch.train.trainer import Trainer

    sents = toy_sentences(120, seed=seed)
    vocab = build_vocab(sents, min_count=1)
    trainer = Trainer(toy_config(), vocab, device=device)
    ck = os.path.join(workdir, "ck")
    trainer.save_checkpoint(ck)

    port = _free_port()
    service = EmbeddingService(
        checkpoint=ck, ann=False, watch=True, reload_poll_s=0.02, max_batch=8,
        max_delay_ms=0.5, status_port=port,
        telemetry_path=os.path.join(workdir, "tele.jsonl"), device=device)
    errors: list = []
    stop = threading.Event()
    words = [w for w in vocab.words[:8] if w]

    def _guard(fn):
        def run():
            try:
                while not stop.is_set():
                    fn()
            except Exception as e:  # noqa: BLE001 — any raise fails the run
                errors.append(f"{type(e).__name__}: {e}")
        return run

    def queries():
        for w in words:
            service.vector(w, timeout=30.0)

    def scrapes():
        urllib.request.urlopen(f"http://127.0.0.1:{port}/status.json", timeout=5).read()
        time.sleep(0.002)

    def dumps():
        service.dump_blackbox({"kind": "racecheck"}, include_stats=False)
        service.stats()
        service.emit_stats()
        time.sleep(0.002)

    def publishes():
        trainer.save_checkpoint(ck)
        time.sleep(0.05)

    threads = [threading.Thread(target=_guard(f), name=f"racecheck-{f.__name__}")
               for f in (queries, scrapes, dumps, publishes)]
    try:
        for t in threads:
            t.start()
        time.sleep(duration_s)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        leaked = service.close()
    if any(t.is_alive() for t in threads):
        errors.append("racecheck hammer thread failed to join")
    if leaked:
        errors.append(f"service leaked {leaked} thread(s) on close")
    rep = lockcheck.report()
    rep["errors"] = errors
    rep["reloads_observed"] = service.reloads
    return rep


def _chaos_phases(workdir: str, n_sentences: int, device: str) -> dict:
    """The full run's second leg: the two chaos phases with the most threads, checking
    exported to the replica processes through the environment."""
    from glint_word2vec_torch.chaos_run import phase_fleet_kill, phase_serve_reload

    out = {}
    for name, fn, sub in [("serve-reload", phase_serve_reload, "p_reload"),
                          ("fleet-kill", phase_fleet_kill, "p_fleet")]:
        d = os.path.join(workdir, sub)
        os.makedirs(d, exist_ok=True)
        try:
            out[name] = fn(d, n_sentences, device)
        except Exception as e:  # noqa: BLE001 — any raise is the failure
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _static_cross_check(runtime_edges: list) -> dict:
    """Edges the schedule executed but the static R9 graph did not predict:
    informational (the rank gate already judged them), reported so that a statically
    invisible nesting is at least visible in the report."""
    from glint_word2vec_torch.graftlint.concurrency import R9LockOrder, TreeIndex

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    static = {f"{a}->{b}" for a, b in R9LockOrder().edges(TreeIndex(root))}
    return {"static_edges": sorted(static),
            "edges_unexplained": sorted(set(runtime_edges) - static)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.racecheck",
                                 description=__doc__.split("\n", 1)[0])
    ap.add_argument("--smoke", action="store_true", help="the in-process stack only")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--perturb", type=float, default=0.05,
                    help="per-acquire yield probability (seeded)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="hammer seconds (default 1.5 smoke / 3.0 full)")
    ap.add_argument("--sentences", type=int, default=300)
    ap.add_argument("--workdir", default="")
    ap.add_argument("--baseline", default=BASELINE)
    ap.add_argument("--device", default="cuda",
                    help="the served model's device (default cuda; cpu only when "
                         "asked for)")
    args = ap.parse_args(argv)

    mode = "smoke" if args.smoke else "full"
    duration = args.duration or (1.5 if args.smoke else 3.0)
    workdir = args.workdir or tempfile.mkdtemp(prefix="glint_racecheck_")
    os.makedirs(workdir, exist_ok=True)

    # 1) zero cost off, shown before anything turns checking on
    zero_cost = _zero_cost_probe()

    # 2) the checked in-process stack
    rep = _smoke_stack(workdir, args.seed, args.perturb, duration, args.device)

    # 3) full mode: the chaos phases, checking exported to the children
    phases: dict = {}
    if mode == "full":
        os.environ["GLINT_LOCKCHECK"] = "1"
        os.environ["GLINT_LOCKCHECK_SEED"] = str(args.seed)
        os.environ["GLINT_LOCKCHECK_PERTURB"] = str(args.perturb)
        phases = _chaos_phases(workdir, args.sentences, args.device)
        from glint_word2vec_torch import lockcheck
        rep = lockcheck.report()  # accumulated across the stack and the phases
        rep["errors"] = []

    cross = _static_cross_check(rep["edges"])

    try:
        with open(args.baseline, "r", encoding="utf-8") as f:
            allowed = json.load(f).get("inversions", [])
        baseline_ok = True
    except OSError:
        allowed, baseline_ok = [], False
    allowed_keys = {(i["held"], i["acquiring"]) for i in allowed}
    unbaselined = [i for i in rep["inversions"]
                   if (i["held"], i["acquiring"]) not in allowed_keys]

    ok = (zero_cost["ok"] and baseline_ok and not unbaselined
          and not rep["errors"] and rep["acquisitions"] > 0
          and all(v == "" for v in phases.values()))
    print(json.dumps({
        "tool": "racecheck", "schema": 1, "mode": mode, "ok": ok,
        "device": args.device, "seed": args.seed, "perturb": args.perturb,
        "zero_cost": zero_cost,
        "lockcheck": rep,
        "inversions_unbaselined": unbaselined,
        "baseline_found": baseline_ok,
        "phases": phases,
        **cross,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
