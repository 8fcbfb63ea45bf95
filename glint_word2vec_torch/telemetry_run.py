"""The scripted telemetry fit, ported from ``tools/telemetry_run.py``: the acceptance
drive of the runtime layer (``obs/``).

A toy fit with telemetry on (the JSONL sink, the host trace spans, the norm watchdog
armed) through the port's :class:`~glint_word2vec_torch.train.trainer.Trainer` on
``--device``, then:

1. every record of the run log validated against the schema catalogue
   (``obs/schema.py``);
2. the exported Chrome trace parsed, holding the producer, dispatch, health-probe and
   checkpoint spans, and on the card the staging span (``stage_put``: the port stages a
   chunk only to a card, where the JAX package puts every chunk on its device);
3. with ``--overhead``, the telemetry's cost: interleaved fits with telemetry off and on
   (4 trials each, the arm order alternated, median steady-state pairs/s);
   ``--status-overhead`` the same with the status endpoint serving and scraped on the on
   arm; ``--trace-overhead`` the fleet's trace propagation off, on and sampled 1 in 16
   (an in-process fleet of 2 replicas).

The toy's 512-pair batches take the per-pair step (the AUTO pool is 0 below 4096 pairs),
so on the card the fit launches the scatter kernel; the result's ``launches`` counts the
kernels' launches during the scripted fit (the wrappers count on the card only). The
overhead fits' 4096-pair batches take the shared pool (the fused kernel).

Artifacts land under ``--out`` (``run.jsonl`` and ``run.jsonl.trace.json``). Stdout
carries exactly one JSON line; progress goes to stderr. Exit code 0 iff the run is ok.

Usage::

    python -m glint_word2vec_torch.telemetry_run --out DIR [--smoke] [--overhead]
        [--status-overhead] [--trace-overhead] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and fails without a card; the CPU runs only when
asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

# the spans the scripted fit must produce: the feed's producer, the chunk's dispatch,
# the health probe and the checkpoint save; on the card the staging copy too
REQUIRED_SPANS = ("producer", "dispatch", "health_probe", "checkpoint_save")
CARD_SPANS = ("stage_put",)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def toy_sentences(n_sentences: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [[f"w{i}" for i in rng.integers(0, 50, 20)] for _ in range(n_sentences)]


def _build(sentences, device: str, **cfg_kw):
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.train.trainer import Trainer
    vocab = build_vocab(sentences, min_count=1)
    enc = encode_sentences(sentences, vocab, 1000)
    cfg = Word2VecConfig(
        vector_size=16, pairs_per_batch=512, window=3, num_iterations=2,
        steps_per_dispatch=4, heartbeat_every_steps=8, subsample_ratio=0.0,
        seed=1, **cfg_kw)
    return Trainer(cfg, vocab, device=device), enc


def _launch_counters():
    from glint_word2vec_torch.ops import fused_sgns, scatter
    return fused_sgns.fused_sgns_shared_step, scatter.scatter_add_rows_


def _launches() -> dict:
    fused, scat = _launch_counters()
    return {"sgns_shared_step": fused.launches, "scatter_add_rows": scat.launches,
            "sgns_shared_step_bf16": fused.bf16_launches,
            "scatter_add_rows_bf16": scat.bf16_launches}


def scripted_fit(out_dir: str, n_sentences: int, device: str) -> dict:
    """One telemetry-on fit; returns the artifacts' summary (validated)."""
    from glint_word2vec_torch.obs.schema import validate_file
    run_log = os.path.join(out_dir, "run.jsonl")
    trainer, enc = _build(toy_sentences(n_sentences), device, telemetry_path=run_log,
                          norm_watch="warn")
    for counter in _launch_counters():
        counter.launches = counter.bf16_launches = 0
    trainer.fit(enc, checkpoint_path=os.path.join(out_dir, "ck"),
                checkpoint_every_steps=16)
    launches = _launches()
    trace_path = run_log + ".trace.json"

    summary = validate_file(run_log)
    spans: list = []
    trace_ok = False
    try:
        with open(trace_path) as f:
            doc = json.load(f)
        spans = sorted({e["name"] for e in doc.get("traceEvents", [])
                        if e.get("ph") == "X"})
        trace_ok = True
    except (OSError, json.JSONDecodeError, KeyError) as e:
        summary["errors"] = summary.get("errors", []) + [f"trace: {e}"]
    required = REQUIRED_SPANS + (CARD_SPANS if trainer.device.type == "cuda" else ())
    missing = [s for s in required if s not in spans]
    # a clean run leaves no flight-recorder dump: the dump is a dying run's artifact
    blackbox_absent = not os.path.exists(run_log + ".blackbox.json")
    ok = bool(summary["ok"] and trace_ok and not missing and blackbox_absent
              and summary["kinds"].get("run_start") == 1
              and summary["kinds"].get("run_end") == 1
              and summary["kinds"].get("heartbeat", 0) >= 1)
    return {
        "ok": ok,
        "device": str(trainer.device),
        "blackbox_absent": blackbox_absent,
        "run_log": run_log,
        "trace": trace_path,
        "records": summary["records"],
        "kinds": summary["kinds"],
        "schema_valid": summary["ok"],
        "schema_errors": summary.get("errors", [])[:5],
        "spans": spans,
        "missing_spans": missing,
        "steps": int(trainer.global_step),
        "heartbeats_in_ring": len(trainer.heartbeats),
        "launches": launches,
    }


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def measure_overhead(n_sentences: int, device: str, trials: int = 4, workdir: str = "",
                     status: bool = False) -> dict:
    """Interleaved telemetry-off/on A/B at heartbeat cadence: the arm order alternates
    each trial (a fixed order measures the host's drift), and each arm is scored by its
    steady-state heartbeat windows (the first two, which hold the graph captures, are
    dropped). The geometry is proportioned as a real run's: multi-chunk dispatches at a
    16-step heartbeat cadence. ``status=True``: the on arm also serves the status
    endpoint and each on-trial scrapes ``/status.json`` and ``/metrics`` once
    mid-fit."""
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.train.trainer import Trainer

    workdir = workdir or tempfile.mkdtemp(prefix="glint_obs_bench_")
    # every fit spans >= ~10 heartbeat windows: some to drop, some to keep
    n_sentences = max(n_sentences, 3000)
    rng = np.random.default_rng(4)
    sents = [[f"w{i}" for i in rng.integers(0, 2000, 30)] for _ in range(n_sentences)]
    geom = dict(vector_size=64, pairs_per_batch=4096, window=3, num_iterations=6,
                steps_per_dispatch=8, heartbeat_every_steps=16, subsample_ratio=0.0,
                seed=1)
    vocab = build_vocab(sents, min_count=1)
    enc = encode_sentences(sents, vocab, 1000)

    warmup = 2
    samples = {"off": [], "on": []}
    scrapes = 0
    for trial in range(trials):
        arms = ("off", "on") if trial % 2 == 0 else ("on", "off")
        for arm in arms:
            kw = {}
            on_heartbeat = None
            scraped: list = []
            if arm == "on":
                kw = dict(telemetry_path=os.path.join(workdir, f"run_{trial}.jsonl"),
                          norm_watch="warn")
                if status:
                    port = _free_port()
                    kw["status_port"] = port

                    def on_heartbeat(rec, _port=port, _s=scraped):
                        if _s:
                            return
                        import urllib.request
                        snap = json.load(urllib.request.urlopen(
                            f"http://127.0.0.1:{_port}/status.json", timeout=5))
                        urllib.request.urlopen(
                            f"http://127.0.0.1:{_port}/metrics", timeout=5).read()
                        assert snap["status"] == "running", snap
                        _s.append(True)
            trainer = Trainer(Word2VecConfig(**geom, **kw), vocab, device=device)
            trainer.fit(enc, on_heartbeat=on_heartbeat)
            scrapes += len(scraped)
            window_pps = [hb.pairs_per_sec for hb in trainer.heartbeats][warmup:]
            samples[arm].extend(window_pps)
            log(f"overhead trial {trial} {arm}: {np.median(window_pps):,.0f} pairs/s "
                f"({len(window_pps)} windows)")
    off = float(np.median(samples["off"]))
    on = float(np.median(samples["on"]))
    spread = float(np.percentile(samples["off"], 75)
                   / max(np.percentile(samples["off"], 25), 1e-9) - 1.0)
    if status:
        assert scrapes == trials, (
            f"status arm scraped {scrapes}/{trials} fits: the endpoint was not live "
            f"during every on-trial")
    return {
        **({"status_arm": True, "status_scrapes": scrapes} if status else {}),
        "telemetry_off_pairs_per_sec": round(off, 1),
        "telemetry_on_pairs_per_sec": round(on, 1),
        # signed: negative means the on arm measured faster, i.e. the overhead is below
        # this host's noise (see window_iqr_frac)
        "telemetry_overhead_frac": round(1.0 - on / off, 4),
        "window_iqr_frac": round(spread, 4),
        "trials": trials,
        "basis": ("median steady-state heartbeat-window pairs/s, "
                  f"{warmup} warmup windows dropped, arm order alternated per trial"),
        "windows_per_arm": len(samples["off"]),
    }


def measure_trace_overhead(device: str, trials: int = 4, queries: int = 400,
                           workdir: str = "") -> dict:
    """The fleet's trace propagation off, on and sampled 1 in 16: an in-process fleet
    of 2 replicas (``ReplicaSet.adopt``) serving one in-memory model, queried back to
    back. Off, no sink exists and the router makes no trace context; on, every query
    writes its spans. Interleaved trials, the arm order alternated, median q/s; the
    batcher at ``max_delay_ms=0`` so the submit and dispatch path is what is timed."""
    import time as _time

    from glint_word2vec_torch.data.vocab import Vocabulary
    from glint_word2vec_torch.models.word2vec import Word2VecModel
    from glint_word2vec_torch.serve.fleet import FleetRouter, ReplicaSet
    from glint_word2vec_torch.serve.service import EmbeddingService

    workdir = workdir or tempfile.mkdtemp(prefix="glint_trace_bench_")
    os.makedirs(workdir, exist_ok=True)
    v, d = 512, 32
    rng = np.random.default_rng(7)
    vocab = Vocabulary.from_words_and_counts([f"w{i}" for i in range(v)],
                                             np.ones(v, np.int64))
    model = Word2VecModel(vocab, rng.standard_normal((v, d)).astype(np.float32),
                          device=device)
    samples = {"off": [], "on": [], "sampled": []}
    for trial in range(trials):
        order = ("off", "on", "sampled")
        arms = order if trial % 2 == 0 else order[::-1]
        for arm in arms:
            def p(name):
                return (os.path.join(workdir, f"t{trial}_{name}.jsonl")
                        if arm != "off" else "")
            svcs = [EmbeddingService(model=model, ann=False, max_delay_ms=0.0,
                                     telemetry_path=p(f"{arm}_r{i}"),
                                     process_name=f"r{i}", device=device)
                    for i in range(2)]
            router = FleetRouter(ReplicaSet.adopt(svcs), probe_s=30.0, hedge_ms=0.0,
                                 retry_deadline_s=10.0,
                                 telemetry_path=p(f"{arm}_router"),
                                 trace_sample=16 if arm == "sampled" else 1)
            try:
                for i in range(32):  # warm the dispatch path
                    router.synonyms(f"w{i}", 5)
                t0 = _time.perf_counter()
                for i in range(queries):
                    router.synonyms(f"w{i % v}", 5)
                dt = _time.perf_counter() - t0
            finally:
                router.close()
            samples[arm].append(queries / dt)
            log(f"trace-overhead trial {trial} {arm}: {queries / dt:,.0f} q/s")
    off = float(np.median(samples["off"]))
    on = float(np.median(samples["on"]))
    sampled = float(np.median(samples["sampled"]))
    return {
        "tracing_off_qps": round(off, 1),
        "tracing_on_qps": round(on, 1),
        "tracing_sampled_16_qps": round(sampled, 1),
        # signed; negative = below this host's noise
        "tracing_on_overhead_frac": round(1.0 - on / off, 4),
        "tracing_sampled_16_overhead_frac": round(1.0 - sampled / off, 4),
        "trials": trials,
        "queries_per_arm_per_trial": queries,
        "basis": ("median q/s over interleaved off/on/sampled trials, arm order "
                  "alternated, in-process 2-replica fleet, max_delay_ms=0"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.telemetry_run",
                                 description=__doc__.split("\n", 1)[0])
    ap.add_argument("--out", default="",
                    help="artifact directory (default: a fresh temporary directory)")
    ap.add_argument("--smoke", action="store_true", help="small corpus, fast")
    ap.add_argument("--overhead", action="store_true",
                    help="also run the interleaved telemetry-off/on throughput A/B")
    ap.add_argument("--status-overhead", action="store_true",
                    help="the overhead A/B with the status endpoint serving (and "
                         "scraped mid-fit) on the on arm")
    ap.add_argument("--trace-overhead", action="store_true",
                    help="the fleet's trace propagation off/on/sampled A/B")
    ap.add_argument("--device", default="cuda",
                    help="the fits' device (default cuda; cpu only when asked for)")
    args = ap.parse_args(argv)

    out_dir = args.out or tempfile.mkdtemp(prefix="glint_telemetry_")
    os.makedirs(out_dir, exist_ok=True)
    n = 300 if args.smoke else 1500

    log(f"telemetry_run: scripted fit on {args.device} -> {out_dir}")
    result = scripted_fit(out_dir, n, args.device)
    if args.overhead:
        result["overhead"] = measure_overhead(n, args.device,
                                              workdir=os.path.join(out_dir, "bench"))
    if args.status_overhead:
        result["status_overhead"] = measure_overhead(
            n, args.device, workdir=os.path.join(out_dir, "bench_status"), status=True)
    if args.trace_overhead:
        result["trace_overhead"] = measure_trace_overhead(
            args.device, trials=3 if args.smoke else 4,
            queries=200 if args.smoke else 400,
            workdir=os.path.join(out_dir, "bench_trace"))
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
