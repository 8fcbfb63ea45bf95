"""Serving bench, ported from ``tools/servebench.py``: the exact and ANN arms through the
real service, on the card.

    python -m glint_word2vec_torch.servebench [--vocab V] [--dim D] [--shard-native]
        [--checkpoint CK] [--device cuda|cpu] [--smoke]

It prints one JSON line on stdout (progress goes to stderr). The arms:

1. **exact per-query**: sequential ``find_synonyms`` calls, one dispatch each;
2. **exact batched**: ``--clients`` threads in a closed loop through the service, the
   batcher coalescing them into batched exact dispatches on the card;
3. **ANN batched**: the same closed loop over the IVF arm (host numpy); the index's
   recall@10, measured at build against the exact full scan, rides the line;
4. **offered load**: an open loop at 0.5x, 1x and 1.5x of the ANN arm's closed-loop
   capacity; refusals (``ServerOverloaded``) and p99 per target;
   ``offered_qps_sustained`` is the highest target with < 1% refusals;
5. **quantized arms**: the int8 and PQ builds through the same closed loop, with
   their footprint (``*_index_bytes``, ``*_bytes_cut`` = f32 bytes over the arm's) and
   recall; their AUTO recall floors (int8 0.99, PQ 0.95) gate the builds, so a build
   below its floor fails the run (``--smoke`` disables the floors). ``--shard-native``
   adds the int8 build straight from a row-shards checkpoint of the same matrix
   (``build_ivf_from_shards``) and checks that its codes equal the in-memory build's.

The headline ``ann_p50_ms``/``ann_p99_ms`` are the half-capacity offered-load row (a
closed loop at saturation measures queueing, N clients over capacity); the closed loop
keeps its own ``*_closed_*`` keys. ``ann_speedup_p50`` is the exact per-query p50 over
that ANN p50.

The default matrix is synthetic and CLUSTERED (unit centroids plus noise of norm
~0.35): trained embeddings are clustered, and a uniform random matrix has no
structure for any index. ``--checkpoint`` serves a real model instead.

``--fleet`` adds the fleet tier: ``--fleet-replicas`` in-process replicas (each its own
model on the device and its own batcher, one shared host IVF index) behind a
:class:`~glint_word2vec_torch.serve.fleet.FleetRouter`, N=1 against N=3 on the exact and
ANN arms at the half-capacity offered point, then the hedge A/B under an injected
straggler on replica 0 (``--straggle-every``, ``--straggle-ms``). On one card the
replicas share it: their queries per second check the router's function, not a fleet's
capacity (``fleet_capacity_note`` in the line says so).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np

from glint_word2vec_torch.lockcheck import make_lock

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[servebench {time.perf_counter() - _T0:.1f}s] {msg}", file=sys.stderr,
          flush=True)


def pct(lats_ms: List[float], p: float) -> float:
    if not lats_ms:
        return float("nan")
    s = sorted(lats_ms)
    return round(s[min(len(s) - 1, int(p * len(s)))], 3)


def clustered_matrix(vocab_size: int, dim: int, clusters: int, seed: int) -> np.ndarray:
    """The synthetic clustered matrix (module doc), float32 [vocab_size, dim]: the
    JAX package's servebench draws the same one from the same seed."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((clusters, dim)).astype(np.float32)
    cents /= np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-12)
    # noise norm ~0.35 relative to the unit centroid at any dim
    noise = rng.standard_normal((vocab_size, dim)).astype(np.float32)
    return cents[rng.integers(0, clusters, vocab_size)] + 0.35 * noise / np.sqrt(dim)


def make_model(vocab_size: int, dim: int, clusters: int, seed: int, device):
    """:func:`clustered_matrix` as a model on ``device``, words ``w0``..."""
    import torch

    from glint_word2vec_torch.data.vocab import Vocabulary
    from glint_word2vec_torch.models.word2vec import Word2VecModel
    m = clustered_matrix(vocab_size, dim, clusters, seed)
    vocab = Vocabulary.from_words_and_counts(
        [f"w{i}" for i in range(vocab_size)], np.ones(vocab_size, np.int64))
    return Word2VecModel(vocab, torch.from_numpy(m), device=device)


def closed_loop(service, words: List[str], num: int, clients: int,
                duration_s: float) -> Dict:
    """``clients`` threads query back to back for ``duration_s``: qps and latency
    percentiles (the service's throughput at this client count)."""
    from glint_word2vec_torch.serve import ServerOverloaded
    lats: List[List[float]] = [[] for _ in range(clients)]
    errs = [0] * clients
    stop_at = time.monotonic() + duration_s

    def client(ci: int) -> None:
        rng = np.random.default_rng(1000 + ci)
        while time.monotonic() < stop_at:
            w = words[int(rng.integers(0, len(words)))]
            t0 = time.monotonic()
            try:
                service.synonyms(w, num)
            except ServerOverloaded:
                errs[ci] += 1
                continue
            lats[ci].append((time.monotonic() - t0) * 1000)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    flat = [x for per in lats for x in per]
    return {"qps": round(len(flat) / wall, 1), "completed": len(flat),
            "refused": sum(errs), "p50_ms": pct(flat, 0.50),
            "p95_ms": pct(flat, 0.95), "p99_ms": pct(flat, 0.99)}


def offered_load(service, words: List[str], num: int, target_qps: float,
                 duration_s: float, workers: int = 16) -> Dict:
    """Open loop: arrivals scheduled at 1/target_qps intervals, so queueing shows up as
    latency and refusals, not as a slower arrival process."""
    from glint_word2vec_torch.serve import ServerOverloaded
    n = max(1, int(target_qps * duration_s))
    start = time.monotonic() + 0.05
    arrivals = [start + i / target_qps for i in range(n)]
    lock = make_lock("servebench.tickets")
    nxt = [0]
    lats: List[float] = []
    refused = [0]
    failed = [0]

    def worker() -> None:
        rng = np.random.default_rng(17)
        while True:
            with lock:
                i = nxt[0]
                if i >= n:
                    return
                nxt[0] += 1
            wait = arrivals[i] - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            w = words[int(rng.integers(0, len(words)))]
            t0 = time.monotonic()
            try:
                service.synonyms(w, num)
            except ServerOverloaded:
                with lock:
                    refused[0] += 1
                continue
            except Exception:  # noqa: BLE001 — counted, not raised
                with lock:
                    failed[0] += 1
                continue
            dt = (time.monotonic() - t0) * 1000
            with lock:
                lats.append(dt)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - start
    done = len(lats)
    return {"target_qps": round(target_qps, 1),
            "achieved_qps": round(done / max(wall, 1e-9), 1),
            "offered": n, "completed": done, "refused": refused[0],
            "failed": failed[0], "refused_frac": round(refused[0] / max(n, 1), 4),
            "p50_ms": pct(lats, 0.50), "p99_ms": pct(lats, 0.99)}


def fleet_tier(args, device) -> Dict:
    """The fleet arms, the JAX bench's ``fleet_tier``: N in-process replicas (each its
    own model on ``device`` and its own batcher; one shared IVF index, read-only) behind
    a router, at the half-capacity offered point, N=1 against N=``--fleet-replicas`` on
    the exact and ANN arms; then the hedge A/B: the N-replica ANN fleet under a 1-in-
    ``--straggle-every`` batch stall of ``--straggle-ms`` on replica 0, hedging off
    against hedging at the healthy fleet's measured p99 (floored at 5 ms, and capped at
    half the stall: on a loaded host the healthy tail can pass the stall, and a hedge
    sent after the stall resolved measures nothing)."""
    import torch

    from glint_word2vec_torch.data.vocab import Vocabulary
    from glint_word2vec_torch.models.word2vec import Word2VecModel
    from glint_word2vec_torch.serve import (EmbeddingService, FleetRouter, ReplicaSet,
                                            build_ivf)

    v, d, n_rep = args.fleet_vocab, args.dim, args.fleet_replicas
    matrix = clustered_matrix(v, d, min(args.clusters, max(8, v // 64)), args.seed)
    vocab = Vocabulary.from_words_and_counts([f"w{i}" for i in range(v)],
                                             np.ones(v, np.int64))
    index = build_ivf(matrix, nprobe=args.nprobe or 0, seed=args.seed)
    log(f"[fleet] shared IVF built: C={index.stats['centroids']} "
        f"recall@10={index.stats.get('recall_at_10')}")
    rng = np.random.default_rng(args.seed + 2)
    qwords = [vocab.words[i] for i in rng.integers(0, v, 2048)]
    num, dur = args.num, args.duration

    def build_fleet(n: int, ann: bool, hedge_ms: float, straggle: bool):
        models = [Word2VecModel(vocab, torch.from_numpy(matrix), device=device)
                  for _ in range(n)]
        # max_delay_ms=0: the router spreads the clients over N batchers, so the
        # coalescing deadline would only add latency. The straggler hits replica 0
        # only: one degraded node in a healthy fleet is what hedging is for
        svcs = [EmbeddingService(
            model=m, ann=ann, ann_index=(index if ann else None),
            nprobe=args.nprobe or None, max_delay_ms=0.0,
            straggle_every=(args.straggle_every if straggle and i == 0 else 0),
            straggle_ms=(args.straggle_ms if straggle and i == 0 else 0.0))
            for i, m in enumerate(models)]
        router = FleetRouter(ReplicaSet.adopt(svcs), hedge_ms=hedge_ms, probe_s=0.25,
                             retry_deadline_s=60.0)
        return router, models

    def run_arm(n: int, ann: bool, hedge_ms: float = 0.0, straggle: bool = False,
                target_qps: float = 0.0) -> Dict:
        router, models = build_fleet(n, ann, hedge_ms, straggle)
        try:
            router.synonyms(qwords[0], num)  # warm
            row: Dict = {}
            if not target_qps:
                cl = closed_loop(router, qwords, num, args.clients, dur)
                row["qps"] = cl["qps"]
                target_qps = max(cl["qps"], 1.0) / 2
            off = offered_load(router, qwords, num, target_qps, min(dur, 2.0))
            row.update(target_qps=off["target_qps"], p50_ms=off["p50_ms"],
                       p99_ms=off["p99_ms"], refused=off["refused"],
                       failed=off["failed"])
            st = router.stats()
            row["hedges"] = st["hedges"]
            row["hedge_wins"] = st["hedge_wins"]
            row["router_failures"] = st["failures"]
            return row
        finally:
            router.close()
            for m in models:
                m.stop()

    out: Dict = {"fleet_vocab": v, "fleet_replicas": n_rep,
                 "fleet_recall_at_10": index.stats.get("recall_at_10"),
                 # the in-process replicas share one index; a deployment pays one copy
                 # per replica host
                 "fleet_index_bytes": index.stats.get("index_bytes"),
                 "fleet_capacity_note": (
                     f"the {n_rep} replicas share one {device.type} device and one "
                     "host: their qps check the router's function, not a fleet's "
                     "capacity")}
    half_targets: Dict = {}
    failed = 0
    for ann in (False, True):
        arm = "ann" if ann else "exact"
        for n in (1, n_rep):
            row = run_arm(n, ann)
            half_targets[(n, ann)] = row["target_qps"]
            failed += row["failed"] + row["router_failures"]
            out[f"fleet{n}_{arm}_qps"] = row["qps"]
            out[f"fleet{n}_{arm}_p50_ms"] = row["p50_ms"]
            out[f"fleet{n}_{arm}_p99_ms"] = row["p99_ms"]
            log(f"[fleet] N={n} {arm}: {row['qps']} qps closed, half-cap "
                f"p50 {row['p50_ms']} ms p99 {row['p99_ms']} ms")
    # hedge past the healthy tail (its p99, floored at 5 ms): duplicates stay rare, and
    # fire before the straggler's stall resolves (at most half the stall)
    healthy_p99 = out[f"fleet{n_rep}_ann_p99_ms"]
    hedge_delay = max(5.0, healthy_p99) if healthy_p99 == healthy_p99 else 5.0
    hedge_delay = min(hedge_delay, args.straggle_ms / 2)
    target = half_targets[(n_rep, True)]
    offrow = run_arm(n_rep, True, hedge_ms=0.0, straggle=True, target_qps=target)
    onrow = run_arm(n_rep, True, hedge_ms=hedge_delay, straggle=True,
                    target_qps=target)
    failed += sum(r["failed"] + r["router_failures"] for r in (offrow, onrow))
    out["fleet_straggle"] = f"r0:1/{args.straggle_every}x{args.straggle_ms}ms"
    out["fleet_hedge_delay_ms"] = round(hedge_delay, 3)
    out["fleet_hedge_off_p99_ms"] = offrow["p99_ms"]
    out["fleet_hedge_on_p99_ms"] = onrow["p99_ms"]
    out["fleet_hedges"] = onrow["hedges"]
    out["fleet_hedge_wins"] = onrow["hedge_wins"]
    out["fleet_hedge_p99_cut"] = (
        round(offrow["p99_ms"] / onrow["p99_ms"], 2)
        if onrow["p99_ms"] and onrow["p99_ms"] == onrow["p99_ms"] else None)
    out["fleet_failed"] = failed
    log(f"[fleet] hedge A/B under straggler {out['fleet_straggle']}: "
        f"p99 {offrow['p99_ms']} ms (off) -> {onrow['p99_ms']} ms (on, "
        f"delay {hedge_delay:.1f} ms), {onrow['hedges']} hedges "
        f"({onrow['hedge_wins']} wins)")
    return out


def card_line() -> str:
    """``name, power limit`` of the card as nvidia-smi reports them, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.servebench",
                                 description=__doc__.split("\n", 1)[0])
    ap.add_argument("--checkpoint", default="",
                    help="serve a real checkpoint instead of the synthetic matrix")
    ap.add_argument("--vocab", type=int, default=400_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--clusters", type=int, default=512)
    ap.add_argument("--num", type=int, default=10, help="top-k per query")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--duration", type=float, default=4.0,
                    help="seconds per closed-loop arm")
    ap.add_argument("--per-query", type=int, default=30,
                    help="sequential queries of the exact per-query arm")
    ap.add_argument("--nprobe", type=int, default=0, help="0 = auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model lives and the exact arm runs")
    ap.add_argument("--shard-native", action="store_true",
                    help="add the int8 build from a row-shards checkpoint of the "
                         "matrix and check its codes against the in-memory build's")
    ap.add_argument("--fleet", action="store_true",
                    help="add the fleet tier: N=1 against N=--fleet-replicas in-process "
                         "replicas behind a router on the exact and ANN arms, and the "
                         "hedge A/B under an injected straggler")
    ap.add_argument("--fleet-replicas", type=int, default=3)
    ap.add_argument("--fleet-vocab", type=int, default=100_000,
                    help="the fleet tier's vocabulary rows (N copies of the matrix "
                         "coexist on the device)")
    ap.add_argument("--straggle-every", type=int, default=3,
                    help="hedge A/B fault injection: every Nth batch of replica 0 "
                         "stalls --straggle-ms")
    ap.add_argument("--straggle-ms", type=float, default=60.0)
    ap.add_argument("--smoke", action="store_true",
                    help="small and fast; the quantized builds' recall floors off")
    args = ap.parse_args(argv)
    if args.smoke:
        args.vocab = min(args.vocab, 20_000)
        args.dim = min(args.dim, 64)
        args.clusters = min(args.clusters, 128)
        args.duration = min(args.duration, 1.0)
        args.clients = min(args.clients, 4)
        args.per_query = min(args.per_query, 8)
        args.fleet_vocab = min(args.fleet_vocab, 8_000)
        args.straggle_ms = min(args.straggle_ms, 40.0)

    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.device import resolve_device
    from glint_word2vec_torch.models.word2vec import Word2VecModel
    from glint_word2vec_torch.serve import (EmbeddingService, build_ivf,
                                            build_ivf_from_shards)
    from glint_word2vec_torch.train.checkpoint import save_row_shards

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    log(f"device {device} ({card})")
    if args.checkpoint:
        model = Word2VecModel.load(args.checkpoint, device=device)
        log(f"serving checkpoint {args.checkpoint}: V={model.num_words:,} "
            f"D={model.vector_size}")
    else:
        model = make_model(args.vocab, args.dim, args.clusters, args.seed, device)
        log(f"synthetic clustered matrix: V={args.vocab:,} D={args.dim} "
            f"({args.clusters} cells)")
    rng = np.random.default_rng(args.seed + 1)
    qwords = [model.vocab.words[i] for i in rng.integers(0, model.num_words, 4096)]

    # -- arm 1: exact per-query ---------------------------------------------------------
    model.norms  # the cached norms, outside the timed region
    for w in qwords[:3]:
        model.find_synonyms(w, args.num)  # warm
    per_lats = []
    for w in qwords[:args.per_query]:
        t0 = time.monotonic()
        model.find_synonyms(w, args.num)
        per_lats.append((time.monotonic() - t0) * 1000)
    exact_pq = {"p50_ms": pct(per_lats, 0.50), "p99_ms": pct(per_lats, 0.99)}
    log(f"exact per-query: p50 {exact_pq['p50_ms']} ms over {len(per_lats)}")

    # -- arm 2: exact batched through the service ---------------------------------------
    svc = EmbeddingService(model=model, ann=False)
    svc.synonyms(qwords[0], args.num)  # warm
    exact_cl = closed_loop(svc, qwords, args.num, args.clients, args.duration)
    occupancy = svc.stats().get("occupancy_mean")
    svc.close()  # the in-memory model stays alive for the next arm
    log(f"exact batched: {exact_cl['qps']} qps, p50 {exact_cl['p50_ms']} ms, "
        f"p99 {exact_cl['p99_ms']} ms, occupancy {occupancy}")

    # -- arm 3: ANN batched through the service -----------------------------------------
    svc = EmbeddingService(model=model, ann=True, nprobe=args.nprobe or None)
    ann_stats = dict(model.ann.stats)
    log(f"IVF built in {ann_stats['build_seconds']}s: C={ann_stats['centroids']} "
        f"nprobe={ann_stats['nprobe']} recall@10={ann_stats.get('recall_at_10')}")
    svc.synonyms(qwords[0], args.num)  # warm
    ann_cl = closed_loop(svc, qwords, args.num, args.clients, args.duration)
    ann_occ = svc.stats().get("occupancy_mean")
    log(f"ann batched: {ann_cl['qps']} qps, p50 {ann_cl['p50_ms']} ms, "
        f"p99 {ann_cl['p99_ms']} ms, occupancy {ann_occ}")

    # -- arm 4: offered load at fractions of the ANN capacity ---------------------------
    offered_rows = []
    sustained = 0.0
    base = max(ann_cl["qps"], 1.0)
    for frac in (0.5, 1.0, 1.5):
        row = offered_load(svc, qwords, args.num, base * frac, min(args.duration, 2.0))
        offered_rows.append(row)
        log(f"offered {row['target_qps']} qps: achieved {row['achieved_qps']}, "
            f"refused {row['refused_frac']:.1%}, p50 {row['p50_ms']} ms, "
            f"p99 {row['p99_ms']} ms")
        if row["refused_frac"] < 0.01 and row["failed"] == 0:
            sustained = max(sustained, row["achieved_qps"])
    svc.close()

    # -- arm 5: quantized indexes --------------------------------------------------------
    # AUTO floors gate the builds (a refusal is the signal), except under --smoke,
    # where toy-scale probe loss would fire the floor about the size, not the code
    matrix = model.syn0.cpu().numpy()
    quant_floor = 0.0 if args.smoke else -1.0
    quant_fields: Dict = {}
    built: Dict = {}
    f32_bytes = ann_stats.get("index_bytes") or 1
    for quant in ("int8", "pq"):
        qix = build_ivf(matrix, nprobe=args.nprobe or 0, seed=args.seed,
                        quant=quant, recall_floor=quant_floor)
        built[quant] = qix
        qstats = dict(qix.stats)
        qsvc = EmbeddingService(model=model, ann=True, ann_index=qix,
                                nprobe=args.nprobe or None)
        qsvc.synonyms(qwords[0], args.num)  # warm
        qcl = closed_loop(qsvc, qwords, args.num, args.clients, args.duration)
        qsvc.close()
        quant_fields.update({
            f"{quant}_qps": qcl["qps"],
            f"{quant}_closed_p50_ms": qcl["p50_ms"],
            f"{quant}_closed_p99_ms": qcl["p99_ms"],
            f"{quant}_recall_at_10": qstats.get("recall_at_10"),
            f"{quant}_recall_floor": qstats["recall_floor"],
            f"{quant}_index_bytes": qstats["index_bytes"],
            f"{quant}_bytes_per_vector": qstats["bytes_per_vector"],
            f"{quant}_bytes_ratio": round(qstats["index_bytes"] / f32_bytes, 4),
            f"{quant}_bytes_cut": round(f32_bytes / max(qstats["index_bytes"], 1), 2),
            f"{quant}_qps_ratio": round(qcl["qps"] / max(ann_cl["qps"], 1e-9), 3),
            f"{quant}_build_s": qstats["build_seconds"],
        })
        if quant == "pq":
            quant_fields["pq_m"] = qstats.get("pq_m")
            quant_fields["pq_rerank"] = qstats.get("rerank")
        log(f"{quant}: built in {qstats['build_seconds']}s, recall@10 "
            f"{qstats.get('recall_at_10')} (floor {qstats['recall_floor']}), "
            f"{qcl['qps']} qps ({quant_fields[f'{quant}_qps_ratio']}x f32-ann), "
            f"{qstats['bytes_per_vector']} B/vec "
            f"({quant_fields[f'{quant}_bytes_ratio']}x f32 bytes)")

    # -- the shard-native build leg --------------------------------------------------------
    if args.shard_native:
        tmp = tempfile.mkdtemp(prefix="servebench-shards-")
        try:
            ck = os.path.join(tmp, "ck")
            save_row_shards(ck, list(model.vocab.words), model.vocab.counts, matrix,
                            Word2VecConfig(vector_size=model.vector_size, min_count=1),
                            rows_per_shard=max(1, -(-model.num_words // 8)))
            six = build_ivf_from_shards(ck, quant="int8", nprobe=args.nprobe or 0,
                                        seed=args.seed, recall_floor=quant_floor)
            # the in-memory int8 build at the same seed and floor is arm 5's
            mem = built["int8"]
            parity = bool(np.array_equal(mem._ids, six._ids)
                          and np.array_equal(mem._storage._codes, six._storage._codes)
                          and np.array_equal(mem._storage._scales,
                                             six._storage._scales))
            quant_fields.update({
                "shard_native_build_s": six.stats["build_seconds"],
                "shard_native_recall_at_10": six.stats.get("recall_at_10"),
                "shard_native_index_bytes": six.stats["index_bytes"],
                "shard_native_parity": parity,
            })
            log(f"shard-native int8 build: {six.stats['build_seconds']}s, recall@10 "
                f"{six.stats.get('recall_at_10')}, codes equal the in-memory "
                f"build's: {parity}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    op = offered_rows[0]
    speedup = (round(exact_pq["p50_ms"] / op["p50_ms"], 2)
               if op["p50_ms"] == op["p50_ms"] and op["p50_ms"] else None)
    result = {
        "metric": "serving_qps_p99",
        "device": str(device), "card": card,
        "vocab_size": model.num_words, "dim": model.vector_size,
        "num": args.num, "clients": args.clients, "smoke": bool(args.smoke),
        "exact_per_query_p50_ms": exact_pq["p50_ms"],
        "exact_per_query_p99_ms": exact_pq["p99_ms"],
        "exact_qps": exact_cl["qps"],
        "exact_closed_p50_ms": exact_cl["p50_ms"],
        "exact_closed_p99_ms": exact_cl["p99_ms"],
        "exact_occupancy_mean": occupancy,
        "ann_qps": ann_cl["qps"],
        "ann_p50_ms": op["p50_ms"],
        "ann_p99_ms": op["p99_ms"],
        "ann_closed_p50_ms": ann_cl["p50_ms"],
        "ann_closed_p99_ms": ann_cl["p99_ms"],
        "ann_occupancy_mean": ann_occ,
        "ann_recall_at_10": ann_stats.get("recall_at_10"),
        "ann_centroids": ann_stats["centroids"],
        "ann_nprobe": ann_stats["nprobe"],
        "ann_build_s": ann_stats["build_seconds"],
        "ann_index_bytes": ann_stats.get("index_bytes"),
        "ann_bytes_per_vector": ann_stats.get("bytes_per_vector"),
        **quant_fields,
        "ann_speedup_p50": speedup,
        "offered_qps_sustained": round(sustained, 1),
        "offered": offered_rows,
    }
    model.stop()
    if args.fleet:
        result.update(fleet_tier(args, device))
    result["seconds"] = round(time.perf_counter() - _T0, 1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
