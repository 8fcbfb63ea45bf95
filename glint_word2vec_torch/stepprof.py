"""Where the time of one of the port's training paths goes, on one NVIDIA GPU.

    python -m glint_word2vec_torch.stepprof [--path PATH] [--feed numpy,native]
        [--prefetch 8,0] [--rounds R] [--switch-interval S] [--seed N] [--tokens N]
        [--out FILE]

``--path`` picks the step: ``shared`` (skip-gram, shared pool: the fused kernel, the
default), ``per_pair`` (skip-gram, ``negative_pool=0``), ``cbow`` (scatter CBOW, shared
pool) or ``cbow_per_example`` (scatter CBOW, ``negative_pool=0``); the last three
scatter their rows through the row-scatter kernel. ``shared_devpairs`` and
``per_pair_devpairs`` are the two skip-gram steps fed by the device pair generator
(``device_pairgen=True``): the host ships token blocks and the card expands them.
Two measurements at the model's full width (V=1,000,000, D=300 padded to 384,
B=8192, n=5; the AUTO pool resolves to P=256 at this vocabulary), printed as one JSON
line:

- ``step``: device time of each CUDA kernel of one step (torch.profiler, mean over the
  profiled steps), on random parameters and Zipf indices;
- ``fit``: ``Trainer.fit`` over a synthetic Zipf corpus, twice from fresh trainers:
  once plain (wall time, steps, pairs/s, and the trainer's ``host_wait_s`` and
  ``dispatch_s``) and once under torch.profiler (the device's busy time, the sum of
  device-side event times, and its idle share of that fit's wall time; the host ops'
  self time per thread); beside them, ``feed_only_s``, the time one pass of the feed
  that ran (``feed_backend``, at the config's ``producer_workers``) alone takes over
  the same corpus. On the device-feed paths it adds ``tokens_per_step``,
  ``dropped_pairs`` and ``generator``: the device time of the pair generator on the
  fit's first chunk (one batched call for its K steps; torch.profiler, per step).

``--feed`` picks the skip-gram pair generator (default: the trainer's choice, native
when it is built; CBOW has only numpy; ``device`` runs the path's device-feed twin),
``--prefetch`` the config's ``prefetch_chunks`` (default 8; 0 assembles and copies the
chunks on the calling thread). Both take comma-separated lists; the profile runs the first of each, and
``--rounds R`` adds ``ab``: plain fits of every pair, R rounds in turns (the order
reversed each round), with their medians and one feed-alone pass per round.
``--switch-interval`` sets the interpreter's GIL switch interval for the run, to test
whether the producer thread's cost is the consumer waiting for the GIL.

It needs a CUDA device and exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data import native
from glint_word2vec_torch.data.pipeline import (
    encode_sentences, epoch_batches, epoch_batches_cbow)
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_torch.ops.pairgen import device_block_pairs
from glint_word2vec_torch.ops.sgns import (
    EmbeddingPair, cbow_step_core, cbow_step_shared_core, sgns_step_core)
from glint_word2vec_torch.train.trainer import Trainer

V, D_REAL, D, B, P, N_NEG, WINDOW = 1_000_000, 300, 384, 8192, 256, 5, 5
PATHS = ("shared", "per_pair", "cbow", "cbow_per_example", "shared_devpairs",
         "per_pair_devpairs")
DEVPAIRS = "_devpairs"


def _device_us(evt) -> float:
    """Self device time of a profiler event average, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _short(name: str) -> str:
    """A kernel's name without its namespace, template and argument lists."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0]


def kernel_times(prof) -> dict:
    """Device-side events only (kernels, memcpy, memset): the host-side op events
    carry their kernels' time too and would count it twice."""
    out = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type != torch.autograd.DeviceType.CPU:
            entry = out.setdefault(_short(evt.key), {"us_total": 0.0, "count": 0})
            entry["us_total"] += us
            entry["count"] += int(evt.count)
    return out


def host_times(prof, top: int = 12) -> dict:
    """Self host time of the profiled ops, per thread (the consumer, and the producer
    when it runs): the ``top`` ops of each by total µs, with their call counts."""
    per = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        ops = per.setdefault(evt.thread, {})
        entry = ops.setdefault(evt.name, [0.0, 0])
        entry[0] += float(evt.self_cpu_time_total)
        entry[1] += 1
    out = {}
    for thread, ops in per.items():
        total = sum(v[0] for v in ops.values())
        ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
        out[str(thread)] = {"self_us_total": total, "top": {
            name: {"us_total": us, "count": n} for name, (us, n) in ranked}}
    return out


def path_config(path: str, seed: int, prefetch: int = 8) -> Word2VecConfig:
    """The model at full width on one path."""
    knobs = dict(vector_size=D_REAL, window=WINDOW, negatives=N_NEG, pairs_per_batch=B,
                 min_count=1, heartbeat_every_steps=16, seed=seed,
                 prefetch_chunks=prefetch, device_pairgen=path.endswith(DEVPAIRS))
    if path.removesuffix(DEVPAIRS) in ("per_pair", "cbow_per_example"):
        knobs["negative_pool"] = 0
    return Word2VecConfig(cbow=path.startswith("cbow"), **knobs)


def step_call(path: str, seed: int):
    """One metrics-off step of ``path`` on random parameters and Zipf indices (a
    device-feed path's step is its host-fed twin's)."""
    path = path.removesuffix(DEVPAIRS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    syn0 = torch.zeros((V, D), device="cuda")
    syn1 = torch.zeros((V, D), device="cuda")
    syn0[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    syn1[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    params = EmbeddingPair(syn0, syn1)

    def zipf(shape):
        return torch.from_numpy((rng.zipf(1.1, shape) - 1) % V).cuda()

    c, x, mask = zipf(B), zipf(B), torch.ones(B, device="cuda")
    neg = zipf(P) if path in ("shared", "cbow") else zipf((B, N_NEG))
    if path == "shared":
        return lambda: fused_sgns_shared_step(params, c, x, mask, neg, 0.025, N_NEG,
                                              "exact", False)
    if path == "per_pair":
        return lambda: sgns_step_core(params, c, x, mask, neg, 0.025)
    # the legacy window's context counts: b + max(b - 1, 0) for b in 1..window-1
    b = rng.integers(1, WINDOW, B)
    nctx = torch.from_numpy(2 * b - 1).cuda()
    C = 2 * WINDOW
    ctx_mask = (torch.arange(C, device="cuda")[None, :] < nctx[:, None]).float()
    ctx = zipf((B, C)) * ctx_mask.long()
    if path == "cbow":
        return lambda: cbow_step_shared_core(params, c, ctx, ctx_mask, mask, neg, 0.025,
                                             N_NEG, "exact", False)
    return lambda: cbow_step_core(params, c, ctx, ctx_mask, mask, neg, 0.025)


def profile_call(fn, steps: int) -> dict:
    """:func:`kernel_times` of ``steps`` calls of ``fn`` under torch.profiler, after
    three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    return kernel_times(prof)


def profile_step(path: str, seed: int, steps: int = 20) -> dict:
    kt = profile_call(step_call(path, seed), steps)
    per_step = {k: v["us_total"] / steps for k, v in kt.items()}
    return {"steps": steps, "device_us_per_step": per_step,
            "total_device_us_per_step": sum(per_step.values())}


def fit_corpus(seed: int, n_tokens: int):
    """A Zipf(1) vocabulary of V words and ``n_tokens`` tokens drawn from it, in
    40-token sentences, encoded."""
    rng = np.random.default_rng(seed)
    counts = (1e9 / np.arange(1, V + 1)).astype(np.int64) + 1
    words = [f"w{i}" for i in range(V)]
    ids = rng.choice(V, size=n_tokens, p=counts / counts.sum())
    toks = [words[i] for i in ids]
    sents = [toks[i:i + 40] for i in range(0, n_tokens, 40)]
    vocab = Vocabulary.from_words_and_counts(words, counts)
    return vocab, encode_sentences(sents, vocab)


def feed_pass(trainer: Trainer, encoded) -> tuple:
    """(batches, seconds) of one pass of the trainer's feed alone, at its config's
    backend and ``producer_workers`` (the token-block chunks on the device feed)."""
    cfg = trainer.config
    if cfg.device_pairgen:
        t0 = time.perf_counter()
        n = sum(c["real"] for c in trainer._token_chunk_stream(encoded, 1.0, 1.0))
        return n, time.perf_counter() - t0
    kw = dict(pairs_per_batch=B, window=WINDOW, seed=cfg.seed,
              subsample_ratio=cfg.subsample_ratio, producer_workers=cfg.producer_workers)
    if not cfg.cbow:
        kw["backend"] = trainer.feed_backend
    t0 = time.perf_counter()
    n = sum(1 for _ in (epoch_batches_cbow if cfg.cbow else epoch_batches)(
        encoded, trainer.vocab, **kw))
    return n, time.perf_counter() - t0


def timed_fit(trainer: Trainer, encoded) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(encoded)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"feed_backend": trainer.feed_backend,
            "prefetch_chunks": trainer.config.prefetch_chunks, "steps": trainer.global_step,
            "pairs": trainer.pairs_trained, "fit_wall_s": wall,
            "pairs_per_s": trainer.pairs_trained / wall,
            "host_wait_s": trainer.host_wait_time, "dispatch_s": trainer.dispatch_time,
            **({"tokens_per_step": trainer._tokens_per_step,
                "dropped_pairs": trainer.dropped_pairs}
               if trainer.config.device_pairgen else {})}


def profile_generator(trainer: Trainer, encoded, calls: int = 20) -> dict:
    """Device time of the pair generator on the first chunk of the trainer's feed:
    one batched call expands its K blocks; the record gives the chunk's and one
    step's share."""
    cfg = trainer.config
    chunk = next(iter(trainer._token_chunk_stream(encoded, 1.0, 1.0)))
    a = {k: torch.from_numpy(v).cuda().long() for k, v in chunk["arrays"].items()}

    def call():
        return device_block_pairs(
            a["tokens"], a["starts"], a["nvalid"], a["obase"][:, 0], a["obase"][:, 1],
            trainer._keep_prob_dev, chunk["sub_base"], chunk["win_base"], cfg.window,
            cfg.pairs_per_batch, presubsampled=True)

    kt = profile_call(call, calls)
    per_chunk = sum(v["us_total"] for v in kt.values()) / calls
    return {"steps_per_call": chunk["real"], "tokens_per_step": trainer._tokens_per_step,
            "device_us_per_chunk": per_chunk,
            "device_us_per_step": per_chunk / chunk["real"],
            "kernels_per_call": sum(v["count"] for v in kt.values()) / calls}


def make_trainer(path: str, seed: int, prefetch: int, feed: str, vocab) -> Trainer:
    """A fresh trainer of ``path``; ``feed="device"`` runs a skip-gram path on the
    device pair generator (its ``_devpairs`` twin), a host feed on the host-fed
    twin."""
    base = path.removesuffix(DEVPAIRS)
    if feed == "device":
        path = base + DEVPAIRS
    elif feed != "auto":
        path = base
    return Trainer(path_config(path, seed, prefetch), vocab, device="cuda",
                   feed_backend=feed)


def profile_fit(path: str, seed: int, corpus, feed: str = "auto",
                prefetch: int = 8) -> dict:
    """The process's first fit (wall, counters), the feed alone, and a second fit
    under torch.profiler (device busy time and idle share)."""
    vocab, encoded = corpus
    trainer = make_trainer(path, seed, prefetch, feed, vocab)
    cfg = trainer.config
    n_batches, feed_s = feed_pass(trainer, encoded)
    rec = timed_fit(trainer, encoded)
    del trainer
    trainer = make_trainer(path, seed, prefetch, feed, vocab)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(encoded)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kt = kernel_times(prof)
    busy_s = sum(v["us_total"] for v in kt.values()) / 1e6
    top = sorted(kt.items(), key=lambda kv: -kv[1]["us_total"])[:10]
    if cfg.device_pairgen:
        rec["generator"] = profile_generator(trainer, encoded)
    return {"tokens": int(sum(s.shape[0] for s in encoded)),
            "pool": trainer.config.negative_pool, "batches": n_batches, **rec,
            "producer_workers": cfg.producer_workers, "feed_only_s": feed_s,
            "profiled_fit_wall_s": prof_wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / prof_wall,
            "top_device_us": {k: v for k, v in top},
            "host_us_by_thread": host_times(prof)}


def ab_fits(path: str, seed: int, corpus, feeds, prefetches, rounds: int) -> dict:
    """Plain fits of every (feed, prefetch) pair, ``rounds`` times, in turns: the
    order reverses each round (A B B A ...), so that drift over the process hits every
    pair alike. Beside each round, one pass of each backend's feed alone."""
    vocab, encoded = corpus
    pairs = [(f, p) for f in feeds for p in prefetches]
    runs, feed_s = [], {}
    for r in range(rounds):
        for feed, prefetch in (pairs if r % 2 == 0 else pairs[::-1]):
            trainer = make_trainer(path, seed, prefetch, feed, vocab)
            if prefetch == prefetches[0]:
                feed_s.setdefault(trainer.feed_backend, []).append(
                    feed_pass(trainer, encoded)[1])
            runs.append({"round": r, **timed_fit(trainer, encoded)})
            del trainer
    summary = {}
    for feed, prefetch in pairs:
        mine = [x for x in runs if x["prefetch_chunks"] == prefetch
                and (feed == "auto" or x["feed_backend"] == feed)]
        summary[f"{mine[0]['feed_backend']}/prefetch={prefetch}"] = {
            k: float(np.median([x[k] for x in mine]))
            for k in ("fit_wall_s", "pairs_per_s", "host_wait_s", "dispatch_s")} | {
            "fit_wall_s_all": [x["fit_wall_s"] for x in mine]}
    return {"rounds": rounds, "runs": runs, "median": summary,
            "feed_only_s": feed_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=PATHS, default="shared")
    ap.add_argument("--feed", default="auto",
                    help="numpy, native or device (skip-gram on the device pair "
                         "generator), or several comma-separated (default: the "
                         "path's own: native when it is built)")
    ap.add_argument("--prefetch", default="8",
                    help="prefetch_chunks, or several comma-separated (default 8)")
    ap.add_argument("--rounds", type=int, default=0,
                    help="after the profile, plain fits of every feed/prefetch pair in "
                         "turns, this many rounds")
    ap.add_argument("--switch-interval", type=float, default=0.0,
                    help="sys.setswitchinterval for the run, in seconds (default: "
                         "the interpreter's, 0.005): how long a thread that wants "
                         "the GIL waits before the holder is asked to drop it")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=2_000_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.switch_interval:
        sys.setswitchinterval(args.switch_interval)
    feeds = args.feed.split(",")
    prefetches = [int(p) for p in args.prefetch.split(",")]
    if any(f not in ("auto", "numpy", "native", "device") for f in feeds):
        ap.error(f"--feed: numpy, native or device, not {args.feed!r}")
    if not torch.cuda.is_available():
        print("stepprof: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus = fit_corpus(args.seed, args.tokens)
    rec = {"device": torch.cuda.get_device_name(0), "path": args.path,
           "switch_interval_s": sys.getswitchinterval(),
           "native_threads": native.default_threads(),
           "step": profile_step(args.path, args.seed),
           "fit": profile_fit(args.path, args.seed, corpus, feeds[0], prefetches[0])}
    if args.rounds:
        rec["ab"] = ab_fits(args.path, args.seed, corpus, feeds, prefetches, args.rounds)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
