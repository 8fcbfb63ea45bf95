"""Where the time of one of the port's training paths goes, on one NVIDIA GPU.

    python -m glint_word2vec_torch.stepprof [--path PATH] [--seed N] [--tokens N]
        [--out FILE]

``--path`` picks the step: ``shared`` (skip-gram, shared pool: the fused kernel, the
default), ``per_pair`` (skip-gram, ``negative_pool=0``), ``cbow`` (scatter CBOW, shared
pool) or ``cbow_per_example`` (scatter CBOW, ``negative_pool=0``); the last three
scatter their rows through the row-scatter kernel. Two measurements at the model's
full width (V=1,000,000, D=300 padded to 384, B=8192, n=5; the AUTO pool resolves to
P=256 at this vocabulary), printed as one JSON line:

- ``step``: device time of each CUDA kernel of one step (torch.profiler, mean over the
  profiled steps), on random parameters and Zipf indices;
- ``fit``: ``Trainer.fit`` over a synthetic Zipf corpus, twice from fresh trainers:
  once plain (wall time, steps, pairs/s) and once under torch.profiler (the device's
  busy time, the sum of device-side event times on its one stream, and its idle share
  of that fit's wall time); beside them, the time one pass of the numpy feed (pairs
  or CBOW windows) alone takes over the same corpus.

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
from glint_word2vec_torch.data.pipeline import (
    encode_sentences, epoch_batches, epoch_batches_cbow)
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_torch.ops.sgns import (
    EmbeddingPair, cbow_step_core, cbow_step_shared_core, sgns_step_core)
from glint_word2vec_torch.train.trainer import Trainer

V, D_REAL, D, B, P, N_NEG, WINDOW = 1_000_000, 300, 384, 8192, 256, 5, 5
PATHS = ("shared", "per_pair", "cbow", "cbow_per_example")


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


def path_config(path: str, seed: int) -> Word2VecConfig:
    """The model at full width on one path."""
    knobs = dict(vector_size=D_REAL, window=WINDOW, negatives=N_NEG, pairs_per_batch=B,
                 min_count=1, heartbeat_every_steps=16, seed=seed)
    if path in ("per_pair", "cbow_per_example"):
        knobs["negative_pool"] = 0
    return Word2VecConfig(cbow=path.startswith("cbow"), **knobs)


def step_call(path: str, seed: int):
    """One metrics-off step of ``path`` on random parameters and Zipf indices."""
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


def profile_fit(path: str, seed: int, n_tokens: int) -> dict:
    rng = np.random.default_rng(seed)
    counts = (1e9 / np.arange(1, V + 1)).astype(np.int64) + 1
    words = [f"w{i}" for i in range(V)]
    ids = rng.choice(V, size=n_tokens, p=counts / counts.sum())
    toks = [words[i] for i in ids]
    sents = [toks[i:i + 40] for i in range(0, n_tokens, 40)]
    vocab = Vocabulary.from_words_and_counts(words, counts)
    encoded = encode_sentences(sents, vocab)
    cfg = path_config(path, seed)
    trainer = Trainer(cfg, vocab, device="cuda")
    feed = epoch_batches_cbow if cfg.cbow else epoch_batches
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in feed(
        encoded, vocab, pairs_per_batch=B, window=WINDOW,
        subsample_ratio=trainer.config.subsample_ratio, seed=seed))
    feed_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(encoded)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps, pairs = trainer.global_step, trainer.pairs_trained
    del trainer
    trainer = Trainer(cfg, vocab, device="cuda")
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
    return {"tokens": n_tokens, "pool": trainer.config.negative_pool, "steps": steps,
            "batches": n_batches, "pairs": pairs,
            "fit_wall_s": wall, "pairs_per_s": pairs / wall, "feed_only_s": feed_s,
            "profiled_fit_wall_s": prof_wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / prof_wall,
            "top_device_us": {k: v for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=PATHS, default="shared")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=2_000_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stepprof: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"device": torch.cuda.get_device_name(0), "path": args.path,
           "step": profile_step(args.path, args.seed),
           "fit": profile_fit(args.path, args.seed, args.tokens)}
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
