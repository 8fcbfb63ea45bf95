"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python -m glint_word2vec_torch.stepprof [--seed N] [--tokens N] [--out FILE]

Two measurements at the main-path shape (V=1,000,000, D=300 padded to 384,
B=8192, AUTO pool P=256), printed as one JSON line:

- ``step``: device time of each CUDA launch of the fused shared-pool step
  (torch.profiler, mean over the profiled steps);
- ``fit``: ``Trainer.fit`` over a synthetic Zipf corpus, twice from fresh trainers:
  once plain (wall time, steps, pairs/s) and once under torch.profiler (the device's
  busy time, the sum of device-side event times on its one stream, and its idle share
  of that fit's wall time); beside them, the time one pass of the numpy pair feed
  alone takes over the same corpus.

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
from glint_word2vec_torch.data.pipeline import encode_sentences, epoch_batches
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_torch.ops.sgns import EmbeddingPair
from glint_word2vec_torch.train.trainer import Trainer

V, D_REAL, D, B, P, N_NEG = 1_000_000, 300, 384, 8192, 256, 5


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


def _kernel_times(prof) -> dict:
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


def profile_step(seed: int, steps: int = 20) -> dict:
    rng = np.random.default_rng(seed)
    syn0 = torch.zeros((V, D), device="cuda")
    syn1 = torch.zeros((V, D), device="cuda")
    syn0[:, :D_REAL] = torch.from_numpy(
        rng.normal(0, 0.35, (V, D_REAL)).astype(np.float32)).cuda()
    syn1[:, :D_REAL] = torch.from_numpy(
        rng.normal(0, 0.35, (V, D_REAL)).astype(np.float32)).cuda()
    c = torch.from_numpy((rng.zipf(1.1, B) - 1) % V).cuda()
    x = torch.from_numpy((rng.zipf(1.1, B) - 1) % V).cuda()
    neg = torch.from_numpy((rng.zipf(1.1, P) - 1) % V).cuda()
    mask = torch.ones(B, device="cuda")
    params = EmbeddingPair(syn0, syn1)

    def step():
        fused_sgns_shared_step(params, c, x, mask, neg, 0.025, N_NEG, "exact", False)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    per_step = {k: v["us_total"] / steps for k, v in _kernel_times(prof).items()}
    return {"steps": steps, "device_us_per_step": per_step,
            "total_device_us_per_step": sum(per_step.values())}


def profile_fit(seed: int, n_tokens: int) -> dict:
    rng = np.random.default_rng(seed)
    counts = (1e9 / np.arange(1, V + 1)).astype(np.int64) + 1
    words = [f"w{i}" for i in range(V)]
    ids = rng.choice(V, size=n_tokens, p=counts / counts.sum())
    toks = [words[i] for i in ids]
    sents = [toks[i:i + 40] for i in range(0, n_tokens, 40)]
    vocab = Vocabulary.from_words_and_counts(words, counts)
    encoded = encode_sentences(sents, vocab)
    cfg = Word2VecConfig(vector_size=300, window=5, negatives=5, pairs_per_batch=B,
                         min_count=1, heartbeat_every_steps=16, seed=seed)
    trainer = Trainer(cfg, vocab, device="cuda")
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in epoch_batches(
        encoded, vocab, pairs_per_batch=B, window=5,
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
    kt = _kernel_times(prof)
    busy_s = sum(v["us_total"] for v in kt.values()) / 1e6
    top = sorted(kt.items(), key=lambda kv: -kv[1]["us_total"])[:10]
    return {"tokens": n_tokens, "steps": steps, "batches": n_batches, "pairs": pairs,
            "fit_wall_s": wall, "pairs_per_s": pairs / wall, "feed_only_s": feed_s,
            "profiled_fit_wall_s": prof_wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / prof_wall,
            "top_device_us": {k: v for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=2_000_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stepprof: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"device": torch.cuda.get_device_name(0),
           "step": profile_step(args.seed), "fit": profile_fit(args.seed, args.tokens)}
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
