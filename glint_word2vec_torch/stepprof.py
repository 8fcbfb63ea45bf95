"""Where the time of one of the port's training paths goes, on one NVIDIA GPU.

    python -m glint_word2vec_torch.stepprof [--path PATH] [--feed numpy,native]
        [--prefetch 8,0] [--stab] [--dtype f32|bf16] [--fused-chain] [--hot-rows K]
        [--geometry config3|bench]
        [--endpoint scatter,shift] [--rounds R] [--telemetry] [--switch-interval S]
        [--seed N] [--tokens N] [--out FILE]

``--path`` picks the step: ``shared`` (skip-gram, shared pool: the fused kernel, the
default), ``per_pair`` (skip-gram, ``negative_pool=0``), ``cbow`` (scatter CBOW, shared
pool) or ``cbow_per_example`` (scatter CBOW, ``negative_pool=0``); the last three
scatter their rows through the row-scatter kernel. ``shared_devpairs`` and
``per_pair_devpairs`` are the two skip-gram steps fed by the device pair generator
(``device_pairgen=True``): the host ships token blocks and the card expands them.
``cbow_banded`` is banded CBOW (``cbow_update="banded"``) on its token-block feed
(``feed_backend`` "device"): T = B + 2·window slots per step. ``--stab`` turns the three
stabilizers on (``max_row_norm=5, update_clip=0.05, row_l2=1e-3``) on any path; the
shared path then runs ``sgns_step_shared_scatter_`` instead of the fused kernel.
``--dtype bf16`` runs the path in bfloat16 (``param_dtype``, ``compute_dtype`` and
``logits_dtype``; the parameters of the step profile are bf16 too), ``--fused-chain``
with ``fused_logits`` and ``bf16_chain`` (skip-gram; the chain needs ``--dtype bf16``),
``--hot-rows K``
with the cross-step hot rows (skip-gram paths: the shared path then runs
``sgns_step_shared_scatter_`` with the slabs; the step profile leaves the flush to the
fit). ``--geometry bench`` (skip-gram paths) takes V=200,000 (the TPU step bench's
vocabulary) with the TPU bench's batch, pool, dispatch and subsample instead
(``bench.py``: B=65536, pool 512, 32 steps a dispatch, 1e-4), on a corpus of the
end-to-end bench's Zipf shape (counts ~ 1/(rank + 10)^1.05); not the end-to-end bench's
own corpus, which keeps the min_count-5 words of 4M tokens over 50,000. Two measurements at the model's full width (V=1,000,000, D=300 padded to 384,
B=8192, n=5; the AUTO pool resolves to P=256 at this vocabulary), printed as one JSON
line:

- ``step``: device time of each CUDA kernel of one step (torch.profiler, mean over the
  profiled steps), on random parameters and Zipf indices; on ``cbow_banded`` also
  ``parts``: the device µs of the step's gathers, prefix sums, endpoint delta (each
  form), products and scatters, each part's ops profiled alone at the step's shapes,
  and ``by_endpoint``: the whole step's device µs and host µs per call (the calls'
  enqueue time, before the device finishes) with each endpoint form;
- ``fit``: ``Trainer.fit`` over a synthetic Zipf corpus, twice from fresh trainers:
  once plain (wall time, steps, pairs/s, and the trainer's ``host_wait_s``,
  ``dispatch_s`` (its ``prologue_s`` included: the chunks' eager prologues, and
  ``prologue_ms_per_chunk``, their mean over the chunks' replays), ``captures`` and
  ``replays`` of the chunk graphs) and once under torch.profiler (the device's busy
  time, the sum of device-side event times, and its idle share of that fit's wall
  time; beside them ``kernel_busy_s`` and ``kernel_idle_share``, from the union of the
  kernels' intervals alone, which counts no copy and no two overlapping kernels twice;
  the host ops' self time per thread; the graphs' captures and replays, the port's
  kernels the profiler traced by name and count beside the launches the wrappers
  counted through the replays: equal counts show that the trace holds the kernels
  inside the CUDA graphs); beside them, ``feed_only_s``, the time one pass of the feed
  that ran (``feed_backend``, at the config's ``producer_workers``) alone takes over
  the same corpus, and ``trainer_setup_s``, the first trainer's construction. On the
  device-feed paths it adds ``tokens_per_step``, ``dropped_pairs`` and ``generator``:
  the device time of the pair generator on the fit's first chunk (one batched call for
  its K steps; torch.profiler, per step).

``--feed`` picks the skip-gram pair generator (default: the trainer's choice, native
when it is built; CBOW has only numpy; ``device`` runs the path's device-feed twin),
``--prefetch`` the config's ``prefetch_chunks`` (default 8; 0 assembles and copies the
chunks on the calling thread). Both take comma-separated lists; the profile runs the first of each, and
``--rounds R`` adds ``ab``: plain fits of every pair, R rounds in turns (the order
reversed each round), with their medians and one feed-alone pass per round.
``--telemetry`` replaces ``ab`` with ``telemetry``: fits of the first feed and
prefetch with the runtime layer off, in parts and on (``log``: ``telemetry_path`` in a
temporary directory and ``norm_watch="warn"``; ``status``: ``status_port`` on a free
port; ``on``: both), ``--rounds`` rounds (at least one) in turns, the order reversed
each round, with their medians and the logged fits' probe and span totals.
``--switch-interval`` sets the interpreter's GIL switch interval for the run, to test
whether the producer thread's cost is the consumer waiting for the GIL. ``--endpoint``
(``cbow_banded``): the banded step's endpoint form on the card
(``ops.cbow_banded.CUDA_ENDPOINT``), or several, which ``--rounds`` then also takes in
turns.

It needs a CUDA device and exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data import native
from glint_word2vec_torch.data.pipeline import (
    encode_sentences, epoch_batches, epoch_batches_cbow)
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.ops import cbow_banded
from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_torch.ops.pairgen import device_block_pairs, device_cbow_windows
from glint_word2vec_torch.ops.scatter import scatter_add_rows_
from glint_word2vec_torch.ops.sgns import (
    EmbeddingPair, Stabilizers, cbow_step_core, cbow_step_shared_core, hot_slabs,
    sgns_step_core, sgns_step_shared_scatter_)
from glint_word2vec_torch.train.trainer import Trainer

V, D_REAL, D, B, P, N_NEG, WINDOW = 1_000_000, 300, 384, 8192, 256, 5, 5
# --geometry bench: V=200,000 (the step bench's, bench.py:55) with the bench's batch,
# pool, dispatch and subsample (bench.py:423-427), on a corpus of the end-to-end bench's
# shape, counts ~ 1e9 / (rank + 10)^1.05 (bench.py e2e_corpus)
BENCH_SHAPE = {"V": 200_000, "B": 65536, "P": 512}
BENCH_KNOBS = {"negative_pool": 512, "steps_per_dispatch": 32, "subsample_ratio": 1e-4}
CORPUS_SHAPE = {"config3": (1.0, 1.0), "bench": (10.0, 1.05)}  # (shift, power)
GEOMETRY = "config3"
PATHS = ("shared", "per_pair", "cbow", "cbow_per_example", "shared_devpairs",
         "per_pair_devpairs", "cbow_banded")
DEVPAIRS = "_devpairs"
# the port's own kernels (csrc/sgns_shared.cu, csrc/scatter_rows.cu), as the profiler
# names them
PORT_KERNELS = ("gather_kernel", "fneg_kernel", "update_kernel", "dz_scatter_kernel",
                "warp_kernel", "rank_kernel", "plan_kernel", "place_kernel",
                "reduce_kernel", "finish_kernel")
# --stab: the JAX stabilizer suite's combined case (tests/test_stabilizers.py)
STAB_KNOBS = {"max_row_norm": 5.0, "update_clip": 0.05, "row_l2": 1e-3}
# --dtype bf16: the JAX bench's bf16 rows (bench.py)
BF16_KNOBS = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16",
              "logits_dtype": "bfloat16"}


def variant_knobs(stab: bool = False, dtype: str = "f32", hot_rows: int = 0,
                  fused_chain: bool = False) -> dict:
    """The config knobs of a variant of a path: the stabilizers, bf16, hot rows, the
    fused and bf16 logit chains."""
    return {**(STAB_KNOBS if stab else {}), **(BF16_KNOBS if dtype == "bf16" else {}),
            **({"hot_rows": hot_rows} if hot_rows else {}),
            **({"fused_logits": True, "bf16_chain": True} if fused_chain else {})}


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


def kernel_busy_s(prof) -> float:
    """Seconds in which at least one kernel ran on the card: the union of the kernel
    events' intervals, read from the raw trace (the profiler's event tree would cost
    seconds on a fit of ~40k kernels). Copies and memsets are left out (the producer's
    copies run on their own stream while the card's SMs may have nothing to run), and
    kernels that overlap on two streams count once."""
    spans = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() != torch.autograd.DeviceType.CPU
        and not e.name().startswith(("Memcpy", "Memset")))
    busy, lo, hi = 0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        busy += hi - lo
    return busy / 1e9


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


def path_config(path: str, seed: int, prefetch: int = 8,
                variant: Optional[dict] = None) -> Word2VecConfig:
    """The model at full width on one path, with the knobs of ``variant``
    (:func:`variant_knobs`)."""
    knobs = dict(vector_size=D_REAL, window=WINDOW, negatives=N_NEG, pairs_per_batch=B,
                 min_count=1, heartbeat_every_steps=16, seed=seed,
                 prefetch_chunks=prefetch, device_pairgen=path.endswith(DEVPAIRS),
                 **(BENCH_KNOBS if GEOMETRY == "bench" else {}), **(variant or {}))
    if path.removesuffix(DEVPAIRS) in ("per_pair", "cbow_per_example"):
        knobs["negative_pool"] = 0
    if path == "cbow_banded":
        knobs["cbow_update"] = "banded"
    return Word2VecConfig(cbow=path.startswith("cbow"), **knobs)


def _zipf(rng, shape):
    return torch.from_numpy((rng.zipf(1.1, shape) - 1) % V).cuda()


def _random_params(seed: int, dtype: torch.dtype = torch.float32) -> EmbeddingPair:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    syn0 = torch.zeros((V, D), device="cuda", dtype=dtype)
    syn1 = torch.zeros((V, D), device="cuda", dtype=dtype)
    syn0[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    syn1[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    return EmbeddingPair(syn0, syn1)


def banded_block(seed: int, T: int = B + 2 * WINDOW, window: int = WINDOW,
                 device: str = "cuda"):
    """One banded step's block on the card: T Zipf tokens in 40-token sentences with a
    padded tail of 100 slots, its window geometry from ``device_cbow_windows`` (kept
    ordinals from 0, as a block past the first), and a Zipf pool of P. Returns
    (tokens, band, negatives)."""
    rng = np.random.default_rng(seed)
    n_valid = T - 100
    tokens = _zipf(rng, T).to(device)
    tokens[n_valid:] = 0
    starts = np.zeros(T, bool)
    starts[0:n_valid:40] = True
    bits = torch.from_numpy(np.packbits(starts, bitorder="little")).to(device)
    band = device_cbow_windows(tokens, bits, n_valid, 0, 0, 0x2545F491, window, window)
    return tokens, band, _zipf(rng, P).to(device)


def step_call(path: str, seed: int, variant: Optional[dict] = None):
    """One metrics-off step of ``path`` on random parameters and Zipf indices (a
    device-feed path's step is its host-fed twin's), with the knobs of ``variant``:
    the stabilizers or the hot rows run the shared path in its scatter form, as the
    trainer runs it."""
    path = path.removesuffix(DEVPAIRS)
    variant = variant or {}
    rng = np.random.default_rng(seed)
    cd = getattr(torch, variant.get("compute_dtype", "float32"))
    ld = getattr(torch, variant.get("logits_dtype", "float32"))
    chain = {k: variant.get(v, False) for k, v in (("fused", "fused_logits"),
                                                   ("bf16_chain", "bf16_chain"))}
    params = _random_params(seed, getattr(torch, variant.get("param_dtype", "float32")))
    st = Stabilizers(**{k: variant[k] for k in STAB_KNOBS if k in variant}) or None
    st = st if st is not None and st.enabled else None
    slabs = (hot_slabs(variant["hot_rows"], D, params.syn0.dtype, "cuda")
             if variant.get("hot_rows") else None)
    if path == "cbow_banded":
        tokens, band, neg = banded_block(seed)
        return lambda: cbow_banded.cbow_step_banded_core(
            params, tokens, band.left, band.right, band.center, band.token, neg, 0.025,
            N_NEG, WINDOW, "exact", False, stabilizers=st, compute_dtype=cd,
            logits_dtype=ld)
    c, x, mask = _zipf(rng, B), _zipf(rng, B), torch.ones(B, device="cuda")
    neg = _zipf(rng, P) if path in ("shared", "cbow") else _zipf(rng, (B, N_NEG))
    if path == "shared" and (st is not None or slabs is not None):
        return lambda: sgns_step_shared_scatter_(
            params, c, x, mask, neg, 0.025, N_NEG, "exact", False, stabilizers=st,
            compute_dtype=cd, logits_dtype=ld, hot_slabs=slabs, **chain)
    if path == "shared":
        return lambda: fused_sgns_shared_step(params, c, x, mask, neg, 0.025, N_NEG,
                                              "exact", False, compute_dtype=cd,
                                              logits_dtype=ld, **chain)
    if path == "per_pair":
        return lambda: sgns_step_core(params, c, x, mask, neg, 0.025, stabilizers=st,
                                      compute_dtype=cd, hot_slabs=slabs, **chain)
    # the legacy window's context counts: b + max(b - 1, 0) for b in 1..window-1
    b = rng.integers(1, WINDOW, B)
    nctx = torch.from_numpy(2 * b - 1).cuda()
    C = 2 * WINDOW
    ctx_mask = (torch.arange(C, device="cuda")[None, :] < nctx[:, None]).float()
    ctx = _zipf(rng, (B, C)) * ctx_mask.long()
    if path == "cbow":
        return lambda: cbow_step_shared_core(params, c, ctx, ctx_mask, mask, neg, 0.025,
                                             N_NEG, "exact", False, stabilizers=st,
                                             compute_dtype=cd, logits_dtype=ld)
    return lambda: cbow_step_core(params, c, ctx, ctx_mask, mask, neg, 0.025,
                                  stabilizers=st, compute_dtype=cd)


def profile_call(fn, steps: int, attempts: int = 5) -> dict:
    """:func:`kernel_times` of ``steps`` calls of ``fn`` under torch.profiler, after
    three warm-up calls. A window in which the profiler recorded no device event at all
    (seen on an H100 with torch 2.11, up to three windows in a row) is profiled again
    after a pause, up to ``attempts`` windows; then it raises."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.5 * attempt)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        kt = kernel_times(prof)
        if kt:
            return kt
    raise RuntimeError(f"torch.profiler recorded no device event in {attempts} windows "
                       f"of {steps} calls")


def _device_us_per_call(fn, calls: int) -> float:
    return sum(v["us_total"] for v in profile_call(fn, calls).values()) / calls


def host_us_per_call(fn, calls: int) -> float:
    """Host µs to enqueue one call of ``fn`` (perf_counter around ``calls`` calls, the
    device synchronised before and not inside), after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def banded_parts(seed: int, calls: int = 20) -> dict:
    """Device µs of the banded step's parts at its shapes (T = B + 2·window, P, D),
    each part's ops profiled alone: the gathers (syn0 and syn1 at the tokens, the pool,
    the two prefix rows per slot), the two prefix sums (``cumsum_rows``; beside it
    other chunk sizes, torch's scan along dim 0, the scan of the transpose and the JAX
    package's triangular-product form), the
    endpoint delta in each form, the three products and the two row scatters (the
    kernel). Their sum leaves out the step's elementwise passes (coefficients, masks,
    casts)."""
    params = _random_params(seed)
    tokens, band, neg = banded_block(seed)
    T = tokens.shape[0]
    t = torch.arange(T, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    S = torch.randn((T + 1, D), generator=gen, device="cuda")
    h = torch.randn((T, D), generator=gen, device="cuda") * 0.1
    g = torch.randn((T, P), generator=gen, device="cuda") * 1e-3
    live = band.center * ((band.left + band.right) > 0).float()
    g_row = torch.randn((T, D), generator=gen, device="cuda") * 1e-3 * live[:, None]
    Z = params.syn1[neg]
    upd1 = torch.randn((T + P, D), generator=gen, device="cuda") * 1e-3
    idx1 = torch.cat([tokens, neg])
    live1 = torch.cat([live, torch.ones(P, device="cuda")])

    def gathers():
        params.syn0[tokens], params.syn1[tokens], params.syn1[neg]
        S[t + band.right + 1], S[t - band.left]

    def prefix_sums(chunk=None):
        cbow_banded.cumsum_rows(h, chunk), cbow_banded.cumsum_rows(g_row, chunk)

    def prefix_sums_dim0():  # the first design: torch's scan along dim 0
        torch.cumsum(h, dim=0), torch.cumsum(g_row, dim=0)

    def prefix_sums_transposed():  # a scan along dim 1 of the transpose
        for x in (h, g_row):
            torch.cumsum(x.t().contiguous(), dim=1).t().contiguous()

    def prefix_sums_matmul():  # the JAX package's form: 128-row triangular products
        tri = torch.tril(torch.ones((128, 128), device="cuda"))
        for x in (h, g_row):
            rows = -(-T // 128)
            xp = torch.nn.functional.pad(x, (0, 0, 0, rows * 128 - T)).view(rows, 128, D)
            within = tri @ xp
            totals = within[:, -1]
            (within + (torch.cumsum(totals, 0) - totals)[:, None]).view(-1, D)[:T]

    def products():
        h @ Z.T, g @ Z, g.T @ h

    def scatters():
        scatter_add_rows_(params.syn0, tokens, g_row, band.token)
        scatter_add_rows_(params.syn1, idx1, upd1, live1)

    parts = {"gathers": gathers, "prefix_sums": prefix_sums,
             "prefix_sums_dim0": prefix_sums_dim0,
             "prefix_sums_transposed": prefix_sums_transposed,
             "prefix_sums_matmul": prefix_sums_matmul, "products": products,
             "scatters": scatters}
    for chunk in (32, 128, 256):
        parts[f"prefix_sums_chunk{chunk}"] = lambda chunk=chunk: prefix_sums(chunk)
    for form in ("scatter", "shift"):
        parts[f"endpoint_{form}"] = (
            lambda form=form: cbow_banded._band_endpoint_delta(
                g_row, band.left, band.right, WINDOW, form, scatter_add_rows_, live))
    out = {k: _device_us_per_call(fn, calls) for k, fn in parts.items()}
    out["endpoint_shift_kernels"] = sum(
        v["count"] for v in profile_call(parts["endpoint_shift"], 1).values())
    return out


def profile_step(path: str, seed: int, steps: int = 20,
                 variant: Optional[dict] = None) -> dict:
    fn = step_call(path, seed, variant)
    kt = profile_call(fn, steps)
    per_step = {k: v["us_total"] / steps for k, v in kt.items()}
    rec = {"steps": steps, "variant": variant or {}, "device_us_per_step": per_step,
           "total_device_us_per_step": sum(per_step.values())}
    if path == "cbow_banded":
        rec["parts"] = banded_parts(seed)
        rec["by_endpoint"] = {}
        for form in ("scatter", "shift"):
            cbow_banded.CUDA_ENDPOINT = form
            rec["by_endpoint"][form] = {
                "device_us": _device_us_per_call(fn, steps),
                "host_us": host_us_per_call(fn, steps)}
        cbow_banded.CUDA_ENDPOINT = "scatter"
    return rec


def fit_corpus(seed: int, n_tokens: int):
    """A Zipf vocabulary of V words (the geometry's shape: Zipf(1) for config 3) and
    ``n_tokens`` tokens drawn from it, in 40-token sentences, encoded."""
    rng = np.random.default_rng(seed)
    shift, power = CORPUS_SHAPE[GEOMETRY]
    counts = (1e9 / (np.arange(V) + shift) ** power).astype(np.int64) + 1
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
    if trainer.feed_backend == "device":
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
            "prologue_s": trainer.prologue_time,
            "prologue_ms_per_chunk": 1e3 * trainer.prologue_time
            / max(trainer.graph_replays, 1),
            "captures": trainer.graph_captures, "replays": trainer.graph_replays,
            **({"tokens_per_step": trainer._tokens_per_step,
                "dropped_pairs": trainer.dropped_pairs}
               if trainer.feed_backend == "device" else {})}


def profile_generator(trainer: Trainer, encoded, calls: int = 20) -> dict:
    """Device time of the pair generator (banded CBOW: the window generator) on the
    first chunk of the trainer's feed: one batched call covers its K blocks; the record
    gives the chunk's and one step's share."""
    cfg = trainer.config
    chunk = next(iter(trainer._token_chunk_stream(encoded, 1.0, 1.0)))
    # one device runs one token segment: its [K, ...] rows
    a = {k: torch.from_numpy(v).cuda().long()[:, 0] for k, v in chunk["arrays"].items()
         if k != "alphas"}

    def call():
        if trainer._banded_cbow:
            return device_cbow_windows(
                a["tokens"], a["starts"], a["nvalid"], a["obase"][:, 0],
                a["obase"][:, 1], chunk["win_bases"][0], cfg.window, trainer._block_halo)
        return device_block_pairs(
            a["tokens"], a["starts"], a["nvalid"], a["obase"][:, 0], a["obase"][:, 1],
            trainer._keep_prob_dev, chunk["sub_bases"][0], chunk["win_bases"][0],
            cfg.window, cfg.pairs_per_batch, presubsampled=True)

    kt = profile_call(call, calls)
    per_chunk = sum(v["us_total"] for v in kt.values()) / calls
    return {"steps_per_call": chunk["real"], "tokens_per_step": trainer._tokens_per_step,
            "device_us_per_chunk": per_chunk,
            "device_us_per_step": per_chunk / chunk["real"],
            "kernels_per_call": sum(v["count"] for v in kt.values()) / calls}


def make_trainer(path: str, seed: int, prefetch: int, feed: str, vocab,
                 variant: Optional[dict] = None) -> Trainer:
    """A fresh trainer of ``path``; ``feed="device"`` runs a skip-gram path on the
    device pair generator (its ``_devpairs`` twin), a host feed on the host-fed
    twin; banded CBOW has only the token feed."""
    base = path.removesuffix(DEVPAIRS)
    if feed == "device" and path != "cbow_banded":
        path = base + DEVPAIRS
    elif feed not in ("auto", "device"):
        path = base
    return Trainer(path_config(path, seed, prefetch, variant), vocab, device="cuda",
                   feed_backend=feed)


def profile_fit(path: str, seed: int, corpus, feed: str = "auto",
                prefetch: int = 8, variant: Optional[dict] = None) -> dict:
    """The trainer's construction (``trainer_setup_s``: vocabulary tables, the init
    and its copy to the card, all outside a fit's wall), the process's first fit (wall,
    counters), the feed alone, and a second fit under torch.profiler (device busy time
    and idle share)."""
    vocab, encoded = corpus
    t0 = time.perf_counter()
    trainer = make_trainer(path, seed, prefetch, feed, vocab, variant)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = trainer.config
    n_batches, feed_s = feed_pass(trainer, encoded)
    rec = timed_fit(trainer, encoded)
    del trainer
    trainer = make_trainer(path, seed, prefetch, feed, vocab, variant)
    torch.cuda.synchronize()
    before = (fused_sgns_shared_step.launches, scatter_add_rows_.launches)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(encoded)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    launches = (fused_sgns_shared_step.launches - before[0],
                scatter_add_rows_.launches - before[1])
    kt = kernel_times(prof)
    busy_s = sum(v["us_total"] for v in kt.values()) / 1e6
    kernel_busy = kernel_busy_s(prof)
    top = sorted(kt.items(), key=lambda kv: -kv[1]["us_total"])[:10]
    # the port's kernels as the profiler saw them, against the launches the wrappers
    # counted (through the graphs' replays): equal counts show that the trace holds the
    # kernels inside replays
    ours = {k: v["count"] for k, v in kt.items() if k in PORT_KERNELS}
    if trainer.feed_backend == "device":
        rec["generator"] = profile_generator(trainer, encoded)
    return {"tokens": int(sum(s.shape[0] for s in encoded)),
            "pool": trainer.config.negative_pool, "batches": n_batches, **rec,
            "producer_workers": cfg.producer_workers, "feed_only_s": feed_s,
            "trainer_setup_s": setup_s,
            "profiled_fit_wall_s": prof_wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / prof_wall,
            "kernel_busy_s": kernel_busy,
            "kernel_idle_share": 1.0 - kernel_busy / prof_wall,
            "profiled_captures": trainer.graph_captures,
            "profiled_replays": trainer.graph_replays,
            "profiled_launches": {"sgns_shared_step": launches[0],
                                  "scatter_add_rows": launches[1]},
            "traced_port_kernels": ours,
            "top_device_us": {k: v for k, v in top},
            "host_us_by_thread": host_times(prof)}


def ab_fits(path: str, seed: int, corpus, feeds, prefetches, rounds: int,
            variant: Optional[dict] = None, endpoints=("scatter",)) -> dict:
    """Plain fits of every (feed, prefetch, endpoint form) arm, ``rounds`` times, in
    turns: the order reverses each round (A B B A ...), so that drift over the process
    hits every arm alike. Beside each round, one pass of each backend's feed alone."""
    vocab, encoded = corpus
    arms = [(f, p, e) for f in feeds for p in prefetches for e in endpoints]
    runs, feed_s = [], {}
    for r in range(rounds):
        for feed, prefetch, form in (arms if r % 2 == 0 else arms[::-1]):
            cbow_banded.CUDA_ENDPOINT = form
            trainer = make_trainer(path, seed, prefetch, feed, vocab, variant)
            if prefetch == prefetches[0] and form == endpoints[0]:
                feed_s.setdefault(trainer.feed_backend, []).append(
                    feed_pass(trainer, encoded)[1])
            runs.append({"round": r, "endpoint": form, **timed_fit(trainer, encoded)})
            del trainer
    cbow_banded.CUDA_ENDPOINT = "scatter"
    summary = {}
    for feed, prefetch, form in arms:
        mine = [x for x in runs if x["prefetch_chunks"] == prefetch
                and x["endpoint"] == form
                and (feed == "auto" or x["feed_backend"] == feed)]
        name = f"{mine[0]['feed_backend']}/prefetch={prefetch}"
        summary[name + (f"/endpoint={form}" if len(endpoints) > 1 else "")] = {
            k: float(np.median([x[k] for x in mine]))
            for k in ("fit_wall_s", "pairs_per_s", "host_wait_s", "dispatch_s",
                      "prologue_s", "prologue_ms_per_chunk", "captures", "replays")} | {
            "fit_wall_s_all": [x["fit_wall_s"] for x in mine]}
    return {"rounds": rounds, "runs": runs, "median": summary,
            "feed_only_s": feed_s}


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for a status endpoint)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def telemetry_ab(path: str, seed: int, corpus, feed: str, prefetch: int, rounds: int,
                 variant: Optional[dict] = None) -> dict:
    """Fits with the runtime layer off, with its parts (``log``: the run log and
    ``norm_watch="warn"``; ``status``: the status endpoint) and on (both), ``rounds``
    rounds in turns (the arms' order reversed each round), each from a fresh trainer;
    the fits with the log report their heartbeats and the span totals of the probe and
    of the device waits."""
    import tempfile

    vocab, encoded = corpus
    runs = []
    arms = ("off", "log", "status", "on")
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(rounds):
            for arm in (arms if r % 2 == 0 else arms[::-1]):
                knobs = dict(variant or {})
                if arm in ("log", "on"):
                    knobs.update(telemetry_path=f"{tmp}/run-{r}-{arm}.jsonl",
                                 norm_watch="warn")
                if arm in ("status", "on"):
                    knobs.update(status_port=free_port())
                trainer = make_trainer(path, seed, prefetch, feed, vocab, knobs)
                run = {"round": r, "arm": arm, **timed_fit(trainer, encoded)}
                if arm in ("log", "on"):
                    spans = trainer._tracer.span_summary()
                    run.update(heartbeats=len(trainer.heartbeats),
                               spans={k: spans[k] for k in
                                      ("health_probe", "device_block", "dispatch")
                                      if k in spans})
                runs.append(run)
                del trainer
    median = {}
    for arm in arms:
        mine = [x for x in runs if x["arm"] == arm]
        median[arm] = {
            k: float(np.median([x[k] for x in mine]))
            for k in ("fit_wall_s", "pairs_per_s", "host_wait_s", "dispatch_s")} | {
            "fit_wall_s_all": [x["fit_wall_s"] for x in mine]}
    return {"rounds": rounds, "runs": runs, "median": median}


def use_geometry(name: str) -> None:
    """Set the module's shapes to a geometry (``config3``, the default, or ``bench``)."""
    global V, B, P, GEOMETRY
    shape = BENCH_SHAPE if name == "bench" else {"V": 1_000_000, "B": 8192, "P": 256}
    V, B, P, GEOMETRY = shape["V"], shape["B"], shape["P"], name


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
    ap.add_argument("--stab", action="store_true",
                    help="the three stabilizers on (max_row_norm=5, update_clip=0.05, "
                         "row_l2=1e-3)")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="bf16: param_dtype, compute_dtype and logits_dtype bfloat16")
    ap.add_argument("--fused-chain", action="store_true",
                    help="fused_logits and bf16_chain (skip-gram; with --dtype bf16)")
    ap.add_argument("--hot-rows", type=int, default=0,
                    help="the cross-step hot rows of the skip-gram paths (hot_rows=K)")
    ap.add_argument("--geometry", choices=tuple(CORPUS_SHAPE), default="config3",
                    help="bench: V=200k with the TPU bench's batch, pool and dispatch "
                         "(skip-gram paths)")
    ap.add_argument("--telemetry", action="store_true",
                    help="fits with the runtime layer off, in parts and on, in turns, "
                         "--rounds rounds (in place of the feed/prefetch A/B)")
    ap.add_argument("--endpoint", default="scatter",
                    help="cbow_banded: the endpoint form on the card, scatter or shift, "
                         "or both comma-separated (taken in turns by --rounds)")
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
    endpoints = args.endpoint.split(",")
    if any(f not in ("auto", "numpy", "native", "device") for f in feeds):
        ap.error(f"--feed: numpy, native or device, not {args.feed!r}")
    if any(e not in ("scatter", "shift") for e in endpoints):
        ap.error(f"--endpoint: scatter or shift, not {args.endpoint!r}")
    if not torch.cuda.is_available():
        print("stepprof: no CUDA device", file=sys.stderr)
        return 2
    if (args.hot_rows or args.fused_chain) and args.path.startswith("cbow"):
        ap.error("--hot-rows and --fused-chain are skip-gram restructurings")
    if args.geometry == "bench":
        if args.path.startswith("cbow"):
            ap.error("--geometry bench: the bench's geometry is skip-gram's")
        use_geometry("bench")
    torch.backends.cuda.matmul.allow_tf32 = False
    variant = variant_knobs(args.stab, args.dtype, args.hot_rows, args.fused_chain)
    corpus = fit_corpus(args.seed, args.tokens)
    rec = {"device": torch.cuda.get_device_name(0), "path": args.path,
           "stab": args.stab, "dtype": args.dtype, "hot_rows": args.hot_rows,
           "fused_chain": args.fused_chain, "geometry": args.geometry,
           "switch_interval_s": sys.getswitchinterval(),
           "native_threads": native.default_threads(),
           "step": profile_step(args.path, args.seed, variant=variant)}
    cbow_banded.CUDA_ENDPOINT = endpoints[0]
    rec["fit"] = profile_fit(args.path, args.seed, corpus, feeds[0], prefetches[0],
                             variant)
    rec["fit"]["endpoint"] = endpoints[0]
    if args.telemetry:
        rec["telemetry"] = telemetry_ab(args.path, args.seed, corpus, feeds[0],
                                        prefetches[0], max(args.rounds, 1), variant)
    elif args.rounds:
        rec["ab"] = ab_fits(args.path, args.seed, corpus, feeds, prefetches, args.rounds,
                            variant, endpoints)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
