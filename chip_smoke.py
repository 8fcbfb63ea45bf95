#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (glint_word2vec_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out FILE]

Phases, one line each (or a few); any failure exits non-zero:
  1. card      nvidia-smi name and power limit, torch/CUDA versions, TF32 off;
  2. build     every kernel in glint_word2vec_torch/csrc/, nvcc runs started together;
  3. kernel    the fused shared-pool SGNS step against its plain PyTorch version at the
               main shape (V=1,000,000, D=300 padded to 384, B=8192, P=256, Zipf
               duplicates, a masked tail, both sigmoid modes), then a hot-row case (all
               live centers on one row, the pool all one row) and a heavy draw (Zipf
               1.3 over V=65536, parameters of scale 0.5), kernel and plain each against
               a float64 step and the plain version against itself; the kernel takes
               alpha in the trainer's form (a one-element float32 tensor on the card,
               read at run time), the plain step the Python float; timed per wrapper
               call (CUDA events, the record's "ms"), and on the device per launch
               (torch.profiler), warm (one batch) and L2-cold (a ring of independently
               drawn batches whose rows exceed the 50 MB L2);
 3b. kernel_bf16
               the fused step's bf16 forms at the main shape: bf16 parameters, compute
               and logits; the same with fused_logits and bf16_chain; f32 parameters
               with bf16 compute. Each through the kernel (its bf16 updates applied by
               the scatter kernel's bf16 path) against the plain step with the same
               dtypes and against a float64 step, elementwise on the touched rows within
               2^-7 |row| (bf16 rows) + 2^-4 of the element's summed update terms
               (alpha in the trainer's form for the kernel, as in phase 3);
               and its update rows (bf16 parameters: d_in, d_pos, dZ before the
               scatters; f32 parameters: the rows' deltas) against the plain step's:
               at most 2% of the elements differ, at most 0.2% by more than one bf16
               ulp, and the f32 kernel (the flags cleared) must break that limit
               (ops/bf16_check); timed per call and on the device, with its fp32, bf16
               tensor-core and byte bounds;
  4. scatter   the row scatter-add kernel against its plain version (index_add_) and
               both against a float64 sum, at the TPU probe's shape (H=2048, D=384,
               B=65536 Zipf rows into a zeroed target), at the per-pair syn1 shape
               (49152 Zipf rows, a tenth of them dead, into V=1,000,000 x 384), at
               the CBOW syn0 context shape (B*2*window = 81920 slots, about two thirds
               dead, into V=1,000,000 x 384), and on the traffic a per-pair step
               sends: syn1 with B Zipf contexts and B*n negatives from the port's alias
               sampler (scatterprobe.step_syn1_draw), and syn0 with the centers of the
               first batch of this corpus's per-pair feed (scatterprobe.feed_centers);
               timed per wrapper call (events) and on the device (torch.profiler),
               index_add_ the same two ways;
 4b. scatter_bf16
               the same five shapes with bf16 target and updates: kernel and plain
               (each row's updates summed in f32, the row rounded once) against the
               float64 sum within half a bf16 ulp plus the f32 summation bound, untouched
               rows bit for bit, torch's bf16 index_add_ beside them (it rounds after
               every add: another function); 1000 updates of bf16(1e-3) to one row of
               1.0 (the kernel must give 2.0); timed as in phase 4, byte bound at 2 B;
  5. steps     one full-width per-pair skip-gram step and one CBOW step (shared pool),
               each run once through the scatter kernel and once through the plain
               scatter on identical inputs, parameters compared;
 5b. banded    one full-width banded CBOW step (T = 8192 + 2*window token slots in
               sentences of 5 to 60 tokens, a padded tail, block 0's wrapped ordinal
               base, P=256 Zipf pool, window 5; its window geometry from the device
               window generator) through the scatter kernel, against its plain version
               on the card and both against a float64 plain step; timed per call
               (events) and per launch (torch.profiler), and its endpoint delta in
               both forms;
 5c. stabilizers
               one full-width step of each of the five step functions (per-pair and
               shared-pool skip-gram, the latter in its scatter form, scatter CBOW with
               each pool, banded CBOW) with max_row_norm=5, update_clip=0.05,
               row_l2=1e-3, and the per-pair and per-example CBOW steps with
               duplicate_scaling, kernel against plain on identical inputs;
  6. feed      the native pair generator built with g++ (the run fails if it does
               not build); the smoke corpus's skip-gram pair stream from the native
               generator against numpy's at producer_workers 1 and 4, and the CBOW
               stream at 1 and 4, each held bit for bit by a digest of every batch;
               one timed pass of each; the host's cores and the thread budget;
  7. pairgen   the device pair generator (ops/pairgen.py, plain torch ops) on the
               first chunk of the smoke corpus's device feed (16 blocks of the
               trainer's tokens_per_step kept tokens), on the card and on the CPU, in
               the trainer's mode and in the subsampling one: every output
               bit-identical; one batched call timed on the card;
  8. fits      Word2Vec(vector_size=300, window=5, negatives=5, pairs_per_batch=8192)
               .fit() on one synthetic Zipf corpus over one 1,000,000-word vocabulary,
               five times with the default feed (prefetch_chunks=8: a producer thread
               assembles the chunks and stages their copies to the card):
               skip-gram with the shared pool (the fused kernel), per-pair skip-gram
               (negative_pool=0), CBOW with the shared pool and per-example CBOW
               (negative_pool=0) (the scatter kernel), and skip-gram with the shared
               pool fed by the device pair generator (device_pairgen=True, the fused
               kernel); then banded CBOW (cbow_update="banded", the scatter kernel
               three times a step) and shared-pool skip-gram with the three
               stabilizers on (the scatter form: the fused kernel never, the scatter
               kernel twice a step); every kernel's launch count set to 0 just before
               each fit and read just after; the host-fed skip-gram fits must feed from
               the native generator, the scatter CBOW fits from numpy (there is no
               native CBOW generator), the device-fed and banded ones from the token
               blocks; the device-fed fit's pairs trained and dropped must equal a
               numpy replay of its token stream through the host pair generator, its
               drops stay under 2%; the banded fit's steps and examples a numpy replay
               through the halo packer and the host window draw; then shared-pool
               skip-gram in bf16 with fused_logits and bf16_chain (the fused kernel and
               two bf16 scatters a step), shared-pool and per-pair skip-gram with
               hot_rows=4096 (the scatter form, four scatters a step) and banded CBOW in
               bf16, the host-fed ones held to a numpy replay of their feed (steps and
               pairs); last a bf16 fit at V=200,000 (the TPU step bench's vocabulary)
               with the TPU bench's batch, pool, dispatch and subsample (B=65536, pool
               512, 32 steps a dispatch, 1e-4) and the device pair generator, on a
               4.5M-token corpus of the end-to-end bench's Zipf shape, held to the host
               replay of its token stream. Every fit runs through the trainer's CUDA
               graphs (one replay a chunk, one or two captures; the launch counts are
               those of the steps the card ran: K a replay and K a capture's warm-up),
               under torch.profiler (the card's activity only): the idle share is the
               share of Trainer.fit's wall outside the union of the kernels'
               intervals. Each fit must have trained: both matrices moved from the
               parameters it started from, and a held batch's skip-gram loss fell below
               theirs. Each V=1M fit is then followed by its eager control (the
               trainer's private _eager_chunks; not profiled) from the same parameters
               and corpus, held to it at PARAM_ATOL and LOSS_RTOL (f32) or by
               ops/bf16_check's limits on the parameter deltas and its LOSS_RTOL (bf16);
               each prints its captures, replays, dispatch_s and idle share;
  9. model     save -> verify -> load -> find_synonyms / analogy on the shared-pool
               fit's model, right after that fit; transform_sentences, pull and
               multiply against float64 on the host; a binary word2vec export of the
               whole 1,000,000-row model (file size and sampled rows read back), a
               text export of its first 2,000 rows (rows read back), and
               load_latest(reclaim=False) on a directory holding save debris (the
               torn swap's predecessor wins, nothing is touched); then the
               shared-pool fit once more on the calling thread (prefetch_chunks=0)
               with the numpy generator: the same step count, parameters within
               PARAM_ATOL.
 10. runtime  the runtime layer on the main path (V=1,000,000, D=300 padded to 384,
               B=8192, P=256, f32, the fits' 750,000-token corpus), four fits:
               (a) telemetry_path, status_port and norm_watch="warn": a thread polls
               /status.json and /metrics during the fit (HTTP 200, global_step
               rising), the run log validates, the trace loads, and the last
               heartbeat's probe channels are held against a float64 NumPy
               computation on the parameters that probe read (max and mean within
               1e-5 relative, frac_over and the p99 bucket equal, one row or bucket
               allowed only for a norm within 1e-6 of the threshold or an edge);
               then the probe's and one snapshot's device time beside their byte
               bounds, and the fit's wall beside the layer-off "shared" fit of phase 8;
               (b) nonfinite_policy="rollback" with NaN injected at the round reaching
               step 40: one rollback, global_step past 2^22, finite parameters, the
               fused kernel launching before and after the rollback, the graphs
               captured anew after it and one replay a chunk; (c)
               norm_watch="recover" with the parameters scaled x1e6 there: one
               recovery record, lr_scale 0.5, max_row_norm engaged at 100, the fused
               kernel before the recovery and the scatter kernel (its scatter form)
               after, captured anew after it, finite and below the threshold at the
               end; (d) a child process
               fits at V=200,000 with telemetry and checkpoint_on_preempt and gets
               SIGTERM after its first heartbeat: it dies of the signal, its emergency
               checkpoint passes load_latest_valid and verify_checkpoint, its log has
               the preempt record and its blackbox dump validates.
 11. serve    the serving path on the shared fit's checkpoint (phase 8's, saved dense):
               (a) EmbeddingService(checkpoint, watch=True, reload_poll_s=0.05,
               status_port, telemetry_path) on the card, the exact arm: 8 client
               threads query synonyms for 2 s; every served list equals
               Word2VecModel.load(ck).find_synonyms on the card (ids, scores within
               1e-6; a swap allowed only between scores within 1e-6), 32 queries' ids
               equal a float64 NumPy oracle's (the same ties; scores within 1e-5), the
               batcher coalesced (batches < submitted), /metrics carries glint_serve_*;
               one batch of 8 exact queries profiled by kernel beside syn0's read;
               then a second fit from the checkpoint's parameters (its kernel launches
               counted) is saved to the same path while the clients query: it must be
               hot-reloaded within 5 s with no query error, reloads and models_released
               +1, every list served meanwhile one of the two models', every list
               after it the new model's; the card's memory during the swap; the run
               log validates; (b) the same checkpoint with the IVF arm (f32): its
               build seconds, index bytes, recall@10 against the exact oracle, the
               served lists' overlap with the exact ones, p50 and p99 beside (a)'s;
               (c) python -m glint_word2vec_torch.servebench at V=200,000, d=300 over
               its clustered matrix (V=1M fails PQ's 0.95 floor there and its builds
               take ~70 s): every arm, the int8 and PQ builds at their recall floors,
               and the shard-native int8 build's codes equal to the in-memory build's;
               (d) python -m glint_word2vec_torch.serve_checkpoint ck --ann as a child
               process on the card: synonyms and synonyms_batch equal to (b)'s lists,
               an out-of-vocabulary word's error_type, reload, stats, info, exit 0.
 12. quality  training from a token file, held to a quality number: (a) the port's
               generate_corpus at EVAL.md's scale (17,000,000 words, 90,000 raw types,
               seed 42) into a temporary directory, its seconds and SHA-256; (b) python
               -m glint_word2vec_torch.eval_quality on it in a child process on the card
               with the JAX tool's defaults (d=100, 3 iterations, B=65536, P=512, f32,
               lr 0.025, subsample 1e-4, min_count 5, 32 steps a dispatch) and
               --idle-share: not diverged, purity@10 >= 0.95, cosine margin >= 0.30, the
               fused kernel launched on every step (K a replay and K a capture's
               warm-up) and the scatter kernel never; its analogy accuracies printed,
               held to nothing; (c) the same corpus, config and seed through python -m
               glint_word2vec_torch.train_run --cmd <a worker this script writes>
               --status-port --telemetry, the first attempt SIGTERM'd by the fault plan
               at half of (b)'s steps under checkpoint_on_preempt: verdict ok in 2
               attempts (preempt, then ok), the preempt record saved with at most one
               chunk since the last save, the final checkpoint finished at (b)'s step,
               glint_supervisor_* on /metrics, both run logs valid, and its purity@10
               (the port's scorers) within 0.02 of (b)'s; (d) one fused step at (b)'s
               shape (V of its vocabulary, D=100 padded to 128, B=65536, P=512, Zipf 1.1
               duplicates) against its plain version with phase 3's limits, timed per
               call and on the device beside its bound.
 13. fleet    the serving fleet, the chaos drill and the transfer audit, run after
               phase 11 on its checkpoint (V=1,000,000, d=300, the refit's save): (a)
               fleet_run.run_smoke with 3 replica processes on the card serving it
               under 8 client threads, every served list equal to the served model's
               find_synonyms (ids, scores within 1e-6, ties as in phase 11): a SIGKILL
               mid-storm opens the victim's breaker, no client query fails, the replica
               restarts and its breaker closes from half-open; 3 publishes (saves of
               the model) roll through the replicas one at a time, each reload to a
               drained replica, capacity never below 2; a SIGTERM leaves a valid
               flight-recorder dump; the SLO within budget; the collector merges every
               artifact. Printed: the replicas' start-up seconds, queries and
               failures, the breaker's transitions, each rolling round's seconds, the
               card's memory (nvidia-smi) before, at peak and after close. (b) python
               -m glint_word2vec_torch.chaos_run --smoke --device cuda over its phases
               but fleet-kill (13a), train-preempt (12c), nan-rollback (10b),
               norm-recover (10c) and blackbox (10d), each named with the phase that
               covers it (continual-drift and serve-reload's two V-grew epilogues among
               them): every phase run passes. (c) python -m
               glint_word2vec_torch.stepaudit --device cuda at V=1,000,000, d=300,
               B=8192, K=16 (its default geometry there) over every single-device
               variant and the recovery: no undeclared host read or transfer (nor a
               sync-debug witness), no declared site doing more than it declares
               (every staging copy pinned and non-blocking), the parameters in place
               (peak memory over the start below one matrix), no float64 or dense
               float32 [V, D] upcast, the expected graph captures, with the declared
               syncs per chunk printed. (b) and (c) run side by side.
 14. continual continual training on phase 11's checkpoint, after phase 13: (a) a copy
               of it (V=1,000,000, d=300, syn1 and its train state) served by an
               EmbeddingService on the card (exact arm, watch=True) under 8 client
               threads querying 64 old words throughout; a tail segment of 2,000,000
               Zipf(1) tokens over its words (another seed than phase 8's corpus) and
               10,000 unseen words, each min_count + 3 times; ContinualRunner(
               device="cuda").run_once() with continual_lr_rewarm=0.5 must grow V by
               exactly 10,000 (old words first, in order; new ones in first-seen
               order), merge counts equal to the old counts plus np.bincount of the
               tail, publish an extension whose carried syn0/syn1 rows are bit-identical
               to the source, new syn1 rows zero and new syn0 rows seed_new_rows'
               (within 0.5/300), checked on disk before the fit; then the increment:
               syn0 rows of old words the tail never holds bit-identical, global_step
               advanced by exactly the steps (and pairs) of a numpy replay of the
               feed, the published learning_rate unchanged, a lineage of depth 1 with
               remap identity-prefix, the fused kernel launched on every step (K a
               replay and K a capture's warm-up) and the scatter kernel never; the
               service reloads both publishes, counts one vocabulary-change reload and
               answers a new word with finite scores; no query fails or is refused; a
               second run_once() is idle. Printed: the seconds of count, extension,
               encode, load, trainer set-up and fit; pairs/s and the device's idle share
               over the fit (profiled; the service's kernels count busy); each reload's
               seconds from publish to swap; the card's memory before, at peak and
               after. (b) python -m glint_word2vec_torch.eval_quality --continual-ab
               --words 6000000 --vocab 30000 --dim 64 --iters 1 (seed 42, B=65536,
               P=512, a 1,500,000-word tail, 2,000 new raw types) in a child process on
               the card: vocab_base 30,349, new_words 1,747, vocab_grown 32,096 (the JAX
               tool's EVAL_RUNS.jsonl:27-28), post purity@10 >= 0.95 and >= pre - 0.02,
               post margin >= 0.30, the fused kernel on every step of both fits; analogy
               @1 and each arm's train seconds printed, held to nothing.
 15. mesh     row-sharded training over torch.distributed, after phase 12: two rank
               processes of this script on the one card (NCCL refuses two ranks on one
               device, so a gloo world whose every collective is staged through host
               memory), V=1,000,000, d=300 (384), B=8192, the AUTO pool (256 at 1M
               words), f32, this corpus's Zipf(1) tokens: (a) mesh (1, 2), the
               default sharded-input fit through Trainer(plan=) for 64 steps from the
               trainer's seeded start; its global chunks replayed through the plain
               single-process step on the card, and the ranks' row-shards checkpoint
               within PARAM_ATOL of the replay; each rank's step time (dispatch, eager)
               and the staging's share of it, its scatter launches (non-zero; the fused
               kernel's zero) and the scatter kernel against its plain version at the
               shapes the mesh step gives it; (b) mesh (2, 1), sync_every=2, one
               window a chunk: after every merge the two replicas' fingerprints are
               equal, and their bytes at the end; (c) the checkpoint loaded by one
               process serves find_synonyms for 16 words as the explicitly gathered
               rows do (ids identical, scores within 1e-6); (d) a world of one on NCCL
               runs the collective interface on the card.
Then a line with every fit's captures, replays, chunks, dispatch_s and idle share, one
JSON line with the kernels' numbers, the nvidia-smi line, and the result line
{"ok": true, "device": {...}}. With no CUDA device, or without the package beside
this file, it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): fp32 on CUDA
# cores, TF32 on the tensor cores and HBM3 bandwidth. The bounds below use them.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

V, D_REAL, D, B, N_NEG, WINDOW, P = 1_000_000, 300, 384, 8192, 5, 5, 256
MASKED_TAIL = 1000
# Kernel vs plain: |kernel - plain| <= 1e-4 on parameters of scale ~0.35 and 1e-4
# relative on the loss. The kernels sum a row's duplicate updates with fp32 atomics in
# a run-dependent order (and the fused kernel its products in another order than
# cuBLAS); the hottest row takes ~800 (fused step) to ~5000 (per-pair syn1) summed
# updates per step, whose reordering moves the sum by ~1e-5 at most.
PARAM_ATOL = 1e-4
LOSS_RTOL = 1e-4
TIMED_STEPS = 30
L2_RING = 16  # independently drawn batches for the L2-cold timing (~10 MB of rows each)
HOT_CENTER, HOT_POOL = 7, 11  # the hot-row case's rows
HEAVY_V = 65536  # the heavy-draw case's vocabulary
STAB = {"max_row_norm": 5.0, "update_clip": 0.05, "row_l2": 1e-3}  # the JAX suite's
T_BANDED = B + 2 * WINDOW  # a banded step's token slots
BANDED_PAD = 100  # its padded tail
SCATTER_RUNS = 25
# Scatter vs float64: the standard bound of recursive f32 summation, (m - 1)·2^-24·Σ|x|
# for a row that takes m updates, computed from each shape's own data (scatter_tol).
EPS32 = 2.0 ** -24
N_TOKENS = 750_000  # one corpus for every V=1M fit: >= 4 dispatch chunks on each path
TEXT_ROWS = 2_000  # the text export's rows (the binary export writes all 1M)


_T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line of the run, after the seconds since the script started."""
    print(f"[{phase} {time.perf_counter() - _T0:.1f}s] {msg}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def build_all(kernels) -> float:
    t0 = time.perf_counter()
    pending = {name: kernels.start_build(name) for name in kernels.sources()}
    for name, build in pending.items():
        kernels.load(name, build)
    return time.perf_counter() - t0


def zipf_ids(gen, n: int, vocab: int, a: float, torch):
    """Zipf(a) draws folded into [0, vocab), on the card, from a seeded generator."""
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    # inverse of the continuous Zipf tail, rank r >= 1 with P(r) ~ r^-a
    r = torch.floor((1.0 - u) ** (-1.0 / (a - 1.0)))
    return ((r - 1) % vocab).to(torch.int64)


def step_bound(c, x, neg, mask, D: int, torch) -> dict:
    """Least time for the step on these inputs: every touched row read once and
    written once, indices and mask read once, and the transposed copies that tf32
    wgmma needs as K-major B operands (Zᵀ [D, P] and Gᵀ [P, B], each as TF32 big and
    small parts) written once and read once; 6·B_real·P·D flops for the three
    products (E·Zᵀ, G·Z, Gᵀ·E) over the real pairs. ``bound_ms`` takes them in fp32 on
    CUDA cores (comparable with earlier runs), ``bound_tc_ms`` as three TF32 products
    each (3xTF32) on the tensor cores."""
    real = mask > 0
    u0 = int(torch.unique(c[real]).numel())
    u1 = int(torch.unique(torch.cat([x[real], neg])).numel())
    b_real, B, P = int(real.sum()), c.numel(), neg.numel()
    transposed = 2 * 2 * (D * P + P * B) * 4
    bytes_ = 2 * (u0 + u1) * D * 4 + B * (8 + 8 + 4) + P * 8 + transposed
    flops = 6 * b_real * P * D
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    t_tc = 3 * flops / PEAK_TF32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_tc_ms": 1e3 * max(t_bytes, t_tc),
            "bound_tc_by": "operations" if t_tc >= t_bytes else "bytes",
            "bytes": bytes_, "transposed_bytes": transposed, "flops": flops}


def time_steps(fn, steps: int, torch) -> float:
    """Median ms of ``fn()`` over ``steps`` calls, CUDA events around each."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def shared_batch(gen, torch):
    """One skip-gram batch at the main shape: Zipf centers, contexts and pool, pool
    entries equal to positives, a masked tail of index 0."""
    c = zipf_ids(gen, B, V, 1.1, torch)
    x = zipf_ids(gen, B, V, 1.1, torch)
    neg = zipf_ids(gen, P, V, 1.1, torch)
    neg[:16] = x[:16]                       # pool entries equal to positives
    mask = torch.ones(B, device="cuda")
    mask[-MASKED_TAIL:] = 0.0
    c[-MASKED_TAIL:] = 0
    x[-MASKED_TAIL:] = 0
    return c, x, mask, neg


def per_launch_us(fn, profile_call) -> dict:
    """Mean device µs of one launch of each kernel that ``fn`` runs, from
    torch.profiler over TIMED_STEPS calls (stepprof.profile_call)."""
    return {k: v["us_total"] / max(v["count"], 1)
            for k, v in profile_call(fn, TIMED_STEPS).items()}


def f64_case(name: str, syn0, syn1, c, x, mask, neg, torch, sgns, fused) -> dict:
    """One exact-sigmoid step through the kernel and through the plain version, each
    against a float64 step, within the recursive-summation bound
    depth·2^-24·max(|param| + Σ|terms|), depth = 2(B + P) fp32 additions into one
    element (B pair updates, each a product of depth P, and the pool's B-long sums).
    The plain version also runs a second time: its index_add_ sums duplicate rows with
    atomics, so the two runs show how far its own order varies from run to run.
    Returns the largest differences, over the touched rows of syn0 and syn1."""
    alpha, B, P = 0.025, c.numel(), neg.numel()
    pair = sgns.EmbeddingPair
    want, wm = sgns.sgns_step_shared_core(pair(syn0, syn1), c, x, mask, neg, alpha,
                                          N_NEG, "exact")
    again, _ = sgns.sgns_step_shared_core(pair(syn0, syn1), c, x, mask, neg, alpha,
                                          N_NEG, "exact")
    got0, got1 = syn0.clone(), syn1.clone()
    gm = fused.fused_sgns_shared_step(pair(got0, got1), c, x, mask, neg,
                                      fused.alpha_on_card(alpha, "cuda"), N_NEG, "exact")
    rows0 = torch.unique(c)
    rows1 = torch.unique(torch.cat([x, neg]))
    s0, s1, m64 = syn0.double(), syn1.double(), mask.double()
    ref, _ = sgns.sgns_step_shared_core(pair(s0, s1), c, x, m64, neg, alpha, N_NEG,
                                        "exact")
    e_in, e_pos, Z = s0[c], s1[x], s1[neg]
    *_, g_pos, g_neg = sgns.shared_pool_coeffs(e_in, e_pos, Z, x, neg, m64, alpha, N_NEG,
                                               "exact")
    e_in, e_pos, Z, g_pos, g_neg = (t.abs() for t in (e_in, e_pos, Z, g_pos, g_neg))
    mag0 = s0.abs().index_add_(0, c, g_pos[:, None] * e_pos + g_neg @ Z)[rows0]
    mag1 = s1.abs().index_add_(0, x, g_pos[:, None] * e_in).index_add_(
        0, neg, g_neg.T @ e_in)[rows1]
    tol = 2 * (B + P) * EPS32 * float(max(mag0.max(), mag1.max()))
    torch.cuda.synchronize()
    errs = {}
    for name_, k, p_, q, r, rows in (("syn0", got0, want.syn0, again.syn0, ref.syn0, rows0),
                                     ("syn1", got1, want.syn1, again.syn1, ref.syn1, rows1)):
        errs[name_] = {"kernel_f64": float((k[rows].double() - r[rows]).abs().max()),
                       "plain_f64": float((p_[rows].double() - r[rows]).abs().max()),
                       "kernel_plain": float((k[rows] - p_[rows]).abs().max()),
                       "plain_plain": float((q[rows] - p_[rows]).abs().max())}
    loss_rel = abs(float(gm.loss) - float(wm.loss)) / abs(float(wm.loss))
    moved = max(float((got0[rows0] - syn0[rows0]).abs().max()),
                float((got1[rows1] - syn1[rows1]).abs().max()))
    log("kernel", "%s: max_abs_err %s; summation bound %.3e; loss_rel_err %.3e (kernel "
        "moved a row by %.3e)" % (name, "; ".join(
            f"{a} " + " ".join(f"{k.replace('_', '-')} {v:.3e}" for k, v in e.items())
            for a, e in errs.items()), tol, loss_rel, moved))
    bad = [k for k, ok in (("syn0", max(errs["syn0"]["kernel_f64"],
                                        errs["syn0"]["plain_f64"]) <= tol),
                           ("syn1", max(errs["syn1"]["kernel_f64"],
                                        errs["syn1"]["plain_f64"]) <= tol),
                           ("loss", loss_rel <= LOSS_RTOL), ("moved", moved > 1e-3),
                           ("finite", math.isfinite(float(gm.loss)))) if not ok]
    if bad:
        raise AssertionError(f"{name}: off the float64 step beyond {tol:.3e}: {bad}")
    return {k: max(errs["syn0"][k], errs["syn1"][k]) for k in errs["syn0"]}


def heavy_draw(gen, mask, torch):
    """A heavier draw than the main shape's: Zipf(1.3) indices over V=65536 and
    parameters of scale 0.5, so the hottest rows take ~2000 large updates a step."""
    syn0 = torch.randn((HEAVY_V, D), generator=gen, device="cuda") * 0.5
    syn1 = torch.randn((HEAVY_V, D), generator=gen, device="cuda") * 0.5
    c, x, neg = (zipf_ids(gen, n, HEAVY_V, 1.3, torch) for n in (B, B, P))
    neg[:4] = x[:4]
    c[mask == 0] = 0
    x[mask == 0] = 0
    return syn0, syn1, c, x, mask, neg


def hold_kernel(syn0, syn1, c, x, mask, neg, torch, sgns, fused, label: str) -> float:
    """One fused step through the kernel (alpha in the trainer's form: a one-element
    float32 tensor on the card, read at run time) and through the plain version (the
    Python float), in both sigmoid modes, on copies of ``syn0``/``syn1``: parameters
    within PARAM_ATOL, the loss within LOSS_RTOL. Returns the largest difference."""
    alpha = 0.025
    alpha_t = fused.alpha_on_card(alpha, "cuda")
    worst = 0.0
    for mode in ("exact", "clipped"):
        want, wm = sgns.sgns_step_shared_core(
            sgns.EmbeddingPair(syn0, syn1), c, x, mask, neg, alpha, N_NEG, mode)
        got0, got1 = syn0.clone(), syn1.clone()
        gm = fused.fused_sgns_shared_step(sgns.EmbeddingPair(got0, got1), c, x, mask,
                                          neg, alpha_t, N_NEG, mode)
        torch.cuda.synchronize()
        err0 = float((got0 - want.syn0).abs().max())
        err1 = float((got1 - want.syn1).abs().max())
        moved = float((want.syn0 - syn0).abs().max())
        rel0 = err0 / max(float(want.syn0.abs().max()), 1e-30)
        rel1 = err1 / max(float(want.syn1.abs().max()), 1e-30)
        loss_rel = abs(float(gm.loss) - float(wm.loss)) / abs(float(wm.loss))
        fpos_err = abs(float(gm.mean_f_pos) - float(wm.mean_f_pos))
        log("kernel", f"{label}, sigmoid={mode}: max_abs_err syn0={err0:.3e} "
            f"syn1={err1:.3e} max_rel_err syn0={rel0:.3e} syn1={rel1:.3e} "
            f"loss={float(gm.loss):.6f} plain_loss={float(wm.loss):.6f} "
            f"loss_rel_err={loss_rel:.3e} mean_f_pos_err={fpos_err:.3e} (largest update "
            f"{moved:.3e})")
        bad = [name for name, ok in (
            ("syn0", err0 <= PARAM_ATOL), ("syn1", err1 <= PARAM_ATOL),
            ("loss", loss_rel <= LOSS_RTOL), ("moved", moved > 1e-3),
            ("finite", math.isfinite(float(gm.loss)))) if not ok]
        if bad:
            raise AssertionError(f"kernel disagrees with the plain version ({label}, "
                                 f"{mode}): {bad}; tolerance atol {PARAM_ATOL}, loss "
                                 f"rtol {LOSS_RTOL}")
        worst = max(worst, err0, err1)
        del want, got0, got1
    return worst


def kernel_phase(seed: int, torch, sgns, fused, profile_call) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    syn0 = torch.zeros((V, D), device="cuda")
    syn1 = torch.zeros((V, D), device="cuda")
    syn0[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    syn1[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    c, x, mask, neg = shared_batch(gen, torch)
    # the plain step takes the Python float, the kernel the trainer's form of it
    alpha = 0.025
    alpha_t = fused.alpha_on_card(alpha, "cuda")
    worst = {"max_abs_err": hold_kernel(syn0, syn1, c, x, mask, neg, torch, sgns, fused,
                                        "main shape")}
    hot = f64_case(f"hot row (centers on row {HOT_CENTER}, pool on row {HOT_POOL})",
                   syn0, syn1, torch.where(mask > 0, HOT_CENTER, 0).to(torch.int64), x,
                   mask, torch.full((P,), HOT_POOL, dtype=torch.int64, device="cuda"),
                   torch, sgns, fused)
    heavy = f64_case(f"heavy draw (Zipf 1.3 over V={HEAVY_V}, parameters of scale 0.5)",
                     *heavy_draw(gen, mask, torch), torch, sgns, fused)
    params = sgns.EmbeddingPair(syn0, syn1)

    def step():
        fused.fused_sgns_shared_step(params, c, x, mask, neg, alpha_t, N_NEG, "exact")

    call_ms = time_steps(step, TIMED_STEPS, torch)
    plain_ms = time_steps(lambda: sgns.sgns_step_shared_core(
        params, c, x, mask, neg, alpha, N_NEG, "exact"), TIMED_STEPS, torch)
    warm = per_launch_us(step, profile_call)
    ring = [shared_batch(gen, torch) for _ in range(L2_RING)]
    rows = [torch.unique(torch.cat([b[0] for b in ring])).numel(),
            torch.unique(torch.cat([torch.cat([b[1], b[3]]) for b in ring])).numel()]
    ring_mb = (int(rows[0]) + int(rows[1])) * D * 4 / 1e6
    turn = iter(range(10 ** 9))

    def cold_step():
        cb, xb, mb, nb = ring[next(turn) % L2_RING]
        fused.fused_sgns_shared_step(params, cb, xb, mb, nb, alpha_t, N_NEG, "exact")

    cold = per_launch_us(cold_step, profile_call)
    bound = step_bound(c, x, neg, mask, D, torch)
    ours = ("gather_kernel", "fneg_kernel", "update_kernel", "dz_scatter_kernel")
    if any(k not in warm for k in ours):
        raise AssertionError(f"the profile shows no launch of {ours}: {warm}")
    # each of the four launches once per step
    device_ms = sum(warm[k] for k in ours) / 1e3
    cold_ms = sum(cold[k] for k in ours) / 1e3
    log("kernel", f"B={B} P={P} D={D} V={V}: one wrapper call {call_ms:.4f} ms (CUDA "
        f"events, median of {TIMED_STEPS}, host enqueue included); on the device "
        f"{device_ms:.4f} ms per step warm (one batch; its four launches' mean times "
        f"summed, torch.profiler over {TIMED_STEPS} steps), {cold_ms:.4f} ms L2-cold (a "
        f"ring of {L2_RING} batches touching {ring_mb:.1f} MB of distinct rows); plain "
        f"{plain_ms:.4f} ms; bound {1e3 * bound['bound_ms']:.1f} us ({bound['bound_by']}, "
        f"fp32 CUDA cores), bound_tc {1e3 * bound['bound_tc_ms']:.1f} us "
        f"({bound['bound_tc_by']}, 3xTF32 tensor cores): {bound['flops'] / 1e9:.3f} GFLOP, "
        f"{bound['bytes'] / 1e6:.1f} MB ({bound['transposed_bytes'] / 1e6:.1f} MB of them "
        f"the transposed B operands); library_ms: none")
    log("kernel", "per launch, warm: %s; L2-cold: %s; other kernels, per launch %s" % (
        ", ".join(f"{k} {warm[k]:.2f} us" for k in ours),
        ", ".join(f"{k} {cold.get(k, 0.0):.2f} us" for k in ours),
        {k: round(v, 2) for k, v in warm.items() if k not in ours}))
    return {"max_abs_err": worst["max_abs_err"], "hot_row_max_abs_err": hot["kernel_plain"],
            "heavy_draw": heavy, "ms": call_ms, "device_ms": device_ms,
            "l2_cold_ms": cold_ms, "plain_ms": plain_ms,
            "per_launch_us": {k: warm[k] for k in ours},
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound_tc_ms": bound["bound_tc_ms"], "bound_tc_by": bound["bound_tc_by"]}


def scatter_tol(target, idx, upd, live, torch) -> float:
    """(1 + the most live updates on one row)·2^-24·max over rows of (|target| +
    Σ|upd|)."""
    mag = target.abs().double().index_add_(0, idx, upd.abs().double())
    m = int(torch.bincount(idx if live is None else idx[live != 0]).max()) + 1
    return m * EPS32 * float(mag.abs().max())


def scatter_case(name: str, target, idx, upd, live, torch, scat, probe,
                 profile_call) -> dict:
    """Kernel vs plain vs float64 on one shape, then timed: one wrapper call (events,
    host enqueue included) and its launches' device time (torch.profiler)."""
    want = target.double().index_add_(0, idx, upd.double())
    tol = scatter_tol(target, idx, upd, live, torch)
    got = scat.scatter_add_rows_(target.clone(), idx, upd, live)
    plain = scat.scatter_add_rows_reference(target.clone(), idx, upd, live)
    scat.check_errors()
    torch.cuda.synchronize()
    err_k = float((got.double() - want).abs().max())
    err_p = float((plain.double() - want).abs().max())
    err_kp = float((got - plain).abs().max())
    del want, plain
    out = target.clone()
    ms = time_steps(lambda: scat.scatter_add_rows_(out, idx, upd, live), SCATTER_RUNS,
                    torch)
    lib_ms = time_steps(lambda: out.index_add_(0, idx, upd), SCATTER_RUNS, torch)
    launches = profile_call(lambda: scat.scatter_add_rows_(out, idx, upd, live),
                            TIMED_STEPS)
    device_ms = sum(v["us_total"] for v in launches.values()) / TIMED_STEPS / 1e3
    cuda_launches = sum(v["count"] for v in launches.values()) / TIMED_STEPS
    lib_launches = profile_call(lambda: out.index_add_(0, idx, upd), TIMED_STEPS)
    lib_device_ms = sum(v["us_total"] for v in lib_launches.values()) / TIMED_STEPS / 1e3
    scat.check_errors()
    bytes_ = probe.bound_bytes(idx, upd.shape[1], live)
    bound_ms = 1e3 * bytes_ / PEAK_BYTES_PER_S
    N = idx.numel()
    written = idx if live is None else idx[live != 0]
    distinct = int(torch.unique(written).numel())
    hottest = int(torch.bincount(written).max())
    log("scatter", f"{name}: N={N} rows of D={upd.shape[1]} into {target.shape[0]}, "
        f"{written.numel()} live (distinct live targets {distinct}, most live updates "
        f"on one row {hottest}): max_abs_err kernel-plain {err_kp:.3e}, kernel-f64 "
        f"{err_k:.3e}, plain-f64 {err_p:.3e} (tolerance {tol:.3e}); kernel {ms:.4f} ms "
        f"per call (median of {SCATTER_RUNS}, {ms / N * 1e6:.3f} ns/row), on the device "
        f"{device_ms:.4f} ms in {cuda_launches:g} CUDA launches per call "
        f"(torch.profiler over {TIMED_STEPS} calls: " + ", ".join(
            f"{k} {v['us_total'] / TIMED_STEPS:.2f} us" for k, v in launches.items())
        + f"), index_add_ {lib_ms:.4f} ms per call ({lib_ms / N * 1e6:.3f} ns/row), "
        f"{lib_device_ms:.4f} ms on the device, bound "
        f"{bound_ms * 1e3:.1f} us (bytes: {bytes_ / 1e6:.1f} MB, "
        f"{bound_ms / N * 1e6:.3f} ns/row; device time at {bound_ms / device_ms:.0%} "
        f"of it)")
    if not (err_k <= tol and err_p <= tol):
        raise AssertionError(f"scatter {name}: kernel or plain off the float64 sum "
                             f"beyond the summation bound {tol:.3e}")
    return {"max_abs_err": err_kp, "max_abs_err_f64": err_k, "tolerance": tol,
            "ms": ms, "device_ms": device_ms, "cuda_launches_per_call": cuda_launches,
            "plain_ms": lib_ms, "library_ms": lib_ms, "library_device_ms": lib_device_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes", "ns_per_row": ms / N * 1e6, "distinct": distinct,
            "most_on_one_row": hottest}


def scatter_shapes(seed: int, corpus, torch, probe):
    """The scatter's five shapes, as (key, name, target, idx, upd, live): the TPU
    probe's shape, then the per-pair step's syn1 scatter and the CBOW steps' syn0
    context scatter at full width; then the traffic a per-pair step really sends: syn1
    with its negatives from the port's alias sampler, and syn0 with the centers of one
    batch of the smoke's own per-pair feed. Each draw is made when it is reached."""
    from glint_word2vec_torch.data.pipeline import encode_sentences

    idxs, x = probe.zipf_head_draw(2048, D, 65536, sets=1)
    yield ("probe_shape", "probe shape", torch.zeros((2048, D), device="cuda"),
           torch.from_numpy(idxs[0]).cuda(), torch.from_numpy(x).cuda(), None)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    N = B * (1 + N_NEG)
    target = torch.randn((V, D), generator=gen, device="cuda") * 0.35
    idx = zipf_ids(gen, N, V, 1.1, torch)
    live = (torch.rand(N, generator=gen, device="cuda") >= 0.1).float()
    idx[live == 0] = 0                     # dead slots point at the hottest row
    upd = torch.randn((N, D), generator=gen, device="cuda") * 1e-2 * live[:, None]
    yield "main", "per-pair syn1 shape", target, idx, upd, live
    (syn0, _), (_, ctx, ctx_mask, mask, _) = step_inputs(seed, torch, cbow=True)
    live = (ctx_mask * mask[:, None]).reshape(-1)  # dead slots carry index 0
    idx = ctx.reshape(-1)
    upd = torch.randn((idx.numel(), D), generator=gen, device="cuda") * 1e-2 * live[:, None]
    yield "cbow_syn0_shape", "CBOW syn0 context shape", syn0, idx, upd, live
    del syn0
    vocab, sents = corpus
    idx, live = probe.step_syn1_draw(gen, vocab.counts, seed)
    upd = torch.randn((idx.numel(), D), generator=gen, device="cuda") * 1e-2 * live[:, None]
    yield ("step_syn1_shape", "per-pair syn1, step draw (alias negatives)", target, idx,
           upd, live)
    idx, live = probe.feed_centers(encode_sentences(sents, vocab), vocab, seed, "cuda")
    upd = torch.randn((idx.numel(), D), generator=gen, device="cuda") * 1e-2 * live[:, None]
    yield ("syn0_centers_shape", "per-pair syn0 centers (one feed batch)", target, idx,
           upd, live)


def scatter_phase(seed: int, corpus, torch, scat, probe, profile_call) -> dict:
    """The five shapes of ``scatter_shapes`` in f32; the record is the per-pair syn1
    shape's, with the others beside it."""
    recs = {}
    for key, name, target, idx, upd, live in scatter_shapes(seed, corpus, torch, probe):
        recs[key] = scatter_case(name, target, idx, upd, live, torch, scat, probe,
                                 profile_call)
        if key == "cbow_syn0_shape":
            recs[key]["dead_share"] = float(1.0 - live.mean())
    rec = recs.pop("main")
    keys = ("ms", "device_ms", "cuda_launches_per_call", "library_ms",
            "library_device_ms", "bound_ms", "ns_per_row", "max_abs_err",
            "max_abs_err_f64", "tolerance", "distinct", "most_on_one_row")
    rec["max_abs_err"] = max(r["max_abs_err"] for r in (rec, *recs.values()))
    for name, r in recs.items():
        rec[name] = {k: r[k] for k in keys + (("dead_share",) if "dead_share" in r else ())}
    return rec


# bf16 forms. The bf16 scatter rounds each row once from an f32 sum: against the float64
# sum it is within half an ulp (<= 2^-8 |x|) plus the f32 summation bound, and so is the
# plain version (another f32 order); kernel and plain are within twice that of each other.
BF16_HALF_ULP = 2.0 ** -8
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense (the 700 W data sheet)
ONE_ROW_CASE = (1000, 1e-3)  # updates of bf16(1e-3) to one row of 1.0: exact 1.9995


def bf16_scatter_case(name: str, target, idx, upd, live, torch, scat, probe,
                      profile_call) -> dict:
    """The bf16 scatter on one shape (target and updates cast to bf16): kernel and plain
    against the float64 sum and each other, elementwise, on the live rows; untouched
    rows bit for bit; torch's bf16 index_add_ beside them (it rounds after every add, on
    the card as on the CPU: another function). Then timed as the f32 case."""
    target, upd = target.to(torch.bfloat16), upd.to(torch.bfloat16)
    keep = live != 0 if live is not None else torch.ones_like(idx, dtype=torch.bool)
    rows, inv = torch.unique(idx[keep], return_inverse=True)
    want = target[rows].double().index_add_(0, inv, upd[keep].double())
    mag = target[rows].abs().double().index_add_(0, inv, upd[keep].abs().double())
    m = torch.bincount(inv, minlength=rows.numel()).double()[:, None] + 1
    f32_term = m * EPS32 * mag
    got = scat.scatter_add_rows_(target.clone(), idx, upd, live)
    plain = scat.scatter_add_rows_reference(target.clone(), idx, upd, live)
    lib = target.clone().index_add_(0, idx, upd)
    scat.check_errors()
    torch.cuda.synchronize()
    k, p_, l_ = got[rows].double(), plain[rows].double(), lib[rows].double()
    # rounding the f32 sum s: half an ulp of s <= 2^-8 (|x| + f32_term)
    tol = BF16_HALF_ULP * want.abs() + (1 + BF16_HALF_ULP) * f32_term
    ratio_k = float(((k - want).abs() / tol).max())
    ratio_p = float(((p_ - want).abs() / tol).max())
    ratio_kp = float(((k - p_).abs() / (2 * tol)).max())
    untouched = torch.ones(target.shape[0], dtype=torch.bool, device="cuda")
    untouched[rows] = False
    same = bool(torch.equal(got[untouched], target[untouched]))
    err_kp = float((k - p_).abs().max())
    err_k = float((k - want).abs().max())
    err_lib = float((l_ - want).abs().max())
    del want, mag, f32_term, tol, plain, lib
    out = target.clone()
    ms = time_steps(lambda: scat.scatter_add_rows_(out, idx, upd, live), SCATTER_RUNS,
                    torch)
    lib_ms = time_steps(lambda: out.index_add_(0, idx, upd), SCATTER_RUNS, torch)
    plain_ms = time_steps(lambda: scat.scatter_add_rows_reference(out, idx, upd, live),
                          SCATTER_RUNS, torch)
    launches = profile_call(lambda: scat.scatter_add_rows_(out, idx, upd, live),
                            TIMED_STEPS)
    device_ms = sum(v["us_total"] for v in launches.values()) / TIMED_STEPS / 1e3
    cuda_launches = sum(v["count"] for v in launches.values()) / TIMED_STEPS
    lib_launches = profile_call(lambda: out.index_add_(0, idx, upd), TIMED_STEPS)
    lib_device_ms = sum(v["us_total"] for v in lib_launches.values()) / TIMED_STEPS / 1e3
    scat.check_errors()
    bytes_ = probe.bound_bytes(idx, upd.shape[1], live, elem=2)
    bound_ms = 1e3 * bytes_ / PEAK_BYTES_PER_S
    N = idx.numel()
    log("scatter_bf16", f"{name}: N={N} bf16 rows of D={upd.shape[1]} into "
        f"{target.shape[0]}, {int(keep.sum())} live, {rows.numel()} distinct live "
        f"targets: max_abs_err kernel-plain {err_kp:.3e}, kernel-f64 {err_k:.3e}; "
        f"largest share of the stated bound: kernel-f64 {ratio_k:.3f}, plain-f64 "
        f"{ratio_p:.3f}, kernel-plain {ratio_kp:.3f}; untouched rows bit for bit {same}; "
        f"index_add_ (bf16, per-add rounding) max_abs_err vs f64 {err_lib:.3e}; kernel "
        f"{ms:.4f} ms per call (median of {SCATTER_RUNS}), on the device "
        f"{device_ms:.4f} ms in {cuda_launches:g} CUDA launches per call (" + ", ".join(
            f"{k} {v['us_total'] / TIMED_STEPS:.2f} us" for k, v in launches.items())
        + f"), plain {plain_ms:.4f} ms per call, index_add_ bf16 {lib_ms:.4f} ms per "
        f"call, {lib_device_ms:.4f} ms on the "
        f"device; bound {bound_ms * 1e3:.1f} us (bytes at 2 B an element: "
        f"{bytes_ / 1e6:.1f} MB; device time at {bound_ms / device_ms:.0%} of it)")
    if not (ratio_k <= 1 and ratio_p <= 1 and ratio_kp <= 1 and same):
        raise AssertionError(f"bf16 scatter {name}: beyond the stated bound (kernel-f64 "
                             f"{ratio_k:.3f}, plain-f64 {ratio_p:.3f}, kernel-plain "
                             f"{ratio_kp:.3f} of it) or untouched rows moved ({not same})")
    return {"max_abs_err": err_kp, "max_abs_err_f64": err_k,
            "bound_share_kernel_f64": ratio_k, "bound_share_kernel_plain": ratio_kp,
            "index_add_bf16_max_abs_err_f64": err_lib, "ms": ms, "device_ms": device_ms,
            "cuda_launches_per_call": cuda_launches, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library_device_ms": lib_device_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "distinct": int(rows.numel())}


def bf16_scatter_phase(seed: int, corpus, torch, scat, probe, profile_call) -> dict:
    """The five shapes of ``scatter_shapes`` in bf16, then the one-row case: 1000
    updates of bf16(1e-3) to a row of 1.0 through the kernel (one rounding: 2.0) and
    through torch's bf16 index_add_ on the card."""
    recs = {key: bf16_scatter_case(name, target, idx, upd, live, torch, scat, probe,
                                   profile_call)
            for key, name, target, idx, upd, live in scatter_shapes(seed, corpus, torch,
                                                                    probe)}
    n, u = ONE_ROW_CASE
    mat = torch.ones((4, D), dtype=torch.bfloat16, device="cuda")
    idx = torch.full((n,), 1, dtype=torch.int64, device="cuda")
    upd = torch.full((n, D), u, device="cuda").to(torch.bfloat16)
    kernel = float(scat.scatter_add_rows_(mat.clone(), idx, upd)[1, 0])
    lib = float(mat.clone().index_add_(0, idx, upd)[1, 0])
    exact = 1.0 + n * float(upd[0, 0])
    log("scatter_bf16", f"one row of 1.0 plus {n} updates of bf16({u}) = "
        f"{float(upd[0, 0]):.8f}: exact {exact:.6f}, the kernel {kernel}, torch's bf16 "
        f"index_add_ on the card {lib}")
    if kernel != 2.0:
        raise AssertionError(f"the bf16 scatter rounded the one-row case to {kernel}")
    rec = recs.pop("main")
    rec["max_abs_err"] = max(r["max_abs_err"] for r in (rec, *recs.values()))
    rec.update(recs)
    rec["one_row_case"] = {"exact": exact, "kernel": kernel, "index_add_bf16": lib}
    return rec


def bf16_step_bound(c, x, neg, mask, elem: int, torch) -> dict:
    """The bf16 step's three bounds: 6·B_real·P·D flops at the fp32 CUDA-core rate and
    at the bf16 tensor-core rate; the touched rows read and written once at ``elem``
    bytes an element with the indices and mask; and those bytes plus the f32 scratch
    this design writes and reads (E, Pc; Z and Zᵀ split; G and Gᵀ split; the dZ
    partials; the bf16 update rows, when the parameters are bf16)."""
    real = mask > 0
    u0 = int(torch.unique(c[real]).numel())
    u1 = int(torch.unique(torch.cat([x[real], neg])).numel())
    b_real, Bn, Pn = int(real.sum()), c.numel(), neg.numel()
    pad = lambda n: -(-n // 128) * 128  # noqa: E731
    Bp, Pp, Dp = pad(Bn), pad(Pn), pad(D)
    rows = 2 * (u0 + u1) * D * elem + Bn * (8 + 8 + 4) + Pn * 8
    scratch = 2 * 4 * (2 * Bp * Dp + 4 * Pp * Dp + 3 * Bp * Pp
                       + -(-Bp // 1024) * Pp * Dp)
    if elem == 2:
        scratch += 2 * 2 * (2 * Bn + Pn) * D
    flops = 6 * b_real * Pn * D
    t_rows = rows / PEAK_BYTES_PER_S
    t_bf16 = flops / PEAK_BF16_FLOPS
    return {"bound_ms": 1e3 * max(t_rows, t_bf16),
            "bound_by": "operations" if t_bf16 >= t_rows else "bytes",
            "bound_fp32_ms": 1e3 * flops / PEAK_FP32_FLOPS,
            "bound_bf16_tc_ms": 1e3 * t_bf16, "bound_bytes_ms": 1e3 * t_rows,
            "bound_design_bytes_ms": 1e3 * (rows + scratch) / PEAK_BYTES_PER_S,
            "flops": flops, "row_bytes": rows, "scratch_bytes": scratch}


def bf16_kernel_phase(seed: int, torch, sgns, fused, profile_call) -> dict:
    """The fused step's three bf16 forms at the main shape, each held to both limits of
    ``ops/bf16_check.check_form`` (the touched rows against the plain step and a
    float64 step; the update rows against the plain step's, with the f32 kernel as the
    control that must break that limit); then timed per wrapper call (events), on the
    device (torch.profiler: the four fused launches, and every launch of the call) and
    the plain step per call."""
    from glint_word2vec_torch.ops import bf16_check

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    base0 = torch.zeros((V, D), device="cuda")
    base1 = torch.zeros((V, D), device="cuda")
    base0[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    base1[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    c, x, mask, neg = shared_batch(gen, torch)
    alpha, pair = 0.025, sgns.EmbeddingPair
    alpha_t = fused.alpha_on_card(alpha, "cuda")
    ours = ("gather_kernel", "fneg_kernel", "update_kernel", "dz_scatter_kernel")
    out = {}
    for name, (pd, cd, ld, fz, ch) in bf16_check.FORMS.items():
        res = bf16_check.check_form(base0, base1, c, x, mask, neg, name, alpha, N_NEG)
        pd, cd, ld = (getattr(torch, t) for t in (pd, cd, ld))
        kw = dict(compute_dtype=cd, logits_dtype=ld, fused=fz, bf16_chain=ch)
        q = pair(base0.to(pd), base1.to(pd))

        def step(q=q, kw=kw):
            fused.fused_sgns_shared_step(q, c, x, mask, neg, alpha_t, N_NEG, "exact",
                                         **kw)

        call_ms = time_steps(step, TIMED_STEPS, torch)
        plain_ms = time_steps(lambda q=q, kw=kw: sgns.sgns_step_shared_core(
            q, c, x, mask, neg, alpha, N_NEG, "exact", **kw), TIMED_STEPS, torch)
        launches = profile_call(step, TIMED_STEPS)
        device_ms = sum(v["us_total"] for v in launches.values()) / TIMED_STEPS / 1e3
        fused_ms = sum(launches[k]["us_total"] for k in ours if k in launches) \
            / TIMED_STEPS / 1e3
        bound = bf16_step_bound(c, x, neg, mask, 2 if pd == torch.bfloat16 else 4, torch)
        upd, ctl = res["updates"], res["control"]
        log("kernel_bf16", f"{name}: rows: max_abs_err {res['errs']}, largest share of "
            f"the stated bound {res['bound_share']}; update rows against the plain "
            f"step's ({upd['compared']} elements): differ {upd['differ_share']:.3e}, "
            f"beyond one bf16 ulp {upd['beyond_share']:.3e}, largest {upd['max_ulps']:g} "
            f"ulps (limits {bf16_check.DIFFER_SHARE:g} and {bf16_check.BEYOND_SHARE:g}); "
            f"the control (the f32 kernel): differ {ctl['differ_share']:.3e}, beyond "
            f"{ctl['beyond_share']:.3e}, largest {ctl['max_ulps']:g} ulps; loss_rel_err "
            f"{res['loss_rel_err']:.3e} (the kernel moved a row by {res['moved']:.3e}); "
            f"one wrapper call {call_ms:.4f} ms (events, median of {TIMED_STEPS}), on "
            f"the device {device_ms:.4f} ms per step (all launches of the call; the four "
            f"fused launches {fused_ms:.4f} ms), plain {plain_ms:.4f} ms; bounds: fp32 "
            f"{1e3 * bound['bound_fp32_ms']:.1f} us, bf16 tensor cores "
            f"{1e3 * bound['bound_bf16_tc_ms']:.2f} us, bytes of the touched rows "
            f"{1e3 * bound['bound_bytes_ms']:.1f} us, with this design's scratch "
            f"{1e3 * bound['bound_design_bytes_ms']:.1f} us; per launch " + ", ".join(
                f"{k} {v['us_total'] / TIMED_STEPS:.2f} us" for k, v in launches.items())
            + "; library_ms: none")
        if res["failures"]:
            raise AssertionError(f"bf16 fused step {name}: {res['failures']}")
        out[name] = {**{k: res[k] for k in ("max_abs_err", "max_abs_err_f64",
                                            "bound_share", "updates", "control",
                                            "loss_rel_err")},
                     "ms": call_ms, "device_ms": device_ms, "fused_device_ms": fused_ms,
                     "plain_ms": plain_ms, **bound}
        del q
    return out


def step_inputs(seed: int, torch, cbow: bool):
    """Full-width parameters and one batch: Zipf centers/contexts, a masked tail, per
    pair negatives [B, n] (skip-gram) or a pool of P (CBOW), negatives equal to
    positives; CBOW windows with the legacy window's context counts."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2 + cbow)
    syn0 = torch.zeros((V, D), device="cuda")
    syn1 = torch.zeros((V, D), device="cuda")
    syn0[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    syn1[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    c = zipf_ids(gen, B, V, 1.1, torch)
    mask = torch.ones(B, device="cuda")
    mask[-MASKED_TAIL:] = 0.0
    c[-MASKED_TAIL:] = 0
    if not cbow:
        x = zipf_ids(gen, B, V, 1.1, torch)
        x[-MASKED_TAIL:] = 0
        neg = zipf_ids(gen, B * N_NEG, V, 1.1, torch).view(B, N_NEG)
        neg[:64, 0] = x[:64]
        return (syn0, syn1), (c, x, mask, neg)
    b = torch.randint(1, WINDOW, (B,), generator=gen, device="cuda")
    nctx = 2 * b - 1                       # b + max(b - 1, 0), b >= 1
    nctx[-MASKED_TAIL:] = 0
    ctx_mask = (torch.arange(2 * WINDOW, device="cuda")[None, :]
                < nctx[:, None]).float()
    ctx = zipf_ids(gen, B * 2 * WINDOW, V, 1.1, torch).view(B, -1) * ctx_mask.long()
    neg = zipf_ids(gen, P, V, 1.1, torch)
    neg[:8] = c[:8]
    return (syn0, syn1), (c, ctx, ctx_mask, mask, neg)


def steps_phase(seed: int, torch, sgns, scat) -> float:
    """One per-pair and one CBOW step through the kernel and through the plain
    scatter, identical inputs; returns the largest parameter difference."""
    worst = 0.0
    for name, cbow in (("per-pair skip-gram", False), ("CBOW, shared pool", True)):
        base, batch = step_inputs(seed, torch, cbow)
        if cbow:
            def run(p, scatter):
                return sgns.cbow_step_shared_core(p, *batch, 0.025, N_NEG, "exact", True,
                                                  scatter)
        else:
            def run(p, scatter):
                return sgns.sgns_step_core(p, *batch, 0.025, "exact", scatter)
        got = sgns.EmbeddingPair(base[0].clone(), base[1].clone())
        before = scat.scatter_add_rows_.launches
        gm = run(got, scat.scatter_add_rows_)
        launched = scat.scatter_add_rows_.launches - before
        want = sgns.EmbeddingPair(base[0].clone(), base[1].clone())
        wm = run(want, scat.scatter_add_rows_reference)
        scat.check_errors()
        torch.cuda.synchronize()
        err = max(float((got.syn0 - want.syn0).abs().max()),
                  float((got.syn1 - want.syn1).abs().max()))
        moved = max(float((want.syn0 - base[0]).abs().max()),
                    float((want.syn1 - base[1]).abs().max()))
        loss_rel = abs(float(gm.loss) - float(wm.loss)) / abs(float(wm.loss))
        del want
        p = sgns.EmbeddingPair(*base)
        ms = time_steps(lambda: run(p, scat.scatter_add_rows_), TIMED_STEPS, torch)
        plain_ms = time_steps(lambda: run(p, scat.scatter_add_rows_reference),
                              TIMED_STEPS, torch)
        log("steps", f"{name}: max_abs_err kernel-plain {err:.3e} (largest update "
            f"{moved:.3e}), loss {float(gm.loss):.6f} vs {float(wm.loss):.6f}, "
            f"pairs {float(gm.pairs):.0f}, scatter launches {launched}; step with the "
            f"kernel {ms:.4f} ms, with index_add_ {plain_ms:.4f} ms (medians of "
            f"{TIMED_STEPS})")
        bad = [k for k, ok in (("params", err <= PARAM_ATOL), ("moved", moved > 1e-3),
                               ("loss", loss_rel <= LOSS_RTOL),
                               ("launches", launched == sgns.SCATTERS_PER_STEP),
                               ("finite", math.isfinite(float(gm.loss)))) if not ok]
        if bad:
            raise AssertionError(f"{name} step with the scatter kernel disagrees with "
                                 f"the plain scatter: {bad}; tolerance {PARAM_ATOL}")
        worst = max(worst, err)
        del got, p, base
    return worst


def banded_block(gen, torch, np):
    """One banded step's block on the card: T_BANDED Zipf tokens in sentences of 5 to
    60 tokens, a zero tail of BANDED_PAD slots, the window geometry of block 0 (ordinal
    base −window wrapped to 64 bits, core slots [window, T − window)), and a Zipf pool.
    Returns (tokens, band, negatives)."""
    from glint_word2vec_torch.ops.pairgen import device_cbow_windows

    n_valid = T_BANDED - BANDED_PAD
    tokens = zipf_ids(gen, T_BANDED, V, 1.1, torch)
    tokens[n_valid:] = 0
    lens = torch.randint(5, 61, (T_BANDED,), generator=gen, device="cuda").cpu().numpy()
    cuts = np.cumsum(np.concatenate([[0], lens]))
    starts = np.zeros(T_BANDED, bool)
    starts[cuts[cuts < n_valid]] = True
    bits = torch.from_numpy(np.packbits(starts, bitorder="little")).cuda()
    base = (-WINDOW) & 0xFFFFFFFFFFFFFFFF
    band = device_cbow_windows(tokens, bits, n_valid, base & 0xFFFFFFFF, base >> 32,
                               0x5BD1E995, WINDOW, WINDOW)
    neg = zipf_ids(gen, P, V, 1.1, torch)
    neg[:8] = tokens[WINDOW:WINDOW + 8]      # pool entries equal to centers
    return tokens, band, neg


def full_params(gen, torch, scale=0.35):
    """Full-width parameters, N(0, scale) in the real columns, zero in the padding."""
    syn0 = torch.zeros((V, D), device="cuda")
    syn1 = torch.zeros((V, D), device="cuda")
    syn0[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * scale
    syn1[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * scale
    return syn0, syn1


def banded_bound(tokens, band, neg, torch) -> dict:
    """Least time of one banded step: the touched rows of syn0 (the valid slots) and of
    syn1 (the live centers and the pool) read and written once, the indices, masks and
    extents read once; 6·T·P·D flops for its three products (hidden·Zᵀ, G·Z, Gᵀ·hidden)
    in fp32."""
    valid = band.token > 0
    live = (band.center > 0) & ((band.left + band.right) > 0)
    u0 = int(torch.unique(tokens[valid]).numel())
    u1 = int(torch.unique(torch.cat([tokens[live], neg])).numel())
    T = tokens.numel()
    bytes_ = 2 * (u0 + u1) * D * 4 + T * (8 * 3 + 4 * 2) + neg.numel() * 8
    flops = 6 * T * neg.numel() * D
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": bytes_, "flops": flops}


def banded_phase(seed: int, torch, np, sgns, scat, profile_call) -> dict:
    """One full-width banded step through the kernel, against its plain version on
    the card, both against a float64 plain step; timed; the endpoint delta in both
    forms."""
    from glint_word2vec_torch.ops import cbow_banded as banded

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    syn0, syn1 = full_params(gen, torch)
    tokens, band, neg = banded_block(gen, torch, np)
    args = (tokens, band.left, band.right, band.center, band.token, neg, 0.025, N_NEG,
            WINDOW)

    def run(p, scatter, **kw):
        return banded.cbow_step_banded_core(p, *args, "exact", True, scatter, **kw)

    got = sgns.EmbeddingPair(syn0.clone(), syn1.clone())
    before = scat.scatter_add_rows_.launches
    gm = run(got, scat.scatter_add_rows_)
    launched = scat.scatter_add_rows_.launches - before
    want = sgns.EmbeddingPair(syn0.clone(), syn1.clone())
    wm = run(want, scat.scatter_add_rows_reference)
    scat.check_errors()
    torch.cuda.synchronize()
    err = max(float((got.syn0 - want.syn0).abs().max()),
              float((got.syn1 - want.syn1).abs().max()))
    moved = max(float((want.syn0 - syn0).abs().max()),
                float((want.syn1 - syn1).abs().max()))
    ref = sgns.EmbeddingPair(syn0.double(), syn1.double())
    rm = run(ref, scat.scatter_add_rows_reference)
    err64 = {}
    for name, p_ in (("kernel", got), ("plain", want)):
        err64[name] = max(float((p_.syn0.double() - ref.syn0).abs().max()),
                          float((p_.syn1.double() - ref.syn1).abs().max()))
    del ref
    loss_rel = abs(float(gm.loss) - float(wm.loss)) / abs(float(wm.loss))
    loss_rel64 = max(abs(float(m.loss) - float(rm.loss)) / abs(float(rm.loss))
                     for m in (gm, wm))
    examples = int(float(gm.pairs))
    p = sgns.EmbeddingPair(syn0, syn1)
    ms = time_steps(lambda: run(p, scat.scatter_add_rows_), TIMED_STEPS, torch)
    plain_ms = time_steps(lambda: run(p, scat.scatter_add_rows_reference), TIMED_STEPS,
                          torch)
    kt = profile_call(lambda: run(p, scat.scatter_add_rows_), TIMED_STEPS)
    launches = {k: v["us_total"] / TIMED_STEPS for k, v in kt.items()}  # µs per step
    device_ms = sum(launches.values()) / 1e3
    g_row = torch.randn((T_BANDED, D), generator=gen, device="cuda") * 1e-3
    live = band.center * ((band.left + band.right) > 0).float()
    g_row *= live[:, None]
    endpoint = {}
    for form in ("scatter", "shift"):
        def delta(form=form):
            return banded._band_endpoint_delta(g_row, band.left, band.right, WINDOW, form,
                                               scat.scatter_add_rows_, live)
        kt = profile_call(delta, TIMED_STEPS)
        endpoint[form] = {"ms": time_steps(delta, TIMED_STEPS, torch),
                          "device_ms": sum(v["us_total"] for v in kt.values())
                          / TIMED_STEPS / 1e3,
                          "cuda_launches": sum(v["count"] for v in kt.values())
                          / TIMED_STEPS}
    shift, scat_form = (banded._band_endpoint_delta(g_row, band.left, band.right, WINDOW,
                                                    f, scat.scatter_add_rows_reference)
                        for f in ("shift", "scatter"))
    endpoint_err = float((shift - scat_form).abs().max())
    bound = banded_bound(tokens, band, neg, torch)
    log("banded", f"T={T_BANDED} P={P} D={D} V={V} window {WINDOW}: {examples} examples, "
        f"max_abs_err kernel-plain {err:.3e} (largest update {moved:.3e}), kernel-f64 "
        f"{err64['kernel']:.3e}, plain-f64 {err64['plain']:.3e}; loss "
        f"{float(gm.loss):.6f} vs plain {float(wm.loss):.6f} (rel {loss_rel:.3e}; vs "
        f"f64 {loss_rel64:.3e}); scatter launches {launched}; step {ms:.4f} ms per call "
        f"(events, median of {TIMED_STEPS}), plain {plain_ms:.4f} ms; on the device "
        f"{device_ms:.4f} ms per step ({len(launches)} kernels, us per step: " + ", ".join(
            f"{k} {v:.1f} us" for k, v in sorted(launches.items(),
                                                  key=lambda kv: -kv[1])[:8])
        + f"); bound {1e3 * bound['bound_ms']:.1f} us ({bound['bound_by']}: "
        f"{bound['flops'] / 1e9:.3f} GFLOP, {bound['bytes'] / 1e6:.1f} MB); endpoint "
        f"delta: " + "; ".join(f"{k} {v['ms']:.4f} ms per call, {v['device_ms']:.4f} ms "
                               f"on the device in {v['cuda_launches']:g} launches"
                               for k, v in endpoint.items())
        + f" (forms differ by {endpoint_err:.3e})")
    bad = [k for k, ok in (
        ("params", err <= PARAM_ATOL), ("kernel_f64", err64["kernel"] <= PARAM_ATOL),
        ("plain_f64", err64["plain"] <= PARAM_ATOL), ("loss", loss_rel <= LOSS_RTOL),
        ("loss_f64", loss_rel64 <= LOSS_RTOL), ("moved", moved > 1e-3),
        ("launches", launched == 3), ("examples", examples > T_BANDED // 2),
        ("endpoint forms", endpoint_err <= 1e-6),
        ("finite", math.isfinite(float(gm.loss)))) if not ok]
    if bad:
        raise AssertionError(f"banded step: {bad}; tolerance {PARAM_ATOL}, loss rtol "
                             f"{LOSS_RTOL}")
    return {"max_abs_err": err, "max_abs_err_f64": err64, "loss_rel_err": loss_rel,
            "examples": examples, "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms, "us_per_step_by_kernel": launches,
            "endpoint": endpoint,
            **bound}


def stabilizers_phase(seed: int, torch, np, sgns, scat) -> dict:
    """One full-width step of each step function with the three stabilizers (and the
    per-pair and per-example CBOW steps with duplicate_scaling), kernel against plain
    on identical inputs; the clamp must hold every touched row to max_row_norm."""
    from glint_word2vec_torch.ops import cbow_banded as banded

    stab = sgns.Stabilizers(**STAB)
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    base_sg, (c, x, mask, neg_pp) = step_inputs(seed, torch, cbow=False)
    pool = zipf_ids(gen, P, V, 1.1, torch)
    pool[:16] = x[:16]
    base_cb, (cc, ctx, cm, cmask, cpool) = step_inputs(seed, torch, cbow=True)
    neg_cb = zipf_ids(gen, B * N_NEG, V, 1.1, torch).view(B, N_NEG)
    tokens, band, bneg = banded_block(gen, torch, np)
    cases = {
        "per_pair": (base_sg, lambda p, sc, **kw: sgns.sgns_step_core(
            p, c, x, mask, neg_pp, 0.025, "exact", sc, **kw), 2),
        "shared_scatter": (base_sg, lambda p, sc, **kw: sgns.sgns_step_shared_scatter_(
            p, c, x, mask, pool, 0.025, N_NEG, "exact", True, sc, **kw), 2),
        "cbow": (base_cb, lambda p, sc, **kw: sgns.cbow_step_shared_core(
            p, cc, ctx, cm, cmask, cpool, 0.025, N_NEG, "exact", True, sc, **kw), 2),
        "cbow_per_example": (base_cb, lambda p, sc, **kw: sgns.cbow_step_core(
            p, cc, ctx, cm, cmask, neg_cb, 0.025, "exact", sc, **kw), 2),
        "cbow_banded": (base_cb, lambda p, sc, **kw: banded.cbow_step_banded_core(
            p, tokens, band.left, band.right, band.center, band.token, bneg, 0.025,
            N_NEG, WINDOW, "exact", True, sc, **kw), 3),
    }
    runs = [(name, "stabilizers", {"stabilizers": stab}) for name in cases]
    runs += [(name, "duplicate_scaling", {"duplicate_scaling": True})
             for name in ("per_pair", "cbow_per_example")]
    out = {}
    for name, knob, kw in runs:
        base, fn, want_launches = cases[name]
        got = sgns.EmbeddingPair(base[0].clone(), base[1].clone())
        before = scat.scatter_add_rows_.launches
        gm = fn(got, scat.scatter_add_rows_, **kw)
        launched = scat.scatter_add_rows_.launches - before
        want = sgns.EmbeddingPair(base[0].clone(), base[1].clone())
        wm = fn(want, scat.scatter_add_rows_reference, **kw)
        scat.check_errors()
        torch.cuda.synchronize()
        err = max(float((got.syn0 - want.syn0).abs().max()),
                  float((got.syn1 - want.syn1).abs().max()))
        moved0 = (want.syn0 != base[0]).any(1)
        moved1 = (want.syn1 != base[1]).any(1)
        top_norm = max(float(got.syn0[moved0].norm(dim=1).max()),
                       float(got.syn1[moved1].norm(dim=1).max()))
        loss_rel = abs(float(gm.loss) - float(wm.loss)) / abs(float(wm.loss))
        del want
        p = sgns.EmbeddingPair(base[0].clone(), base[1].clone())
        ms = time_steps(lambda: fn(p, scat.scatter_add_rows_, **kw), 10, torch)
        plain_ms = time_steps(lambda: fn(p, scat.scatter_add_rows_reference, **kw), 10,
                              torch)
        del p, got
        key = f"{name}+{knob}"
        out[key] = {"max_abs_err": err, "loss_rel_err": loss_rel, "launches": launched,
                    "rows_moved": int(moved0.sum()) + int(moved1.sum()),
                    "largest_touched_norm": top_norm, "ms": ms, "plain_ms": plain_ms}
        log("stab", f"{key}: max_abs_err kernel-plain {err:.3e}, loss {float(gm.loss):.6f} "
            f"(rel {loss_rel:.3e}), scatter launches {launched}, rows moved "
            f"{out[key]['rows_moved']}, largest touched row norm {top_norm:.4f}; step "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (medians of 10)")
        checks = [("params", err <= PARAM_ATOL), ("loss", loss_rel <= LOSS_RTOL),
                  ("launches", launched == want_launches),
                  ("moved", out[key]["rows_moved"] > 0),
                  ("finite", math.isfinite(float(gm.loss)))]
        if knob == "stabilizers":
            checks.append(("max_row_norm", top_norm <= STAB["max_row_norm"] * (1 + 1e-5)))
        bad = [k for k, ok in checks if not ok]
        if bad:
            raise AssertionError(f"stabilized step {key}: {bad}; tolerance {PARAM_ATOL}")
    return out


def synthetic_corpus(seed: int, n_tokens: int, np, vocab_size: int = V,
                     shift: float = 1.0, power: float = 1.0):
    """Words w0..w{vocab_size-1} with Zipf counts 1e9 / (rank + shift)^power (rank
    from 0; the defaults are Zipf(1)), and sentences of 40 tokens drawn from that
    distribution."""
    rng = np.random.default_rng(seed)
    counts = (1e9 / (np.arange(vocab_size) + shift) ** power).astype(np.int64) + 1
    words = [f"w{i}" for i in range(vocab_size)]
    ids = rng.choice(vocab_size, size=n_tokens, p=counts / counts.sum())
    toks = [words[i] for i in ids]
    sents = [toks[i:i + 40] for i in range(0, n_tokens, 40)]
    return words, counts, sents


def feed_phase(corpus, seed: int, np) -> dict:
    """The pair stream of every feed configuration, held bit for bit, and one timed
    pass of each (the smoke's fits' subsample ratio, 1e-3)."""
    from glint_word2vec_torch.data import native
    from glint_word2vec_torch.data.pipeline import (
        encode_sentences, epoch_batches, epoch_batches_cbow)

    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("the native pair generator did not build (g++); the port "
                             "feeds skip-gram from it by default")
    build_s = time.perf_counter() - t0
    vocab, sents = corpus
    encoded = encode_sentences(sents, vocab)
    kw = dict(pairs_per_batch=B, window=WINDOW, subsample_ratio=1e-3, seed=seed)
    runs = [("skip-gram", "numpy", 1), ("skip-gram", "numpy", 4),
            ("skip-gram", "native", 1), ("skip-gram", "native", 4),
            ("cbow", "numpy", 1), ("cbow", "numpy", 4)]

    def stream(kind, backend, workers):
        if kind == "cbow":
            return epoch_batches_cbow(encoded, vocab, producer_workers=workers, **kw)
        return epoch_batches(encoded, vocab, backend=backend, producer_workers=workers,
                             **kw)

    out = {"cpu_count": os.cpu_count(), "native_threads": native.default_threads(),
           "native_build_s": build_s, "library": native.loaded_library(), "runs": []}
    digests = {}
    for kind, backend, workers in runs:
        t0 = time.perf_counter()
        n = sum(1 for _ in stream(kind, backend, workers))
        feed_s = time.perf_counter() - t0
        h = hashlib.sha256()
        for b in stream(kind, backend, workers):
            arrays = ((b.centers, b.contexts, b.mask) if kind == "skip-gram" else
                      (b.centers, b.contexts, b.n_ctx, b.mask))
            for a in arrays:
                h.update(np.ascontiguousarray(a).tobytes())
            h.update(np.asarray([b.words_seen, len(b.centers)], np.int64).tobytes())
        digests.setdefault(kind, set()).add(h.hexdigest())
        per_call = native.threads_per_call(workers)
        out["runs"].append({"feed": kind, "backend": backend,
                            "producer_workers": workers, "batches": n,
                            "feed_s": feed_s, "digest": h.hexdigest()[:16]})
        log("feed", f"{kind} {backend} producer_workers={workers}: {n} batches in "
            f"{feed_s:.4f} s, digest {h.hexdigest()[:16]}" + (
                f"; C++ threads {per_call} per call x {workers} concurrent calls"
                if backend == "native" else ""))
    log("feed", f"os.cpu_count() {out['cpu_count']}, default_threads() "
        f"{out['native_threads']} (GLINT_NATIVE_THREADS "
        f"{os.environ.get('GLINT_NATIVE_THREADS', 'unset')}), native library "
        f"{out['library']} ready in {build_s:.2f} s; a fit adds the producer thread and "
        "the consumer to the feed's threads")
    bad = [kind for kind, d in digests.items() if len(d) != 1]
    if bad:
        raise AssertionError(f"feed streams differ across backends or worker counts: "
                             f"{bad}")
    return out


BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16",
        "logits_dtype": "bfloat16"}
# V=200,000 in bf16 with the TPU bench's batch, pool, dispatch and subsample (bench.py:55,
# 423-427: B=65536, pool 512, 32 steps a dispatch, 1e-4) and the device pair generator,
# on a corpus of the end-to-end bench's Zipf shape (counts ~ 1/(rank + 10)^1.05). Not
# the end-to-end bench's own fit: that draws 4M tokens over 50,000 words and keeps those
# of min_count 5 (bench.py:395-405); V=200,000 is the step bench's vocabulary.
BENCH_V, BENCH_TOKENS, BENCH_SHIFT, BENCH_POWER = 200_000, 4_500_000, 10.0, 1.05
BENCH_KNOBS = {"pairs_per_batch": 65536, "negative_pool": 512, "steps_per_dispatch": 32,
               "subsample_ratio": 1e-4, "device_pairgen": True, **BF16}
HOT_ROWS = 4096  # tools/eval_quality.py's default
FITS = (  # (name, config knobs, pool the trainer must resolve)
    ("shared", {}, 256),
    ("per_pair", {"negative_pool": 0}, 0),
    ("cbow", {"cbow": True}, 256),
    ("cbow_per_example", {"cbow": True, "negative_pool": 0}, 0),
    ("shared_devpairs", {"device_pairgen": True}, 256),
    ("cbow_banded", {"cbow": True, "cbow_update": "banded"}, 256),
    ("shared_stab", STAB, 256),
    ("shared_bf16_fused_chain", {**BF16, "fused_logits": True, "bf16_chain": True}, 256),
    ("shared_hot", {"hot_rows": HOT_ROWS}, 256),
    ("per_pair_hot", {"negative_pool": 0, "hot_rows": HOT_ROWS}, 0),
    ("cbow_banded_bf16", {"cbow": True, "cbow_update": "banded", **BF16}, 256),
)
BENCH_FIT = ("v200k_bench_batch_bf16_devpairs", BENCH_KNOBS, 512)
# host-fed fits whose steps and pairs are held to a numpy replay of the feed
HOST_REPLAY = ("shared_bf16_fused_chain", "shared_hot", "per_pair_hot")
DROP_LIMIT = 0.02  # the device feed's overflow drops, as a share of pairs trained
FIT_WALL = {}  # fit name -> wall seconds (setup included), for the runtime phase
GRAPHS = {}  # fit name -> its graphs, dispatch and idle share (and its eager control)
# the runtime phase (10): the fault steps (the round reaching it; 16 steps a chunk),
# the watchdog's threshold, the child's vocabulary
INJECT_STEP = 40
NORM_THRESHOLD = 100.0
CHILD_V = 200_000


def pairgen_phase(corpus, seed: int, torch, np) -> dict:
    """The device generator on the card and on the CPU, on the first chunk of the smoke
    corpus's device feed: every output bit-identical."""
    from glint_word2vec_torch import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.ops.pairgen import device_block_pairs
    from glint_word2vec_torch.train.trainer import Trainer

    vocab, sents = corpus
    cfg = Word2VecConfig(vector_size=D_REAL, window=WINDOW, negatives=N_NEG,
                         pairs_per_batch=B, min_count=1, seed=seed, device_pairgen=True)
    tr = Trainer(cfg, vocab, device="cpu")
    chunk = next(iter(tr._token_chunk_stream(encode_sentences(sents, vocab), 1.0, 1.0)))
    keep = tr._keep_prob_dev

    def run(dev, presubsampled=True):
        a = {k: torch.from_numpy(v).to(dev).long() for k, v in chunk["arrays"].items()}
        return lambda: device_block_pairs(
            a["tokens"], a["starts"], a["nvalid"], a["obase"][:, 0], a["obase"][:, 1],
            keep.to(dev), chunk["sub_base"], chunk["win_base"], WINDOW, B,
            presubsampled=presubsampled)

    bad = []
    for presubsampled in (True, False):  # the trainer's mode, then the subsampling one
        got = run("cuda", presubsampled)()
        want = run("cpu", presubsampled)()
        bad += [f"{name} (presubsampled={presubsampled})"
                for name, x, y in zip(got._fields, got, want)
                if not torch.equal(x.cpu(), y)]
        if presubsampled:
            on_cpu = want
    card_ms = time_steps(run("cuda"), TIMED_STEPS, torch)
    t0 = time.perf_counter()
    run("cpu")()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    pairs = int(on_cpu.mask.sum())
    log("pairgen", f"first chunk: {chunk['real']} blocks of {tr._tokens_per_step} token "
        f"slots, {pairs} pairs ({pairs / (chunk['real'] * B):.4f} of the slots), "
        f"{int(on_cpu.dropped_pairs.sum())} dropped; card vs CPU, every output of both "
        f"modes identical: {not bad} {bad}; one batched call {card_ms:.4f} ms on the "
        f"card (events, median of {TIMED_STEPS}), {cpu_ms:.1f} ms on the CPU")
    if bad or pairs == 0:
        raise AssertionError(f"the device generator differs between card and CPU: {bad}")
    return {"blocks": chunk["real"], "tokens_per_step": tr._tokens_per_step,
            "pairs": pairs, "card_ms": card_ms}


def replay_device_feed(tr, sents, np) -> tuple:
    """(trained, dropped) of the device feed's stream replayed on the host: the
    corpus in the shuffled order, subsampled by the hashrng draws on raw ordinals, the
    kept stream cut every tokens_per_step tokens, and each block expanded by the host
    pair generator (``_block_pairs``, keep 1, windows keyed by kept ordinals), of which
    a step trains the first B pairs."""
    from glint_word2vec_torch.data.hashrng import STREAM_SUBSAMPLE, hash_u01_at, stream_base
    from glint_word2vec_torch.data.pipeline import (
        _block_pairs, encode_sentences, keep_probabilities, stream_rng)

    cfg, vocab, T = tr.config, tr.vocab, tr._tokens_per_step
    encoded = encode_sentences(sents, vocab)
    keep = keep_probabilities(vocab.counts, vocab.train_words_count,
                              cfg.subsample_ratio).astype(np.float32)
    ones = np.ones(vocab.size, np.float32)
    trained = dropped = 0
    for it in range(1, cfg.num_iterations + 1):
        order = np.arange(len(encoded))
        stream_rng(cfg.seed, it, 0).shuffle(order)
        flat = np.concatenate([encoded[i] for i in order])
        sid = np.repeat(np.arange(len(order)), [encoded[i].shape[0] for i in order])
        u = hash_u01_at(stream_base(cfg.seed, STREAM_SUBSAMPLE, it, 0),
                        np.arange(flat.shape[0], dtype=np.uint64))
        m = u <= keep[flat]
        tokens, sid = flat[m], sid[m]
        starts = np.ones(tokens.shape[0], bool)
        starts[1:] = sid[1:] != sid[:-1]
        for i in range(0, tokens.shape[0], T):
            st = starts[i:i + T].copy()
            st[0] = True
            lens = np.diff(np.append(np.flatnonzero(st), st.shape[0]))
            n = _block_pairs(tokens[i:i + T], lens, ones, cfg.window, cfg.seed, it, 0, i,
                             True)[0].shape[0]
            trained += min(n, cfg.pairs_per_batch)
            dropped += max(n - cfg.pairs_per_batch, 0)
    return trained, dropped


def replay_banded_feed(tr, sents, np) -> tuple:
    """(steps, examples) of the banded feed's stream replayed on the host: the corpus
    in the shuffled order, subsampled by the hashrng draws on raw ordinals, the kept
    stream cut by the halo packer (its blocks are the steps), and every kept token's
    window drawn by the host feed on the whole kept stream (keep 1, kept ordinals): a
    token with a context is an example."""
    from glint_word2vec_torch.data.hashrng import STREAM_SUBSAMPLE, hash_u01_at, stream_base
    from glint_word2vec_torch.data.pipeline import (
        _subsample_and_window, encode_sentences, keep_probabilities,
        pack_halo_token_blocks, stream_rng)

    cfg, vocab = tr.config, tr.vocab
    encoded = encode_sentences(sents, vocab)
    keep = keep_probabilities(vocab.counts, vocab.train_words_count,
                              cfg.subsample_ratio).astype(np.float32)
    ones = np.ones(vocab.size, np.float32)
    steps = examples = 0
    for it in range(1, cfg.num_iterations + 1):
        order = np.arange(len(encoded))
        stream_rng(cfg.seed, it, 0).shuffle(order)
        flat = np.concatenate([encoded[i] for i in order])
        sid = np.repeat(np.arange(len(order)), [encoded[i].shape[0] for i in order])
        u = hash_u01_at(stream_base(cfg.seed, STREAM_SUBSAMPLE, it, 0),
                        np.arange(flat.shape[0], dtype=np.uint64))
        m = u <= keep[flat]
        tokens, sid = flat[m], sid[m]
        starts = np.ones(tokens.shape[0], bool)
        starts[1:] = sid[1:] != sid[:-1]
        steps += sum(1 for _ in pack_halo_token_blocks(
            [(tokens, starts)], tr._tokens_per_step, cfg.window))
        lens = np.diff(np.append(np.flatnonzero(starts), tokens.shape[0]))
        total = _subsample_and_window(tokens, lens, ones, cfg.window, cfg.seed, it, 0, 0,
                                      True)[2]
        examples += int((total > 0).sum())
    return steps, examples


def replay_host_feed(tr, sents, np) -> tuple:
    """(steps, pairs) of the host skip-gram feed replayed by the numpy generator: one
    batch a step, its real pairs."""
    from glint_word2vec_torch.data.pipeline import encode_sentences, epoch_batches

    cfg = tr.config
    encoded = encode_sentences(sents, tr.vocab)
    steps = pairs = 0
    for it in range(1, cfg.num_iterations + 1):
        for b in epoch_batches(encoded, tr.vocab, pairs_per_batch=cfg.pairs_per_batch,
                               window=cfg.window, subsample_ratio=cfg.subsample_ratio,
                               seed=cfg.seed, iteration=it, shuffle=cfg.shuffle,
                               backend="numpy"):
            steps += 1
            pairs += int(b.num_real_pairs)
    return steps, pairs


def reset_counts(fused, scat) -> None:
    fused.fused_sgns_shared_step.launches = 0
    fused.fused_sgns_shared_step.bf16_launches = 0
    scat.scatter_add_rows_.launches = 0
    scat.scatter_add_rows_.bf16_launches = 0


def profiled(fn, torch):
    """``fn()`` under torch.profiler, the card's activity only (the host ops' events
    would cost seconds a fit). Returns its result, the seconds in which a kernel ran on
    the card (stepprof.kernel_busy_s: the union of the kernels' intervals) and the
    seconds the trace took to collect and read after ``fn``."""
    from glint_word2vec_torch.stepprof import kernel_busy_s

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    busy = kernel_busy_s(prof)
    return out, busy, time.perf_counter() - t0


START = {}  # (padded vocabulary, width, seed) -> a trainer's initial parameters
ENCODED = {}  # id of a corpus -> (its encoded sentences, a held batch for the loss)


def start_params(tr, torch):
    """The parameters a trainer of ``tr``'s geometry and seed starts from, drawn as
    ``Trainer`` draws them (``init_embeddings`` from the config's seed), float32 on
    the card and unpadded in width; a bf16 trainer rounds them as it places them."""
    from glint_word2vec_torch.ops.sgns import EmbeddingPair, init_embeddings

    cfg = tr.config
    key = (tr.padded_vocab, cfg.vector_size, cfg.seed)
    if key not in START:
        gen = torch.Generator().manual_seed(cfg.seed & 0xFFFFFFFFFFFFFFFF)
        START[key] = EmbeddingPair(*(m.cuda() for m in init_embeddings(
            tr.padded_vocab, cfg.vector_size, gen)))
    return START[key]


def encoded_corpus(tr, corpus, torch, np) -> tuple:
    """The corpus encoded as the estimator encodes it, and a held batch: the host
    feed's first batch of skip-gram pairs (centers, contexts, mask) with N_NEG
    negatives a pair drawn from the unigram^0.75 distribution, on the card."""
    from glint_word2vec_torch.data.pipeline import encode_sentences, epoch_batches

    if id(corpus) not in ENCODED:
        vocab, sents = corpus
        cfg = tr.config
        enc = encode_sentences(sents, vocab, cfg.max_sentence_length)
        b = next(iter(epoch_batches(enc, vocab, pairs_per_batch=B, window=cfg.window,
                                    subsample_ratio=cfg.subsample_ratio, seed=cfg.seed,
                                    backend="numpy")))
        probs = torch.from_numpy(vocab.counts.astype(np.float64) ** 0.75).cuda()
        gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
        neg = torch.multinomial(probs, B * N_NEG, replacement=True,
                                generator=gen).view(B, N_NEG)
        held = tuple(torch.from_numpy(a).cuda() for a in (
            b.centers.astype(np.int64), b.contexts.astype(np.int64), b.mask)) + (neg,)
        ENCODED[id(corpus)] = (enc, held)
    return ENCODED[id(corpus)]


def held_loss(syn0, syn1, held, torch) -> float:
    """The skip-gram loss of (syn0, syn1) on the held batch, per live pair:
    softplus(-e.p) plus the negatives' softplus(e.z), summed in float32."""
    c, x, m, neg = held
    e = syn0[c].float()
    pos = (e * syn1[x].float()).sum(-1)
    negl = torch.einsum("bd,bkd->bk", e, syn1[neg].float())
    per = torch.nn.functional.softplus(-pos) + torch.nn.functional.softplus(negl).sum(-1)
    return float((per * m).sum() / m.sum())


def steps_run(tr) -> int:
    """The steps the card ran in the trainer's last fit: K a replay and K a capture's
    warm-up (a short chunk padded) through graphs; the real steps on the eager path."""
    if tr.graph_replays:
        return tr.config.steps_per_dispatch * (tr.graph_replays + tr.graph_captures)
    return tr.global_step


def control_fit(name: str, tr, start, encoded, torch) -> dict:
    """The fit again from the same parameters (``start``: ``start_params``) and
    encoded corpus on the eager path (``_eager_chunks``), the trainer's one switch off
    the graphs, held to the graph fit: f32 parameters within PARAM_ATOL and heartbeat
    losses within LOSS_RTOL; bf16 ones by ops/bf16_check's limits on the parameter
    deltas (at most 2% of the touched elements differ, 0.2% by more than one bf16 ulp)
    and its LOSS_RTOL. Not profiled: its ``fit_time`` is a plain wall."""
    from glint_word2vec_torch.ops import bf16_check
    from glint_word2vec_torch.train.trainer import Trainer

    ctl = Trainer(tr.config, tr.vocab, params=start, device="cuda",
                  feed_backend=tr.feed_backend)
    ctl._eager_chunks = True
    placed = [m.clone() for m in ctl.params]
    ctl.fit(encoded)
    bf16 = tr.params.syn0.dtype == torch.bfloat16
    if bf16:
        agree = [bf16_check.update_agreement(g.float() - s.float(), e.float() - s.float(),
                                             bf16_check.bf16_ulp(e))
                 for g, e, s in zip(tr.params, ctl.params, placed)]
        params_ok = all(bf16_check.passes(a) for a in agree)
        err = {"syn0": agree[0], "syn1": agree[1]}
    else:
        err = max(float((g - e).abs().max()) for g, e in zip(tr.params, ctl.params))
        params_ok = err <= PARAM_ATOL
    rtol = bf16_check.LOSS_RTOL if bf16 else LOSS_RTOL
    lg, le = [h.loss for h in tr.heartbeats], [h.loss for h in ctl.heartbeats]
    losses_ok = len(lg) == len(le) and all(
        math.isclose(a, b, rel_tol=rtol) for a, b in zip(lg, le))
    rec = {"fit_time_s": ctl.fit_time, "steps": ctl.global_step,
           "dispatch_s": ctl.dispatch_time, "host_wait_s": ctl.host_wait_time,
           "agreement": err,
           "loss_max_rel": max((abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lg, le)),
                               default=0.0)}
    log("fit", f"{name}: eager control from the same parameters: steps "
        f"{ctl.global_step}, Trainer.fit {ctl.fit_time:.3f} s (not profiled), "
        f"dispatch_s {ctl.dispatch_time:.4f}, host_wait_s {ctl.host_wait_time:.4f}; "
        "graph fit against it: "
        + (f"bf16 deltas {err}" if bf16 else f"max abs err {err:.3e} (limit {PARAM_ATOL})")
        + f", heartbeat losses max rel {rec['loss_max_rel']:.2e} (limit {rtol})")
    if not (params_ok and losses_ok and ctl.global_step == tr.global_step
            and ctl.graph_replays == 0):
        raise AssertionError(f"fit {name}: the graph fit disagrees with its eager "
                             f"control: params {params_ok}, losses {losses_ok}")
    del ctl, placed
    return rec


def fit_phase(name: str, knobs: dict, pool: int, corpus, seed: int, torch, fused,
              scat, sgns, np, control: bool = True):
    """One fit through the estimator, through the trainer's graphs, under the
    profiler (the card's activity only) for the device's idle share over its
    ``Trainer.fit``; the kernel counts are set to 0 just before it and read just after.
    The fit must have trained: both matrices moved from the parameters it started from
    (``start_params``), and the held batch's loss fell below theirs. Then
    (``control``) its eager control fit. Returns (model, fused launches, scatter
    launches, and those of both in a bf16 form)."""
    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.ops import cbow_banded

    vocab, sents = corpus
    est = Word2Vec(**{**dict(vector_size=D_REAL, window=WINDOW, negatives=N_NEG,
                             pairs_per_batch=B, min_count=1, heartbeat_every_steps=16,
                             seed=seed, device="cuda"), **knobs})
    reset_counts(fused, scat)
    t0 = time.perf_counter()
    model, busy, trace_s = profiled(lambda: est.fit(sents, vocab=vocab), torch)
    wall = time.perf_counter() - t0 - trace_s
    FIT_WALL[name] = wall
    n_fused = fused.fused_sgns_shared_step.launches
    n_scat = scat.scatter_add_rows_.launches
    n_fused_bf16 = fused.fused_sgns_shared_step.bf16_launches
    n_scat_bf16 = scat.scatter_add_rows_.bf16_launches
    tr = est.trainer
    idle = 1.0 - busy / tr.fit_time
    log("fit", f"{name}: graphs: {tr.graph_captures} captures, {tr.graph_replays} "
        f"replays for {tr.chunks_run} chunks of {tr.config.steps_per_dispatch} steps; "
        f"dispatch_s {tr.dispatch_time:.4f} (prologues {tr.prologue_time:.4f}); kernels "
        f"ran {busy:.4f} s of the {tr.fit_time:.4f} s Trainer.fit (torch.profiler on, "
        f"the union of the kernels' intervals; its trace took {trace_s:.2f} s after the "
        f"fit): idle share {idle:.1%}")
    start = start_params(tr, torch)
    encoded, held = encoded_corpus(tr, corpus, torch, np)
    V_ = vocab.size
    s0, s1 = (m[:V_].to(tr.params.syn0.dtype).float() for m in start)
    moved = [float((model.syn0 - s0).abs().max()), float((model.syn1 - s1).abs().max())]
    loss0, loss1 = held_loss(s0, s1, held, torch), held_loss(model.syn0, model.syn1,
                                                             held, torch)
    del s0, s1
    log("fit", f"{name}: trained from its start: largest change syn0 {moved[0]:.3e}, "
        f"syn1 {moved[1]:.3e}; held batch's loss {loss0:.6f} -> {loss1:.6f}")
    hb = list(tr.heartbeats)
    loss = hb[-1].loss if hb else float("nan")
    unit = "examples" if tr.config.cbow else "pairs"
    device_feed = tr.config.device_pairgen
    token_feed = tr.feed_backend == "device"
    log("fit", f"{name}: pool {tr.config.negative_pool}, subsample "
        f"{tr.config.subsample_ratio:g}, feed {tr.feed_backend} (prefetch_chunks "
        f"{tr.config.prefetch_chunks}, producer_workers {tr.config.producer_workers}), "
        f"steps {tr.global_step} "
        f"({-(-tr.global_step // tr.config.steps_per_dispatch)} chunks), {unit} "
        f"{tr.pairs_trained:.0f}, params {tr.config.param_dtype}, compute "
        f"{tr.config.compute_dtype}, logits {tr.config.logits_dtype}, hot_rows "
        f"{tr._hot_rows}, launches: sgns_shared {n_fused} ({n_fused_bf16} bf16), "
        f"scatter_rows {n_scat} ({n_scat_bf16} bf16); "
        f"fit wall {wall:.2f} s (setup included), {unit}/s over the fit "
        f"{tr.pairs_trained / wall:.0f}, host_wait_s {tr.host_wait_time:.4f}, "
        f"dispatch_s {tr.dispatch_time:.4f}, heartbeat {unit}/s "
        f"{[round(h.pairs_per_sec) for h in hb]}, losses {[round(h.loss, 5) for h in hb]}"
        + (f"; tokens_per_step {tr._tokens_per_step}, dropped pairs {tr.dropped_pairs}"
           if token_feed else ""))
    steps = tr.global_step
    ran = steps_run(tr)  # the steps the kernels ran: padded and warm-up steps too
    hot = tr._hot_rows > 0
    fused_path = (tr.config.negative_pool > 0 and not tr.config.cbow and not hot
                  and not tr._stabilizers.enabled and not tr.config.duplicate_scaling)
    banded = tr._banded_cbow
    bf16 = tr.config.param_dtype == "bfloat16"
    # the banded step's third scatter is its endpoint delta (ops/cbow_banded, f32); the
    # hot rows split each scatter in two; the fused kernel on bf16 parameters applies
    # its rows with two bf16 scatters
    per_step = sgns.SCATTERS_PER_STEP * (1 + hot) + (
        banded and cbow_banded.CUDA_ENDPOINT == "scatter")
    scat_want = (sgns.SCATTERS_PER_STEP * bf16 if fused_path else per_step) * ran
    scat_bf16_want = sgns.SCATTERS_PER_STEP * ran * bf16
    want_feed = ("device" if device_feed or banded else "numpy" if tr.config.cbow
                 else "native")
    checks = {f"pool == {pool}": tr.config.negative_pool == pool,
              f"feed_backend == {want_feed}": tr.feed_backend == want_feed,
              "steps >= 4 chunks": steps > 3 * tr.config.steps_per_dispatch,
              "one replay a chunk": tr.graph_replays == tr.chunks_run > 0,
              "params moved": min(moved) > 0.0,
              "held loss fell": loss1 < loss0,
              "captures": 1 <= tr.graph_captures <= 2,
              "sgns_shared launches": n_fused == (ran if fused_path else 0),
              "sgns_shared bf16 launches": n_fused_bf16 == (
                  ran if fused_path and bf16 else 0),
              "scatter_rows launches": n_scat == scat_want,
              "scatter_rows bf16 launches": n_scat_bf16 == scat_bf16_want,
              "param dtype": tr.params.syn0.dtype == getattr(torch, tr.config.param_dtype),
              "loss finite": math.isfinite(loss),
              "params finite": bool(torch.isfinite(model.syn0).all())}
    if knobs.get("max_row_norm"):
        checks["stabilizers on"] = tr._stabilizers == sgns.Stabilizers(**STAB)
    if hot:
        checks[f"hot rows {HOT_ROWS}"] = tr._hot_rows == HOT_ROWS
        checks["slabs flushed"] = not any(bool(t.any()) for t in tr._slabs)
    if name in HOST_REPLAY:
        t0 = time.perf_counter()
        want_steps, pairs = replay_host_feed(tr, sents, np)
        log("fit", f"{name}: numpy replay of the host feed: {want_steps} steps, {pairs} "
            f"pairs ({time.perf_counter() - t0:.1f} s); the fit: {steps} and "
            f"{tr.pairs_trained:.0f}")
        checks.update({"steps == host replay": steps == want_steps,
                       "pairs == host replay": abs(tr.pairs_trained - pairs) < 0.5})
    if banded:
        t0 = time.perf_counter()
        want_steps, examples = replay_banded_feed(tr, sents, np)
        log("fit", f"{name}: host replay of the halo token stream: {want_steps} steps, "
            f"{examples} examples ({time.perf_counter() - t0:.1f} s); the fit: "
            f"{steps} and {tr.pairs_trained:.0f}")
        checks.update({"steps == host replay": steps == want_steps,
                       "examples == host replay": abs(tr.pairs_trained - examples) < 0.5})
    if device_feed:
        t0 = time.perf_counter()
        trained, dropped = replay_device_feed(tr, sents, np)
        log("fit", f"{name}: host replay of the token stream: {trained} pairs trained, "
            f"{dropped} dropped ({time.perf_counter() - t0:.1f} s); the fit: "
            f"{tr.pairs_trained:.0f} and {tr.dropped_pairs}")
        checks.update({
            "pairs_trained == host replay": abs(tr.pairs_trained - trained) < 0.5,
            "dropped == host replay": tr.dropped_pairs == dropped,
            f"dropped < {DROP_LIMIT:.0%}": dropped < DROP_LIMIT * trained})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"fit {name} failed: {bad}")
    GRAPHS[name] = {"captures": tr.graph_captures, "replays": tr.graph_replays,
                    "chunks": tr.chunks_run, "steps": steps, "steps_run": ran,
                    "fit_wall_s": wall, "trainer_fit_s": tr.fit_time,
                    "dispatch_s": tr.dispatch_time, "prologue_s": tr.prologue_time,
                    "host_wait_s": tr.host_wait_time, "kernel_busy_s": busy,
                    "device_idle_share": idle, "trace_s": trace_s,
                    "held_loss": [loss0, loss1]}
    if control:
        GRAPHS[name]["eager_control"] = control_fit(name, tr, start, encoded, torch)
    return model, n_fused, n_scat, n_fused_bf16, n_scat_bf16


def sync_numpy_fit(model, steps: int, corpus, seed: int, torch, fused) -> float:
    """The shared-pool fit again with the producer off (prefetch_chunks=0) and the
    numpy generator: the same steps, parameters within PARAM_ATOL of ``model``'s (the
    kernel's fp32 atomics make the parameters on the card run-dependent). Returns the
    largest parameter difference."""
    from glint_word2vec_torch import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.train.trainer import Trainer

    vocab, sents = corpus
    cfg = Word2VecConfig(vector_size=D_REAL, window=WINDOW, negatives=N_NEG,
                         pairs_per_batch=B, min_count=1, heartbeat_every_steps=16,
                         seed=seed, prefetch_chunks=0)
    tr = Trainer(cfg, vocab, device="cuda", feed_backend="numpy")
    launched = fused.fused_sgns_shared_step.launches
    t0 = time.perf_counter()
    tr.fit(encode_sentences(sents, vocab))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = fused.fused_sgns_shared_step.launches - launched
    p = tr.unpadded_params()
    err = max(float((p.syn0 - model.syn0).abs().max()),
              float((p.syn1 - model.syn1).abs().max()))
    log("fit", f"shared, numpy feed on the calling thread (prefetch_chunks 0): steps "
        f"{tr.global_step} (default feed: {steps}), {tr.graph_replays} replays for "
        f"{tr.chunks_run} chunks, sgns_shared launches {launched}, "
        f"fit wall {wall:.2f} s, host_wait_s {tr.host_wait_time:.4f}, dispatch_s "
        f"{tr.dispatch_time:.4f}; max_abs_err against the default fit's parameters "
        f"{err:.3e} (tolerance {PARAM_ATOL})")
    if not (tr.global_step == steps and launched == steps_run(tr)
            and tr.graph_replays == tr.chunks_run and err <= PARAM_ATOL):
        raise AssertionError("the fit on the calling thread with the numpy feed "
                             "disagrees with the default fit")
    return err


def surface_phase(model, m, sents, torch, np) -> dict:
    """The model surface after fit on the 1M-row model: transform_sentences, pull and
    multiply against float64 on the host (``m``, the model's syn0 in float64); the
    word2vec exports read back; load_latest(reclaim=False) on a directory with
    debris. Returns the timings (seconds)."""
    from glint_word2vec_torch import Word2VecModel
    from glint_word2vec_torch.data.vocab import Vocabulary
    from glint_word2vec_torch.train import checkpoint as ckpt

    out = {}
    vocab = model.vocab
    sample = sents[:30000]
    t0 = time.perf_counter()
    means = model.transform_sentences(sample)
    out["transform_sentences_s"] = time.perf_counter() - t0
    want = np.stack([m[[vocab.get(w) for w in s]].mean(0) for s in sample[:500]])
    err_ts = float(np.abs(means[:500] - want).max())
    rng = np.random.default_rng(1)
    ids = rng.integers(0, vocab.size, 1000)
    f32 = model.syn0.cpu().numpy()
    pull_ok = np.array_equal(model.pull(ids), f32[ids])
    v = rng.normal(0, 1, m.shape[1]).astype(np.float32)
    t0 = time.perf_counter()
    got = model.multiply(v)
    out["multiply_s"] = time.perf_counter() - t0
    want_mv = m @ v.astype(np.float64)
    # recursive f32 summation over D terms
    tol_mv = m.shape[1] * EPS32 * (np.abs(m) @ np.abs(v.astype(np.float64)))
    mv_ok = bool((np.abs(got - want_mv) <= tol_mv + 1e-12).all())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        model.export_word2vec(str(tmp / "full.bin"), binary=True)
        out["export_binary_s"] = time.perf_counter() - t0
        header = f"{vocab.size} {model.vector_size}\n".encode()
        rec = np.asarray([len(w.encode()) + 2 + 4 * model.vector_size
                          for w in vocab.words], np.int64)
        size = (tmp / "full.bin").stat().st_size
        size_ok = size == len(header) + int(rec.sum())
        offs = len(header) + np.concatenate([[0], np.cumsum(rec)[:-1]])
        rows_ok = True
        with open(tmp / "full.bin", "rb") as f:
            for i in rng.integers(0, vocab.size, 64).tolist() + [0, vocab.size - 1]:
                f.seek(int(offs[i]))
                word = vocab.words[i].encode() + b" "
                raw = f.read(int(rec[i]))
                rows_ok &= raw[:len(word)] == word and raw[-1:] == b"\n" and np.array_equal(
                    np.frombuffer(raw[len(word):-1], "<f4"), f32[i])
        n = min(TEXT_ROWS, vocab.size)
        small = Word2VecModel(Vocabulary.from_words_and_counts(
            vocab.words[:n], vocab.counts[:n]), f32[:n], device="cuda")
        t0 = time.perf_counter()
        small.export_word2vec(str(tmp / "small.txt"))
        out["export_text_s"] = time.perf_counter() - t0
        lines = (tmp / "small.txt").read_text().splitlines()
        text_ok = lines[0] == f"{n} {model.vector_size}" and len(lines) == n + 1
        for i in (0, 1, n - 1):
            word, *vals = lines[i + 1].split(" ")
            text_ok &= word == vocab.words[i] and np.array_equal(
                np.asarray(vals, np.float64).astype(np.float32), f32[i])
        ck_dir = tmp / "ckpts"
        for step, name in ((5, "ck"), (9, "ck2.old-7")):
            ckpt.save_model(str(ck_dir / name), small.vocab.words, small.vocab.counts,
                            f32[:n] + step, None, small.config,
                            ckpt.TrainState(global_step=step))
        (ck_dir / ".ck.tmp-3").mkdir()
        before = sorted(p.name for p in ck_dir.iterdir())
        t0 = time.perf_counter()
        latest = Word2VecModel.load_latest(str(ck_dir), device="cuda")
        out["load_latest_20k_s"] = time.perf_counter() - t0
        latest_ok = (sorted(p.name for p in ck_dir.iterdir()) == before
                     and np.array_equal(latest.syn0.cpu().numpy(), f32[:n] + 9))
    log("model", f"transform_sentences of {len(sample)} sentences "
        f"{out['transform_sentences_s']:.3f} s (max |err| vs float64 {err_ts:.2e}); "
        f"pull of 1000 rows exact {pull_ok}; multiply {out['multiply_s'] * 1e3:.1f} ms "
        f"within the f32 summation bound {mv_ok}; binary export of {vocab.size} rows "
        f"{out['export_binary_s']:.2f} s, "
        f"{size} bytes (expected size {size_ok}, 66 rows read back {rows_ok}); text "
        f"export of {n} rows {out['export_text_s']:.2f} s (read back {text_ok}); "
        f"load_latest(reclaim=False) {out['load_latest_20k_s']:.2f} s, the debris's "
        f"predecessor, nothing touched {latest_ok}")
    if not (err_ts <= 1e-6 and pull_ok and mv_ok and size_ok and rows_ok and text_ok
            and latest_ok):
        raise AssertionError("the model surface returned wrong results")
    return out


def model_phase(model, corpus, torch, np) -> dict:
    from glint_word2vec_torch import Word2VecModel
    from glint_word2vec_torch.train.checkpoint import verify_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model")
        t0 = time.perf_counter()
        model.save(path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        verify_checkpoint(path)
        back = Word2VecModel.load(path, device="cuda")
        t_load = time.perf_counter() - t0
    if not torch.equal(back.syn0, model.syn0):
        raise AssertionError("loaded syn0 differs from the trained one")
    t0 = time.perf_counter()
    syn = back.find_synonyms("w10", 10)
    torch.cuda.synchronize()
    t_syn = time.perf_counter() - t0
    t0 = time.perf_counter()
    ana = back.analogy("w1", "w2", "w3", 5)
    t_ana = time.perf_counter() - t0
    # reference on the host in float64: the best cosine neighbour of w10
    m = back.syn0.double().cpu().numpy()
    q = m[10] / np.linalg.norm(m[10])
    cos = (m @ q) / np.maximum(np.linalg.norm(m, axis=1), 1e-12)
    cos[10] = -np.inf
    best = int(np.argmax(cos))
    log("model", f"save {t_save:.2f} s, verify+load {t_load:.2f} s, find_synonyms "
        f"{t_syn * 1e3:.1f} ms -> {syn[:3]}, analogy {t_ana * 1e3:.1f} ms -> {ana[:2]}; "
        f"float64 reference top-1 w{best} ({cos[best]:.6f})")
    ok = (len(syn) == 10 and all(w != "w10" and math.isfinite(s) for w, s in syn)
          and len(ana) == 5 and abs(syn[0][1] - cos[best]) < 1e-5)
    if not ok:
        raise AssertionError("model ops returned wrong results")
    return {"save_s": t_save, "verify_load_s": t_load, "find_synonyms_s": t_syn,
            **surface_phase(back, m, corpus[1], torch, np)}


def _poll_status(port: int, stop, seen: list) -> None:
    """Poll /status.json and /metrics until ``stop``: (codes, global_step, status)."""
    import urllib.request

    while not stop.is_set():
        try:
            got = []
            for route in ("/status.json", "/metrics"):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                            timeout=5) as r:
                    got.append((r.status, r.read().decode()))
            snap = json.loads(got[0][1])
            seen.append((got[0][0], got[1][0], snap["global_step"], snap["status"],
                         "glint_global_step" in got[1][1]))
        except OSError:
            pass
        time.sleep(0.02)


def probe_oracle(m, vocab_size: int, threshold: float, np, rows: int = 100_000) -> dict:
    """The probe's channels of one matrix in float64 NumPy, on the host, in row blocks:
    max, mean, rows over the threshold, the p99 bucket, and the distance of the
    norms within 1e-6 relative of the threshold and of a bucket edge (the clamped
    norms below 2^-12, zero rows among them, sit in bucket 0 exactly), for the tie
    rule."""
    norms = np.concatenate([
        np.sqrt((m[i:i + rows].double().cpu().numpy() ** 2).sum(1))
        for i in range(0, vocab_size, rows)])[:vocab_size]
    pos = (np.log2(np.maximum(norms, 2.0 ** -12)) + 12) * 4
    idx = np.clip(np.floor(pos), 0, 127).astype(np.int64)
    k = int(np.argmax(np.cumsum(np.bincount(idx, minlength=128)) >= -(-vocab_size * 99 // 100)))
    return {"max_norm": float(norms.max()), "mean_norm": float(norms.mean()),
            "over": int((norms > threshold).sum()), "bucket": k,
            "finite": bool(np.isfinite(norms).all()),
            "near_threshold": int((np.abs(norms / threshold - 1) < 1e-6).sum()),
            "near_edge": int(((np.abs(pos - np.round(pos)) < 4e-6 / np.log(2))
                              & (norms > 2.0 ** -12)).sum())}


def _hold_channels(ch: dict, want: dict, vocab_size: int) -> list:
    """What disagrees between a heartbeat's channels of one matrix and its float64
    oracle: max and mean within 1e-5 relative; frac_over and the p99 bucket equal,
    one row or one bucket allowed only where a norm sits within 1e-6 of the threshold
    or of a bucket edge."""
    bad = []
    for k in ("max_norm", "mean_norm"):
        if not abs(ch[k] - want[k]) <= 1e-5 * abs(want[k]):
            bad.append(f"{k} {ch[k]!r} vs {want[k]!r}")
    over = round(ch["frac_over"] * vocab_size)
    if abs(over - want["over"]) > (1 if want["near_threshold"] else 0):
        bad.append(f"frac_over rows {over} vs {want['over']}")
    bucket = round(math.log2(ch["p99_norm"]) * 4) - 1 + 48  # edge 2^((k+1)/4 - 12)
    if abs(bucket - want["bucket"]) > (1 if want["near_edge"] else 0):
        bad.append(f"p99 bucket {bucket} vs {want['bucket']}")
    return bad


def _records(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from glint_word2vec_torch import Vocabulary, Word2Vec
vocab_size, out = int(sys.argv[2]), sys.argv[3]
rng = np.random.default_rng(int(sys.argv[4]))
counts = (1e9 / (np.arange(vocab_size) + 1.0)).astype(np.int64) + 1
words = [f"w{i}" for i in range(vocab_size)]
ids = rng.choice(vocab_size, size=750_000, p=counts / counts.sum())
toks = [words[i] for i in ids]
sents = [toks[i:i + 40] for i in range(0, len(toks), 40)]
Word2Vec(vector_size=300, window=5, negatives=5, pairs_per_batch=8192, min_count=1,
         heartbeat_every_steps=16, num_iterations=100, seed=1, device="cuda",
         telemetry_path=out + "/child.jsonl", checkpoint_on_preempt=True).fit(
    sents, vocab=Vocabulary.from_words_and_counts(words, counts),
    checkpoint_path=out + "/ck", checkpoint_every_steps=10_000)
print("FIT FINISHED: the SIGTERM did not land", flush=True)
"""


def preempt_child(tmp: str, seed: int, np) -> dict:
    """Fit (d): a child process fits at V=CHILD_V with telemetry and
    checkpoint_on_preempt; once its run log holds a heartbeat the parent sends
    SIGTERM. The child must die of the signal after an emergency checkpoint that
    load_latest_valid and verify_checkpoint accept, a preempt record, run_end
    "preempted", and a blackbox dump that validates."""
    import signal

    from glint_word2vec_torch.obs.schema import validate_blackbox_file, validate_file
    from glint_word2vec_torch.train.checkpoint import (
        load_latest_valid, load_model, verify_checkpoint)

    out = os.path.join(tmp, "child")
    os.makedirs(out)
    log_path = os.path.join(out, "child.jsonl")
    repo = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "child.out"), "w") as sink:
        child = subprocess.Popen([sys.executable, "-c", CHILD, repo, str(CHILD_V), out,
                                  str(seed)], stdout=sink, stderr=subprocess.STDOUT)
        try:
            while child.poll() is None and time.perf_counter() - t0 < 300:
                if os.path.exists(log_path) and any(
                        r["kind"] == "heartbeat" for r in _records(log_path)):
                    break
                time.sleep(0.05)
            t_term = time.perf_counter() - t0
            child.send_signal(signal.SIGTERM)
            rc = child.wait(timeout=300)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    tail = open(os.path.join(tmp, "child.out")).read()[-2000:]
    recs = _records(log_path) if os.path.exists(log_path) else []
    pre = [r for r in recs if r["kind"] == "preempt"]
    ends = [r["status"] for r in recs if r["kind"] == "run_end"]
    checks = {"rc == -SIGTERM": rc == -signal.SIGTERM,
              "one preempt record, saved": len(pre) == 1 and pre[0]["saved"],
              "run_end preempted": ends == ["preempted"],
              "run log validates": bool(recs) and validate_file(log_path)["ok"],
              "blackbox validates": validate_blackbox_file(
                  log_path + ".blackbox.json")["ok"]}
    ck = load_latest_valid(out) if checks["one preempt record, saved"] else ""
    if ck:
        verify_checkpoint(ck)
        state = load_model(ck, verify=False)["train_state"]
        checks["checkpoint at the preempt step"] = (
            state.global_step == pre[0]["step"] and not state.finished)
    bad = [k for k, ok in checks.items() if not ok]
    log("runtime", f"(d) child at V={CHILD_V}: SIGTERM {t_term:.1f} s after its start, "
        f"rc {rc}, preempt {pre}, run_end {ends}, checkpoint {ck!r}; checks {checks}")
    if bad:
        raise AssertionError(f"runtime (d) failed: {bad}; child output: {tail}")
    return {"rc": rc, "preempt": pre[0], "sigterm_after_s": t_term}


def runtime_phase(corpus, seed: int, torch, np, fused, scat, profile_call) -> tuple:
    """Phase 10: the runtime layer on the main path at V=1M, four fits (see the module
    docstring); returns (record, launches by fit)."""
    import tempfile
    import threading

    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.obs.probe import health_stats, probe_tensor
    from glint_word2vec_torch.obs.schema import validate_file
    from glint_word2vec_torch.stepprof import free_port
    from glint_word2vec_torch.train import faults
    from glint_word2vec_torch.train.trainer import Trainer

    vocab, sents = corpus
    base = dict(vector_size=D_REAL, window=WINDOW, negatives=N_NEG, pairs_per_batch=B,
                min_count=1, heartbeat_every_steps=16, seed=seed, device="cuda")
    rec, launches, graphs = {}, {}, {}
    restores, probed = [], {}
    real_restore, real_probe = Trainer._restore_snapshot, Trainer._health_stats

    def restore(self):  # the kernels' counts at the rollback or the recovery
        restores.append((fused.fused_sgns_shared_step.launches,
                         scat.scatter_add_rows_.launches, self.global_step))
        return real_restore(self)

    def probe(self):  # the parameters each probe read (the last one is held below)
        ch = real_probe(self)
        for name, m in zip(("syn0", "syn1"), self.params):
            if name not in probed:
                probed[name] = torch.empty_like(m)
            probed[name].copy_(m)
        return ch

    def fit(name, knobs, plan=None):
        faults.reset()
        if plan:
            faults.configure(**plan)
        est = Word2Vec(**{**base, **knobs})
        reset_counts(fused, scat)
        t0 = time.perf_counter()
        try:
            est.fit(sents, vocab=vocab)
            torch.cuda.synchronize()
        finally:
            faults.reset()
        wall = time.perf_counter() - t0
        launches[name] = {"sgns_shared_step": fused.fused_sgns_shared_step.launches,
                          "scatter_add_rows": scat.scatter_add_rows_.launches,
                          "sgns_shared_step_bf16": 0, "scatter_add_rows_bf16": 0}
        tr = est.trainer
        graphs[name] = {"captures": tr.graph_captures, "replays": tr.graph_replays,
                        "chunks": tr.chunks_run,
                        "captures_at_restore": tr.restore_captures,
                        "dispatch_s": tr.dispatch_time}
        log("runtime", f"{name}: graphs: {tr.graph_captures} captures "
            f"({tr.restore_captures} before the restore), {tr.graph_replays} replays "
            f"for {tr.chunks_run} chunks, dispatch_s {tr.dispatch_time:.4f}")
        return tr, wall

    def recaptured(name) -> bool:
        g = graphs[name]
        return (len(g["captures_at_restore"]) == 1 and g["replays"] == g["chunks"]
                and g["captures"] > g["captures_at_restore"][0] >= 1)

    with tempfile.TemporaryDirectory() as tmp:
        # (a) telemetry, the status endpoint, norm_watch="warn"
        port, stop, seen = free_port(), threading.Event(), []
        log_a = os.path.join(tmp, "a.jsonl")
        poller = threading.Thread(target=_poll_status, args=(port, stop, seen),
                                  daemon=True)
        poller.start()
        Trainer._health_stats = probe
        try:
            tr, wall = fit("runtime_a_telemetry", dict(
                telemetry_path=log_a, status_port=port, norm_watch="warn"))
        finally:
            Trainer._health_stats = real_probe
            stop.set()
            poller.join(timeout=30)
        summary = validate_file(log_a)
        recs = _records(log_a)
        trace = json.load(open(log_a + ".trace.json"))
        last = [r for r in recs if r["kind"] == "heartbeat"][-1]["norms"]
        oracle = {name: probe_oracle(probed[name], vocab.size, NORM_THRESHOLD, np)
                  for name in ("syn0", "syn1")}
        running = [s for s in seen if s[3] == "running"]
        steps = [s[2] for s in running]
        bad = [f"{name}: {b}" for name in ("syn0", "syn1")
               for b in _hold_channels(last[name], oracle[name], vocab.size)]
        checks = {
            "status polled while running, HTTP 200": bool(running) and all(
                s[0] == s[1] == 200 and s[4] for s in running),
            "global_step rose": len(set(steps)) > 1 and steps == sorted(steps),
            "run log validates": summary["ok"],
            "kinds": set(summary["kinds"]) >= {"run_start", "heartbeat", "run_end"},
            "trace loads": len(trace["traceEvents"]) > 0,
            "finite": last["finite"] is True and all(o["finite"] for o in oracle.values()),
            "probe vs float64": not bad,
            "no watchdog firing": tr.norm_watchdog.fires == 0}
        # the probe's and a snapshot's device time at V=1M, beside their byte bounds
        p = tr.params
        nbytes = sum(m.numel() * m.element_size() for m in p)
        slot = [torch.empty_like(m) for m in p]
        calls = {"probe": lambda: probe_tensor(p, vocab.size, NORM_THRESHOLD),
                 "snapshot": lambda: [d.copy_(m) for d, m in zip(slot, p)]}
        probe_rec, snap_rec = ({
            "ms": time_steps(fn, 20, torch), "bytes": k * nbytes,
            "device_ms": sum(v["us_total"] for v in profile_call(fn, 20).values())
            / 20 / 1e3, "bound_ms": k * nbytes / PEAK_BYTES_PER_S * 1e3}
            for fn, k in ((calls["probe"], 1), (calls["snapshot"], 2)))
        del slot, calls
        rec["a"] = {"wall_s": wall, "layer_off_wall_s": FIT_WALL.get("shared"),
                    "steps": tr.global_step, "heartbeats": len(tr.heartbeats),
                    "kinds": summary["kinds"], "polls": len(seen),
                    "spans": recs[-1].get("spans"), "probe": probe_rec,
                    "snapshot": snap_rec, "oracle": oracle, "last_norms": last}
        log("runtime", f"(a) telemetry + status + norm_watch=warn: {tr.global_step} "
            f"steps, fit wall {wall:.3f} s against the layer-off 'shared' fit's "
            f"{FIT_WALL.get('shared', float('nan')):.3f} s (both with set-up; (a) also "
            f"copies the parameters at each probe for the check), {len(seen)} polls "
            f"({len(running)} while running, steps {steps[:1]}..{steps[-1:]}), log "
            f"{summary['kinds']}, {len(trace['traceEvents'])} trace events, spans "
            f"{recs[-1].get('spans')}")
        log("runtime", f"(a) last heartbeat's norms {last}; float64 oracle {oracle}; "
            f"disagreements {bad}")
        log("runtime", f"probe at V={vocab.size}: device {probe_rec['device_ms']:.4f} ms "
            f"(torch.profiler, 20 calls), call {probe_rec['ms']:.4f} ms (events, host "
            f"enqueue included) beside its byte bound {probe_rec['bound_ms']:.4f} ms "
            f"({nbytes / 1e9:.3f} GB read at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
        log("runtime", f"snapshot at V={vocab.size} (copy_ of both matrices): device "
            f"{snap_rec['device_ms']:.4f} ms, call {snap_rec['ms']:.4f} ms beside its byte "
            f"bound {snap_rec['bound_ms']:.4f} ms ({2 * nbytes / 1e9:.3f} GB moved)")
        del tr, p
        if not all(checks.values()):
            raise AssertionError(f"runtime (a) failed: {checks}; {bad}")

        # (b) nonfinite_policy="rollback", NaN injected
        restores.clear()
        Trainer._restore_snapshot = restore
        try:
            tr, wall = fit("runtime_b_rollback", {"nonfinite_policy": "rollback"},
                           {"nan_at_step": INJECT_STEP})
        finally:
            Trainer._restore_snapshot = real_restore
        n = launches["runtime_b_rollback"]["sgns_shared_step"]
        finite = all(bool(torch.isfinite(m).all()) for m in tr.params)
        checks = {"one rollback": tr.rollbacks_performed == 1 and len(restores) == 1,
                  "global_step past 2^22": tr.global_step > 1 << 22,
                  "params finite": finite,
                  "recaptured after the rollback": recaptured("runtime_b_rollback"),
                  "fused before and after": bool(restores) and 0 < restores[0][0] < n}
        rec["b"] = {"wall_s": wall, "steps": tr.global_step,
                    "fused_before": restores[0][0] if restores else None,
                    "fused_after": n - restores[0][0] if restores else None}
        log("runtime", f"(b) rollback: NaN at the round reaching step {INJECT_STEP}, "
            f"rollbacks {tr.rollbacks_performed}, final global_step {tr.global_step}, "
            f"sgns_shared launches {rec['b']['fused_before']} before the rollback and "
            f"{rec['b']['fused_after']} after, params finite {finite}, wall {wall:.3f} s")
        del tr
        if not all(checks.values()):
            raise AssertionError(f"runtime (b) failed: {checks}")

        # (c) norm_watch="recover", a finite blowup injected
        restores.clear()
        log_c = os.path.join(tmp, "c.jsonl")
        Trainer._restore_snapshot = restore
        try:
            tr, wall = fit("runtime_c_recover", {"norm_watch": "recover",
                                                 "telemetry_path": log_c},
                           {"scale_params_at_step": INJECT_STEP})
        finally:
            Trainer._restore_snapshot = real_restore
        nf = launches["runtime_c_recover"]["sgns_shared_step"]
        ns = launches["runtime_c_recover"]["scatter_add_rows"]
        recovery = [r for r in _records(log_c) if r["kind"] == "recovery"]
        final = health_stats(tr.params, vocab.size, NORM_THRESHOLD)
        top = max(final.syn0.max_norm, final.syn1.max_norm)
        fb, sb = restores[0][:2] if restores else (None, None)
        checks = {"one recovery record": len(recovery) == 1
                  and recovery[0]["action"] == "rollback",
                  "lr_scale 0.5": tr._lr_scale == 0.5,
                  "recaptured after the recovery": recaptured("runtime_c_recover"),
                  "max_row_norm engaged": tr._stabilizers.max_row_norm == NORM_THRESHOLD,
                  "fused before, none after": bool(restores) and fb > 0 and nf == fb,
                  "scatter after, none before": sb == 0 and ns > 0,
                  "log validates": validate_file(log_c)["ok"],
                  "finite, below the threshold": final.finite
                  and top <= NORM_THRESHOLD * (1 + 1e-5)}
        rec["c"] = {"wall_s": wall, "steps": tr.global_step, "fused_before": fb,
                    "fused_after": nf - (fb or 0), "scatter_before": sb,
                    "scatter_after": ns - (sb or 0), "final_max_norm": top,
                    "recovery": recovery}
        log("runtime", f"(c) recover: blowup x1e6 at the round reaching step "
            f"{INJECT_STEP}, recoveries {tr.recoveries_performed}, lr_scale "
            f"{tr._lr_scale}, max_row_norm {tr._stabilizers.max_row_norm}, launches: "
            f"sgns_shared {fb} before the recovery and {nf - (fb or 0)} after, "
            f"scatter_rows {sb} before and {ns - (sb or 0)} after; final max row norm "
            f"{top:.4f}, finite {final.finite}, wall {wall:.3f} s")
        del tr
        if not all(checks.values()):
            raise AssertionError(f"runtime (c) failed: {checks}")

        # (d) SIGTERM to a child process under checkpoint_on_preempt
        rec["d"] = preempt_child(tmp, seed, np)
    rec["graphs"] = graphs
    return rec, launches


# the serving phase (11): clients, query words, the float64 oracle's queries, the
# reload's limit, servebench's vocabulary, ties
SERVE_CLIENTS = 8
SERVE_STORM_S = 2.0
SERVE_WORDS = 256
SERVE_ORACLE = 32
SERVE_TIE = 1e-6  # scores within this are a tie at f32's resolution
SERVE_F64_ATOL = 1e-5  # f32 cosines against float64's (as phase 9's top-1)
RELOAD_LIMIT_S = 5.0
# the IVF arm's served overlap with the card's exact lists against the index's recall
# on the same rows: they differ only where the card's and the host's exact top-10 break
# a near-tie differently
SERVE_OVERLAP_TOL = 0.01
# the second fit's io_workers: threads reading and hashing its V=1M checkpoint (2.4 GB
# of syn0 and syn1, one matrix a thread, each streamed to the card as it is hashed) at
# the reload, through the saved config
SERVE_IO_WORKERS = 4
# servebench's matrix: V=1M fails PQ's 0.95 recall floor (0.38 at 512 clusters of
# ~2,000 rows, wider than the re-rank shortlist) and its builds take ~70 s
SERVE_BENCH_V = 200_000


def lists_agree(got, want, tie: float, atol: float = None) -> bool:
    """Two top-k lists of (word, score) agree: scores within ``atol`` (default
    ``tie``) position by position, and words equal except where the wanted score ties
    (within ``tie``) with a neighbour's or sits at the list's end (a tie with the next
    row)."""
    atol = tie if atol is None else atol
    if len(got) != len(want):
        return False
    for i, ((wg, sg), (ww, sw)) in enumerate(zip(got, want)):
        if abs(sg - sw) > atol:
            return False
        if wg != ww and i != len(want) - 1 and not any(
                abs(sw - want[j][1]) <= tie for j in (i - 1, i + 1)
                if 0 <= j < len(want)):
            return False
    return True


def f64_topk(m, rows, num: int, np) -> list:
    """The float64 oracle: for each query row, the ``num`` best cosine neighbours of
    ``m`` (float64, on the host), the query itself excluded."""
    norms = np.linalg.norm(m, axis=1)
    out = []
    for r in rows:
        cos = (m @ m[r]) / np.maximum(norms, 1e-300) / max(norms[r], 1e-300)
        cos[r] = -np.inf
        top = np.argpartition(-cos, num)[:num]
        top = top[np.lexsort((top, -cos[top]))]
        out.append([(int(i), float(cos[i])) for i in top])
    return out


def storm(svc, words, seconds: float, clients: int, np, until=None) -> tuple:
    """``clients`` threads query ``svc.synonyms`` back to back for ``seconds``, or
    until the event ``until`` is set: (every (word, list) served, errors, latencies in
    ms)."""
    import threading

    served = [[] for _ in range(clients)]
    errors, lats = [], [[] for _ in range(clients)]
    stop_at = time.monotonic() + seconds

    def client(ci: int) -> None:
        rng = np.random.default_rng(ci)
        while (not until.is_set()) if until is not None else time.monotonic() < stop_at:
            w = words[int(rng.integers(0, len(words)))]
            t0 = time.monotonic()
            try:
                res = svc.synonyms(w, 10)
            except Exception as e:  # noqa: BLE001 — counted, the phase fails on any
                errors.append(repr(e))
                continue
            lats[ci].append((time.monotonic() - t0) * 1e3)
            served[ci].append((w, res))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return ([x for s in served for x in s], errors,
            sorted(x for per in lats for x in per))


def pctl(lats, p: float) -> float:
    return lats[min(len(lats) - 1, int(p * len(lats)))] if lats else float("nan")


def serving_phase(ck: str, corpus, seed: int, torch, np, fused, scat,
                  device: str = "cuda", bench_vocab: int = SERVE_BENCH_V) -> tuple:
    """Phase 11: the serving path (see the module docstring): (a) the exact arm under
    concurrent clients and a hot reload, (b) the IVF arm on the same checkpoint, (c)
    servebench, (d) the JSON-lines CLI as a child process. Returns (record, launches
    of the second fit)."""
    import threading
    import urllib.request

    from glint_word2vec_torch import Word2VecModel
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.obs.schema import validate_file
    from glint_word2vec_torch.serve import EmbeddingService
    from glint_word2vec_torch.serve.reload import publish_signature
    from glint_word2vec_torch.stepprof import free_port, profile_call
    from glint_word2vec_torch.train import checkpoint as ckpt
    from glint_word2vec_torch.train.trainer import Trainer

    vocab, sents = corpus
    rec = {"card": card_line() if device == "cuda" else "cpu"}
    log("serve", f"on {rec['card']}: V={vocab.size}, the shared fit's checkpoint")
    rng = np.random.default_rng(seed + 11)
    words = [vocab.words[i] for i in rng.choice(vocab.size, SERVE_WORDS, replace=False)]

    def reference(path: str, f64: bool = False) -> tuple:
        """The card model's lists for ``words`` (and its syn0 in float64 on the host)."""
        t0 = time.perf_counter()
        ref = Word2VecModel.load(path, device=device)
        out = {w: ref.find_synonyms(w, 10) for w in words}
        m64 = ref.syn0.double().cpu().numpy() if f64 else None
        ref.stop()
        log("serve", f"reference: Word2VecModel.load + {len(words)} find_synonyms on "
            f"{device} in {time.perf_counter() - t0:.1f} s")
        return out, m64

    # (a) the exact arm, concurrent clients, a hot reload
    ref_a, m64 = reference(ck, f64=True)
    oracle = f64_topk(m64, [vocab.get(w) for w in words[:SERVE_ORACLE]], 10, np)
    del m64
    log_path = str(Path(ck).parent / "serve.jsonl")
    port = free_port()
    t0 = time.perf_counter()
    svc = EmbeddingService(checkpoint=ck, ann=False, watch=True, reload_poll_s=0.05,
                           status_port=port, telemetry_path=log_path, device=device)
    boot_s = time.perf_counter() - t0
    try:
        served, errors, lats = storm(svc, words, SERVE_STORM_S, SERVE_CLIENTS, np)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            metrics = r.read().decode()
        st1 = svc.stats()
        bad = [w for w, res in served if not lists_agree(res, ref_a[w], SERVE_TIE)]
        # the card's exact lists against float64: ids with ties, scores to f32's error
        oracle_ok = all(lists_agree(ref_a[q], [(vocab.words[i], s) for i, s in o],
                                    SERVE_TIE, SERVE_F64_ATOL)
                        for q, o in zip(words, oracle))
        f64_err = max(abs(s - so) for q, o in zip(words, oracle)
                      for (_, s), (_, so) in zip(ref_a[q], o))
        rec["exact"] = {"boot_s": boot_s, "queries": len(served), "errors": len(errors),
                        "qps": len(served) / SERVE_STORM_S, "p50_ms": pctl(lats, 0.5),
                        "p99_ms": pctl(lats, 0.99), "batches": st1["batches"],
                        "submitted": st1["submitted"],
                        "occupancy_mean": st1["occupancy_mean"],
                        "max_abs_err_vs_f64": f64_err}
        log("serve", f"(a) exact arm on {device}: boot {boot_s:.1f} s; {SERVE_CLIENTS} "
            f"clients {SERVE_STORM_S} s: {len(served)} queries, {len(errors)} errors, "
            f"{len(served) / SERVE_STORM_S:.0f} qps, p50 {pctl(lats, 0.5):.3f} ms, p99 "
            f"{pctl(lats, 0.99):.3f} ms, {st1['batches']} batches for "
            f"{st1['submitted']} submitted (occupancy {st1['occupancy_mean']}); "
            f"{len(bad)} lists differ from Word2VecModel.load(ck).find_synonyms; "
            f"{SERVE_ORACLE} against float64: ids {oracle_ok}, max |score err| "
            f"{f64_err:.2e}; /metrics glint_serve_up "
            f"{'glint_serve_up 1' in metrics}")
        if device == "cuda":  # one batch of the exact arm on the card, by kernel
            with svc._handle.lease() as (model, _):
                batch = words[:SERVE_CLIENTS]
                kt = profile_call(lambda: model.find_synonyms_batch(batch, 10), 20)
                t0 = time.perf_counter()
                for _ in range(20):
                    model.find_synonyms_batch(batch, 10)
                wall_ms = (time.perf_counter() - t0) / 20 * 1e3
            dev_us = {k: v["us_total"] / 20 for k, v in kt.items()}
            # the least time: syn0 read once at the card's memory rate
            bound_ms = model.num_words * model.vector_size * 4 / PEAK_BYTES_PER_S * 1e3
            rec["exact"]["batch"] = {"queries": len(batch), "wall_ms": wall_ms,
                                     "device_us": dev_us, "bound_ms": bound_ms}
            log("serve", f"(a) one batch of {len(batch)} exact queries: {wall_ms:.3f} ms "
                f"a call, device {sum(dev_us.values()):.1f} us (syn0's read at "
                f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s: {bound_ms * 1e3:.1f} us): "
                + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                    dev_us.items(), key=lambda kv: -kv[1])[:6]))
        if not (served and not errors and not bad and oracle_ok
                and f64_err <= SERVE_F64_ATOL
                and st1["batches"] < st1["submitted"] and "glint_serve_up 1" in metrics
                and "glint_serve_submitted_total" in metrics):
            raise AssertionError(f"serving (a) failed: errors {errors[:3]}, lists "
                                 f"differing {bad[:3]}, oracle {oracle_ok}")
        # a second fit from the same parameters, saved to the same path while the
        # clients query; its config's io_workers set the save's and the reload's threads
        data = ckpt.load_model(ck, check_ported=False)
        tr = Trainer(dataclasses.replace(data["config"], io_workers=SERVE_IO_WORKERS),
                     vocab, params=(data["syn0"], data["syn1"]), device=device)
        del data
        reset_counts(fused, scat)
        t0 = time.perf_counter()
        tr.fit(encode_sentences(sents, vocab))
        if device == "cuda":
            torch.cuda.synchronize()
        launches = {"sgns_shared_step": fused.fused_sgns_shared_step.launches,
                    "scatter_add_rows": scat.scatter_add_rows_.launches,
                    "sgns_shared_step_bf16": fused.fused_sgns_shared_step.bf16_launches,
                    "scatter_add_rows_bf16": scat.scatter_add_rows_.bf16_launches}
        fit_s = time.perf_counter() - t0
        if launches["sgns_shared_step"] != steps_run(tr):
            raise AssertionError(f"the second fit's launches {launches}")
        released0 = st1["models_released"]
        mem0 = 0
        if device == "cuda":
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        box, done = {}, threading.Event()
        sig0 = publish_signature(ck)

        def publish():  # save after 0.5 s of queries
            time.sleep(0.5)
            box["save_start"] = time.monotonic()
            tr.save_checkpoint(ck)
            box["saved"] = time.monotonic()

        def watch():  # the publish instant (the swap's rename), then the reload's
            try:
                while publish_signature(ck) in (None, sig0):
                    time.sleep(0.001)
                box["published"] = time.monotonic()
                while (svc.stats()["reloads"] < 1
                       and time.monotonic() - box["published"] < 60):
                    time.sleep(0.005)
                box["reloaded"] = time.monotonic()
                time.sleep(1.0)  # the clients query the new model for 1 s
            finally:
                done.set()

        threads = [threading.Thread(target=publish), threading.Thread(target=watch)]
        for t in threads:
            t.start()
        served2, errors2, lats2 = storm(svc, words, 0.0, SERVE_CLIENTS, np, until=done)
        for t in threads:
            t.join()
        swap_peak = (torch.cuda.max_memory_allocated() - mem0 if device == "cuda"
                     else 0)
        st2 = svc.stats()
        ref_b, _ = reference(ck)
        after = svc.synonyms_batch(words, 10)
        bad2 = [w for w, res in served2 if not (lists_agree(res, ref_a[w], SERVE_TIE)
                                                or lists_agree(res, ref_b[w], SERVE_TIE))]
        bad_after = [w for w, res in zip(words, after)
                     if not lists_agree(res, ref_b[w], SERVE_TIE)]
        changed = sum(ref_a[w] != ref_b[w] for w in words)
        reload_s = box["reloaded"] - box["published"]
        rec["reload"] = {"second_fit_s": fit_s, "reload_s": reload_s,
                         "save_s": box["saved"] - box["save_start"],
                         "io_workers": SERVE_IO_WORKERS,
                         "load_seconds": st2["load_seconds"],
                         "queries": len(served2), "errors": len(errors2),
                         "p99_ms": pctl(lats2, 0.99), "reloads": st2["reloads"],
                         "models_released": st2["models_released"] - released0,
                         "swap_peak_bytes": swap_peak, "resident_bytes": mem0,
                         "lists_changed": changed}
        log("serve", f"(a) second fit {fit_s:.1f} s ({launches['sgns_shared_step']} "
            f"fused launches), saved to the same path while {SERVE_CLIENTS} clients "
            f"queried (the save {box['saved'] - box['save_start']:.1f} s): swapped in "
            f"{reload_s:.2f} s after the publish's rename (load_seconds "
            f"{st2['load_seconds']}, {SERVE_IO_WORKERS} io_workers), reloads "
            f"{st2['reloads']}, models_released "
            f"+{st2['models_released'] - released0}; {len(served2)} queries, "
            f"{len(errors2)} errors, p99 {pctl(lats2, 0.99):.3f} ms, {len(bad2)} lists "
            f"neither model's; after it {len(bad_after)} of {len(words)} differ from "
            f"the new model's ({changed} of the {len(words)} words' lists changed "
            f"between the two models); card memory: {mem0 / 1e9:.3f} GB allocated "
            f"before the swap, peak +{swap_peak / 1e9:.3f} GB during it")
        if not (reload_s <= RELOAD_LIMIT_S and not errors2 and not bad2
                and not bad_after and st2["reloads"] == 1
                and st2["models_released"] - released0 == 1 and changed > 0):
            raise AssertionError(f"serving (a) reload failed: {rec['reload']}, "
                                 f"errors {errors2[:3]}")
    finally:
        svc.close()
    summary = validate_file(log_path)
    kinds = summary["kinds"]
    if not (summary["ok"] and kinds.get("serve_start") == 1
            and kinds.get("serve_reload") == 1 and kinds.get("serve_end") == 1):
        raise AssertionError(f"serve telemetry: {summary}")

    # (b) the IVF arm (f32) on the same checkpoint
    t0 = time.perf_counter()
    svc = EmbeddingService(checkpoint=ck, ann=True, ann_quant="f32", device=device)
    boot_s = time.perf_counter() - t0
    try:
        stats = svc.info()["ann"]
        served3, errors3, lats3 = storm(svc, words, SERVE_STORM_S, SERVE_CLIENTS, np)
        ann_lists = svc.synonyms_batch(words, 10)
        # the index's own recall against its host oracle on the same words' rows: the
        # served lists must overlap the card's exact lists as much (ties apart)
        with svc._handle.lease() as (_, index):
            same_rows = index.measure_recall(np.array([vocab.get(w) for w in words]),
                                             k=10, nprobe=stats["nprobe"])
    finally:
        svc.close()
    overlap = float(np.mean([len({w for w, _ in a} & {w for w, _ in ref_b[q]}) / 10
                             for q, a in zip(words, ann_lists)]))
    rec["ann"] = {"boot_s": boot_s, "build_s": stats["build_seconds"],
                  "index_bytes": stats["index_bytes"],
                  "centroids": stats["centroids"], "nprobe": stats["nprobe"],
                  "recall_at_10": stats.get("recall_at_10"),
                  "served_overlap_at_10": overlap, "recall_same_rows": same_rows,
                  "queries": len(served3),
                  "errors": len(errors3), "qps": len(served3) / SERVE_STORM_S,
                  "p50_ms": pctl(lats3, 0.5), "p99_ms": pctl(lats3, 0.99)}
    log("serve", f"(b) IVF arm (f32) on the same checkpoint: boot {boot_s:.1f} s, "
        f"build {stats['build_seconds']} s, {stats['index_bytes']} index bytes, "
        f"C={stats['centroids']} nprobe={stats['nprobe']}; recall@10 against the "
        f"exact oracle {stats.get('recall_at_10')} (the build's), "
        f"{same_rows:.4f} on the {len(words)} served words' rows, served lists' "
        f"overlap with the card's exact lists {overlap:.4f}; {SERVE_CLIENTS} clients: "
        f"{len(served3)} queries, {len(errors3)} errors, p50 {pctl(lats3, 0.5):.3f} / "
        f"p99 {pctl(lats3, 0.99):.3f} ms (exact batched: {rec['exact']['p50_ms']:.3f} / "
        f"{rec['exact']['p99_ms']:.3f} ms)")
    if (errors3 or not served3 or stats.get("recall_at_10") is None or overlap == 0
            or abs(overlap - same_rows) > SERVE_OVERLAP_TOL):
        raise AssertionError(f"serving (b) failed: errors {errors3[:3]}, overlap "
                             f"{overlap} against the index's recall {same_rows}")

    # (c) servebench over its clustered matrix, every arm
    cmd = [sys.executable, "-m", "glint_word2vec_torch.servebench", "--vocab",
           str(bench_vocab), "--dim", str(D_REAL), "--shard-native", "--duration", "1",
           "--seed", str(seed), "--device", device]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=str(Path(__file__).resolve().parent))
    bench_s = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        log("serve", f"(c) {line}")
    if r.returncode != 0:
        raise AssertionError(f"servebench exited {r.returncode}")
    bench = json.loads(r.stdout.strip().splitlines()[-1])
    bench["wall_s"] = bench_s
    rec["servebench"] = bench
    floors_ok = (bench["int8_recall_at_10"] >= 0.99 and bench["pq_recall_at_10"] >= 0.95
                 and bench["int8_recall_floor"] == 0.99
                 and bench["pq_recall_floor"] == 0.95)
    log("serve", f"(c) servebench at V={bench_vocab}, d={D_REAL} ({bench_s:.1f} s): "
        f"int8 recall@10 {bench['int8_recall_at_10']}, pq "
        f"{bench['pq_recall_at_10']} (floors 0.99, 0.95: {floors_ok}); shard-native "
        f"codes equal the in-memory build's: {bench['shard_native_parity']}")
    if not (floors_ok and bench["shard_native_parity"] is True):
        raise AssertionError("servebench's quantized arms failed")

    # (d) the JSON-lines CLI as a child process, on the card by default
    cmd = [sys.executable, "-m", "glint_word2vec_torch.serve_checkpoint", ck, "--ann"]
    if device != "cuda":
        cmd += ["--device", device]
    reqs = [{"op": "synonyms", "word": words[0], "num": 10, "id": 1},
            {"op": "synonyms_batch", "words": words[:8], "num": 10},
            {"op": "synonyms", "word": "not-a-word", "num": 5},
            {"op": "reload"}, {"op": "stats"}, {"op": "info"}, {"op": "quit"}]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, input="".join(json.dumps(q) + "\n" for q in reqs),
                       capture_output=True, text=True, timeout=600,
                       cwd=str(Path(__file__).resolve().parent))
    cli_s = time.perf_counter() - t0
    out = [json.loads(x) for x in r.stdout.splitlines()]
    ok = (r.returncode == 0 and len(out) == len(reqs) + 1 and out[0].get("ready")
          and out[1].get("id") == 1
          and lists_agree([tuple(x) for x in out[1]["synonyms"]], ann_lists[0],
                          SERVE_TIE)
          and all(lists_agree([tuple(x) for x in row], want, SERVE_TIE)
                  for row, want in zip(out[2]["synonyms"], ann_lists[:8]))
          and out[3].get("error_type") == "KeyError"
          and out[4] == {"reloaded": True, "num_words": vocab.size}
          and out[5].get("reloads") == 1 and out[5]["ann"]["centroids"] > 0
          and out[5].get("device", "").startswith(device)
          and out[6].get("num_words") == vocab.size and out[7] == {"bye": True})
    rec["cli"] = {"wall_s": cli_s, "rc": r.returncode}
    log("serve", f"(d) serve_checkpoint --ann as a child: exit {r.returncode} in "
        f"{cli_s:.1f} s; ready, synonyms and synonyms_batch equal to (b)'s IVF lists, "
        f"OOV error {out[3].get('error_type') if len(out) > 3 else None}, reload, "
        f"stats, info: {bool(ok)}")
    if not ok:
        raise AssertionError(f"the CLI failed: rc {r.returncode}, "
                             f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    return rec, launches


# the quality phase (12): EVAL.md's scale (17M words, 90,000 raw types, seed 42) through
# the port's quality harness with the JAX tool's defaults (d=100, 3 iterations, B=65536,
# P=512, f32, lr 0.025, subsample 1e-4, min_count 5, window 5, 5 negatives, 32 steps a
# dispatch); its floors (chance: 0.008 and 0.0, EVAL.md; every stable f32 row at P=512
# and >= 2M words in EVAL_RUNS.jsonl has purity >= 0.99 and margin >= 0.54); the
# supervised twin's purity within the hot-row A/B's tolerance of the uninterrupted fit's
# (the card's float atomics make the two runs differ in their last bits)
Q_WORDS, Q_VRAW, Q_SEED, Q_DIM, Q_B, Q_P = 17_000_000, 90_000, 42, 100, 65536, 512
Q_PURITY, Q_MARGIN, Q_PARITY = 0.95, 0.30, 0.02
Q_CKPT_CHUNKS = 4  # the supervised worker's checkpoint cadence, in dispatch chunks
Q_TIMEOUT_S = 600  # each child: the harness, the supervisor

QUALITY_WORKER = """
import json, os, sys, time
repo, corpus, out, words, workdir, every, device = sys.argv[1:8]
sys.path.insert(0, repo)
from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch import eval_quality as eq
from glint_word2vec_torch.data.corpus import TokenFileCorpus
from glint_word2vec_torch.train.checkpoint import load_latest_valid
t0 = time.perf_counter()
_, args = eq.parse_args(["--out", out, "--words", words])
cache = eq.encode_dir(out, args.words, args.vocab, args.min_count)
ckdir = os.path.join(workdir, "ckpt")
sents = TokenFileCorpus(corpus)
try:
    ck = load_latest_valid(ckdir)
except FileNotFoundError:
    ck = None
if ck is None:
    est = Word2Vec(device=device, telemetry_path=os.path.join(workdir, "run.jsonl"),
                   checkpoint_on_preempt=True, **eq.arm_config(args))
    est.fit(sents, checkpoint_path=os.path.join(ckdir, "model"),
            checkpoint_every_steps=int(every), encode_cache_dir=cache)
    stats = {"attempt": "fresh", **est.timings}
else:
    # the scripted preemption is the first attempt's; a resume reads the encode cache
    os.environ.pop("GLINT_FAULT_CRASH_AT_STEP", None)
    Word2Vec.resume(ck, sents, checkpoint_every_steps=int(every), encode_cache_dir=cache,
                    device=device)
    stats = {"attempt": "resume", "from": ck}
print("[worker] " + json.dumps({**stats, "wall_s": time.perf_counter() - t0}),
      file=sys.stderr, flush=True)
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _poll_metrics(port: int, stop, seen: list) -> None:
    """Scrape /metrics until ``stop``; keeps each answer's glint_supervisor_* lines."""
    import urllib.request

    while not stop.is_set():
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=5) as r:
                seen.append([line for line in r.read().decode().splitlines()
                             if line.startswith("glint_supervisor_")])
        except OSError:
            pass
        stop.wait(0.2)


def quality_kernel_case(seed: int, vocab_size: int, torch, sgns, fused,
                        profile_call) -> dict:
    """Phase 12 (d): one step of the fused kernel at the quality fit's shape (the
    trainer's [V padded to 8, D=100 padded to 128] parameters, B=65536, P=512, f32, Zipf
    1.1 duplicates, a masked tail), in both sigmoid modes, against its plain version
    with phase 3's limits; timed per call (events) and on the device (the profiler),
    beside its bound at the real width."""
    from glint_word2vec_torch.parallel.mesh import pad_dim_to_lanes, pad_vocab_for_sharding

    Vp, Dp = pad_vocab_for_sharding(vocab_size), pad_dim_to_lanes(Q_DIM)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    syn0 = torch.zeros((Vp, Dp), device="cuda")
    syn1 = torch.zeros((Vp, Dp), device="cuda")
    syn0[:vocab_size, :Q_DIM] = torch.randn((vocab_size, Q_DIM), generator=gen,
                                            device="cuda") * 0.35
    syn1[:vocab_size, :Q_DIM] = torch.randn((vocab_size, Q_DIM), generator=gen,
                                            device="cuda") * 0.35
    c, x = (zipf_ids(gen, Q_B, vocab_size, 1.1, torch) for _ in range(2))
    neg = zipf_ids(gen, Q_P, vocab_size, 1.1, torch)
    neg[:16] = x[:16]
    mask = torch.ones(Q_B, device="cuda")
    mask[-MASKED_TAIL:] = 0.0
    c[-MASKED_TAIL:] = 0
    x[-MASKED_TAIL:] = 0
    err = hold_kernel(syn0, syn1, c, x, mask, neg, torch, sgns, fused,
                      f"quality shape B={Q_B} P={Q_P} D={Q_DIM} (padded {Dp}) V={vocab_size}")
    params = sgns.EmbeddingPair(syn0, syn1)
    alpha_t = fused.alpha_on_card(0.025, "cuda")

    def step():
        fused.fused_sgns_shared_step(params, c, x, mask, neg, alpha_t, N_NEG, "exact")

    call_ms = time_steps(step, TIMED_STEPS, torch)
    plain_ms = time_steps(lambda: sgns.sgns_step_shared_core(
        params, c, x, mask, neg, 0.025, N_NEG, "exact"), TIMED_STEPS, torch)
    warm = per_launch_us(step, profile_call)
    ours = ("gather_kernel", "fneg_kernel", "update_kernel", "dz_scatter_kernel")
    if any(k not in warm for k in ours):
        raise AssertionError(f"the profile shows no launch of {ours}: {warm}")
    device_ms = sum(warm[k] for k in ours) / 1e3
    bound = step_bound(c, x, neg, mask, Q_DIM, torch)
    hottest = int(torch.bincount(c[mask > 0]).max())
    log("quality", f"(d) kernel at B={Q_B} P={Q_P} D={Q_DIM} (padded {Dp}) V={vocab_size}"
        f" (the hottest center row takes {hottest} updates): max_abs_err {err:.3e} "
        f"(limit {PARAM_ATOL}); one wrapper call {call_ms:.4f} ms (events, median of "
        f"{TIMED_STEPS}), on the device {device_ms:.4f} ms ("
        + ", ".join(f"{k} {warm[k]:.2f} us" for k in ours) + f"); plain {plain_ms:.4f} "
        f"ms; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, fp32 at the real "
        f"width: {bound['flops'] / 1e9:.3f} GFLOP, {bound['bytes'] / 1e6:.1f} MB), "
        f"bound_tc {bound['bound_tc_ms']:.4f} ms ({bound['bound_tc_by']}, 3xTF32)")
    return {"max_abs_err": err, "ms": call_ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "per_launch_us": {k: warm[k] for k in ours},
            "hottest_row_updates": hottest, "vocab_size": vocab_size,
            "padded": [Vp, Dp], **{k: bound[k] for k in ("bound_ms", "bound_by",
                                                         "bound_tc_ms", "bound_tc_by",
                                                         "flops", "bytes")}}


def quality_phase(seed: int, torch, np, sgns, fused, profile_call,
                  device: str = "cuda") -> tuple:
    """Phase 12: (a) the corpus at EVAL.md's scale from the port's generator; (b) the
    port's quality harness on it in a child process on the card, held to the floors with
    the fused kernel launched on every step; (c) the same fit under the supervisor
    (train_run), preempted by a scripted SIGTERM at half its steps and resumed, held to
    (b)'s final step and purity; (d) the fused kernel at (b)'s shape. Returns (record,
    (b)'s launches). ``device="cpu"`` rehearses (a) to (c) on the CPU (at a smaller
    Q_WORDS), without the card's checks (graphs, launches, idle share) and (d)."""
    import shlex
    import threading

    from glint_word2vec_torch import eval_quality as eq
    from glint_word2vec_torch.obs.schema import validate_file
    from glint_word2vec_torch.train.checkpoint import (
        load_latest_valid, load_model, verify_checkpoint)

    repo = str(Path(__file__).resolve().parent)
    env = {**os.environ, "PYTHONPATH": repo}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-quality-")
    try:
        out = os.path.join(tmp, "eval")
        os.makedirs(out)
        corpus = eq.corpus_file(out, Q_WORDS, Q_VRAW, Q_SEED)
        t0 = time.perf_counter()
        eq.generate_corpus(corpus, Q_WORDS, Q_SEED, Q_VRAW)
        gen_s = time.perf_counter() - t0
        sha = hashlib.sha256()
        with open(corpus, "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                sha.update(block)
        rec = {"corpus": {"words": Q_WORDS, "v_raw": Q_VRAW, "seed": Q_SEED,
                          "bytes": os.path.getsize(corpus), "sha256": sha.hexdigest(),
                          "generate_s": gen_s}}
        log("quality", f"(a) corpus: {Q_WORDS} words over {Q_VRAW} raw types, seed "
            f"{Q_SEED}: {rec['corpus']['bytes']} bytes in {gen_s:.1f} s, sha256 "
            f"{rec['corpus']['sha256']}")

        # (b) the uninterrupted fit, through the CLI a user runs
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "harness.err"), "w") as err:
            r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.eval_quality",
                                "--out", out, "--words", str(Q_WORDS), "--vocab",
                                str(Q_VRAW), "--seed", str(Q_SEED), "--runs-out",
                                os.path.join(tmp, "rows.jsonl"), "--device", device]
                               + (["--idle-share"] if device == "cuda" else []),
                               env=env, cwd=repo, stdout=subprocess.PIPE, stderr=err,
                               text=True, timeout=Q_TIMEOUT_S)
        wall = time.perf_counter() - t0
        tail = open(os.path.join(tmp, "harness.err")).read()[-3000:]
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"quality (b): the harness exited {r.returncode} with "
                                 f"{len(lines)} stdout lines: {r.stdout[-1000:]} {tail}")
        row = json.loads(lines[0])
        run = row.get("run", {})
        K = run.get("steps_per_dispatch", 0)
        launches = run.get("launches", {})
        ran = K * (run.get("graph_replays", 0) + run.get("graph_captures", 0))
        checks = {"not diverged": "diverged" not in row,
                  f"purity@10 >= {Q_PURITY}": row.get("purity_at_10", 0) >= Q_PURITY,
                  f"margin >= {Q_MARGIN}": row.get("cosine_margin", 0) >= Q_MARGIN,
                  f"on {device}": row.get("device", "").startswith(device)}
        if device == "cuda":
            checks.update({
                "one replay a chunk": run.get("graph_replays") == run.get("chunks", -1) > 0,
                "every chunk's steps ran": run.get("chunks", 0) * K >= run.get("steps", 1),
                "fused kernel on every step": launches.get("sgns_shared_step") == ran > 0,
                "no scatter launch": launches.get("scatter_add_rows") == 0})
        rec["fit"] = {"wall_s": wall, "row": row, "checks": checks}
        analogies = {k: row[k] for k in row if k.startswith("analogy_")}
        log("quality", f"(b) eval_quality on {device} in {wall:.1f} s: vocabulary "
            f"{row.get('vocab_size')}, purity@10 {row.get('purity_at_10')} (random "
            f"{row.get('purity_at_10_random_baseline')}), margin {row.get('cosine_margin')}"
            f" (random {row.get('cosine_margin_random_baseline')}); analogies {analogies}"
            f"; ann recall@10 {row.get('ann_recall_at_10')}; steps {run.get('steps')} in "
            f"{run.get('chunks')} chunks ({run.get('graph_captures')} captures, "
            f"{run.get('graph_replays')} replays), launches {launches}; vocab "
            f"{run.get('vocab_s', 0):.2f} s, encode {run.get('encode_s', 0):.2f} s, "
            f"trainer setup {run.get('setup_s', 0):.2f} s, Trainer.fit "
            f"{run.get('fit_s', 0):.2f} s (host_wait_s {run.get('host_wait_s', 0):.3f}, "
            f"dispatch_s {run.get('dispatch_s', 0):.3f}, prologue_s "
            f"{run.get('prologue_s', 0):.3f}), idle share "
            f"{run.get('device_idle_share', float('nan')):.1%} (kernels "
            f"{run.get('kernel_busy_s', float('nan')):.3f} s), scoring "
            f"{run.get('score_s', 0):.1f} s; checks {checks}")
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"quality (b) failed: {bad}; stderr: {tail}")

        # (c) the same fit under the supervisor, preempted at half its steps
        steps = run["steps"]
        workdir = os.path.join(tmp, "sup")
        ckdir = os.path.join(workdir, "ckpt")
        os.makedirs(workdir)
        worker = os.path.join(tmp, "worker.py")
        Path(worker).write_text(QUALITY_WORKER)
        port = _free_port()
        every = Q_CKPT_CHUNKS * K
        sup_log, run_log = os.path.join(workdir, "sup.jsonl"), os.path.join(workdir,
                                                                           "run.jsonl")
        cmd = [sys.executable, "-m", "glint_word2vec_torch.train_run",
               "--cmd", shlex.join([sys.executable, worker, repo, corpus, out,
                                    str(Q_WORDS), workdir, str(every), device]),
               "--log", run_log, "--checkpoint-dir", ckdir, "--telemetry", sup_log,
               "--status-port", str(port), "--workdir", workdir, "--max-restarts", "2"]
        stop, scraped = threading.Event(), []
        poller = threading.Thread(target=_poll_metrics, args=(port, stop, scraped),
                                  daemon=True)
        poller.start()
        t0 = time.perf_counter()
        try:
            with open(os.path.join(tmp, "sup.err"), "w") as err:
                r = subprocess.run(cmd, env={**env,
                                             "GLINT_FAULT_CRASH_AT_STEP": str(steps // 2),
                                             "GLINT_FAULT_CRASH_SIGNAL": "TERM"},
                                   cwd=repo, stdout=subprocess.PIPE, stderr=err, text=True,
                                   timeout=Q_TIMEOUT_S)
        finally:
            stop.set()
            poller.join(timeout=10)
        sup_wall = time.perf_counter() - t0
        tail = open(os.path.join(tmp, "sup.err")).read()
        workers = [json.loads(line[len("[worker] "):]) for line in tail.splitlines()
                   if line.startswith("[worker] {")]
        lines = r.stdout.strip().splitlines()
        verdict = json.loads(lines[0]) if len(lines) == 1 else {}
        recs = [json.loads(line) for line in open(run_log)] if os.path.exists(
            run_log) else []
        pre = [x for x in recs if x["kind"] == "preempt"]
        ends = [x for x in recs if x["kind"] == "run_end"]
        ck = load_latest_valid(ckdir, reclaim=False)
        verify_checkpoint(ck)
        data = load_model(ck, verify=False)
        state = data["train_state"]
        t0 = time.perf_counter()
        scored = eq.evaluate(data["words"], data["syn0"].astype(np.float32),
                             device=device)
        score_s = time.perf_counter() - t0
        metrics = [m for m in scraped if m]
        checks = {"one stdout line": len(lines) == 1,
                  "verdict ok": verdict.get("status") == "ok" and r.returncode == 0,
                  "2 attempts": verdict.get("attempts") == 2,
                  "first attempt preempt": [h["cls"] for h in verdict.get("history", [])]
                  == ["preempt", "ok"],
                  "preempt saved": len(pre) == 1 and pre[0]["saved"],
                  f"steps_since_save <= {K}": bool(pre) and pre[0]["steps_since_save"] <= K,
                  "run_end preempted then ok": [x["status"] for x in ends]
                  == ["preempted", "ok"],
                  "final checkpoint finished": state.finished,
                  "final step == (b)'s": state.global_step == steps,
                  "/metrics glint_supervisor_*": any(
                      any(m.startswith("glint_supervisor_attempts_total") for m in s)
                      for s in metrics),
                  "supervisor log validates": validate_file(sup_log)["ok"],
                  "worker log validates": validate_file(run_log)["ok"],
                  f"purity within {Q_PARITY} of (b)'s": abs(
                      scored.get("purity_at_10", -1) - row["purity_at_10"]) <= Q_PARITY}
        rec["supervised"] = {
            "wall_s": sup_wall, "verdict": verdict, "preempt": pre[0] if pre else None,
            "crash_at_step": steps // 2, "checkpoint_every_steps": every,
            "final_step": state.global_step, "workers": workers,
            "metrics_scrapes": len(metrics), "last_metrics": metrics[-1] if metrics else [],
            "score_s": score_s,
            **{k: scored.get(k) for k in ("purity_at_10", "cosine_margin",
                                          "analogy_accuracy_at_1")},
            "checks": checks}
        log("quality", f"(c) train_run --cmd <worker> on {device} in {sup_wall:.1f} s: "
            f"verdict {verdict.get('status')} after {verdict.get('attempts')} attempts "
            f"{[h['cls'] for h in verdict.get('history', [])]}; SIGTERM scripted at step "
            f"{steps // 2}, preempt record {pre[0] if pre else None}; final step "
            f"{state.global_step} (b: {steps}), finished {state.finished}; workers "
            f"{workers}; {len(metrics)} /metrics scrapes, the last {metrics[-1:]}; "
            f"purity@10 {scored.get('purity_at_10')} (b: {row['purity_at_10']}), margin "
            f"{scored.get('cosine_margin')}, analogy "
            f"{scored.get('analogy_accuracy_at_1')} (scored in {score_s:.1f} s); "
            f"checks {checks}")
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"quality (c) failed: {bad}; stdout {r.stdout[-1000:]}; "
                                 f"stderr {tail[-3000:]}")
        if device == "cuda":
            rec["kernel"] = quality_kernel_case(seed, row["vocab_size"], torch, sgns,
                                                fused, profile_call)
        return rec, launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the fleet phase (13): the drill's replicas, clients and query words; the chaos phases
# another phase of this smoke already runs on the card at a larger size (left out of
# 13b, each beside the phase that covers it)
FLEET_REPLICAS = 3
FLEET_CLIENTS = 8
FLEET_WORDS = 64
CHAOS_COVERED = {"fleet-kill": "13a", "train-preempt": "12c", "nan-rollback": "10b",
                 "norm-recover": "10c", "blackbox": "10d"}


def card_memory_mib():
    """The card's used memory (MiB) as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return int(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _module_child(args, log_path: str):
    """Start ``python -m glint_word2vec_torch.<args>`` with its stderr in
    ``log_path``; returns (process, its stderr file)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH"))
        if p))
    err = open(log_path, "w")
    return subprocess.Popen([sys.executable, "-m", *args], stdout=subprocess.PIPE,
                            stderr=err, text=True, env=env), err


def _child_result(proc, err, limit_s: float, what: str) -> dict:
    """Wait for a child started by :func:`_module_child` and parse its one JSON line."""
    try:
        out, _ = proc.communicate(timeout=limit_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what} did not finish within {limit_s:.0f} s")
    finally:
        err.close()
    lines = out.strip().splitlines()
    if not lines:
        raise AssertionError(f"{what} exited {proc.returncode} with no result "
                             f"(stderr: {Path(err.name).read_text()[-1500:]})")
    return {"rc": proc.returncode, **json.loads(lines[-1])}


def fleet_phase(ck: str, corpus, seed: int, np, device: str = "cuda",
                chaos_sentences: int = 0) -> dict:
    """Phase 13 (see the module docstring): (a) the fleet-kill drill with replica
    processes serving ``ck`` on ``device``, each served list held to the served
    model's ``find_synonyms``; (b) the chaos drill and (c) the transfer-contract audit
    as child processes on ``device``, run side by side after (a). Returns the record."""
    import threading

    from glint_word2vec_torch import Word2VecModel
    from glint_word2vec_torch.fleet_run import run_smoke
    from glint_word2vec_torch.obs.sink import TelemetrySink
    from glint_word2vec_torch.obs.trace import emit_publish

    vocab, _ = corpus
    card = device == "cuda"
    rec = {"card": card_line() if card else "cpu"}
    work = Path(ck).parent / "fleet"
    work.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed + 13)
    words = [vocab.words[i] for i in rng.choice(vocab.size, FLEET_WORDS, replace=False)]

    # (a) the fleet drill at full width
    t0 = time.perf_counter()
    model = Word2VecModel.load(ck, device=device)
    want = {w: model.find_synonyms(w, 10) for w in words}
    log("fleet", f"on {rec['card']}: V={model.num_words}, D={model.vector_size}; "
        f"reference lists of {len(words)} words in {time.perf_counter() - t0:.1f} s")
    publisher = TelemetrySink(str(work / "publisher.jsonl"))
    saves = []

    def publish() -> None:  # a save of the served model: a fresh publish signature
        t = time.perf_counter()
        model.save(ck)
        saves.append(round(time.perf_counter() - t, 3))
        emit_publish(publisher.emit, ck, model.train_state.global_step
                     if model.train_state else 0, publisher="chip_smoke")

    def check(word: str, res: list):
        ref = want.get(word)
        if ref is None or not lists_agree([(w, float(s)) for w, s in res], ref,
                                          SERVE_TIE):
            return f"{word}: served {res[:3]}... differs from find_synonyms {ref[:3]}..."
        return None

    mem = {"before_mib": card_memory_mib() if card else None, "peak_mib": None}
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(0.25):
            m = card_memory_mib()
            if m is not None:
                mem["peak_mib"] = max(mem["peak_mib"] or 0, m)

    sampler = threading.Thread(target=sample, daemon=True) if card else None
    if sampler is not None:
        sampler.start()
    t0 = time.perf_counter()
    try:
        drill = run_smoke(str(work), replicas=FLEET_REPLICAS, device=device,
                          checkpoint=ck, publish=publish, words=words, check=check,
                          clients=FLEET_CLIENTS, num=10, ready_timeout=600.0)
    finally:
        stop.set()
        if sampler is not None:
            sampler.join(timeout=30)
        publisher.close()
        model.stop()
    mem["after_close_mib"] = card_memory_mib() if card else None
    rec["drill"] = {**drill, "saves_s": saves, "memory": mem,
                    "seconds": round(time.perf_counter() - t0, 3)}
    log("fleet", f"(a) {FLEET_REPLICAS} replicas on {device} started in "
        f"{drill['start_s']:.1f} s; {FLEET_CLIENTS} clients: {drill['queries']} queries, "
        f"{drill['failed_queries']} failed, every list equal to find_synonyms; SIGKILL: "
        f"breaker {' '.join(drill['breaker_transitions'])}, back in "
        f"{drill['victim_recovery_s']:.1f} s; 3 publishes (saves {saves} s): rolling "
        f"rounds {drill['reload_round_s']} s (publish to round end), min serving "
        f"{drill['min_serving_during_reloads']} of {FLEET_REPLICAS}, drained reloads "
        f"{drill['drained_reloads']}; SIGTERM dump {drill['sigterm_dump']}, merged as "
        f"{drill['collector']['blackboxes']}; "
        f"SLO {drill['slo']} within budget {drill['slo_within_budget']}; collector "
        f"{len(drill['collector']['processes'])} processes, {drill['collector']['traces']}"
        f" traces; card memory {mem['before_mib']} MiB before, {mem['peak_mib']} at "
        f"peak, {mem['after_close_mib']} after close ({rec['drill']['seconds']:.1f} s)")

    # (b) the chaos drill and (c) the transfer-contract audit, side by side
    from glint_word2vec_torch.chaos_run import NOT_PORTED, phase_table
    chaos_run = [p for p, _ in phase_table("", 0, device)
                 if p not in NOT_PORTED and p not in CHAOS_COVERED]
    t0 = time.perf_counter()
    chaos = _module_child(
        ["glint_word2vec_torch.chaos_run", "--smoke", "--device", device, "--workdir",
         str(work / "chaos"), "--only", ",".join(chaos_run)]
        + (["--sentences", str(chaos_sentences)] if chaos_sentences else []),
        str(work / "chaos.err"))
    audit = _module_child(["glint_word2vec_torch.stepaudit", "--device", device]
                          + ([] if card else ["--smoke"]),
                          str(work / "stepaudit.err"))
    rec["audit"] = _child_result(*audit, 900, "the transfer-contract audit")
    rec["chaos"] = _child_result(*chaos, 900, "the chaos drill")
    rec["chaos"]["left_out"] = {p: f"runs on the card in phase {ph}"
                                for p, ph in CHAOS_COVERED.items()}
    rec["children_s"] = round(time.perf_counter() - t0, 3)
    c = rec["chaos"]
    log("fleet", f"(b) chaos_run --smoke --device {device}: "
        + ", ".join(f"{p} {r}" for p, r in c["phases"].items())
        + f"; left out (another phase runs them on the card at a larger size): "
        + ", ".join(f"{p} ({ph})" for p, ph in CHAOS_COVERED.items())
        + f"; not ported: {', '.join(NOT_PORTED) or 'none'}")
    if c["rc"] != 0 or not c["ok"] or set(c["phases"]) != set(chaos_run):
        raise AssertionError(f"phase 13b: chaos drill failed: {c['phases']}")
    a = rec["audit"]
    for name, v in a["variants"].items():
        t = v["transfers"]
        log("fleet", f"(c) stepaudit {name:18s} at V={a['geometry']['v']}: "
            f"{v['chunks']} chunks {v['chunk_steps']}, in place {v['in_place']['ok']} "
            f"(peak +{v['in_place']['peak_over_start_bytes']} B of a "
            f"{v['in_place']['matrix_bytes']} B matrix), undeclared "
            f"{t['undeclared_count']}, misplaced {t['misplaced_count']} (witness "
            f"{None if t['witness'] is None else t['witness']['undeclared']}), dtype "
            f"{v['dtype']['ok']}, captures {v['recompile']}, declared syncs/chunk "
            f"{t['declared_syncs_per_chunk']} {t['declared_syncs_per_chunk_by_site']}, "
            f"fit {v['fit_seconds']} s")
    log("fleet", f"(c) recovery: {a['recover_rebuild']}; audit {a['seconds']} s; "
        f"(b) and (c) side by side in {rec['children_s']:.1f} s")
    if a["rc"] != 0 or not a["ok"]:
        bad = {n: v for n, v in a["variants"].items() if not v["ok"]}
        raise AssertionError(f"phase 13c: the transfer-contract audit failed: "
                             f"{json.dumps(bad)[:3000]} {a.get('recover_rebuild')}")
    return rec


# the continual phase (14): phase 11's checkpoint grown by one tail segment of
# CONT_TOKENS Zipf(1) tokens over its words (another seed than phase 8's corpus) and
# CONT_NEW unseen words, each the checkpoint's min_count + 3 times, in one increment at
# lr re-warm CONT_REWARM under a service on the card queried by CONT_CLIENTS clients;
# then the forgetting A/B at the settings of the JAX tool's rows EVAL_RUNS.jsonl:27-28
# (seed 42, B=65536, P=512, a tail of words // 4, 2,000 new raw types), its vocabulary
# sizes, and the quality phase's floors with the hot-row A/B's 0.02 parity
CONT_TOKENS = 2_000_000
CONT_NEW = 10_000
CONT_REWARM = 0.5
CONT_CLIENTS = 8
CONT_WORDS = 64
AB_ARGS = ["--continual-ab", "--words", "6000000", "--vocab", "30000", "--dim", "64",
           "--iters", "1"]
AB_SIZES = (30_349, 1_747, 32_096)  # vocab_base, new_words, vocab_grown
AB_PURITY, AB_MARGIN, AB_PARITY = 0.95, 0.30, 0.02
AB_TIMEOUT_S = 900


def write_tail(path: str, words, counts, mc: int, seed: int, np):
    """The tail segment: CONT_TOKENS draws of the vocabulary's own Zipf counts and
    CONT_NEW unseen words ``novel<j>`` ``mc + 3`` times each, shuffled together into
    sentences of 40 tokens. Returns the draws' ids (new words from len(words) up) in
    file order and the new words' names."""
    rng = np.random.default_rng(seed + 14)
    V = len(words)
    old = rng.choice(V, size=CONT_TOKENS, p=counts / counts.sum())
    new = np.repeat(np.arange(V, V + CONT_NEW), mc + 3)
    ids = np.concatenate([old, new])[rng.permutation(CONT_TOKENS + len(new))]
    names = [f"novel{j:05d}" for j in range(CONT_NEW)]
    vocab = np.asarray(list(words) + names, dtype=object)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(0, len(ids), 40):
            f.write(" ".join(vocab[ids[i:i + 40]]) + "\n")
    return ids, names


def continual_phase(ck: str, seed: int, torch, np, fused, scat,
                    device: str = "cuda") -> tuple:
    """Phase 14 (see the module docstring): (a) ``ContinualRunner.run_once`` on a copy
    of ``ck`` under a live service, every assertion of the loop at full width; (b) the
    forgetting A/B, ``eval_quality --continual-ab`` in a child process. Returns (record,
    (a)'s launches, (b)'s launches). ``device="cpu"`` rehearses it on the CPU at a
    smaller checkpoint (patched CONT_* sizes), without the card's checks."""
    import threading
    from types import SimpleNamespace

    from glint_word2vec_torch.continual import ContinualRunner, seed_new_rows
    from glint_word2vec_torch.data.corpus import TokenFileCorpus
    from glint_word2vec_torch.data.vocab import Vocabulary
    from glint_word2vec_torch.serve import EmbeddingService
    from glint_word2vec_torch.serve.reload import publish_signature
    from glint_word2vec_torch.train import trainer as trainer_mod
    from glint_word2vec_torch.train.checkpoint import load_model_header

    card = device == "cuda"
    rec = {"card": card_line() if card else "cpu"}
    root = Path(ck).parent / "continual"
    publish, stream, work = root / "publish" / "ck", root / "stream", root / "work"
    stream.mkdir(parents=True)
    t0 = time.perf_counter()
    shutil.copytree(ck, publish)
    h0 = load_model_header(str(publish))
    V, cfg0, step0 = len(h0["words"]), h0["config"], h0["train_state"].global_step
    mc, D = cfg0.min_count, cfg0.vector_size
    ids, names = write_tail(str(stream / "seg-001.txt"), h0["words"], h0["counts"], mc,
                            seed, np)
    tail_counts = np.bincount(ids, minlength=V + CONT_NEW)
    new_ids = ids[ids >= V]  # the new words in the order they are first seen
    want_new = [names[j - V] for j in new_ids[np.sort(np.unique(new_ids,
                                                                return_index=True)[1])]]
    src0 = np.load(os.path.join(ck, "syn0.npy"), mmap_mode="r")
    src1 = np.load(os.path.join(ck, "syn1.npy"), mmap_mode="r")
    rec["prep_s"] = time.perf_counter() - t0
    log("continual", f"on {rec['card']}: phase 11's checkpoint V={V:,}, d={D}, step "
        f"{step0} copied; tail {CONT_TOKENS:,} Zipf(1) tokens + {CONT_NEW:,} new words x "
        f"{mc + 3} ({rec['prep_s']:.1f} s)")

    checks, pre_fit, timing = {}, {}, {}

    class Observed(ContinualRunner):
        """The runner, its extended checkpoint held to the source on disk between the
        extension's publish and the fit (the parameters' load is the first step after
        it)."""

        def _load_params(self, path, header, cfg):
            t = time.perf_counter()
            g0 = np.load(os.path.join(path, "syn0.npy"), mmap_mode="r")
            g1 = np.load(os.path.join(path, "syn1.npy"), mmap_mode="r")
            pre_fit.update({
                "carried syn0 bit-identical": bool(np.array_equal(g0[:V], src0)),
                "carried syn1 bit-identical": bool(np.array_equal(g1[:V], src1)),
                "new syn1 zero": not np.asarray(g1[V:]).any(),
                "new syn0 within 0.5/D": bool(np.abs(g0[V:]).max() <= 0.5 / D),
                "new syn0 = seed_new_rows": bool(np.array_equal(
                    g0[V:], seed_new_rows(CONT_NEW, D, cfg0.seed, V)))})
            timing["pre_fit_checks_s"] = time.perf_counter() - t
            return super()._load_params(path, header, cfg)

    words = [h0["words"][i] for i in
             np.random.default_rng(seed + 15).choice(V, CONT_WORDS, replace=False)]
    svc = EmbeddingService(checkpoint=str(publish), ann=False, watch=True,
                           reload_poll_s=0.05, device=device)
    mem = {"before_mib": card_memory_mib() if card else None, "peak_mib": None}
    done, stop = threading.Event(), threading.Event()
    events = {"publish": [], "reload": []}

    def watch() -> None:  # each publish's rename and each reload, on one clock
        sig, n = publish_signature(str(publish)), svc.reloads
        while not stop.is_set():
            s = publish_signature(str(publish))
            if s is not None and s != sig:
                events["publish"].append(time.monotonic())
                sig = s
            if svc.reloads != n:
                events["reload"].append(time.monotonic())
                n = svc.reloads
            time.sleep(0.005)

    def sample() -> None:  # the card's memory every 0.25 s
        while not stop.wait(0.25):
            m = card_memory_mib()
            if m is not None:
                mem["peak_mib"] = max(mem["peak_mib"] or 0, m)

    box = {}
    clients = threading.Thread(target=lambda: box.update(zip(
        ("served", "errors", "lats"),
        storm(svc, words, 0.0, CONT_CLIENTS, np, until=done))))
    watcher = threading.Thread(target=watch, daemon=True)
    sampler = threading.Thread(target=sample, daemon=True) if card else None
    fit_prof = {}
    real_fit, real_save = trainer_mod.Trainer.fit, trainer_mod.Trainer.save_checkpoint

    def end_training() -> None:  # the steps' end: the profile stops, the clock reads
        if "train_s" not in fit_prof:
            if card:
                torch.cuda.synchronize()
                fit_prof["prof"].stop()
            fit_prof["train_s"] = time.perf_counter() - fit_prof["t0"]

    def fit(self, *a, **k):  # the increment's steps under the profiler (card only),
        # up to its final save; the trace is read after the reloads, not beside them
        fit_prof["global_step_start"] = int(self.global_step)
        if card:
            fit_prof["prof"] = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            fit_prof["prof"].start()
        fit_prof["t0"] = time.perf_counter()
        try:
            return real_fit(self, *a, **k)
        finally:
            end_training()

    def save(self, path):  # the final save, timed apart from the steps
        if self.state.finished:
            end_training()
        t = time.perf_counter()
        real_save(self, path)
        fit_prof["save_s"] = time.perf_counter() - t

    reset_counts(fused, scat)
    watcher.start()
    if sampler is not None:
        sampler.start()
    clients.start()
    trainer_mod.Trainer.fit, trainer_mod.Trainer.save_checkpoint = fit, save
    t0 = time.perf_counter()
    try:
        with Observed(str(publish), str(stream), str(work), device=device,
                      config_overrides={"continual_lr_rewarm": CONT_REWARM}) as runner:
            rep = runner.run_once()
            rec["run_once_s"] = time.perf_counter() - t0
            launches = {"sgns_shared_step": fused.fused_sgns_shared_step.launches,
                        "scatter_add_rows": scat.scatter_add_rows_.launches,
                        "sgns_shared_step_bf16": fused.fused_sgns_shared_step.bf16_launches,
                        "scatter_add_rows_bf16": scat.scatter_add_rows_.bf16_launches}
            again = runner.run_once()
        deadline = time.monotonic() + 60  # both publishes reloaded
        while not len(events["reload"]) >= len(events["publish"]) >= 2 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(1.0)  # the clients query the grown model for 1 s
        new_res = svc.synonyms(want_new[0], 10)
        st, info = svc.stats(), svc.info()
    finally:
        trainer_mod.Trainer.fit, trainer_mod.Trainer.save_checkpoint = real_fit, real_save
        done.set()
        clients.join(timeout=120)
        stop.set()
        watcher.join(timeout=30)
        if sampler is not None:
            sampler.join(timeout=30)
        svc.close()
    if card:
        from glint_word2vec_torch.stepprof import kernel_busy_s
        fit_prof["busy_s"] = kernel_busy_s(fit_prof.pop("prof"))
        torch.cuda.empty_cache()
    mem["after_mib"] = card_memory_mib() if card else None
    h1 = load_model_header(str(publish))
    g0 = np.load(os.path.join(publish, "syn0.npy"), mmap_mode="r")
    untouched = tail_counts[:V] == 0
    inc_cfg = h1["config"].replace(num_iterations=h1["config"].continual_iterations)
    steps, pairs = replay_host_feed(
        SimpleNamespace(config=inc_cfg, vocab=Vocabulary.from_words_and_counts(
            h1["words"], h1["counts"])), TokenFileCorpus(str(stream / "seg-001.txt")), np)
    tr = rep["trainer"]
    K = inc_cfg.steps_per_dispatch
    served = len(box.get("served", ()))
    lineage = h1["vocab_lineage"]
    checks.update(pre_fit)
    checks.update({
        "grew by CONT_NEW to V + CONT_NEW": (rep["new_words"], rep["vocab_size"])
        == (CONT_NEW, V + CONT_NEW),
        "old words first, in order": h1["words"][:V] == h0["words"],
        "new words in first-seen order": h1["words"][V:] == want_new,
        "merged counts = old + bincount": bool(np.array_equal(
            h1["counts"], np.concatenate([h0["counts"], np.zeros(CONT_NEW, np.int64)])
            + tail_counts)),
        "untouched syn0 rows bit-identical": bool(np.array_equal(g0[:V][untouched],
                                                                 src0[untouched])),
        "global_step advanced by the steps": h1["train_state"].global_step
        == tr["global_step"] == step0 + steps and tr["global_step_start"] == step0
        == fit_prof["global_step_start"],
        "pairs = the numpy feed's": tr["pairs_trained"] == pairs,
        "learning_rate unchanged": h1["config"].learning_rate == cfg0.learning_rate,
        "lineage depth 1, identity-prefix": len(lineage) == 1
        and lineage[0]["remap"] == "identity-prefix" and lineage[0]["new_words"] == CONT_NEW,
        "second run_once idle": again["action"] == "idle",
        "service reloaded the grown model": info["num_words"] == V + CONT_NEW,
        "one vocabulary-change reload": st["vocab_change_reloads"] == 1,
        "new word answered, finite": bool(new_res) and all(
            np.isfinite(s) for _, s in new_res),
        "no query failed or refused": not box.get("errors") and st["refused"] == 0
        and served > 0})
    if card:
        checks.update({
            "fused kernel on every step": launches["sgns_shared_step"]
            == K * (tr["graph_replays"] + tr["graph_captures"]) > 0 and tr["graph_replays"]
            == tr["chunks"],
            "scatter kernel never": launches["scatter_add_rows"] == 0})
    reloads = [r - p for p, r in zip(events["publish"], events["reload"])]
    lats = box.get("lats", [])
    sec = rep["seconds"]
    train_s = fit_prof["train_s"]
    idle = (1.0 - fit_prof["busy_s"] / train_s) if "busy_s" in fit_prof else None
    rec["loop"] = {"report": rep, "checks": checks, "timing": timing, "steps": steps,
                   "pairs": pairs, "train_s": train_s, "final_save_s": fit_prof["save_s"],
                   "pairs_per_s": pairs / train_s, "device_idle_share": idle,
                   "reload_s": reloads, "load_seconds": st["load_seconds"],
                   "queries": served, "p50_ms": pctl(lats, 0.5), "p99_ms": pctl(lats, 0.99),
                   "memory": mem, "launches": launches}
    log("continual", f"(a) run_once in {rec['run_once_s']:.1f} s: count {sec['count']:.2f}"
        f" s, extension {sec['extend']:.2f} s, encode {sec['encode']:.2f} s, load "
        f"{sec['load']:.2f} s, trainer set-up {sec['setup']:.2f} s, fit {sec['fit']:.2f} s "
        f"= steps {train_s:.2f} s + final save {fit_prof['save_s']:.2f} s (pre-fit checks "
        f"{timing.get('pre_fit_checks_s', 0):.1f} s); V {V:,} -> {rep['vocab_size']:,}; "
        f"{steps} steps from global step {step0}, {pairs / train_s:,.0f} pairs/s, device "
        f"idle {'n/a' if idle is None else f'{idle:.1%}'} of the steps (the service's "
        "kernels count busy), "
        f"host_wait_s {tr['host_wait_s']:.2f}, dispatch_s {tr['dispatch_s']:.2f} "
        f"(prologues {tr['prologue_s']:.2f}), "
        f"{tr['chunks']} chunks, captures {tr['graph_captures']}, replays "
        f"{tr['graph_replays']}, launches {launches}; reloads {[f'{r:.2f}' for r in reloads]}"
        f" s from publish to swap (load_seconds {st['load_seconds']}); {served} queries "
        f"under {CONT_CLIENTS} clients (p50 {pctl(lats, 0.5):.2f}, p99 "
        f"{pctl(lats, 0.99):.2f} ms), errors {len(box.get('errors', []))}, refused "
        f"{st['refused']}, vocab-change reloads {st['vocab_change_reloads']}; "
        f"{want_new[0]} -> {new_res[:2]}; card memory {mem['before_mib']} MiB before, "
        f"{mem['peak_mib']} at peak, {mem['after_mib']} after")
    bad = [k for k, ok in checks.items() if ok is not True]
    if bad:
        raise AssertionError(f"continual (a) failed: {bad}; {json.dumps(rep)[:2000]}; "
                             f"errors {box.get('errors', [])[:3]}")
    del g0, src0, src1

    # (b) the forgetting A/B in a child process
    t0 = time.perf_counter()
    out = root / "ab"
    child = _module_child(["glint_word2vec_torch.eval_quality", *AB_ARGS, "--device",
                           device, "--out", str(out), "--runs-out",
                           str(out / "rows.jsonl")], str(root / "ab.err"))
    ab = _child_result(*child, AB_TIMEOUT_S, "the forgetting A/B")
    pre, post = ab["arms"]
    la = {k: pre["run"]["launches"][k] + post["run"]["launches"][k]
          for k in pre["run"]["launches"]}
    Kb = pre["run"]["steps_per_dispatch"]
    checks = {
        "exit 0": ab["rc"] == 0,
        "sizes as EVAL_RUNS.jsonl:27-28": (ab["vocab_base"], ab["new_words"],
                                          ab["vocab_grown"]) == AB_SIZES,
        f"post purity >= {AB_PURITY}": ab["purity_post"] >= AB_PURITY,
        f"post purity >= pre - {AB_PARITY}": ab["purity_post"]
        >= ab["purity_pre"] - AB_PARITY,
        f"post margin >= {AB_MARGIN}": post["cosine_margin"] >= AB_MARGIN}
    if card:
        checks["fused kernel on both fits"] = all(
            r["run"]["launches"]["sgns_shared_step"] == Kb * (
                r["run"]["graph_replays"] + r["run"]["graph_captures"]) > 0
            for r in (pre, post))
    rec["ab"] = {"wall_s": time.perf_counter() - t0, "checks": checks,
                 **{k: v for k, v in ab.items() if k != "arms"},
                 "pre": {k: pre.get(k) for k in ("purity_at_10", "cosine_margin",
                                                 "analogy_accuracy_at_1",
                                                 "train_seconds_total", "run")},
                 "post": {k: post.get(k) for k in ("purity_at_10", "cosine_margin",
                                                   "analogy_accuracy_at_1",
                                                   "train_seconds_total", "run")}}
    log("continual", f"(b) eval_quality --continual-ab on {device} in "
        f"{rec['ab']['wall_s']:.1f} s: vocab {ab['vocab_base']:,} + {ab['new_words']:,} "
        f"new = {ab['vocab_grown']:,} (JAX rows: {AB_SIZES}); purity@10 "
        f"{ab['purity_pre']} -> {ab['purity_post']}, margin {pre['cosine_margin']} -> "
        f"{post['cosine_margin']}, analogy@1 {ab['analogy_pre']} -> {ab['analogy_post']} "
        f"(held to nothing); train seconds {pre['train_seconds_total']} (base, vocabulary"
        f" and encode included) and {post['train_seconds_total']} (increment: set-up and "
        f"fit); launches {la}; checks {checks}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"continual (b) failed: {bad}; "
                             f"{Path(root / 'ab.err').read_text()[-3000:]}")
    return rec, launches, la


# --- phase 15: the mesh -----------------------------------------------------------------

MESH_STEPS = 64       # (a): the model-sharded fit's steps
MESH_K = 16           # its steps a chunk
MESH_SGD_STEPS = 8    # (b): local SGD's steps, one window a chunk (K = sync_every = 2)
MESH_TOKENS = 300_000  # >= 64 steps of the 2-rank sharded feed at B=8192, window 5
MESH_WORDS = 16       # (c): the synonym queries
MESH_LIMIT_S = 600.0  # each world's ranks, start-up and build included


class _MeshStop(Exception):
    pass


def _stop_at(tr, steps: int) -> None:
    """End ``tr``'s fit by raising at the end of the round that reaches ``steps``
    (every rank reaches it at the same round)."""
    finish = tr._finish_round

    def finish_then_stop(chunk, *a, **kw):
        finish(chunk, *a, **kw)
        if tr.global_step >= steps:
            raise _MeshStop()

    tr._finish_round = finish_then_stop


def _replica_fingerprint(params, torch) -> int:
    """A position-weighted int64 sum over the bits of both matrices (wrapping): two
    replicas that differ in one bit differ here."""
    total = 0
    for m in params:
        bits = m.view(torch.int32).to(torch.int64)
        w = torch.arange(1, m.shape[1] + 1, device=m.device, dtype=torch.int64)
        rows = (bits * w).sum(dim=1)
        rw = torch.arange(m.shape[0], device=m.device, dtype=torch.int64) % 65521 + 1
        total = (total + int((rows * rw).sum())) % (1 << 62)
    return total


def _rank_scatter_hold(tr, plan, torch, scat) -> dict:
    """The row-scatter kernel at the sizes the mesh step gives it on this rank, against
    its plain version on the same inputs. The synchronous step scatters the
    data-gathered payload: B centers into the rank's syn0 block, and B + num_data * P
    contexts and pool rows into its syn1 block. A local-SGD window's step scatters this
    data shard's own: Bl = B / num_data centers, and Bl + P contexts and pool rows. The
    last eighth of every segment's centers and contexts is masked (index -1, as a
    stream's last batch is); those slots and the rows the rank does not own are dead."""
    cfg = tr.config
    gen = torch.Generator(device="cuda").manual_seed(plan.rank + 1)
    vs = tr.params.syn0.shape[0]
    lo = plan.rows(tr.padded_vocab)[0]
    bl, pool = cfg.pairs_per_batch // plan.num_data, cfg.negative_pool
    segments = 1 if cfg.sync_every > 1 else plan.num_data
    out = {}
    for name, with_pool in (("syn0", False), ("syn1", True)):
        parts = []
        for _ in range(segments):
            ids = zipf_ids(gen, bl, tr.padded_vocab, 1.1, torch)
            ids[bl - bl // 8:] = -1
            parts.append(ids)
            if with_pool:
                parts.append(zipf_ids(gen, pool, tr.padded_vocab, 1.1, torch))
        idx = torch.cat(parts) - lo
        n = idx.shape[0]
        own = (idx >= 0) & (idx < vs)
        loc = torch.where(own, idx, 0).contiguous()
        live = own.to(torch.float32)
        upd = torch.randn((n, tr.padded_dim), generator=gen, device="cuda") * 1e-3
        base = getattr(tr.params, name)
        got = scat.scatter_add_rows_(base.clone(), loc, upd, live)
        want = scat.scatter_add_rows_reference(base.clone(), loc[own], upd[own])
        torch.cuda.synchronize()
        out[name] = {"slots": n, "live": int(own.sum()),
                     "max_abs_err": float((got - want).abs().max())}
    return out


def mesh_rank_main(args) -> int:
    """One rank of phase 15, run by :func:`mesh_phase` as
    ``chip_smoke.py --mesh-rank R --mesh-case CASE --mesh-dir DIR``: a gloo world of
    two ranks on this one card, every collective staged through host memory."""
    import numpy as np
    import torch

    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from glint_word2vec_torch import Vocabulary
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.ops import fused_sgns as fused
    from glint_word2vec_torch.ops import scatter as scat
    from glint_word2vec_torch.parallel import distributed
    from glint_word2vec_torch.parallel.mesh import make_mesh
    from glint_word2vec_torch.train.trainer import Trainer

    d = Path(args.mesh_dir)
    case, r = args.mesh_case, args.mesh_rank
    distributed.initialize(init_method=f"file://{d / (case + '.store')}",
                           num_processes=2, process_id=r, backend="gloo",
                           device="cuda", timeout_s=300)
    rec = {"rank": r, "case": case}
    words, counts, sents = synthetic_corpus(args.seed, MESH_TOKENS, np)
    vocab = Vocabulary.from_words_and_counts(words, counts)
    enc = encode_sentences(sents, vocab, 1000)
    knobs = dict(vector_size=D_REAL, window=WINDOW, negatives=N_NEG, pairs_per_batch=B,
                 seed=args.seed, heartbeat_every_steps=MESH_K)
    if case == "model":
        plan, steps = make_mesh(1, 2), MESH_STEPS
        cfg = Word2VecConfig(steps_per_dispatch=MESH_K, **knobs)
    else:
        plan, steps = make_mesh(2, 1), MESH_SGD_STEPS
        cfg = Word2VecConfig(steps_per_dispatch=2, step_lowering="shard_map",
                             sync_every=2, **knobs)
    tr = Trainer(cfg, vocab, device="cuda", plan=plan)
    rec.update(place=[plan.data_index, plan.model_index], pool=tr.config.negative_pool,
               rows=list(plan.rows(tr.padded_vocab)), padded_dim=tr.padded_dim)
    rounds = []
    run = tr._run_chunk
    fps = []

    def run_chunk(chunk):
        a = chunk["arrays"]
        rounds.append({k: np.array(a[k]) for k in ("centers", "contexts", "reals",
                                                   "alphas")} | {"real": chunk["real"]})
        out = run(chunk)
        if case == "data":  # every chunk is one window: it ended on a merge
            fp = torch.tensor([_replica_fingerprint(tr.params, torch)], dtype=torch.int64)
            fps.append(distributed.COLLECTIVES.all_gather(
                fp, distributed.host_group()).tolist())
        return out

    tr._run_chunk = run_chunk
    _stop_at(tr, steps)
    torch.cuda.synchronize()
    fused.fused_sgns_shared_step.launches = 0
    scat.scatter_add_rows_.launches = 0
    distributed.COLLECTIVES.reset()
    t0 = time.perf_counter()
    try:
        tr.fit(enc)
    except _MeshStop:
        pass
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rec.update(steps=tr.global_step, scatter_launches=scat.scatter_add_rows_.launches,
               fused_launches=fused.fused_sgns_shared_step.launches,
               collectives={f"{op}/{ax}": n for (op, ax), n in
                            distributed.COLLECTIVES.counts.items()},
               fit_s=fit_s, dispatch_s=tr.dispatch_time, host_wait_s=tr.host_wait_time,
               step_ms=1e3 * tr.dispatch_time / max(tr.global_step, 1),
               staged_s=distributed.COLLECTIVES.staged_s,
               staged_calls=distributed.COLLECTIVES.staged_calls,
               staging_share=distributed.COLLECTIVES.staged_s / max(tr.dispatch_time, 1e-9))
    if case == "model":
        if r == 0:
            np.savez(d / "rounds.npz", **{k: np.stack([x[k] for x in rounds]) for k in
                                          ("centers", "contexts", "reals", "alphas")},
                     real=np.asarray([x["real"] for x in rounds]))
        tr.save_checkpoint(str(d / "ck"))
        g = tr.gather_params()
        if r == 0:
            np.save(d / "gathered_syn0.npy", g.syn0.float().cpu().numpy())
        del g
    else:
        rec["fingerprints"] = fps
        dig = hashlib.sha256()
        for m in tr.params:
            dig.update(m.cpu().numpy().tobytes())
        rec["sha256"] = dig.hexdigest()
    rec["scatter_hold"] = _rank_scatter_hold(tr, plan, torch, scat)
    (d / f"{case}-r{r}.json").write_text(json.dumps(rec))
    distributed.shutdown()
    return 0


def _mesh_world(case: str, d: Path, seed: int) -> list:
    procs = []
    for r in range(2):
        err = open(d / f"{case}-r{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(r),
             "--mesh-case", case, "--mesh-dir", str(d), "--seed", str(seed)],
            stdout=err, stderr=subprocess.STDOUT), err))
    deadline = time.monotonic() + MESH_LIMIT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"mesh {case}: a rank did not finish within "
                             f"{MESH_LIMIT_S:.0f} s")
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    out = []
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"mesh {case} rank {r} exited {p.returncode}: "
                                 f"{(d / f'{case}-r{r}.log').read_text()[-3000:]}")
        out.append(json.loads((d / f"{case}-r{r}.json").read_text()))
    return out


def _mesh_replay(d: Path, vocab, pool: int, seed: int, torch, np, sgns):
    """The model-sharded fit's recorded global chunks through the single-process plain
    shared-pool step on the card, from the trainer's start parameters."""
    from glint_word2vec_torch.ops.sampler import build_alias_table, sample_negatives_hash

    rd = np.load(d / "rounds.npz")
    table = build_alias_table(vocab.counts, 0.75)
    prob = torch.from_numpy(table.prob).cuda()
    alias = torch.from_numpy(table.alias.astype(np.int64)).cuda()
    start = sgns.init_embeddings(V, D_REAL, torch.Generator().manual_seed(seed))
    p = sgns.EmbeddingPair(*(torch.nn.functional.pad(m, (0, D - D_REAL)).cuda()
                             for m in start))
    step = 0
    for i, real in enumerate(rd["real"]):
        negs = sample_negatives_hash(prob, alias, seed, step + 1, (MESH_K, pool))
        reals = torch.from_numpy(rd["reals"][i]).cuda().reshape(MESH_K, -1)
        pos = torch.arange(B // reals.shape[1], device="cuda")
        mask = (pos < reals[:, :, None]).to(torch.float32).reshape(MESH_K, B)
        c = torch.from_numpy(rd["centers"][i]).cuda().long()
        x = torch.from_numpy(rd["contexts"][i]).cuda().long()
        a = torch.from_numpy(rd["alphas"][i]).cuda()
        for k in range(int(real)):
            p, _ = sgns.sgns_step_shared_core(p, c[k], x[k], mask[k], negs[k], a[k],
                                              N_NEG)
        step += int(real)
    return p, step


def mesh_phase(seed: int, torch, np, sgns) -> tuple:
    """Phase 15: row-sharded training over torch.distributed, two ranks sharing this
    one card through a gloo group staged in host memory (NCCL refuses two ranks on one
    device): (a) the model-sharded fit, (b) local SGD on the data axis, (c) the
    row-shards checkpoint served on one device, (d) NCCL at a world of one."""
    from glint_word2vec_torch import Vocabulary, Word2VecModel
    from glint_word2vec_torch.parallel import distributed
    from glint_word2vec_torch.train.checkpoint import load_model

    from glint_word2vec_torch.data import native

    native.native_available()  # built here once, not raced by the ranks
    torch.cuda.empty_cache()
    d = Path(tempfile.mkdtemp(prefix="chip-smoke-mesh-"))
    rec = {}
    try:
        t0 = time.perf_counter()
        model = _mesh_world("model", d, seed)
        rec["model_world_s"] = time.perf_counter() - t0
        for r in model:
            if r["scatter_launches"] <= 0:
                raise AssertionError(f"mesh (a) rank {r['rank']}: no scatter launch")
            if r["fused_launches"]:
                raise AssertionError("mesh (a): the fused kernel ran on the mesh path")
        words, counts, _ = synthetic_corpus(seed, 1, np)
        vocab = Vocabulary.from_words_and_counts(words, counts)
        ref, steps = _mesh_replay(d, vocab, model[0]["pool"], seed, torch, np, sgns)
        if steps != model[0]["steps"]:
            raise AssertionError(f"mesh (a): replay {steps} steps, fit {model[0]['steps']}")
        got = load_model(str(d / "ck"), verify=True)
        err = 0.0
        for name, m in (("syn0", got["syn0"]), ("syn1", got["syn1"])):
            want = getattr(ref, name)[:V, :D_REAL]
            err = max(err, float((torch.from_numpy(m).cuda() - want).abs().max()))
        if not err <= PARAM_ATOL:
            raise AssertionError(f"mesh (a): sharded vs single-process max |diff| {err}")
        del ref
        # (c) the row-shards checkpoint on one device against the gathered rows
        served = Word2VecModel.load(str(d / "ck"), device="cuda")
        gathered = Word2VecModel(vocab, np.load(d / "gathered_syn0.npy"), device="cuda")
        queries = [f"w{i}" for i in range(0, 4 * MESH_WORDS, 4)]
        for w in queries:
            a, b = served.find_synonyms(w, 10), gathered.find_synonyms(w, 10)
            if [x for x, _ in a] != [x for x, _ in b] or max(
                    abs(s - t) for (_, s), (_, t) in zip(a, b)) > 1e-6:
                raise AssertionError(f"mesh (c): find_synonyms({w!r}) differs")
        del served, gathered
        t0 = time.perf_counter()
        sgd = _mesh_world("data", d, seed)
        rec["data_world_s"] = time.perf_counter() - t0
        fps = sgd[0]["fingerprints"]
        if len(fps) != MESH_SGD_STEPS // 2 or any(a != b for a, b in fps):
            raise AssertionError(f"mesh (b): replicas differ after a merge: {fps}")
        if sgd[0]["sha256"] != sgd[1]["sha256"]:
            raise AssertionError("mesh (b): the replicas' bytes differ at the end")
        # (d) NCCL at a world of one, through the collective interface
        distributed.initialize(init_method=f"file://{d / 'nccl.store'}", num_processes=1,
                               process_id=0, backend="nccl", device="cuda")
        try:
            x = torch.arange(1024, device="cuda", dtype=torch.float32)
            C = distributed.COLLECTIVES
            same = bool(torch.equal(C.all_reduce(x.clone()), x)
                        and torch.equal(C.all_gather(x), x))
            C.barrier()
            nccl = {"backend": torch.distributed.get_backend(), "ok": same}
        finally:
            distributed.shutdown()
        if not same:
            raise AssertionError("mesh (d): NCCL collectives at a world of one differ")
        rec.update(model=model, data=sgd, max_abs_err_vs_single=err, nccl=nccl,
                   synonyms_checked=len(queries))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    hold = max(v["max_abs_err"] for r in model + sgd for v in r["scatter_hold"].values())
    if not hold <= PARAM_ATOL:
        raise AssertionError(f"mesh: scatter kernel vs plain {hold}")
    rec["scatter_hold_max_abs_err"] = hold
    for r in model + sgd:
        log("mesh", f"({'a' if r['case'] == 'model' else 'b'}) rank {r['rank']} at "
            f"(data {r['place'][0]}, model {r['place'][1]}), rows {r['rows']}: "
            f"{r['steps']} steps, {r['step_ms']:.3f} ms a step (dispatch, eager), staging "
            f"{r['staged_s']:.3f} s in {r['staged_calls']} calls = "
            f"{r['staging_share']:.1%} of it; host wait {r['host_wait_s']:.3f} s; "
            f"scatter launches {r['scatter_launches']}, fused {r['fused_launches']}; "
            f"collectives {r['collectives']}; scatter vs plain " + ", ".join(
                f"{m} {h['slots']} slots ({h['live']} live) {h['max_abs_err']:.3g}"
                for m, h in r["scatter_hold"].items()))
    log("mesh", f"(a) sharded vs single-process replay max |diff| {err:.3g} "
        f"(limit {PARAM_ATOL}); (b) {len(fps)} merges, replicas bit-identical; (c) "
        f"{len(queries)} synonym lists equal; (d) NCCL world of one ok; scatter vs plain "
        f"{hold:.3g}; worlds {rec['model_world_s']:.1f} s + {rec['data_world_s']:.1f} s")
    launches = {"mesh_model": sum(r["scatter_launches"] for r in model),
                "mesh_localsgd": sum(r["scatter_launches"] for r in sgd)}
    return rec, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="also write the kernels record here")
    # phase 15's rank processes (mesh_phase starts them)
    ap.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-case", default="", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    repo = Path(__file__).resolve().parent
    if not (repo / "glint_word2vec_torch" / "csrc").is_dir():
        print("chip_smoke.py: glint_word2vec_torch is not beside this script",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.mesh_rank is not None:
        return mesh_rank_main(args)
    sys.path.insert(0, str(repo))
    from glint_word2vec_torch import Vocabulary
    from glint_word2vec_torch import scatterprobe as probe
    from glint_word2vec_torch.ops import fused_sgns as fused
    from glint_word2vec_torch.ops import kernels
    from glint_word2vec_torch.ops import scatter as scat
    from glint_word2vec_torch.ops import sgns
    from glint_word2vec_torch.stepprof import profile_call

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; allow_tf32 "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log("build", f"{kernels.sources()} built in {build_all(kernels):.1f} s "
        f"({' '.join(kernels.NVCC_FLAGS)})")
    rec = kernel_phase(args.seed, torch, sgns, fused, profile_call)
    bf16_rec = bf16_kernel_phase(args.seed, torch, sgns, fused, profile_call)
    t0 = time.perf_counter()
    words, counts, sents = synthetic_corpus(args.seed, N_TOKENS, np)
    corpus = (Vocabulary.from_words_and_counts(words, counts), sents)
    log("fit", f"vocabulary {corpus[0].size} words, corpus {N_TOKENS} tokens in "
        f"{len(sents)} sentences ({time.perf_counter() - t0:.1f} s)")
    srec = scatter_phase(args.seed, corpus, torch, scat, probe, profile_call)
    sbf_rec = bf16_scatter_phase(args.seed, corpus, torch, scat, probe, profile_call)
    srec["max_abs_err"] = max(srec["max_abs_err"], steps_phase(args.seed, torch, sgns,
                                                                  scat))
    brec = banded_phase(args.seed, torch, np, sgns, scat, profile_call)
    stab_rec = stabilizers_phase(args.seed, torch, np, sgns, scat)
    srec["max_abs_err"] = max(srec["max_abs_err"], brec["max_abs_err"],
                              *(r["max_abs_err"] for r in stab_rec.values()))
    feed = feed_phase(corpus, args.seed, np)
    gen = pairgen_phase(corpus, args.seed, torch, np)
    launches = {}
    t0 = time.perf_counter()
    words, counts, bench_sents = synthetic_corpus(args.seed, BENCH_TOKENS, np, BENCH_V,
                                                  BENCH_SHIFT, BENCH_POWER)
    bench_corpus = (Vocabulary.from_words_and_counts(words, counts), bench_sents)
    log("fit", f"V=200k vocabulary {BENCH_V} words, corpus {BENCH_TOKENS} tokens "
        f"({time.perf_counter() - t0:.1f} s)")
    serve_dir = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    serve_ck = str(Path(serve_dir) / "model")
    for name, knobs, pool in FITS + (BENCH_FIT,):
        model, *counts_ = fit_phase(name, knobs, pool,
                                    bench_corpus if knobs is BENCH_KNOBS else corpus,
                                    args.seed, torch, fused, scat, sgns, np,
                                    control=knobs is not BENCH_KNOBS)
        launches[name] = dict(zip(("sgns_shared_step", "scatter_add_rows",
                                   "sgns_shared_step_bf16", "scatter_add_rows_bf16"),
                                  counts_))
        if name == "shared":
            surface = model_phase(model, corpus, torch, np)
            model.save(serve_ck)  # the checkpoint the serving phase serves
            sync_numpy_fit(model, GRAPHS[name]["steps"], corpus, args.seed, torch, fused)
        del model
    del bench_corpus, bench_sents
    runtime, runtime_launches = runtime_phase(corpus, args.seed, torch, np, fused, scat,
                                              profile_call)
    launches.update(runtime_launches)
    try:
        serving, launches["serving_refit"] = serving_phase(
            serve_ck, corpus, args.seed, torch, np, fused, scat)
        t0 = time.perf_counter()
        fleet = fleet_phase(serve_ck, corpus, args.seed, np)
        log("fleet", f"phase 13 in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        continual, launches["continual"], launches["continual_ab"] = continual_phase(
            serve_ck, args.seed, torch, np, fused, scat)
        log("continual", f"phase 14 in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    t0 = time.perf_counter()
    quality, launches["quality"] = quality_phase(args.seed, torch, np, sgns, fused,
                                                 profile_call)
    q_fit, q_sup = quality["fit"]["row"], quality["supervised"]
    log("quality", f"phase 12 in {time.perf_counter() - t0:.1f} s: purity@10 "
        f"{q_fit['purity_at_10']} (floor {Q_PURITY}), margin {q_fit['cosine_margin']} "
        f"(floor {Q_MARGIN}), analogy@1 {q_fit.get('analogy_accuracy_at_1')}; supervised "
        f"{q_sup['verdict']['history']} to step {q_sup['final_step']}, purity@10 "
        f"{q_sup['purity_at_10']}; kernel at the fit's shape {quality['kernel']['ms']:.4f}"
        f" ms a call, {quality['kernel']['device_ms']:.4f} ms on the device, bound "
        f"{quality['kernel']['bound_ms']:.4f} ms")
    t0 = time.perf_counter()
    mesh, mesh_launches = mesh_phase(args.seed, torch, np, sgns)
    for name, n in mesh_launches.items():  # phase 15: the scatter kernel on every rank
        launches[name] = {"sgns_shared_step": 0, "scatter_add_rows": n,
                          "sgns_shared_step_bf16": 0, "scatter_add_rows_bf16": 0}
    srec["max_abs_err"] = max(srec["max_abs_err"], mesh["scatter_hold_max_abs_err"])
    log("mesh", f"phase 15 in {time.perf_counter() - t0:.1f} s")
    by_path = {k: {name: v[k] for name, v in launches.items() if v[k]}
               for k in ("sgns_shared_step", "scatter_add_rows", "sgns_shared_step_bf16",
                         "scatter_add_rows_bf16")}
    for k in ("sgns_shared_step", "scatter_add_rows"):  # the f32 forms' own counts
        by_path[k] = {name: n - launches[name][k + "_bf16"] for name, n in by_path[k].items()
                      if n - launches[name][k + "_bf16"]}
    trio = bf16_rec["trio"]
    kernels_line = {"kernels": [{
        "name": "sgns_shared_step", "route": "cuda", "source": fused.KERNEL_SOURCE,
        "replaces": fused.REPLACES, "launches": sum(by_path["sgns_shared_step"].values()),
        "launches_by_path": by_path["sgns_shared_step"],
        "max_abs_err": max(rec["max_abs_err"], quality["kernel"]["max_abs_err"]),
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        "bound_tc_ms": rec["bound_tc_ms"], "bound_tc_by": rec["bound_tc_by"],
        "device_ms": rec["device_ms"], "l2_cold_ms": rec["l2_cold_ms"],
        "per_launch_us": rec["per_launch_us"],
        "hot_row_max_abs_err": rec["hot_row_max_abs_err"],
        "heavy_draw": rec["heavy_draw"], "quality_shape": quality["kernel"]}, {
        "name": "scatter_add_rows", "route": "cuda", "source": scat.KERNEL_SOURCE,
        "replaces": scat.REPLACES, "launches": sum(by_path["scatter_add_rows"].values()),
        "launches_by_path": by_path["scatter_add_rows"],
        "max_abs_err": srec["max_abs_err"], "ms": srec["ms"],
        "plain_ms": srec["plain_ms"], "bound_ms": srec["bound_ms"],
        "bound_by": srec["bound_by"], "library_ms": srec["library_ms"],
        "device_ms": srec["device_ms"], "library_device_ms": srec["library_device_ms"],
        "ns_per_row": srec["ns_per_row"],
        "cuda_launches_per_call": srec["cuda_launches_per_call"],
        "distinct": srec["distinct"], "most_on_one_row": srec["most_on_one_row"],
        **{k: srec[k] for k in ("probe_shape", "cbow_syn0_shape", "step_syn1_shape",
                                "syn0_centers_shape")}}, {
        "name": "sgns_shared_step_bf16", "route": "cuda", "source": fused.KERNEL_SOURCE,
        "replaces": fused.REPLACES,
        "launches": sum(by_path["sgns_shared_step_bf16"].values()),
        "launches_by_path": by_path["sgns_shared_step_bf16"],
        "max_abs_err": max(r["max_abs_err"] for r in bf16_rec.values()),
        "ms": trio["ms"], "plain_ms": trio["plain_ms"], "bound_ms": trio["bound_ms"],
        "bound_by": trio["bound_by"], "library_ms": None,
        "device_ms": trio["device_ms"], "forms": bf16_rec}, {
        "name": "scatter_add_rows_bf16", "route": "cuda", "source": scat.KERNEL_SOURCE,
        "replaces": scat.REPLACES,
        "launches": sum(by_path["scatter_add_rows_bf16"].values()),
        "launches_by_path": by_path["scatter_add_rows_bf16"],
        **sbf_rec,
        "library_note": "index_add_ on bf16 rounds after every add: another function"}]}
    for k in kernels_line["kernels"]:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: no launch on the main path's fits")
    log("graphs", "per fit (captures, replays, chunks, dispatch_s, idle share): " + "; ".join(
        f"{n} {g['captures']}/{g['replays']}/{g['chunks']} {g['dispatch_s']:.4f} s "
        f"{g['device_idle_share']:.1%}" for n, g in GRAPHS.items()))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**kernels_line, "feed": feed,
                                              "pairgen": gen, "model": surface,
                                              "banded": brec, "stabilizers": stab_rec,
                                              "runtime": runtime,
                                              "serving": serving,
                                              "fleet": fleet,
                                              "continual": continual,
                                              "quality": quality,
                                              "mesh": mesh,
                                              "launches_by_fit": launches,
                                              "graphs": GRAPHS,
                                              "card": card}) + "\n")
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
