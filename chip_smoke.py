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
               a float64 step and the plain version against itself; timed per wrapper
               call (CUDA events, the record's "ms"), and on the device per launch
               (torch.profiler), warm (one batch) and L2-cold (a ring of independently
               drawn batches whose rows exceed the 50 MB L2);
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
  5. steps     one full-width per-pair skip-gram step and one CBOW step (shared pool),
               each run once through the scatter kernel and once through the plain
               scatter on identical inputs, parameters compared;
  6. fits      Word2Vec(vector_size=300, window=5, negatives=5, pairs_per_batch=8192)
               .fit() on one synthetic Zipf corpus over one 1,000,000-word vocabulary,
               four times: skip-gram with the shared pool (the fused kernel), per-pair
               skip-gram (negative_pool=0), CBOW with the shared pool and per-example
               CBOW (negative_pool=0) (the scatter kernel), every kernel's launch
               count set to 0 just before each fit and read just after;
  7. model     save -> verify -> load -> find_synonyms / analogy on the shared-pool
               fit's model, right after that fit.
Then one JSON line with the kernels' numbers, the nvidia-smi line, and the result
line {"ok": true, "device": {...}}. With no CUDA device, or without the package beside
this file, it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
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
SCATTER_RUNS = 25
# Scatter vs float64: the standard bound of recursive f32 summation, (m - 1)·2^-24·Σ|x|
# for a row that takes m updates, computed from each shape's own data (scatter_tol).
EPS32 = 2.0 ** -24
N_TOKENS = 1_200_000  # one corpus for every fit: >= 4 dispatch chunks on each path


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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
    gm = fused.fused_sgns_shared_step(pair(got0, got1), c, x, mask, neg, alpha, N_NEG,
                                      "exact")
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


def kernel_phase(seed: int, torch, sgns, fused, profile_call) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    syn0 = torch.zeros((V, D), device="cuda")
    syn1 = torch.zeros((V, D), device="cuda")
    syn0[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    syn1[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    c, x, mask, neg = shared_batch(gen, torch)
    alpha = 0.025
    worst = {"max_abs_err": 0.0}
    for mode in ("exact", "clipped"):
        want, wm = sgns.sgns_step_shared_core(
            sgns.EmbeddingPair(syn0, syn1), c, x, mask, neg, alpha, N_NEG, mode)
        got0, got1 = syn0.clone(), syn1.clone()
        gm = fused.fused_sgns_shared_step(sgns.EmbeddingPair(got0, got1), c, x, mask,
                                          neg, alpha, N_NEG, mode)
        torch.cuda.synchronize()
        err0 = float((got0 - want.syn0).abs().max())
        err1 = float((got1 - want.syn1).abs().max())
        moved = float((want.syn0 - syn0).abs().max())
        rel0 = err0 / max(float(want.syn0.abs().max()), 1e-30)
        rel1 = err1 / max(float(want.syn1.abs().max()), 1e-30)
        loss_rel = abs(float(gm.loss) - float(wm.loss)) / abs(float(wm.loss))
        fpos_err = abs(float(gm.mean_f_pos) - float(wm.mean_f_pos))
        log("kernel", f"sigmoid={mode}: max_abs_err syn0={err0:.3e} syn1={err1:.3e} "
            f"max_rel_err syn0={rel0:.3e} syn1={rel1:.3e} loss={float(gm.loss):.6f} "
            f"plain_loss={float(wm.loss):.6f} loss_rel_err={loss_rel:.3e} "
            f"mean_f_pos_err={fpos_err:.3e} (largest update {moved:.3e})")
        bad = [name for name, ok in (
            ("syn0", err0 <= PARAM_ATOL), ("syn1", err1 <= PARAM_ATOL),
            ("loss", loss_rel <= LOSS_RTOL), ("moved", moved > 1e-3),
            ("finite", math.isfinite(float(gm.loss)))) if not ok]
        if bad:
            raise AssertionError(f"kernel disagrees with the plain version ({mode}): "
                                 f"{bad}; tolerance atol {PARAM_ATOL}, loss rtol "
                                 f"{LOSS_RTOL}")
        worst["max_abs_err"] = max(worst["max_abs_err"], err0, err1)
        del want, got0, got1
    hot = f64_case(f"hot row (centers on row {HOT_CENTER}, pool on row {HOT_POOL})",
                   syn0, syn1, torch.where(mask > 0, HOT_CENTER, 0).to(torch.int64), x,
                   mask, torch.full((P,), HOT_POOL, dtype=torch.int64, device="cuda"),
                   torch, sgns, fused)
    heavy = f64_case(f"heavy draw (Zipf 1.3 over V={HEAVY_V}, parameters of scale 0.5)",
                     *heavy_draw(gen, mask, torch), torch, sgns, fused)
    params = sgns.EmbeddingPair(syn0, syn1)

    def step():
        fused.fused_sgns_shared_step(params, c, x, mask, neg, alpha, N_NEG, "exact")

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
        fused.fused_sgns_shared_step(params, cb, xb, mb, nb, alpha, N_NEG, "exact")

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


def scatter_phase(seed: int, corpus, torch, scat, probe, profile_call) -> dict:
    """The TPU probe's shape, then the per-pair step's syn1 scatter and the CBOW
    steps' syn0 context scatter at full width; then the traffic a per-pair step really
    sends: syn1 with its negatives from the port's alias sampler, and syn0 with the
    centers of one batch of the smoke's own per-pair feed."""
    from glint_word2vec_torch.data.pipeline import encode_sentences

    def case(name, target, idx, upd, live):
        return scatter_case(name, target, idx, upd, live, torch, scat, probe,
                            profile_call)

    idxs, x = probe.zipf_head_draw(2048, D, 65536, sets=1)
    idx = torch.from_numpy(idxs[0]).cuda()
    rec_probe = case("probe shape", torch.zeros((2048, D), device="cuda"), idx,
                     torch.from_numpy(x).cuda(), None)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    N = B * (1 + N_NEG)
    target = torch.randn((V, D), generator=gen, device="cuda") * 0.35
    idx = zipf_ids(gen, N, V, 1.1, torch)
    live = (torch.rand(N, generator=gen, device="cuda") >= 0.1).float()
    idx[live == 0] = 0                     # dead slots point at the hottest row
    upd = torch.randn((N, D), generator=gen, device="cuda") * 1e-2 * live[:, None]
    rec = case("per-pair syn1 shape", target, idx, upd, live)
    del idx, upd, live
    (syn0, _), (_, ctx, ctx_mask, mask, _) = step_inputs(seed, torch, cbow=True)
    live = (ctx_mask * mask[:, None]).reshape(-1)  # dead slots carry index 0
    idx = ctx.reshape(-1)
    upd = torch.randn((idx.numel(), D), generator=gen, device="cuda") * 1e-2 * live[:, None]
    rec_cbow = case("CBOW syn0 context shape", syn0, idx, upd, live)
    dead_share = float(1.0 - live.mean())
    del syn0, idx, upd, live
    vocab, sents = corpus
    idx, live = probe.step_syn1_draw(gen, vocab.counts, seed)
    upd = torch.randn((idx.numel(), D), generator=gen, device="cuda") * 1e-2 * live[:, None]
    rec_step = case("per-pair syn1, step draw (alias negatives)", target, idx, upd, live)
    encoded = encode_sentences(sents, vocab)
    idx, live = probe.feed_centers(encoded, vocab, seed, "cuda")
    upd = torch.randn((idx.numel(), D), generator=gen, device="cuda") * 1e-2 * live[:, None]
    rec_centers = case("per-pair syn0 centers (one feed batch)", target, idx, upd, live)
    del target
    others = {"probe_shape": rec_probe, "cbow_syn0_shape": rec_cbow,
              "step_syn1_shape": rec_step, "syn0_centers_shape": rec_centers}
    keys = ("ms", "device_ms", "cuda_launches_per_call", "library_ms",
            "library_device_ms", "bound_ms", "ns_per_row", "max_abs_err",
            "max_abs_err_f64", "tolerance", "distinct", "most_on_one_row")
    rec["max_abs_err"] = max(r["max_abs_err"] for r in (rec, *others.values()))
    for name, r in others.items():
        rec[name] = {k: r[k] for k in keys}
    rec["cbow_syn0_shape"]["dead_share"] = dead_share
    return rec


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


def synthetic_corpus(seed: int, n_tokens: int, np):
    """Words w0..w{V-1} with Zipf(1) counts, and sentences of 40 tokens drawn from
    that distribution."""
    rng = np.random.default_rng(seed)
    counts = (1e9 / np.arange(1, V + 1)).astype(np.int64) + 1
    words = [f"w{i}" for i in range(V)]
    ids = rng.choice(V, size=n_tokens, p=counts / counts.sum())
    toks = [words[i] for i in ids]
    sents = [toks[i:i + 40] for i in range(0, n_tokens, 40)]
    return words, counts, sents


FITS = (  # (name, config knobs, pool the trainer must resolve)
    ("shared", {}, 256),
    ("per_pair", {"negative_pool": 0}, 0),
    ("cbow", {"cbow": True}, 256),
    ("cbow_per_example", {"cbow": True, "negative_pool": 0}, 0),
)


def fit_phase(name: str, knobs: dict, pool: int, corpus, seed: int, torch, fused,
              scat, sgns):
    """One fit through the estimator; the kernel counts are set to 0 just before it
    and read just after. Returns (model, fused launches, scatter launches)."""
    from glint_word2vec_torch import Word2Vec

    vocab, sents = corpus
    est = Word2Vec(vector_size=D_REAL, window=WINDOW, negatives=N_NEG,
                   pairs_per_batch=B, min_count=1, heartbeat_every_steps=16, seed=seed,
                   device="cuda", **knobs)
    fused.fused_sgns_shared_step.launches = 0
    scat.scatter_add_rows_.launches = 0
    t0 = time.perf_counter()
    model = est.fit(sents, vocab=vocab)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_fused = fused.fused_sgns_shared_step.launches
    n_scat = scat.scatter_add_rows_.launches
    tr = est.trainer
    hb = list(tr.heartbeats)
    loss = hb[-1].loss if hb else float("nan")
    unit = "examples" if tr.config.cbow else "pairs"
    log("fit", f"{name}: pool {tr.config.negative_pool}, subsample "
        f"{tr.config.subsample_ratio:g}, steps {tr.global_step} "
        f"({-(-tr.global_step // tr.config.steps_per_dispatch)} chunks), {unit} "
        f"{tr.pairs_trained:.0f}, launches: sgns_shared {n_fused}, scatter_rows {n_scat}; "
        f"fit wall {wall:.2f} s (setup included), {unit}/s over the fit "
        f"{tr.pairs_trained / wall:.0f}, heartbeat {unit}/s "
        f"{[round(h.pairs_per_sec) for h in hb]}, losses {[round(h.loss, 5) for h in hb]}")
    steps = tr.global_step
    shared = name == "shared"
    checks = {f"pool == {pool}": tr.config.negative_pool == pool,
              "steps >= 4 chunks": steps > 3 * tr.config.steps_per_dispatch,
              "sgns_shared launches": n_fused == (steps if shared else 0),
              "scatter_rows launches": n_scat == (0 if shared
                                                  else steps * sgns.SCATTERS_PER_STEP),
              "loss finite": math.isfinite(loss),
              "params finite": bool(torch.isfinite(model.syn0).all())}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"fit {name} failed: {bad}")
    return model, n_fused, n_scat


def model_phase(model, torch, np) -> None:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="also write the kernels record here")
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
    t0 = time.perf_counter()
    words, counts, sents = synthetic_corpus(args.seed, N_TOKENS, np)
    corpus = (Vocabulary.from_words_and_counts(words, counts), sents)
    log("fit", f"vocabulary {corpus[0].size} words, corpus {N_TOKENS} tokens in "
        f"{len(sents)} sentences ({time.perf_counter() - t0:.1f} s)")
    srec = scatter_phase(args.seed, corpus, torch, scat, probe, profile_call)
    srec["max_abs_err"] = max(srec["max_abs_err"], steps_phase(args.seed, torch, sgns,
                                                                  scat))
    launches = {}
    for name, knobs, pool in FITS:
        model, n_fused, n_scat = fit_phase(
            name, knobs, pool, corpus, args.seed, torch, fused, scat, sgns)
        launches[name] = {"sgns_shared_step": n_fused, "scatter_add_rows": n_scat}
        if name == "shared":
            model_phase(model, torch, np)
        del model
    by_path = {k: {name: v[k] for name, v in launches.items() if v[k]}
               for k in ("sgns_shared_step", "scatter_add_rows")}
    kernels_line = {"kernels": [{
        "name": "sgns_shared_step", "route": "cuda", "source": fused.KERNEL_SOURCE,
        "replaces": fused.REPLACES, "launches": sum(by_path["sgns_shared_step"].values()),
        "launches_by_path": by_path["sgns_shared_step"],
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        "bound_tc_ms": rec["bound_tc_ms"], "bound_tc_by": rec["bound_tc_by"],
        "device_ms": rec["device_ms"], "l2_cold_ms": rec["l2_cold_ms"],
        "per_launch_us": rec["per_launch_us"],
        "hot_row_max_abs_err": rec["hot_row_max_abs_err"],
        "heavy_draw": rec["heavy_draw"]}, {
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
                                "syn0_centers_shape")}}]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**kernels_line, "card": card}) + "\n")
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
