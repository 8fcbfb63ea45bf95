#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (glint_word2vec_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out FILE]

Phases, one line each; any failure exits non-zero:
  1. card      nvidia-smi name and power limit, torch/CUDA versions, TF32 off;
  2. build     every kernel in glint_word2vec_torch/csrc/, nvcc runs started together;
  3. kernel    the fused shared-pool SGNS step against its plain PyTorch version at the
               main shape (V=1,000,000, D=300 padded to 384, B=8192, P=256, Zipf
               duplicates, a masked tail, both sigmoid modes), then timed;
  4. main      Word2Vec(vector_size=300, window=5, negatives=5, pairs_per_batch=8192)
               .fit() on a synthetic Zipf corpus over a 1,000,000-word vocabulary,
               with the kernel launch count read around the fit;
  5. model     save -> verify -> load -> find_synonyms / analogy.
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
# cores and HBM3 bandwidth. The bound below is computed against them.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

V, D_REAL, B, N_NEG = 1_000_000, 300, 8192, 5
MASKED_TAIL = 1000
# Kernel vs plain: |kernel - plain| <= 1e-4 on parameters of scale ~0.35 and 1e-4
# relative on the loss. The kernel sums a row's duplicate updates with fp32 atomics in
# a run-dependent order and its products in another order than cuBLAS; the hottest
# row takes ~800 summed updates per step, whose reordering moves the sum by ~1e-5.
PARAM_ATOL = 1e-4
LOSS_RTOL = 1e-4
TIMED_STEPS = 30


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
    written once, indices and mask read once; 6·B_real·P·D flops for the three
    products (E·Zᵀ, G·Z, Gᵀ·E) over the real pairs."""
    real = mask > 0
    u0 = int(torch.unique(c[real]).numel())
    u1 = int(torch.unique(torch.cat([x[real], neg])).numel())
    b_real, P = int(real.sum()), neg.numel()
    bytes_ = 2 * (u0 + u1) * D * 4 + c.numel() * (8 + 8 + 4) + P * 8
    flops = 6 * b_real * P * D
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": bytes_, "flops": flops}


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


def kernel_phase(seed: int, torch, sgns, fused) -> dict:
    P = 256
    D = 384
    gen = torch.Generator(device="cuda").manual_seed(seed)
    syn0 = torch.zeros((V, D), device="cuda")
    syn1 = torch.zeros((V, D), device="cuda")
    syn0[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    syn1[:, :D_REAL] = torch.randn((V, D_REAL), generator=gen, device="cuda") * 0.35
    c = zipf_ids(gen, B, V, 1.1, torch)
    x = zipf_ids(gen, B, V, 1.1, torch)
    neg = zipf_ids(gen, P, V, 1.1, torch)
    neg[:16] = x[:16]                       # pool entries equal to positives
    mask = torch.ones(B, device="cuda")
    mask[-MASKED_TAIL:] = 0.0
    c[-MASKED_TAIL:] = 0
    x[-MASKED_TAIL:] = 0
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
    params = sgns.EmbeddingPair(syn0, syn1)
    ms = time_steps(lambda: fused.fused_sgns_shared_step(
        params, c, x, mask, neg, alpha, N_NEG, "exact"), TIMED_STEPS, torch)
    plain_ms = time_steps(lambda: sgns.sgns_step_shared_core(
        params, c, x, mask, neg, alpha, N_NEG, "exact"), TIMED_STEPS, torch)
    bound = step_bound(c, x, neg, mask, D, torch)
    log("kernel", f"B={B} P={P} D={D} V={V}: kernel {ms:.4f} ms (median of "
        f"{TIMED_STEPS}), plain {plain_ms:.4f} ms, bound {1e3 * bound['bound_ms']:.1f} us "
        f"({bound['bound_by']}: {bound['flops'] / 1e9:.3f} GFLOP, "
        f"{bound['bytes'] / 1e6:.1f} MB), library_ms: none")
    return {"max_abs_err": worst["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


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


def main_path_phase(seed: int, torch, np, fused):
    from glint_word2vec_torch import Vocabulary, Word2Vec

    t0 = time.perf_counter()
    words, counts, sents = synthetic_corpus(seed, 400_000, np)
    vocab = Vocabulary.from_words_and_counts(words, counts)
    log("main", f"vocabulary {vocab.size} words, corpus {sum(map(len, sents))} tokens "
        f"in {len(sents)} sentences ({time.perf_counter() - t0:.1f} s)")
    est = Word2Vec(vector_size=300, window=5, negatives=5, pairs_per_batch=8192,
                   min_count=1, heartbeat_every_steps=16, seed=seed, device="cuda")
    fused.fused_sgns_shared_step.launches = 0
    t0 = time.perf_counter()
    model = est.fit(sents, vocab=vocab)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused.fused_sgns_shared_step.launches
    tr = est.trainer
    hb = list(tr.heartbeats)
    loss = hb[-1].loss if hb else float("nan")
    log("main", f"pool {tr.config.negative_pool}, subsample {tr.config.subsample_ratio:g}, "
        f"steps {tr.global_step}, pairs {tr.pairs_trained:.0f}, kernel launches "
        f"{launches}, fit wall {wall:.2f} s (setup included), heartbeat pairs/s "
        f"{[round(h.pairs_per_sec) for h in hb]}, losses "
        f"{[round(h.loss, 5) for h in hb]}")
    checks = {"pool == 256": tr.config.negative_pool == 256,
              "steps >= 64": tr.global_step >= 64,
              "launches == steps": launches == tr.global_step,
              "loss finite": math.isfinite(loss),
              "params finite": bool(torch.isfinite(model.syn0).all())}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"main path failed: {bad}")
    return model, launches


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
    from glint_word2vec_torch.ops import fused_sgns as fused
    from glint_word2vec_torch.ops import kernels
    from glint_word2vec_torch.ops import sgns

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; allow_tf32 "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log("build", f"{kernels.sources()} built in {build_all(kernels):.1f} s "
        f"({' '.join(kernels.NVCC_FLAGS)})")
    rec = kernel_phase(args.seed, torch, sgns, fused)
    model, launches = main_path_phase(args.seed, torch, np, fused)
    model_phase(model, torch, np)
    kernels_line = {"kernels": [{
        "name": "sgns_shared_step", "route": "cuda", "source": fused.KERNEL_SOURCE,
        "replaces": fused.REPLACES, "launches": launches,
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None}]}
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
