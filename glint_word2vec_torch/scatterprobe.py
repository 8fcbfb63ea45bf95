"""Measure the row scatter-add rate of the port's CUDA kernel on one NVIDIA GPU.

    python -m glint_word2vec_torch.scatterprobe [--h 2048] [--d 384] [--b 65536]
        [--repeats 5] [--out FILE]
    python -m glint_word2vec_torch.scatterprobe --variants [--seed N] [--out FILE]
    python -m glint_word2vec_torch.scatterprobe --hot-head [--repeats 5]

The port of the TPU probe ``tools/pallas_vmem_scatter.py`` (its ``main``): B update
rows of width D, with Zipf-hot indices into an [H, D] target, are added to their
targets, ``out[idx[i]] += x[i]``. The draw is the probe's: ``default_rng(0)``,
p ∝ (i + 10)^-1.07 over the H rows, 8 index sets, x ~ N(0, 1)·1e-3.

It times ``scatter_add_rows_`` (the kernel) and ``index_add_`` (the PyTorch call that
computes the same function) with CUDA events, ``--repeats`` times over the 8 index
sets, and prints ms per B rows, ns per row and the least time the card could take: the
update rows read once, each distinct target row read and written once, the indices read
once, over the H100's 3.35 TB/s. Then one JSON line.

``--variants`` asks what bounds a scatter that adds one update row at a time with
atomics. It builds ``csrc/probes/scatter_bound.cu`` (the port's first scatter kernel,
one warp per update row and a vector ``atomicAdd`` per 16 bytes, and four variants of
its loop that write plainly, or into distinct rows) and times each, with the current
kernel, both of its paths forced (``grouped``: four launches; ``one_launch``) and
``index_add_``, at five shapes of the model's full width (D=384): the probe shape, the
per-pair step's syn1 scatter as ``chip_smoke.py`` draws it (49152 Zipf 1.1 rows into
1M, a tenth dead), the same step with its negatives drawn by the port's alias sampler
(:func:`step_syn1_draw`), the CBOW steps' syn0 context scatter (81920 slots, about two
thirds dead) and the per-pair step's syn0 scatter of one feed batch's centers
(:func:`feed_centers`); then the step draw cut to the sizes of ``SWEEP``, and the
probe's 65536 slots drawn into the row counts of ``RATIO_SWEEP``, where the two paths
cross. Times are medians of CUDA events around runs of back-to-back calls;
each path's and ``index_add_``'s device time per call is read from torch.profiler.

``--hot-head`` reads how far each path and ``index_add_`` land from a float64 sum when
all 65536 slots fall on one row (:func:`hot_head_draw`), over ``--repeats`` runs.

It needs a CUDA device and exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from glint_word2vec_torch.ops.scatter import check_errors, scatter_add_rows_

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# the model's full width, as chip_smoke.py and stepprof.py drive it
V_FULL, D_FULL, B_FULL, N_NEG, WINDOW, MASKED_TAIL = 1_000_000, 384, 8192, 5, 5, 1000
VARIANTS = ("atomic", "plain_store", "load_add_store", "distinct_atomic",
            "distinct_store")  # probe modes 0-4 of csrc/probes/scatter_bound.cu
VARIANT_SHAPES = ("probe", "per_pair_syn1", "step_syn1", "cbow_syn0", "syn0_centers")
SWEEP = (4096, 16384, 24576, 32768)  # --variants: prefixes of the step draw
RATIO_SWEEP = (4096, 8192, 16384, 65536)  # --variants: target rows of the probe's draw


def zipf_head_draw(H: int, D: int, B: int, sets: int = 8, seed: int = 0):
    """The probe's index sets and update rows, as numpy arrays."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(H) + 10.0) ** 1.07
    p /= p.sum()
    idxs = [rng.choice(H, size=B, p=p) for _ in range(sets)]
    x = rng.standard_normal((B, D), np.float32) * np.float32(1e-3)
    return idxs, x


def bound_bytes(idx: torch.Tensor, D: int, live: Optional[torch.Tensor] = None,
                elem: int = 4) -> int:
    """Bytes the scatter must move: the live update rows and their indices in, each
    distinct live target row in and out, the live mask (when there is one) in; rows
    and updates of ``elem`` bytes an element (4: f32, 2: bf16)."""
    if live is None:
        return (idx.numel() * (8 + D * elem)
                + 2 * int(torch.unique(idx).numel()) * D * elem)
    keep = live != 0
    n_live, u = int(keep.sum()), int(torch.unique(idx[keep]).numel())
    return idx.numel() * 4 + n_live * (8 + D * elem) + 2 * u * D * elem


def zipf_ids(gen: torch.Generator, n: int, vocab: int, a: float) -> torch.Tensor:
    """Zipf(a) draws folded into [0, vocab), on the generator's device (the draw of
    ``chip_smoke.py``)."""
    u = torch.rand(n, generator=gen, device=gen.device, dtype=torch.float64)
    r = torch.floor((1.0 - u) ** (-1.0 / (a - 1.0)))
    return ((r - 1) % vocab).to(torch.int64)


def zipf_counts(V: int) -> np.ndarray:
    """Zipf(1) word counts over V words (the synthetic corpus of the chip scripts)."""
    return (1e9 / np.arange(1, V + 1)).astype(np.int64) + 1


def step_syn1_draw(gen: torch.Generator, counts: np.ndarray, seed: int):
    """(idx, live) of the per-pair step's syn1 scatter on a step's own draw: B contexts
    from the folded Zipf 1.1 with a masked tail of index 0, then B x n negatives from
    the port's alias sampler over ``counts`` at power 0.75, live where they differ from
    their pair's context (``neg_valid`` of ``ops.sgns.sgns_step_core``)."""
    from glint_word2vec_torch.ops.sampler import build_alias_table, sample_negatives_hash

    V = counts.shape[0]
    x = zipf_ids(gen, B_FULL, V, 1.1)
    mask = torch.ones(B_FULL, device=x.device)
    mask[-MASKED_TAIL:] = 0.0
    x[-MASKED_TAIL:] = 0
    table = build_alias_table(counts, 0.75)
    neg = sample_negatives_hash(torch.from_numpy(table.prob).to(x.device),
                                torch.from_numpy(table.alias.astype(np.int64)).to(x.device),
                                seed, 1, (B_FULL, N_NEG))
    neg_valid = (neg != x[:, None]).to(torch.float32) * mask[:, None]
    return torch.cat([x, neg.reshape(-1)]), torch.cat([mask, neg_valid.reshape(-1)])


def feed_centers(sentences, vocab, seed: int, device):
    """(idx, live) of the per-pair step's syn0 scatter on the first batch of the
    per-pair feed over ``sentences`` (encoded): its centers, in runs of one center per
    context, and its mask. The subsample ratio is the one a per-pair trainer resolves."""
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import epoch_batches
    from glint_word2vec_torch.train.trainer import Trainer

    cfg = Word2VecConfig(vector_size=300, window=WINDOW, negatives=N_NEG,
                         pairs_per_batch=B_FULL, min_count=1, seed=seed, negative_pool=0)
    # only the resolved config is read; a 1 x 1 placeholder spares the random init
    placeholder = np.zeros((1, 1), np.float32)
    ratio = Trainer(cfg, vocab, params=(placeholder, placeholder),
                    device=device).config.subsample_ratio
    batch = next(iter(epoch_batches(sentences, vocab, pairs_per_batch=B_FULL,
                                    window=WINDOW, subsample_ratio=ratio, seed=seed)))
    return (torch.from_numpy(batch.centers).to(device).long(),
            torch.from_numpy(batch.mask).to(device))


def time_ms(fn, n: int) -> float:
    """ms per call of ``fn(i)`` over ``n`` calls, CUDA events around the whole run."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def probe_main(args) -> dict:
    H, D, B = args.h, args.d, args.b
    idxs_np, x_np = zipf_head_draw(H, D, B)
    idxs = [torch.from_numpy(i).cuda() for i in idxs_np]
    x = torch.from_numpy(x_np).cuda()
    out = torch.zeros((H, D), device="cuda")

    want = torch.zeros((H, D), device="cuda").index_add_(0, idxs[0], x)
    got = scatter_add_rows_(torch.zeros((H, D), device="cuda"), idxs[0], x)
    check_errors()
    err = float((got - want).abs().max())

    def kernel(i):
        scatter_add_rows_(out, idxs[i % 8], x)

    def library(i):
        out.index_add_(0, idxs[i % 8], x)

    for fn in (kernel, library):  # warm-up (and the kernel's first-call build)
        time_ms(fn, 8)
    rows = {"kernel": [], "index_add_": []}
    for _ in range(args.repeats):
        rows["kernel"].append(time_ms(kernel, 8))
        rows["index_add_"].append(time_ms(library, 8))
    check_errors()
    bound_ms = 1e3 * np.mean([bound_bytes(i, D) for i in idxs]) / PEAK_BYTES_PER_S
    rec = {"H": H, "D": D, "B": B, "max_abs_err_vs_index_add": err, "bound_ms": bound_ms}
    for name, ts in rows.items():
        med = float(np.median(ts))
        print(f"{name:>10} scatter-apply: {med:7.4f} ms per {B} rows -> "
              f"{med / B * 1e6:6.3f} ns/row  [{min(ts) / B * 1e6:.3f} .. "
              f"{max(ts) / B * 1e6:.3f}]")
        rec[f"{name}_ms"] = med
        rec[f"{name}_ms_all"] = ts
    print(f"     bound: {bound_ms:7.4f} ms per {B} rows -> {bound_ms / B * 1e6:6.3f} "
          f"ns/row (bytes at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s); kernel vs index_add_ "
          f"max abs err {err:.3e}")
    return rec


def variant_shapes(seed: int) -> dict:
    """name -> (target rows, idx, live or None) of the five shapes of ``--variants``."""
    from glint_word2vec_torch.data.vocab import Vocabulary

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = {"probe": (2048, torch.from_numpy(zipf_head_draw(2048, D_FULL, 65536,
                                                              sets=1)[0][0]).cuda(), None)}
    n = B_FULL * (1 + N_NEG)
    idx = zipf_ids(gen, n, V_FULL, 1.1)
    live = (torch.rand(n, generator=gen, device="cuda") >= 0.1).float()
    idx[live == 0] = 0
    shapes["per_pair_syn1"] = (V_FULL, idx, live)
    counts = zipf_counts(V_FULL)
    shapes["step_syn1"] = (V_FULL, *step_syn1_draw(gen, counts, seed))
    b = torch.randint(1, WINDOW, (B_FULL,), generator=gen, device="cuda")
    nctx = 2 * b - 1
    nctx[-MASKED_TAIL:] = 0
    ctx_mask = (torch.arange(2 * WINDOW, device="cuda")[None, :] < nctx[:, None]).float()
    ctx = zipf_ids(gen, B_FULL * 2 * WINDOW, V_FULL, 1.1).view(B_FULL, -1) * ctx_mask.long()
    shapes["cbow_syn0"] = (V_FULL, ctx.reshape(-1), ctx_mask.reshape(-1))
    rng = np.random.default_rng(seed)
    tokens = rng.choice(V_FULL, size=200_000, p=counts / counts.sum()).astype(np.int32)
    vocab = Vocabulary.from_words_and_counts([f"w{i}" for i in range(V_FULL)], counts)
    sentences = [tokens[i:i + 40] for i in range(0, tokens.size, 40)]
    shapes["syn0_centers"] = (V_FULL, *feed_centers(sentences, vocab, seed, "cuda"))
    return shapes


def hot_head_draw(n: int = 65536, seed: int = 17):
    """(base [2048, 384], idx [n], upd [n, 384]) as numpy: every slot on row 3, updates
    N(0, 1e-3) onto a target N(0, 0.5) (the hot-head test of test_torch_kernel.py)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 0.5, (2048, D_FULL)).astype(np.float32)
    upd = rng.normal(0, 1e-3, (n, D_FULL)).astype(np.float32)
    return base, np.full(n, 3, np.int64), upd


def _forced(ratio: int):
    """The kernel with its path forced: GROUP_RATIO set for the length of one call."""
    from glint_word2vec_torch.ops import scatter

    def call(target, idx, upd, live):
        keep, scatter.GROUP_RATIO = scatter.GROUP_RATIO, ratio
        try:
            return scatter_add_rows_(target, idx, upd, live)
        finally:
            scatter.GROUP_RATIO = keep
    return call


PATHS = {"kernel": scatter_add_rows_, "grouped": _forced(0),
         "one_launch": _forced(1 << 40)}


def hot_head_main(args) -> dict:
    """Distance from float64 of each path and of index_add_ on :func:`hot_head_draw`,
    over ``--repeats`` runs: the readings the hot-head test's limit is set from."""
    base_np, idx_np, upd_np = hot_head_draw()
    base, idx, upd = (torch.from_numpy(a).cuda() for a in (base_np, idx_np, upd_np))
    sum64 = upd.double().sum(0)
    want = base.double()
    want[3] += sum64
    paths = {**{k: v for k, v in PATHS.items() if k != "kernel"},
             "index_add_": lambda t, i, u, _: t.index_add_(0, i, u)}
    rec = {name: {"f64": [], "moved": []} for name in paths}
    for _ in range(args.repeats):
        for name, fn in paths.items():
            got = fn(base.clone(), idx, upd, None)
            check_errors()
            rec[name]["f64"].append(float((got.double() - want).abs().max()))
            rec[name]["moved"].append(
                float(((got[3].double() - base[3].double()) - sum64).abs().max()))
    for name, r in rec.items():
        print(f"hot head, {name}: max |got - f64| {max(r['f64']):.3e} (runs "
              f"{', '.join(f'{x:.3e}' for x in r['f64'])}); max |moved - f64 sum| "
              f"{max(r['moved']):.3e}")
    return {"hot_head": rec}


def variants_main(args) -> dict:
    from glint_word2vec_torch.ops import kernels
    from glint_word2vec_torch.stepprof import profile_call

    lib = kernels.load("probes/scatter_bound")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    shapes = variant_shapes(args.seed)
    _, step_idx, step_live = shapes["step_syn1"]
    for n in SWEEP:  # the step draw cut to n slots
        shapes[f"step_syn1_first{n}"] = (V_FULL, step_idx[:n].clone(), step_live[:n].clone())
    for h in RATIO_SWEEP:  # the probe's draw into h rows: where the two paths cross
        shapes[f"probe_into{h}"] = (h, torch.from_numpy(
            zipf_head_draw(h, D_FULL, 65536, sets=1)[0][0]).cuda(), None)
    rec = {}
    for name, (rows, idx, live) in shapes.items():
        N = idx.numel()
        upd = torch.randn((N, D_FULL), generator=gen, device="cuda") * 1e-2
        if live is not None:
            upd *= live[:, None]
        target = torch.randn((rows, D_FULL), generator=gen, device="cuda") * 0.35
        fns = {}
        if name in VARIANT_SHAPES:
            sink = torch.empty((N, D_FULL), device="cuda")
            live_ptr = live.data_ptr() if live is not None else None
            for mode, variant in enumerate(VARIANTS):
                def fn(_, mode=mode):
                    err = lib.glint_scatter_probe(mode, target.data_ptr(), idx.data_ptr(),
                                                  upd.data_ptr(), live_ptr, sink.data_ptr(),
                                                  N, D_FULL, stream)
                    if err != 0:
                        raise RuntimeError(f"probe mode {mode} failed: cudaError {err}")
                fns[variant] = fn
        for path, call in PATHS.items():
            fns[path] = lambda _, call=call: call(target, idx, upd, live)
        fns["index_add_"] = lambda _: target.index_add_(0, idx, upd)
        for fn in fns.values():
            time_ms(fn, 3)
        times = {k: [] for k in fns}
        for _ in range(args.repeats):
            for k, fn in fns.items():
                times[k].append(time_ms(fn, 10))
        check_errors()
        med = {k: float(np.median(v)) for k, v in times.items()}
        launches_us = {}
        for k in (*PATHS, "index_add_"):  # device ms per call, from the profiler
            dev = profile_call(lambda k=k: fns[k](0), 20)
            med[f"{k}_device"] = sum(v["us_total"] for v in dev.values()) / 20 / 1e3
            launches_us[k] = {kk: v["us_total"] / 20 for kk, v in dev.items()}
        n_live = N if live is None else int((live != 0).sum())
        keep = idx if live is None else idx[live != 0]
        bound = 1e3 * bound_bytes(idx, D_FULL, live) / PEAK_BYTES_PER_S
        rec[name] = {"rows": rows, "N": N, "live": n_live,
                     "distinct": int(torch.unique(keep).numel()),
                     "most_on_one_row": int(torch.bincount(keep).max()),
                     "bound_ms": bound, "ms": med, "launches_us": launches_us}
        print(f"{name}: N={N} live={n_live} into {rows} rows, distinct "
              f"{rec[name]['distinct']}, most on one row {rec[name]['most_on_one_row']}; "
              f"bound {bound:.4f} ms; " + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
              + " ms")
        del target, upd
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=int, default=2048)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--b", type=int, default=65536)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--hot-head", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scatterprobe: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({card})")
    rec = {"device": torch.cuda.get_device_name(0), "card": card,
           **(variants_main(args) if args.variants
              else hot_head_main(args) if args.hot_head else probe_main(args))}
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
