"""Measure the row scatter-add rate of the port's CUDA kernel on one NVIDIA GPU.

    python -m glint_word2vec_torch.scatterprobe [--h 2048] [--d 384] [--b 65536]
        [--tile 32] [--repeats 5] [--out FILE]

The port of the TPU probe ``tools/pallas_vmem_scatter.py`` (its ``main``): B update
rows of width D, with Zipf-hot indices into an [H, D] target, are added to their
targets, ``out[idx[i]] += x[i]``. The draw is the probe's: ``default_rng(0)``,
p ∝ (i + 10)^-1.07 over the H rows, 8 index sets, x ~ N(0, 1)·1e-3. ``--tile`` is the
kernel's update rows per CUDA block (the probe's tile was the rows per grid step).

It times ``scatter_add_rows_`` (the kernel) and ``index_add_`` (the PyTorch call that
computes the same function) with CUDA events, ``--repeats`` times over the 8 index
sets, and prints ms per B rows, ns per row and the least time the card could take: the
update rows read once, each distinct target row read and written once, the indices read
once, over the H100's 3.35 TB/s. Then one JSON line. It needs a CUDA device and exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from glint_word2vec_torch.ops.scatter import (
    ROWS_PER_BLOCK, check_errors, scatter_add_rows_)

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def zipf_head_draw(H: int, D: int, B: int, sets: int = 8, seed: int = 0):
    """The probe's index sets and update rows, as numpy arrays."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(H) + 10.0) ** 1.07
    p /= p.sum()
    idxs = [rng.choice(H, size=B, p=p) for _ in range(sets)]
    x = rng.standard_normal((B, D), np.float32) * np.float32(1e-3)
    return idxs, x


def bound_bytes(idx: torch.Tensor, D: int, live: Optional[torch.Tensor] = None) -> int:
    """Bytes the scatter must move: the live update rows and their indices in, each
    distinct live target row in and out, the live mask (when there is one) in."""
    if live is None:
        return idx.numel() * (8 + D * 4) + 2 * int(torch.unique(idx).numel()) * D * 4
    keep = live != 0
    n_live, u = int(keep.sum()), int(torch.unique(idx[keep]).numel())
    return idx.numel() * 4 + n_live * (8 + D * 4) + 2 * u * D * 4


def time_ms(fn, n: int) -> float:
    """ms per call of ``fn(i)`` over ``n`` calls, CUDA events around the whole run."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=int, default=2048)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--b", type=int, default=65536)
    ap.add_argument("--tile", type=int, default=ROWS_PER_BLOCK)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scatterprobe: no CUDA device", file=sys.stderr)
        return 2
    H, D, B, T = args.h, args.d, args.b, args.tile
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} ({card})  H={H} D={D} B={B} "
          f"tile={T}")
    idxs_np, x_np = zipf_head_draw(H, D, B)
    idxs = [torch.from_numpy(i).cuda() for i in idxs_np]
    x = torch.from_numpy(x_np).cuda()
    out = torch.zeros((H, D), device="cuda")

    want = torch.zeros((H, D), device="cuda").index_add_(0, idxs[0], x)
    got = scatter_add_rows_(torch.zeros((H, D), device="cuda"), idxs[0], x,
                            rows_per_block=T)
    check_errors()
    err = float((got - want).abs().max())

    def kernel(i):
        scatter_add_rows_(out, idxs[i % 8], x, rows_per_block=T)

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
    rec = {"device": torch.cuda.get_device_name(0), "card": card, "H": H, "D": D,
           "B": B, "tile": T, "max_abs_err_vs_index_add": err, "bound_ms": bound_ms}
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
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
