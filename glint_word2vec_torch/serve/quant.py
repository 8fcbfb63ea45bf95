"""Quantized IVF storage arms and the shard-native index build, ported from
``glint_word2vec_tpu/serve/quant.py``.

:mod:`.ann` owns the index structure (coarse centroids, CSR inverted lists,
best-first probing, recall gating); this module owns what a cell's rows are stored as
when ``quant != "f32"``, and the build that never holds a dense [V, D] float32 copy:

- :class:`Int8Storage`: per-row scalar quantization, ``scale = maxabs/127`` per
  unit-normalized row, int8 codes; a probed cell is one contiguous int8 block scanned
  as ``codes.astype(f32) @ q`` and rescaled. ~4x smaller, ~1e-2 relative score error.
- :class:`PQStorage`: product quantization (Jégou, Douze, Schmid, PAMI 2011): D split
  into ``m`` subspaces, each coded against 256 seeded Euclidean k-means centroids; the
  scan is asymmetric distance computation (one [m, 256] table of exact subspace dots
  per query, then a gather and a row sum). Codes are uint16 with the ``+ 256*j``
  subspace offset baked in. The exact re-rank (:mod:`.ann`) restores recall.
- :class:`ShardRowFetch`: a lazy exact-row source over a memory-mapped row-shards
  checkpoint (the port's :class:`~glint_word2vec_torch.train.checkpoint.ShardedMatrixReader`).
- :func:`build_ivf_from_shards`: a quantized index straight from
  ``<ckpt>/syn0.shards``, streaming bounded row blocks through normalize, assign and
  quantize; its codes equal the in-memory build's for the same matrix and seed.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Tuple

import numpy as np

from glint_word2vec_torch.serve.ann import (
    IvfIndex,
    _argmax_rows,
    _gate_recall,
    _finish_stats,
    _kmeans_unit,
    _normalize_rows,
    auto_centroids,
    auto_nprobe,
    resolve_recall_floor,
)
from glint_word2vec_torch.train.checkpoint import ShardedMatrixReader

logger = logging.getLogger("glint_word2vec_torch")

_PQ_K = 256          # centroids per subspace — one uint8 worth, the PAMI
                     # 2011 operating point; codes carry uint16 only to
                     # pre-bake the flat-LUT subspace offset
_PQ_ITERS = 6        # subspace Lloyd iterations (cheap: dsub-dim points)


def auto_pq_m(dim: int) -> int:
    """AUTO subspace count: ~8 dims per subspace (the PAMI 2011 sweet
    spot for ADC), clamped to [1, 64]. D=128 → m=16 → 32 B/row codes."""
    return max(1, min(64, dim // 8 if dim >= 8 else 1))


class Int8Storage:
    """Per-row-scaled int8 codes in the packed-cell layout."""

    kind = "int8"

    def __init__(self, codes: np.ndarray, scales: np.ndarray):
        self._codes = codes              # [V, D] int8, list order
        self._scales = scales            # [V] f32: dequant = codes*scale

    @property
    def nbytes(self) -> int:
        return int(self._codes.nbytes + self._scales.nbytes)

    @staticmethod
    def encode(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(int8 codes, per-row scales) for unit-normalized f32 rows.
        Zero rows get scale 1 and all-zero codes (score 0 everywhere —
        same exclusion behavior as the f32 arm's zero-norm rows)."""
        maxabs = np.max(np.abs(rows), axis=1)
        scales = np.where(maxabs > 0, maxabs / 127.0, 1.0).astype(np.float32)
        codes = np.clip(np.rint(rows / scales[:, None]),
                        -127, 127).astype(np.int8)
        return codes, scales

    def scanner(self, q: np.ndarray) -> Callable[[int, int], np.ndarray]:
        codes, scales = self._codes, self._scales

        def scan(lo: int, hi: int) -> np.ndarray:
            # contiguous int8 block -> in-cache f32 -> one BLAS matvec;
            # DRAM traffic is the int8 read (1 B/elem vs f32's 4)
            return (codes[lo:hi].astype(np.float32) @ q) * scales[lo:hi]

        return scan

    def reconstruct(self, pos) -> np.ndarray:
        return (self._codes[pos].astype(np.float32)
                * np.asarray(self._scales[pos])[..., None]
                if np.ndim(pos) else
                self._codes[pos].astype(np.float32) * self._scales[pos])


class PQStorage:
    """Product-quantized codes + per-subspace codebooks, ADC scan."""

    kind = "pq"

    def __init__(self, codes: np.ndarray, codebooks: np.ndarray, dim: int):
        self.m = int(codebooks.shape[0])
        self.dsub = int(codebooks.shape[2])
        self._dim = int(dim)             # original D (≤ m*dsub zero-pad)
        self._codes = codes              # [V, m] uint16, +256*j baked in
        self._codebooks = codebooks      # [m, 256, dsub] f32
        self._flat_cb = np.ascontiguousarray(
            codebooks.reshape(self.m * _PQ_K, self.dsub))

    @property
    def nbytes(self) -> int:
        return int(self._codes.nbytes + self._codebooks.nbytes)

    @staticmethod
    def train(train_rows: np.ndarray, m: int, dsub: int,
              seed: int) -> np.ndarray:
        """Seeded EUCLIDEAN k-means per subspace over the (zero-padded)
        training sample → [m, 256, dsub] codebooks. Subvectors are not
        unit vectors, so nearest-centroid uses ``x@c.T - ||c||²/2``, and
        means are NOT re-normalized — both unlike the coarse stage."""
        rng = np.random.default_rng(seed + 1)   # decorrelate from coarse
        cb = np.zeros((m, _PQ_K, dsub), np.float32)
        n = train_rows.shape[0]
        if n == 0:
            return cb
        X = _pad_cols(train_rows, m * dsub)
        k = min(_PQ_K, n)
        for j in range(m):
            xj = np.ascontiguousarray(X[:, j * dsub:(j + 1) * dsub])
            cents = xj[rng.choice(n, size=k, replace=False)].copy()
            for _ in range(_PQ_ITERS):
                assign = np.argmax(
                    xj @ cents.T - 0.5 * np.sum(cents * cents, axis=1),
                    axis=1)
                sums = np.zeros_like(cents)
                np.add.at(sums, assign, xj)
                counts = np.bincount(assign, minlength=k)
                live = counts > 0
                sums[live] /= counts[live, None]
                dead = np.flatnonzero(~live)
                if dead.size:
                    sums[dead] = xj[rng.choice(n, size=dead.size)]
                cents = sums
            cb[j, :k] = cents
        return cb

    def encode(self, rows: np.ndarray) -> np.ndarray:
        """Nearest-codeword per subspace → [n, m] uint16 offset codes."""
        X = _pad_cols(np.asarray(rows, np.float32), self.m * self.dsub)
        out = np.empty((X.shape[0], self.m), np.uint16)
        for j in range(self.m):
            xj = X[:, j * self.dsub:(j + 1) * self.dsub]
            cj = self._codebooks[j]
            idx = np.argmax(xj @ cj.T - 0.5 * np.sum(cj * cj, axis=1),
                            axis=1)
            out[:, j] = idx + _PQ_K * j
        return out

    def scanner(self, q: np.ndarray) -> Callable[[int, int], np.ndarray]:
        # ADC: one exact [m, 256] table of subspace dots per query, then
        # every cell scan is a flat gather + row-sum — no float math on
        # the codes at all
        qr = _pad_cols(q[None, :], self.m * self.dsub).reshape(
            self.m, self.dsub)
        flat_lut = np.ascontiguousarray(np.einsum(
            "mcd,md->mc", self._codebooks, qr).ravel().astype(np.float32))
        codes = self._codes

        def scan(lo: int, hi: int) -> np.ndarray:
            return flat_lut[codes[lo:hi]].sum(axis=1)

        return scan

    def reconstruct(self, pos) -> np.ndarray:
        rec = self._flat_cb[self._codes[pos]]
        return rec.reshape(rec.shape[:-2] + (-1,))[..., :self._dim]


def _pad_cols(x: np.ndarray, width: int) -> np.ndarray:
    if x.shape[1] == width:
        return x
    out = np.zeros((x.shape[0], width), np.float32)
    out[:, :x.shape[1]] = x
    return out


def make_quant_storage(quant: str, train_rows: np.ndarray, seed: int,
                       pq_m: int, encode_blocks: Iterable[
                           Tuple[np.ndarray, np.ndarray]],
                       num_rows: int, dim: int):
    """Build a quantized storage by streaming ``encode_blocks`` — an
    iterator of ``(unit-normalized f32 rows, their PACKED positions)`` —
    into preallocated code arrays. Both the in-memory build (blocks in
    list order) and the shard-native build (blocks in row order,
    scattered via ``row_pos``) feed the same factory, so the resulting
    codes are bit-identical for the same matrix + seed either way."""
    if quant == "int8":
        codes = np.empty((num_rows, dim), np.int8)
        scales = np.empty(num_rows, np.float32)
        for rows, pos in encode_blocks:
            c, s = Int8Storage.encode(rows)
            codes[pos] = c
            scales[pos] = s
        return Int8Storage(codes, scales)
    if quant == "pq":
        m = int(pq_m) if pq_m else auto_pq_m(dim)
        dsub = -(-dim // m)
        cb = PQStorage.train(train_rows, m, dsub, seed)
        storage = PQStorage(np.empty((num_rows, m), np.uint16), cb, dim)
        for rows, pos in encode_blocks:
            storage._codes[pos] = storage.encode(rows)
        return storage
    raise ValueError(f"unknown quant arm {quant!r}")


class ShardRowFetch:
    """Lazy exact-row source over a mmap'd row-shards checkpoint: fetched
    rows are truncated to the real (unpadded) extents recorded in
    checkpoint metadata and unit-normalized. Contiguous id runs become
    single reader reads (the recall oracle streams ``arange`` blocks;
    re-rank shortlists are scattered but small), and a scattered set
    whose span is modest is served by one span read + gather."""

    kind = "row-shards"

    def __init__(self, reader, vocab_size: int, vector_size: int):
        self._reader = reader
        self._rows = int(vocab_size)
        self._cols = int(vector_size)

    def __call__(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        if ids.size == 0:
            return np.zeros((0, self._cols), np.float32)
        lo, hi = int(ids.min()), int(ids.max()) + 1
        if hi - lo == ids.size and np.array_equal(ids, np.arange(lo, hi)):
            rows = self._reader.read(lo, hi)      # oracle/streaming blocks
        else:
            rows = self._reader.gather(ids)       # re-rank shortlists
        return _normalize_rows(
            np.asarray(rows[:, :self._cols], np.float32))[0]


def build_ivf_from_shards(
    checkpoint_path: str,
    quant: str = "int8",
    num_centroids: int = 0,
    nprobe: int = 0,
    seed: int = 0,
    kmeans_iters: int = 4,
    train_sample: int = 65536,
    recall_queries: int = 256,
    recall_k: int = 10,
    measure_recall: bool = True,
    pq_m: int = 0,
    rerank: int = 0,
    recall_floor: float = -1.0,
    block_rows: int = 65536,
    keep_rows: bool = True,
) -> IvfIndex:
    """Build a quantized :class:`~glint_word2vec_torch.serve.ann.IvfIndex`
    straight from a row-shards checkpoint without ever
    materializing a dense [V, D] float32 matrix.

    Three bounded streaming passes over the mmap'd shard files:

    1. **sample + norms** — one pass computing per-row norms (zero-norm
       exclusion, exactly as the in-memory build) plus a seeded row
       sample for k-means training;
    2. **assign** — normalize each [block_rows, D] block and assign to
       the trained coarse centroids → ``assign[V]``;
    3. **quantize + scatter** — re-stream blocks, quantize (int8 / PQ
       codes) and scatter each row's codes to its packed position.

    Peak extra memory: O(V) 1-D bookkeeping (norms, assign, ids,
    row_pos) + one [block_rows, D] f32 scratch + the sample — the codes
    array itself is the index being built. ``quant="f32"`` is refused:
    its packed copy IS a dense [V, D] f32 allocation, defeating the
    point; use :func:`~glint_word2vec_torch.serve.ann.build_ivf`.

    Recall is measured at EVERY build against the exact oracle (streamed
    through the shard reader in bounded blocks) and gated by
    ``recall_floor`` exactly as the in-memory build; the resulting index
    keeps a :class:`ShardRowFetch` as its lazy exact-row source (re-rank
    + word-query vectors) unless ``keep_rows=False``. bf16 shards are
    handled by the reader and upcast per block."""
    t0 = time.perf_counter()
    if quant not in ("int8", "pq"):
        raise ValueError(
            f"build_ivf_from_shards is the dense-free path: quant must be "
            f"'int8' or 'pq', got {quant!r} — an f32 packed index IS a "
            f"dense [V, D] float32 copy; use serve.ann.build_ivf for that")
    meta_path = os.path.join(checkpoint_path, "metadata.json")
    with open(meta_path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("layout") != "row-shards":
        raise ValueError(
            f"{checkpoint_path!r} is not a row-shards checkpoint "
            f"(layout={meta.get('layout')!r})")
    V = int(meta["vocab_size"])
    D = int(meta["vector_size"])
    reader = ShardedMatrixReader(os.path.join(checkpoint_path,
                                              "syn0.shards"))
    fetch = ShardRowFetch(reader, V, D)
    rng = np.random.default_rng(seed)
    block_rows = max(int(block_rows), 1)

    # pass 1: norms (padding rows beyond V never enter; zero-norm rows
    # inside V are excluded from training/queries like the dense build)
    norms = np.empty(V, np.float32)
    for lo in range(0, V, block_rows):
        hi = min(lo + block_rows, V)
        norms[lo:hi] = np.linalg.norm(
            np.asarray(reader.read(lo, hi)[:, :D], np.float32), axis=1)
    nonzero = np.flatnonzero(norms > 0)

    # the seeded training sample, in the order the in-memory build draws it (k-means
    # seeds its centroids by position in the sample), fetched as sorted runs; the
    # JAX package keeps the sorted order here, so past train_sample rows its codes
    # differ from its in-memory build's (ROADMAP.md queue C)
    if nonzero.size > train_sample:
        sample_ids = rng.choice(nonzero, size=train_sample, replace=False)
        order = np.argsort(sample_ids, kind="stable")
        X = np.empty((sample_ids.size, D), np.float32)
        X[order] = fetch(sample_ids[order])
    else:
        X = fetch(nonzero) if nonzero.size else np.zeros((0, D), np.float32)

    C = int(num_centroids) if num_centroids else auto_centroids(V)
    C = max(1, min(C, max(nonzero.size, 1)))
    if X.shape[0]:
        centroids = _kmeans_unit(X, C, rng, kmeans_iters)
    else:
        centroids = np.zeros((1, D), np.float32)
        C = 1

    # pass 2: assignment
    assign_all = np.empty(V, np.int32)
    for lo in range(0, V, block_rows):
        hi = min(lo + block_rows, V)
        block = _normalize_rows(
            np.asarray(reader.read(lo, hi)[:, :D], np.float32))[0]
        assign_all[lo:hi] = _argmax_rows(block, centroids)

    counts = np.bincount(assign_all, minlength=C)
    offsets = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    ids = np.argsort(assign_all, kind="stable").astype(np.int32)
    row_pos = np.empty(V, np.int64)
    row_pos[ids] = np.arange(V)

    # pass 3: quantize + scatter codes to packed positions
    def blocks():
        for lo in range(0, V, block_rows):
            hi = min(lo + block_rows, V)
            block = _normalize_rows(
                np.asarray(reader.read(lo, hi)[:, :D], np.float32))[0]
            yield block, row_pos[lo:hi]

    storage = make_quant_storage(quant, train_rows=X, seed=seed,
                                 pq_m=pq_m, encode_blocks=blocks(),
                                 num_rows=V, dim=D)

    npr = int(nprobe) if nprobe else auto_nprobe(C)
    floor = resolve_recall_floor(recall_floor, quant)
    stats: Dict = {
        "quant": quant,
        "build": "shard-native",
        "centroids": C,
        "nprobe": min(npr, C),
        "rows": V,
        "mean_list_len": round(float(counts.mean()), 2) if C else 0.0,
        "max_list_len": int(counts.max()) if C else 0,
        "recall_floor": floor,
    }
    index = IvfIndex(centroids, offsets, storage, ids, row_pos,
                     min(npr, C), stats, rerank=rerank, row_fetch=fetch)
    _finish_stats(index, t0)
    if measure_recall and nonzero.size > recall_k:
        _gate_recall(index, rng, nonzero, recall_queries, recall_k, floor)
    stats["build_seconds"] = round(time.perf_counter() - t0, 3)
    if not keep_rows:
        index._row_fetch = None
    logger.info(
        "shard-native IVF build: %s V=%d C=%d nprobe=%d quant=%s "
        "recall@%d=%s bytes/vec=%s in %.2fs",
        checkpoint_path, V, C, stats["nprobe"], quant, recall_k,
        stats.get(f"recall_at_{recall_k}"), stats["bytes_per_vector"],
        stats["build_seconds"])
    return index
