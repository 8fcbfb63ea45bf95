"""IVF approximate-nearest-neighbour index over a trained embedding matrix, ported from
``glint_word2vec_tpu/serve/ann.py``.

The serving tier's fast arm. The exact ``find_synonyms`` scans the whole [V, D] matrix
per batch; this index trades a little recall for a scan of ~``nprobe / C`` of it:

- **build**: unit-normalize the rows (cosine == dot; zero rows stay zero and never
  enter a top-k), k-means a seeded sample into ``num_centroids`` cells (seeded Lloyd
  iterations: the same matrix and seed give the same index, bit for bit, in both
  packages), assign every row to its nearest centroid, and store the rows in one
  CSR-style packed layout (``offsets [C+1]``, rows of a cell contiguous);
- **search**: score the query against the C centroids, scan the ``nprobe`` nearest
  cells, rank the candidates;
- **recall is measured**: every build scores the index against the exact full scan on
  sampled rows; ``stats["recall_at_10"]`` travels with the index, and a quantized
  build below its floor raises :class:`RecallFloorError` instead of serving.

Storage is pluggable (``quant=``): ``"f32"`` one normalized float copy (exact scores);
``"int8"`` per-row-scaled int8 codes; ``"pq"`` product-quantized codes scanned by ADC
lookup tables, re-ranked against exact rows (:mod:`.quant`).

Host numpy by design, as in the reference: the same numpy calls in the same order are
what makes the index equal the JAX package's; the search never touches the card, so
ANN queries do not contend with the exact arm's dispatches or a trainer on the card.
The exact top-k on the card (``models/word2vec.py``) stays the ground truth.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger("glint_word2vec_torch")

# chunk sizes bounding host scratch: assignment [chunk, C] and the exact-
# oracle [Q, chunk] score blocks stay under ~256 MB each
_ASSIGN_BLOCK_BYTES = 256 << 20
_ORACLE_BLOCK_BYTES = 256 << 20

# documented per-arm recall@10 floors the AUTO (-1) ``recall_floor``
# resolves to, the JAX package's (measured there on clustered embedding
# geometry at V >= 400k by its servebench): both quantized arms
# rely on their exact re-rank stage to hold these (int8's rescaled dots
# carry ~1e-2 relative error; PQ's ADC ordering scrambles inside dense
# clusters) — disabling re-rank (rerank=-1) forfeits the floor. f32 is
# never auto-gated — its recall is governed by the nprobe choice, and
# gating it would refuse every legitimately small-nprobe deployment.
# Toy-scale builds (unit tests) pass an explicit floor
# (0.0 disables) because IVF probe loss at tiny V dominates any
# quantization effect.
RECALL_FLOORS: Dict[str, float] = {"f32": 0.0, "int8": 0.99, "pq": 0.95}

QUANT_MODES = ("f32", "int8", "pq")


class RecallFloorError(RuntimeError):
    """A quantized index build measured recall below its resolved floor
    and refused to publish (docs/serving.md §6). Carries the measured
    value and the floor so callers (hot-reload, benches) can report both."""

    def __init__(self, quant: str, measured: float, floor: float):
        self.quant = quant
        self.measured = measured
        self.floor = floor
        super().__init__(
            f"{quant} index build refused: measured recall@10 "
            f"{measured:.4f} < floor {floor:.4f} — the matrix geometry "
            f"does not support this quantization arm at this nprobe; "
            f"raise nprobe/rerank, use a weaker arm (int8/f32), or pass "
            f"an explicit recall_floor to override")


def resolve_recall_floor(recall_floor: float, quant: str) -> float:
    """-1 = AUTO (the documented per-arm floor above); >= 0 explicit
    (0.0 disables the gate)."""
    if recall_floor is None or recall_floor < 0:
        return RECALL_FLOORS[quant]
    return float(recall_floor)


def _normalize_rows(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(unit rows, norms); zero-norm rows stay zero (cosine 0 everywhere —
    the same masking rule as the exact path's zero-norm handling)."""
    m = np.ascontiguousarray(m, dtype=np.float32)
    norms = np.linalg.norm(m, axis=1)
    out = m / np.maximum(norms, 1e-12)[:, None]
    return out, norms


def _argmax_rows(x: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid id per row of ``x`` (both unit-normalized), with the
    [chunk, C] score block bounded."""
    C = centroids.shape[0]
    chunk = max(1, _ASSIGN_BLOCK_BYTES // max(C * 4, 1))
    out = np.empty(x.shape[0], np.int32)
    for lo in range(0, x.shape[0], chunk):
        out[lo:lo + chunk] = np.argmax(
            x[lo:lo + chunk] @ centroids.T, axis=1).astype(np.int32)
    return out


def _topk_desc(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest entries, sorted descending by score (ties:
    ascending index — stable across runs)."""
    n = scores.shape[0]
    if k >= n:
        cand = np.arange(n)
    else:
        cand = np.argpartition(scores, n - k)[n - k:]
    return cand[np.lexsort((cand, -scores[cand]))][:k]


def _kmeans_unit(X: np.ndarray, C: int, rng, iters: int) -> np.ndarray:
    """Seeded Lloyd over unit rows (cosine assignment, re-normalized
    means, dead-cell repair from random training rows — deterministic:
    same X + rng state → the same centroids)."""
    centroids = X[rng.choice(X.shape[0], size=C, replace=False)].copy()
    for _ in range(max(iters, 1)):
        assign = _argmax_rows(X, centroids)
        sums = np.zeros_like(centroids)
        np.add.at(sums, assign, X)
        counts = np.bincount(assign, minlength=C)
        live = counts > 0
        sums[live] /= counts[live, None]
        dead = np.flatnonzero(~live)
        if dead.size:
            # re-seed empty cells from random training rows so every
            # cell stays live (classic Lloyd repair, deterministic)
            sums[dead] = X[rng.choice(X.shape[0], size=dead.size)]
        centroids, _ = _normalize_rows(sums)
    return centroids


class F32Storage:
    """The original packed-cell storage: one contiguous float32 normalized
    copy in inverted-list order. Scores are exact cosines."""

    kind = "f32"

    def __init__(self, packed: np.ndarray):
        self._packed = packed            # [V, D] unit rows, list order

    @property
    def nbytes(self) -> int:
        return int(self._packed.nbytes)

    def scanner(self, q: np.ndarray) -> Callable[[int, int], np.ndarray]:
        packed = self._packed

        def scan(lo: int, hi: int) -> np.ndarray:
            # one contiguous matvec per probed cell (packed layout)
            return packed[lo:hi] @ q

        return scan

    def reconstruct(self, pos) -> np.ndarray:
        return self._packed[pos]

    def block(self, lo: int, hi: int) -> np.ndarray:
        """Exact normalized rows [lo:hi) in PACKED order (oracle scans)."""
        return self._packed[lo:hi]


class MatrixRowFetch:
    """Lazy exact-row source over a borrowed in-memory matrix: rows are
    normalized per fetch, nothing beyond the caller's own matrix is held.
    The quantized arms' re-rank/oracle source for in-memory builds — the
    model already holds its matrix, so borrowing it costs no extra copy
    (``index_bytes`` counts only what the index OWNS; docs/serving.md §6).
    """

    kind = "borrowed-matrix"

    def __init__(self, matrix: np.ndarray):
        self._matrix = matrix

    def __call__(self, ids: np.ndarray) -> np.ndarray:
        return _normalize_rows(self._matrix[np.asarray(ids)])[0]


class IvfIndex:
    """Built inverted-file index; see :func:`build_ivf`.

    Storage is the PACKED layout: rows are reordered so each inverted list
    is one contiguous block (``storage`` rows ``offsets[c]:offsets[c+1]``
    are cell ``c``). Probing a cell is then a sequential scan over its
    block — the naive gather of ~nprobe/C·V scattered rows is
    DRAM-latency-bound and measured 5-10x slower at V ≥ 400k on this host
    class. ``_ids`` maps packed positions back to original row ids;
    ``_row_pos`` is the inverse (for :meth:`vector`).

    ``row_fetch`` (optional) is the exact-row source: ``fetch(ids) ->
    normalized f32 rows``. Quantized arms use it for the PQ re-rank stage,
    for exact word-query vectors, and as the :meth:`measure_recall`
    oracle; without one, :meth:`vector` falls back to dequantized codes
    and ``measure_recall`` is unavailable after build."""

    def __init__(self, centroids: np.ndarray, offsets: np.ndarray,
                 storage, ids: np.ndarray, row_pos: np.ndarray,
                 nprobe: int, stats: Dict, rerank: int = 0,
                 row_fetch: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None):
        self._centroids = centroids      # [C, D] unit rows
        self._offsets = offsets          # [C + 1] int64
        self._storage = storage          # cell-contiguous code/row store
        self._ids = ids                  # [V] int32: packed pos -> row id
        self._row_pos = row_pos          # [V] int64: row id -> packed pos
        self.nprobe = int(nprobe)
        self.stats = stats
        self._rerank = int(rerank)       # 0 = no re-rank stage
        self._row_fetch = row_fetch

    @property
    def quant(self) -> str:
        return self._storage.kind

    @property
    def num_centroids(self) -> int:
        return int(self._centroids.shape[0])

    @property
    def num_rows(self) -> int:
        return int(self._ids.shape[0])

    @property
    def index_bytes(self) -> int:
        """Bytes the index OWNS: codes/rows + centroids + list structure
        (+ codebooks/scales). A borrowed re-rank row source is NOT counted
        — it is the model's own matrix (in-memory builds) or mmap'd
        checkpoint shards (shard-native builds), alive either way."""
        return int(self._storage.nbytes + self._centroids.nbytes
                   + self._offsets.nbytes + self._ids.nbytes
                   + self._row_pos.nbytes)

    def vector(self, row: int) -> np.ndarray:
        """The indexed (unit-normalized) vector of one row — lets word
        queries reuse the host copy instead of a device gather. Exact when
        a row source exists (f32 storage IS one); dequantized otherwise."""
        if self._storage.kind == "f32":
            return self._storage.reconstruct(self._row_pos[row])
        if self._row_fetch is not None:
            return self._row_fetch(np.asarray([row]))[0]
        return self._storage.reconstruct(self._row_pos[row])

    def _resolved_rerank(self, k: int) -> int:
        """The re-rank candidate count for one top-``k`` search: >0
        explicit, -1 explicitly off, 0 = AUTO — pq widens to max(100,
        40k) (ADC's fine ordering scrambles inside dense clusters, where
        top-10 score gaps are smaller than the reconstruction error, so
        the shortlist must out-span the cluster); int8's rescaled dots
        are much tighter, max(32, 4k) heals the ordering. f32 never
        re-ranks (its scores are already exact)."""
        if self._row_fetch is None or self._rerank < 0:
            return 0
        if self._rerank > 0:
            return self._rerank
        if self._storage.kind == "pq":
            return max(100, 40 * k)
        if self._storage.kind == "int8":
            return max(32, 4 * k)
        return 0

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-``k`` cosine rows per query over the probed cells.

        Returns ``(scores [Q, k], row_ids [Q, k])``; slots past the
        candidate count (possible only at tiny nprobe on tiny lists) carry
        ``(-inf, -1)`` — identical fill semantics across all three storage
        arms. ``nprobe`` overrides the index default; clamped to the
        centroid count (``nprobe >= C`` degrades to an exact scan and is
        the recall-1.0 reference point for f32; quantized arms add their
        code error). f32 scores are exact cosines; int8 scores are
        rescaled int8 dots (~1e-2 relative error); pq results are ADC-
        shortlisted then re-ranked against exact rows, so the RETURNED
        top-k scores are exact cosines again."""
        q, _ = _normalize_rows(np.atleast_2d(np.asarray(queries, np.float32)))
        C = self.num_centroids
        npr = min(int(nprobe) if nprobe else self.nprobe, C)
        npr = max(npr, 1)
        cscore = q @ self._centroids.T                       # [Q, C]
        Q = q.shape[0]
        off = self._offsets
        scores = np.full((Q, k), -np.inf, np.float32)
        idx = np.full((Q, k), -1, np.int64)
        rerank_n = self._resolved_rerank(k)
        for r in range(Q):
            # probe cells best-first, and past the nprobe budget KEEP
            # probing until the candidate pool covers k (a tiny/uneven cell
            # must not starve the result below the requested top-k)
            order = np.argsort(-cscore[r], kind="stable")
            scan = self._storage.scanner(q[r])
            parts, pos_parts, got = [], [], 0
            for j, c in enumerate(order):
                if j >= npr and got >= k:
                    break
                lo, hi = off[c], off[c + 1]
                if hi == lo:
                    continue
                parts.append(scan(lo, hi))
                pos_parts.append(np.arange(lo, hi))
                got += hi - lo
            if not parts:
                continue
            s = np.concatenate(parts)
            pos = np.concatenate(pos_parts)
            if rerank_n:
                # ADC/quantized shortlist -> exact re-rank: fetch the top
                # rerank_n candidates' float rows lazily and rank those by
                # true cosine (asymmetric distance discipline, PAMI 2011)
                short = _topk_desc(s, min(rerank_n, s.size))
                cand_ids = self._ids[pos[short]]
                exact = self._row_fetch(cand_ids) @ q[r]
                top = _topk_desc(exact, min(k, exact.size))
                scores[r, :top.size] = exact[top]
                idx[r, :top.size] = cand_ids[top]
            else:
                top = _topk_desc(s, min(k, s.size))
                scores[r, :top.size] = s[top]
                idx[r, :top.size] = self._ids[pos[top]]
        return scores, idx

    # -- exact oracle ------------------------------------------------------------------

    def _oracle_blocks(self, chunk: int
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(exact normalized rows, their row ids) in bounded blocks — the
        full-scan oracle's source: f32 storage serves its own packed copy;
        quantized storages stream through the row source."""
        V = self.num_rows
        if self._storage.kind == "f32":
            for lo in range(0, V, chunk):
                hi = min(lo + chunk, V)
                yield self._storage.block(lo, hi), self._ids[lo:hi]
        elif self._row_fetch is not None:
            for lo in range(0, V, chunk):
                ids = np.arange(lo, min(lo + chunk, V))
                yield self._row_fetch(ids), ids
        else:
            raise RuntimeError(
                "exact-oracle recall needs a row source; this quantized "
                "index was built with keep_rows=False (recall was still "
                "measured at build — see index.stats)")

    def _query_rows(self, query_rows: np.ndarray) -> np.ndarray:
        if self._storage.kind == "f32":
            return self._storage.reconstruct(self._row_pos[query_rows])
        if self._row_fetch is not None:
            return self._row_fetch(query_rows)
        return np.stack([self._storage.reconstruct(self._row_pos[r])
                         for r in query_rows])

    def measure_recall(self, query_rows: np.ndarray, k: int = 10,
                       nprobe: Optional[int] = None) -> float:
        """recall@k of this index vs the EXACT full-scan oracle on the same
        normalized matrix, querying by row id (self excluded on both arms —
        the serving semantics). Quantized arms stream the oracle through
        their row source in bounded blocks, so the measurement never
        materializes a dense [V, D] copy either."""
        query_rows = np.asarray(query_rows)
        q = self._query_rows(query_rows)
        _, ann_i = self.search(q, k + 1, nprobe)
        Q = q.shape[0]
        kk = k + 1
        chunk = max(kk, _ORACLE_BLOCK_BYTES // max(Q * 4, 1))
        best_s = np.full((Q, kk), -np.inf, np.float32)
        best_i = np.full((Q, kk), -1, np.int64)
        for rows, ids in self._oracle_blocks(chunk):
            s = q @ rows.T                                   # [Q, block]
            cat_s = np.concatenate([best_s, s], axis=1)
            cat_i = np.concatenate(
                [best_i, np.broadcast_to(ids, (Q, ids.shape[0]))], axis=1)
            sel = np.argpartition(cat_s, cat_s.shape[1] - kk,
                                  axis=1)[:, -kk:]
            best_s = np.take_along_axis(cat_s, sel, axis=1)
            best_i = np.take_along_axis(cat_i, sel, axis=1)
        hits, total = 0, 0
        for r in range(Q):
            qi = int(query_rows[r])
            order = _topk_desc(best_s[r], kk)
            exact = [int(best_i[r][p]) for p in order
                     if best_i[r][p] >= 0 and best_i[r][p] != qi][:k]
            ann = [i for i in ann_i[r] if i >= 0 and i != qi][:k]
            hits += len(set(exact) & set(ann))
            total += len(exact)
        return hits / max(total, 1)


def auto_centroids(num_rows: int) -> int:
    """The AUTO cell count: ~4·sqrt(V), clamped so every cell averages ≥ 8
    rows and the centroid scan stays tiny next to the scan it replaces."""
    return max(1, min(int(round(4 * math.sqrt(max(num_rows, 1)))),
                      max(num_rows // 8, 1), 4096))


def auto_nprobe(num_centroids: int) -> int:
    """The AUTO probe width: ~1/12 of the cells (≈8% of the vocabulary
    scanned) — the measured recall ≥ 0.95 operating point on clustered
    embedding geometry (tools/servebench.py); tune per deployment."""
    return max(1, -(-num_centroids // 12))


def _gate_recall(index: IvfIndex, rng, nonzero: np.ndarray,
                 recall_queries: int, recall_k: int, floor: float) -> None:
    """Measure recall vs the exact oracle (EVERY build that can measure
    does) and refuse a quantized build below its floor."""
    probes = rng.choice(nonzero, size=min(recall_queries, nonzero.size),
                        replace=False)
    key = ("recall_at_10" if recall_k == 10
           else f"recall_at_{recall_k}")
    measured = round(index.measure_recall(probes, k=recall_k), 4)
    index.stats[key] = measured
    index.stats["recall_queries"] = int(probes.size)
    if measured < floor:
        raise RecallFloorError(index.quant, measured, floor)


def build_ivf(
    matrix: np.ndarray,
    num_centroids: int = 0,
    nprobe: int = 0,
    seed: int = 0,
    kmeans_iters: int = 4,
    train_sample: int = 65536,
    recall_queries: int = 256,
    recall_k: int = 10,
    measure_recall: bool = True,
    quant: str = "f32",
    pq_m: int = 0,
    rerank: int = 0,
    recall_floor: float = -1.0,
    keep_rows: bool = True,
) -> IvfIndex:
    """Build an :class:`IvfIndex` from a [V, D] embedding matrix (pass the
    UNPADDED ``model.syn0``; sharding padding would only add zero rows).

    ``num_centroids``/``nprobe`` 0 = AUTO (:func:`auto_centroids` /
    :func:`auto_nprobe` — the ``serve_ann_centroids``/``serve_ann_nprobe``
    config knobs carry the same 0-is-AUTO convention). ``measure_recall``
    scores the built index against the exact oracle on ``recall_queries``
    sampled rows; the result rides ``index.stats`` (and, from there,
    servebench's JSON line).

    Quantization (docs/serving.md §6): ``quant`` picks the storage arm
    (``f32``/``int8``/``pq``); ``pq_m`` is the PQ subspace count (0 = AUTO,
    serve/quant.py); ``rerank`` the exact-re-rank shortlist (0 = AUTO:
    max(32, 4k) for pq, off for int8); ``recall_floor`` the refusal gate
    (-1 = AUTO per-arm documented floor, 0 disables) — a measured-recall
    build below floor raises :class:`RecallFloorError`. Quantized arms
    BORROW the input matrix as their lazy exact-row source (re-rank,
    word-query vectors, oracle); ``keep_rows=False`` drops it after the
    build-time recall measurement, leaving a codes-only index."""
    t0 = time.perf_counter()
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    src = np.asarray(matrix)
    normed, norms = _normalize_rows(src)
    V = normed.shape[0]
    nonzero = np.flatnonzero(norms > 0)
    C = int(num_centroids) if num_centroids else auto_centroids(V)
    C = max(1, min(C, max(nonzero.size, 1)))
    rng = np.random.default_rng(seed)

    if nonzero.size:
        if nonzero.size > train_sample:
            train = rng.choice(nonzero, size=train_sample, replace=False)
        else:
            train = nonzero
        X = normed[train]
        centroids = _kmeans_unit(X, C, rng, kmeans_iters)
    else:
        # degenerate all-zero matrix: one empty-ish cell, exact fallback
        centroids = np.zeros((1, normed.shape[1]), np.float32)
        C = 1
        X = normed[:0]

    assign_all = _argmax_rows(normed, centroids)
    counts = np.bincount(assign_all, minlength=C)
    offsets = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    ids = np.argsort(assign_all, kind="stable").astype(np.int32)
    row_pos = np.empty(V, np.int64)
    row_pos[ids] = np.arange(V)

    row_fetch = None
    if quant == "f32":
        storage = F32Storage(
            np.ascontiguousarray(normed[ids]))   # list-contiguous layout
    else:
        from glint_word2vec_torch.serve.quant import make_quant_storage
        storage = make_quant_storage(
            quant, train_rows=X, seed=seed, pq_m=pq_m,
            encode_blocks=((normed[ids[lo:lo + 262144]],
                            np.arange(lo, min(lo + 262144, V)))
                           for lo in range(0, V, 262144)),
            num_rows=V, dim=normed.shape[1])
        row_fetch = MatrixRowFetch(src)

    npr = int(nprobe) if nprobe else auto_nprobe(C)
    floor = resolve_recall_floor(recall_floor, quant)
    stats: Dict = {
        "quant": quant,
        "centroids": C,
        "nprobe": min(npr, C),
        "rows": V,
        "mean_list_len": round(float(counts.mean()), 2) if C else 0.0,
        "max_list_len": int(counts.max()) if C else 0,
        "recall_floor": floor,
    }
    index = IvfIndex(centroids, offsets, storage, ids, row_pos,
                     min(npr, C), stats, rerank=rerank, row_fetch=row_fetch)
    _finish_stats(index, t0)
    if measure_recall and nonzero.size > recall_k:
        _gate_recall(index, rng, nonzero, recall_queries, recall_k, floor)
    stats["build_seconds"] = round(time.perf_counter() - t0, 3)
    if not keep_rows and quant != "f32":
        index._row_fetch = None
    logger.info("IVF index built: V=%d C=%d nprobe=%d quant=%s recall@%d=%s "
                "bytes/vec=%s in %.2fs",
                V, C, stats["nprobe"], quant, recall_k,
                stats.get(f"recall_at_{recall_k}"),
                stats["bytes_per_vector"], stats["build_seconds"])
    return index


def _finish_stats(index: IvfIndex, t0: float) -> None:
    """Footprint observability: every build reports
    what it OWNS — statusd renders these as ``glint_serve_index_bytes`` /
    ``glint_serve_ann_bytes_per_vector``."""
    stats = index.stats
    stats["index_bytes"] = index.index_bytes
    stats["bytes_per_vector"] = (
        round(index.index_bytes / max(index.num_rows, 1), 2))
    if index._storage.kind == "pq":
        stats["pq_m"] = index._storage.m
    if index._storage.kind in ("pq", "int8"):
        stats["rerank"] = index._resolved_rerank(10)
