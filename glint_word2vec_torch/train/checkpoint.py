"""Model persistence (dense layout), ported from ``glint_word2vec_tpu/train/checkpoint.py``.

One on-disk format for both packages, so a checkpoint written by either loads in the
other:

    path/
      words          one word per line, line order == embedding row order
      counts.npy     per-word corpus counts
      syn0.npy       input embeddings [V, D] float32
      syn1.npy       output embeddings [V, D] float32 (present iff trainable state saved)
      metadata.json  format version, framework, sizes, config, train_state, and the
                     SHA-256 digest of every data file

or, in the JAX package's row-shards layout (written by its multi-device runs),
``syn0.shards/rows-<start>-<stop>.npy`` and ``syn1.shards/...`` in place of the two
``.npy`` matrices, padded as they were sharded, the real sizes in ``metadata.json``.

Saves are atomic (staged in a sibling temp directory, then swapped in); readers verify
the digests. The port writes and reads both. A mesh fit (``parallel/``) writes the
row-shards layout, every rank its own rows (``save_model_sharded``), and
``load_params_into_plan`` streams one onto another mesh, a rank's rows at a time;
``save_row_shards`` is a one-writer row-shards save of syn0 alone. File writes,
digest checks and shard reads fan out over ``io_workers`` threads; the bytes written
and the arrays read are the same at any worker count.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.pipeline import ordered_pool_map
from glint_word2vec_torch.obs.spans import default_tracer
from glint_word2vec_torch.train import faults

logger = logging.getLogger("glint_word2vec_torch")

DENSE_FORMAT_VERSION = 1
SHARDED_FORMAT_VERSION = 2
# a checkpoint whose train state carries shard_progress stamps 3, so that readers
# that would drop the field refuse it instead (the JAX package's rule)
SHARD_PROGRESS_FORMAT_VERSION = 3
_READABLE_VERSIONS = (1, 2, 3)
FRAMEWORK = "glint_word2vec_torch"


class CheckpointCorruptError(ValueError):
    """A checkpoint failed integrity verification: missing or unparseable metadata,
    a file named in the digest map absent, or content whose SHA-256 does not match."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


_READ_BLOCK = 64 << 20  # bytes read and hashed at a time (hashlib drops the GIL)
_NPY_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _read_npy_hashed(path: str, device: Optional[torch.device] = None
                     ) -> Tuple[Optional[Any], str]:
    """Read a ``.npy`` file in one pass: its array and the SHA-256 of all its bytes.
    What is hashed is what is returned, and each byte is read once. On a CUDA
    ``device`` a float32 C-order payload goes block by block through two pinned
    staging buffers into a tensor there, with no host array (on an H100's host,
    faulting in a fresh 1.2 GB array costs ~0.5 s, half a SHA-256 pass). The array
    is None for a file this reader does not parse (an object array, a truncated or
    foreign file): the caller compares the digest and lets ``np.load`` judge it."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        try:
            shape, fortran, dtype = _NPY_HEADERS[np.lib.format.read_magic(f)](f)
        except (KeyError, ValueError):
            return None, _sha256_file(path)
        if dtype.hasobject:
            return None, _sha256_file(path)
        head = f.tell()
        f.seek(0)
        h.update(f.read(head))
        count = int(np.prod(shape))
        if (device is not None and device.type == "cuda" and not fortran
                and dtype == np.dtype(np.float32)):
            out, got = _stream_to_card(f, h, count * 4, device)
            out = out.view(torch.float32).view(shape)
        else:
            out = np.empty(count, dtype)
            buf = memoryview(out).cast("B")
            got = 0
            while got < len(buf):
                n = f.readinto(buf[got:got + _READ_BLOCK])
                if not n:
                    break
                h.update(buf[got:got + n])
                got += n
            out = out.reshape(shape, order="F" if fortran else "C")
        extra = 0
        for block in iter(lambda: f.read(1 << 20), b""):  # bytes past the payload
            h.update(block)
            extra += len(block)
    whole = got == count * dtype.itemsize and not extra
    return (out if whole else None), h.hexdigest()


def _stream_to_card(f, h, nbytes: int, device: torch.device) -> Tuple[torch.Tensor, int]:
    """Read ``nbytes`` of ``f`` into a uint8 tensor on ``device``, hashing each block
    into ``h``: a block is read into one pinned buffer and hashed while the other's
    copy runs on a side stream. Returns the tensor and the bytes read."""
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    stage = [torch.empty(min(_READ_BLOCK, nbytes), dtype=torch.uint8, pin_memory=True)
             for _ in range(2 if nbytes > _READ_BLOCK else 1)]
    copied: List[Optional[torch.cuda.Event]] = [None] * len(stage)
    stream = torch.cuda.Stream(device)
    got = k = 0
    with torch.cuda.stream(stream):
        while got < nbytes:
            if copied[k] is not None:
                copied[k].synchronize()  # this buffer's last copy has left it
            view = memoryview(stage[k].numpy())[:min(_READ_BLOCK, nbytes - got)]
            n = f.readinto(view)
            if not n:
                break
            h.update(view[:n])
            dst[got:got + n].copy_(stage[k][:n], non_blocking=True)
            copied[k] = torch.cuda.Event()
            copied[k].record(stream)
            got += n
            k = (k + 1) % len(stage)
    stream.synchronize()
    return dst, got


class _HashingWriter:
    """File proxy hashing every byte as it is written (one pass per file)."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()

    def write(self, data) -> int:
        self.sha.update(data)
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()

    def tell(self) -> int:
        return self._f.tell()


def _save_npy_hashed(path: str, arr: np.ndarray) -> str:
    with open(path, "wb") as f:
        w = _HashingWriter(f)
        np.save(w, arr)
    return w.sha.hexdigest()


def _save_words_hashed(path: str, words: List[str]) -> str:
    with open(path, "wb") as f:
        w = _HashingWriter(f)
        for word in words:
            w.write((word + "\n").encode("utf-8"))
    return w.sha.hexdigest()


def _run_io(tasks, workers: int) -> list:
    """Run independent no-argument I/O callables, their results in task order;
    ``workers <= 1`` runs them on the calling thread."""
    tasks = list(tasks)
    return list(ordered_pool_map(lambda t: t(), tasks, min(workers, len(tasks))))


def _format_version(base: int, train_state: Optional["TrainState"]) -> int:
    if train_state is not None and train_state.shard_progress is not None:
        return SHARD_PROGRESS_FORMAT_VERSION
    return base


# keys the checkpoint writers own; extra_metadata may not shadow them (a caller's
# "digests" or "config" would corrupt the contract)
_RESERVED_META_KEYS = frozenset({
    "format_version", "framework", "layout", "vocab_size", "vector_size",
    "padded_vocab", "padded_dim", "config", "train_state", "digests"})


def _merge_extra_metadata(meta: Dict[str, Any], extra: Optional[Dict[str, Any]]) -> None:
    if not extra:
        return
    clash = sorted(_RESERVED_META_KEYS & set(extra))
    if clash:
        raise ValueError(
            f"extra_metadata may not shadow writer-owned metadata keys "
            f"{clash}; pick different names")
    meta.update(extra)


@dataclasses.dataclass
class TrainState:
    """Mid-training progress: iteration, lr-clock words, ``global_step`` (the hash-PRNG
    counter, so resume does not redraw the opening negatives) and ``batches_done`` in
    the current iteration (exact-step resume). ``shard_progress``/``shard_feed``
    index the JAX package's sharded streams: per process for ``"pairs"``, per data
    segment for ``"tokens"`` (every device-feed run writes them, the port's too, so
    that either package can resume the other's checkpoint); the port resumes a
    device-feed checkpoint from ``batches_done`` and refuses the rest."""

    iteration: int = 1
    words_processed: int = 0
    finished: bool = False
    global_step: int = 0
    batches_done: int = 0
    shard_progress: Optional[List[List[int]]] = None
    shard_feed: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainState":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def save_model(
    path: str,
    words: List[str],
    counts: np.ndarray,
    syn0: np.ndarray,
    syn1: Optional[np.ndarray],
    config: Word2VecConfig,
    train_state: Optional[TrainState] = None,
    extra_metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Atomic dense save with per-file SHA-256 digests in ``metadata.json``, each
    digest taken in its file's write pass; the file writes fan out over
    ``config.io_workers`` threads. ``extra_metadata``: additive keys merged into
    ``metadata.json`` (the continual runner's ``vocab_lineage``); a writer-owned key
    is refused. The fault plan's crash points ``save:arrays-written``,
    ``save:staged`` and ``save:swap`` (the torn window: ``path`` absent while its
    ``.old-*`` predecessor and the ``.tmp-*`` staging directory are live) sit where the
    JAX package has them, and ``corrupt_checkpoint`` runs after the save; the save is a
    ``checkpoint_save`` span of the process-wide tracer."""
    with default_tracer().span("checkpoint_save"):
        _save_model(path, words, counts, syn0, syn1, config, train_state, extra_metadata)
    faults.corrupt_checkpoint(path)


def _save_model(path, words, counts, syn0, syn1, config, train_state,
                extra_metadata) -> None:
    bad = [w for w in words if (not w) or ("\n" in w)]
    if bad:
        raise ValueError(
            f"cannot save vocabulary: {len(bad)} token(s) are empty or contain newlines "
            f"(first: {bad[0]!r}); the words sidecar is newline-delimited")
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(path)}.tmp-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        def stage(name: str) -> str:
            return os.path.join(tmp, name)

        syn0 = np.asarray(syn0, dtype=np.float32)
        tasks = [lambda: _save_words_hashed(stage("words"), words),
                 lambda: _save_npy_hashed(stage("counts.npy"),
                                          np.asarray(counts, dtype=np.int64)),
                 lambda: _save_npy_hashed(stage("syn0.npy"), syn0)]
        names = ["words", "counts.npy", "syn0.npy"]
        if syn1 is not None:
            tasks.append(lambda: _save_npy_hashed(stage("syn1.npy"),
                                                  np.asarray(syn1, dtype=np.float32)))
            names.append("syn1.npy")
        digests = dict(zip(names, _run_io(tasks, config.io_workers)))
        faults.crash_point("save:arrays-written")
        train_state = train_state or TrainState(finished=True)
        meta = {
            "format_version": _format_version(DENSE_FORMAT_VERSION, train_state),
            "framework": FRAMEWORK,
            "vocab_size": int(syn0.shape[0]),
            "vector_size": int(syn0.shape[1]),
            "config": config.to_dict(auto_markers=False),
            "train_state": train_state.to_dict(),
            "digests": digests,
        }
        _merge_extra_metadata(meta, extra_metadata)
        with open(stage("metadata.json"), "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=2)
        faults.crash_point("save:staged")
        old = None
        if os.path.exists(path):
            old = path + f".old-{os.getpid()}"
            os.rename(path, old)
        faults.crash_point("save:swap")  # the torn window: path absent, old and tmp live
        os.rename(tmp, path)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class ShardedMatrixReader:
    """Memory-mapped reader over a ``*.shards/`` directory of the row-shards layout:
    row ranges and scattered rows without assembling the whole matrix.

    A bf16 run's shards hold numpy's raw 2-byte void ``|V2`` (numpy has no bfloat16);
    their bytes are read as int16, viewed as ``torch.bfloat16`` and widened to
    float32, exactly the values the JAX package's reader returns as bfloat16."""

    _VOID2 = np.dtype("V2")

    @classmethod
    def _undo_void(cls, arr: np.ndarray) -> np.ndarray:
        if arr.dtype != cls._VOID2:
            return arr
        bits = torch.from_numpy(np.array(arr).view(np.int16))  # a writable copy
        return bits.view(torch.bfloat16).to(torch.float32).numpy()

    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        self._mmap_cache: Optional[List[tuple]] = None
        self._spans: List[tuple] = []
        for fname in sorted(os.listdir(dirpath)):
            if not fname.startswith("rows-"):
                continue
            start, stop = (int(x) for x in fname[len("rows-"):-len(".npy")].split("-"))
            self._spans.append((start, stop, fname))
        if not self._spans:
            raise FileNotFoundError(f"no shard files under {dirpath!r}")
        self._spans.sort()
        self.rows = self._spans[-1][1]
        probe = self._load(self._spans[0][2])
        self.cols = probe.shape[1]
        self.dtype = np.dtype(np.float32) if probe.dtype == self._VOID2 else probe.dtype
        prev = 0
        for start, stop, _ in self._spans:
            if start != prev:
                raise ValueError(f"shard gap/overlap at row {prev} (next shard starts "
                                 f"{start}) under {dirpath!r}")
            prev = stop

    def _load(self, fname: str) -> np.ndarray:
        return np.load(os.path.join(self.dirpath, fname), mmap_mode="r")

    def read(self, start: int, stop: int, workers: int = 1) -> np.ndarray:
        """Rows [start, stop) from the overlapping shard files (only their pages are
        read); ``workers`` copies the shards' ranges concurrently into disjoint
        slices."""
        out = np.empty((stop - start, self.cols), dtype=self.dtype)

        def copy_span(span):
            s, e, fname = span
            lo, hi = max(start, s), min(stop, e)
            if lo < hi:
                out[lo - start:hi - start] = self._undo_void(
                    self._load(fname)[lo - s:hi - s])

        _run_io([lambda sp=sp: copy_span(sp) for sp in self._spans], workers)
        return out

    def read_all(self, workers: int = 1) -> np.ndarray:
        return self.read(0, self.rows, workers=workers)

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Rows by id, in ``ids`` order, through per-shard mmap handles opened once."""
        ids = np.asarray(ids)
        if self._mmap_cache is None:
            self._mmap_cache = [(s, e, self._load(fname)) for s, e, fname in self._spans]
        out = np.empty((ids.size, self.cols), dtype=self.dtype)
        for s, e, m in self._mmap_cache:
            sel = (ids >= s) & (ids < e)
            if sel.any():
                out[sel] = self._undo_void(m[ids[sel] - s])
        return out


def save_row_shards(path: str, words: List[str], counts: np.ndarray,
                    syn0: np.ndarray, config: Word2VecConfig,
                    rows_per_shard: int,
                    extra_metadata: Optional[Dict[str, Any]] = None) -> None:
    """A one-writer row-shards checkpoint of ``syn0`` at ``path`` (no syn1): the layout
    the JAX package's ``save_model_sharded`` writes and :class:`ShardedMatrixReader`
    reads, files ``syn0.shards/rows-<start>-<stop>.npy`` beside ``words``,
    ``counts.npy`` and a ``metadata.json`` with their digests. ``path`` must not exist;
    the save is not staged (:func:`save_model_sharded` is the staged, multi-process
    writer). ``extra_metadata`` as in :func:`save_model`."""
    os.makedirs(os.path.join(path, "syn0.shards"))
    digests = {"words": _save_words_hashed(os.path.join(path, "words"), words),
               "counts.npy": _save_npy_hashed(os.path.join(path, "counts.npy"),
                                              np.asarray(counts, np.int64))}
    V, D = syn0.shape
    for lo in range(0, V, rows_per_shard):
        hi = min(lo + rows_per_shard, V)
        rel = f"syn0.shards/rows-{lo:010d}-{hi:010d}.npy"
        digests[rel] = _save_npy_hashed(os.path.join(path, rel),
                                        np.ascontiguousarray(syn0[lo:hi], np.float32))
    meta = {"format_version": SHARDED_FORMAT_VERSION, "framework": FRAMEWORK,
            "layout": "row-shards",
            "vocab_size": V, "vector_size": D, "padded_vocab": V, "padded_dim": D,
            "config": config.to_dict(auto_markers=False),
            "train_state": TrainState(finished=True).to_dict(),
            "digests": digests}
    _merge_extra_metadata(meta, extra_metadata)
    with open(os.path.join(path, "metadata.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)


def _shard_array(t) -> np.ndarray:
    """A row block as the array its ``rows-*.npy`` file holds: f32 as it is, bf16 as
    numpy's raw 2-byte void (the bytes the JAX package's bf16 shards hold)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.detach().view(torch.int16).cpu().numpy().view(np.dtype("V2"))
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_model_sharded(
    path: str,
    words: List[str],
    counts: np.ndarray,
    syn0,
    syn1,
    config: Word2VecConfig,
    train_state: Optional[TrainState] = None,
    *,
    plan=None,
    vocab_size: Optional[int] = None,
    vector_size: Optional[int] = None,
    extra_metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Row-shards save, the JAX package's ``save_model_sharded``: every rank writes its
    own rows, and rank 0 writes the metadata and swaps the directory into place between
    barriers. ``syn0``/``syn1`` are this rank's padded row blocks exactly as trained
    (torch or numpy; ``syn1`` may be None) on ``plan`` (a :class:`..parallel.mesh
    .MeshPlan`), or the whole padded matrices when ``plan`` is None (one writer, the
    same protocol). Only the ranks of data index 0 write (the other data replicas hold
    the same rows). ``vocab_size`` / ``vector_size`` record the real extents.

    Staging: ``.<name>.tmp-sharded`` beside ``path`` (every rank writes into it: the
    shared-filesystem contract), digest sidecars a rank, merged by rank 0 after the
    write barrier. The crash points ``save:arrays-written`` (every rank),
    ``save:staged`` and ``save:swap`` (rank 0, the torn window: ``path`` absent, its
    ``.old-swap`` and the staging directory live) sit where the JAX package has them,
    so a killed save leaves the previous checkpoint loadable
    (:func:`load_latest_valid`). A rank that raises between the barriers fails the
    others' next barrier: a partial save is never swapped in."""
    from glint_word2vec_torch.parallel import distributed

    bad = [w for w in words if (not w) or ("\n" in w)]
    if bad:
        raise ValueError(
            f"cannot save vocabulary: {len(bad)} token(s) are empty or contain newlines "
            f"(first: {bad[0]!r}); the words sidecar is newline-delimited")
    multi = plan is not None and plan.size > 1
    rank = plan.rank if multi else 0
    writes = not multi or plan.data_index == 0
    rows = int(syn0.shape[0])
    lo = plan.model_index * rows if multi else 0
    padded_vocab = rows * plan.num_model if multi else rows

    def barrier():
        if multi:
            distributed.COLLECTIVES.barrier(distributed.host_group())

    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(path)}.tmp-sharded")
    with default_tracer().span("checkpoint_save"):
        if rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        barrier()
        try:
            digests: Dict[str, str] = {}
            if writes:
                fname = f"rows-{lo:010d}-{lo + rows:010d}.npy"
                jobs = [(name, m) for name, m in (("syn0", syn0), ("syn1", syn1))
                        if m is not None]
                for name, _ in jobs:
                    os.makedirs(os.path.join(tmp, f"{name}.shards"), exist_ok=True)
                got = _run_io([lambda name=name, m=m: _save_npy_hashed(
                    os.path.join(tmp, f"{name}.shards", fname), _shard_array(m))
                    for name, m in jobs], config.io_workers)
                digests = {f"{name}.shards/{fname}": d
                           for (name, _), d in zip(jobs, got)}
                with open(os.path.join(tmp, f".digests-{rank}.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(digests, f)
            faults.crash_point("save:arrays-written")
            barrier()
            if rank == 0:
                digests = {}
                for name in sorted(os.listdir(tmp)):
                    if name.startswith(".digests-"):
                        with open(os.path.join(tmp, name), encoding="utf-8") as f:
                            digests.update(json.load(f))
                        os.unlink(os.path.join(tmp, name))
                digests["words"] = _save_words_hashed(os.path.join(tmp, "words"), words)
                digests["counts.npy"] = _save_npy_hashed(
                    os.path.join(tmp, "counts.npy"), np.asarray(counts, dtype=np.int64))
                meta = {
                    "format_version": _format_version(SHARDED_FORMAT_VERSION,
                                                      train_state),
                    "framework": FRAMEWORK,
                    "layout": "row-shards",
                    "vocab_size": int(vocab_size if vocab_size is not None
                                      else padded_vocab),
                    "vector_size": int(vector_size if vector_size is not None
                                       else syn0.shape[1]),
                    "padded_vocab": int(padded_vocab),
                    "padded_dim": int(syn0.shape[1]),
                    "config": config.to_dict(auto_markers=False),
                    "train_state": (train_state or TrainState(finished=True)).to_dict(),
                    "digests": digests,
                }
                _merge_extra_metadata(meta, extra_metadata)
                with open(os.path.join(tmp, "metadata.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(meta, f, indent=2)
                faults.crash_point("save:staged")
                old = None
                if os.path.exists(path):
                    old = path + ".old-swap"
                    if os.path.exists(old):
                        shutil.rmtree(old)
                    os.rename(path, old)
                faults.crash_point("save:swap")
                os.rename(tmp, path)
                if old is not None:
                    shutil.rmtree(old)
            barrier()
        except BaseException:
            if rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
    if rank == 0:
        faults.corrupt_checkpoint(path)


def load_params_into_plan(path: str, plan, padded_vocab: int, padded_dim: int,
                          dtype=torch.float32, verify: bool = False,
                          io_workers: Optional[int] = None, device=None):
    """Stream a row-shards checkpoint onto ``plan`` (which may differ from the mesh
    that wrote it: elastic resume): this rank's row block ``[lo, hi)`` of the
    ``[padded_vocab, padded_dim]`` target is read from the memory-mapped shard files
    (only the overlapping ranges), zero-padded past the real extents, and never a
    dense copy of the whole matrix. ``plan`` None reads the whole padded matrices.
    Returns a :class:`..parallel.mesh.LocalShards` of ``dtype`` tensors on ``device``
    (the host when None); syn1 is None if the checkpoint has none. ``verify=True``
    checks the digests first (one extra read of every shard file)."""
    from glint_word2vec_torch.parallel.mesh import LocalShards

    with open(os.path.join(path, "metadata.json"), "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("layout") != "row-shards":
        raise ValueError(f"{path!r} is not a row-shards checkpoint")
    if io_workers is None:
        io_workers = int(meta.get("config", {}).get("io_workers", 1))
    if verify:
        _verify_digests(path, meta, workers=io_workers)
    V, Dr = meta["vocab_size"], meta["vector_size"]
    lo, hi = plan.rows(padded_vocab) if plan is not None else (0, padded_vocab)
    d = min(Dr, padded_dim)

    def make(name: str):
        dirpath = os.path.join(path, f"{name}.shards")
        if not os.path.isdir(dirpath):
            return None
        block = np.zeros((hi - lo, padded_dim), dtype=np.float32)
        top = min(hi, V)  # rows past the real vocabulary stay zero
        if lo < top:
            src = ShardedMatrixReader(dirpath).read(lo, top, workers=io_workers)
            block[:top - lo, :d] = src[:, :d]
        t = torch.from_numpy(block).to(dtype)
        return t if device is None else t.to(device)

    return LocalShards(make("syn0"), make("syn1"))


def _verify_digests(path: str, meta: Dict[str, Any], workers: int = 1) -> None:
    """Check every recorded SHA-256 digest against the bytes on disk (checkpoints
    without a digest map pass vacuously); ``workers`` hashes files concurrently, and
    failures are reported in sorted-name order either way."""
    items = _digest_items(path, meta)
    got_all = _run_io([lambda rel=rel: _sha256_file(os.path.join(
        path, rel.replace("/", os.sep))) for rel, _ in items], workers)
    _check_digests(path, items, dict(zip((rel for rel, _ in items), got_all)))


def _digest_items(path: str, meta: Dict[str, Any]) -> List[tuple]:
    """The digest map's (name, digest) pairs in sorted-name order, every file present."""
    items = sorted((meta.get("digests") or {}).items())
    for rel, _ in items:
        if not os.path.exists(os.path.join(path, rel.replace("/", os.sep))):
            raise CheckpointCorruptError(
                f"checkpoint {path!r}: {rel!r} is recorded in the digest map but "
                f"missing on disk — torn or partially deleted checkpoint")
    return items


def _check_digests(path: str, items: List[tuple], got: Dict[str, str]) -> None:
    for rel, want in items:
        if got[rel] != want:
            raise CheckpointCorruptError(
                f"checkpoint {path!r}: {rel!r} content digest {got[rel][:12]}… does "
                f"not match the recorded {want[:12]}… — corrupt; refusing to load it")


def verify_checkpoint(path: str, io_workers: int = 1) -> Dict[str, Any]:
    """Integrity audit without loading the matrices: metadata parses, the format
    version is readable, the layout's files exist (shard spans gapless), and every
    digest matches. Returns the parsed metadata."""
    meta_path = os.path.join(path, "metadata.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no metadata.json under {path!r}")
    try:
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: metadata.json unreadable ({e})") from e
    version = meta.get("format_version")
    if version not in _READABLE_VERSIONS:
        raise CheckpointCorruptError(
            f"checkpoint {path!r}: unsupported format_version {version}")
    required = ["words", "counts.npy"]
    if meta.get("layout") == "row-shards":
        for dirname in ("syn0.shards", "syn1.shards"):
            if dirname == "syn1.shards" and not os.path.isdir(os.path.join(path, dirname)):
                continue
            try:
                ShardedMatrixReader(os.path.join(path, dirname))
            except (OSError, ValueError) as e:
                raise CheckpointCorruptError(
                    f"checkpoint {path!r}: {dirname} unreadable ({e})") from e
    else:
        required.append("syn0.npy")
    for name in required:
        if not os.path.exists(os.path.join(path, name)):
            raise CheckpointCorruptError(
                f"checkpoint {path!r}: required file {name!r} missing — partial or "
                f"torn checkpoint")
    _verify_digests(path, meta, workers=io_workers)
    return meta


def load_latest_valid(directory: str, reclaim: bool = True) -> str:
    """Path of the newest checkpoint under ``directory`` that verifies, ordered by
    (global_step, words_processed, normal before swap debris, mtime).

    With ``reclaim=True`` this is the recovery after a dead writer (it must not race a
    live saver): staging directories (``.*.tmp-*``) are deleted, a winning
    ``*.old-*`` swap leftover is renamed back to its base name, and superseded ones
    are deleted. ``reclaim=False`` touches nothing, for readers that may overlap a
    running trainer: a winning ``*.old-*`` is returned at its debris path."""
    try:
        entries = sorted(os.listdir(directory))
    except OSError as e:
        raise FileNotFoundError(
            f"cannot scan checkpoint directory {directory!r}: {e}") from e
    candidates = []  # (kind, name, path)
    for name in entries:
        p = os.path.join(directory, name)
        if not os.path.isdir(p):
            continue
        if ".tmp-" in name:
            if reclaim:
                logger.info("reclaiming interrupted-save staging dir %s", p)
                shutil.rmtree(p, ignore_errors=True)
            continue
        candidates.append(("old" if ".old-" in name else "normal", name, p))
    best = None  # (sort key, kind, name, path)
    for kind, name, p in candidates:
        try:
            meta = verify_checkpoint(p)
        except (FileNotFoundError, ValueError) as e:
            logger.warning("skipping unverifiable checkpoint %s: %s", p, e)
            continue
        ts = meta.get("train_state") or {}
        key = (int(ts.get("global_step") or 0), int(ts.get("words_processed") or 0),
               1 if kind == "normal" else 0, os.path.getmtime(p))
        if best is None or key > best[0]:
            best = (key, kind, name, p)
    if best is None:
        raise FileNotFoundError(
            f"no verifiable checkpoint under {directory!r} "
            f"({len(candidates)} candidate(s) scanned)")
    _, kind, name, p = best
    if not reclaim:
        return p
    if kind == "old":
        base = os.path.join(directory, name.split(".old-")[0])
        if os.path.exists(base):
            shutil.rmtree(base)
        os.rename(p, base)
        logger.warning("recovered checkpoint %s from interrupted-save debris %s",
                       base, name)
        p = base
    for kind2, _, p2 in candidates:
        if kind2 == "old" and p2 != best[3] and os.path.exists(p2):
            logger.info("reclaiming superseded swap debris %s", p2)
            shutil.rmtree(p2, ignore_errors=True)
    return p


def load_model_header(path: str, check_ported: bool = True) -> Dict[str, Any]:
    """Everything except the matrices: metadata, words sidecar, counts, config,
    train state. ``check_ported=False`` accepts a config with knobs the port has not
    implemented (for reading a model, not for resuming its training)."""
    meta_path = os.path.join(path, "metadata.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no metadata.json under {path!r}")
    with open(meta_path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    version = meta.get("format_version")
    if version not in _READABLE_VERSIONS:
        raise ValueError(f"unsupported checkpoint format_version {version}")
    with open(os.path.join(path, "words"), "r", encoding="utf-8") as f:
        words = [w for w in f.read().split("\n") if w]
    counts = np.load(os.path.join(path, "counts.npy"))
    declared = meta.get("vocab_size")
    if declared is not None and declared != len(words):
        raise ValueError(
            f"words sidecar has {len(words)} entries but metadata declares vocab_size "
            f"{declared} — corrupt or hand-edited checkpoint")
    return {
        "words": words,
        "counts": counts,
        "layout": meta.get("layout", "dense"),
        "vocab_size": meta.get("vocab_size", len(words)),
        "vector_size": meta.get("vector_size"),
        "config": Word2VecConfig.from_dict(meta["config"], check_ported=check_ported),
        "train_state": TrainState.from_dict(meta.get("train_state", {})),
        "vocab_lineage": meta.get("vocab_lineage", []),
    }


def load_model(path: str, header: Optional[Dict[str, Any]] = None,
               verify: bool = True, check_ported: bool = True,
               io_workers: Optional[int] = None,
               device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Read a checkpoint of either layout: words, counts, syn0, syn1 (None if not
    saved), config, train_state. A row-shards checkpoint is sliced to its real
    (vocab_size, vector_size). ``verify`` checks the SHA-256 digests; a dense matrix is
    hashed as it is read, so each of its bytes is read once. ``io_workers`` (default:
    the saved config's) fans the hashing, the matrix reads and the shard copies over
    threads. The matrices are host arrays, or float32 tensors on ``device`` if one is
    given (a dense float32 matrix streams there as it is read and hashed)."""
    if header is None:
        header = load_model_header(path, check_ported=check_ported)
    if io_workers is None:
        io_workers = header["config"].io_workers

    def place(a):
        if device is None or isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.asarray(a)).to(device, torch.float32)

    items: List[tuple] = []
    if verify:
        with open(os.path.join(path, "metadata.json"), "r", encoding="utf-8") as f:
            meta = json.load(f)
        if header["layout"] == "row-shards":
            _verify_digests(path, meta, workers=io_workers)
        else:
            items = _digest_items(path, meta)
    if header["layout"] == "row-shards":
        V, Dr = header["vocab_size"], header["vector_size"]
        per = max(1, io_workers // 2)  # each matrix fans its own shard copies

        def read(name: str):
            d = os.path.join(path, f"{name}.shards")
            if not os.path.isdir(d):
                return None
            return ShardedMatrixReader(d).read(0, V, workers=per)[:, :Dr]

        syn0, syn1 = _run_io([lambda: read("syn0"), lambda: read("syn1")], io_workers)
        syn0 = place(syn0)
        syn1 = place(syn1) if syn1 is not None else None
    else:
        want = dict(items)
        mats = [rel for rel in ("syn0.npy", "syn1.npy")
                if rel == "syn0.npy" or os.path.exists(os.path.join(path, rel))]

        def read_dense(rel: str) -> tuple:  # (matrix or None, digest or None)
            p = os.path.join(path, rel)
            if rel not in mats:
                return None, _sha256_file(p)
            if not verify:
                return place(np.load(p)), None
            arr, got = _read_npy_hashed(p, device)
            if want.get(rel, got) != got:
                return None, got  # refused below, in sorted-name order
            return place(np.load(p) if arr is None else arr), got

        order = mats + sorted(rel for rel in want if rel not in mats)
        out = dict(zip(order, _run_io([lambda rel=rel: read_dense(rel) for rel in order],
                                      io_workers)))
        _check_digests(path, items, {rel: got for rel, (_, got) in out.items()})
        syn0 = out["syn0.npy"][0]
        syn1 = out["syn1.npy"][0] if "syn1.npy" in out else None
    if syn0.shape[0] != len(header["words"]):
        raise ValueError(f"words sidecar has {len(header['words'])} entries but syn0 "
                         f"has {syn0.shape[0]} rows")
    return {"words": header["words"], "counts": header["counts"], "syn0": syn0,
            "syn1": syn1, "config": header["config"],
            "train_state": header["train_state"]}
