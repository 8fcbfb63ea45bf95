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

Saves are atomic (staged in a sibling temp directory, then swapped in); readers verify
the digests. The row-shards layout of the JAX package is read-compatible in its
metadata but not ported (multi-device work, ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from glint_word2vec_torch.config import Word2VecConfig

logger = logging.getLogger("glint_word2vec_torch")

DENSE_FORMAT_VERSION = 1
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


@dataclasses.dataclass
class TrainState:
    """Mid-training progress: iteration, lr-clock words, ``global_step`` (the hash-PRNG
    counter, so resume does not redraw the opening negatives) and ``batches_done`` in
    the current iteration (exact-step resume). ``shard_progress``/``shard_feed``
    belong to the JAX package's multi-process feeds; the port carries them through
    and refuses to resume from them."""

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
) -> None:
    """Atomic dense save with per-file SHA-256 digests in ``metadata.json``."""
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
        syn0 = np.asarray(syn0, dtype=np.float32)
        digests = {
            "words": _save_words_hashed(os.path.join(tmp, "words"), words),
            "counts.npy": _save_npy_hashed(os.path.join(tmp, "counts.npy"),
                                           np.asarray(counts, dtype=np.int64)),
            "syn0.npy": _save_npy_hashed(os.path.join(tmp, "syn0.npy"), syn0),
        }
        if syn1 is not None:
            digests["syn1.npy"] = _save_npy_hashed(
                os.path.join(tmp, "syn1.npy"), np.asarray(syn1, dtype=np.float32))
        meta = {
            "format_version": DENSE_FORMAT_VERSION,
            "framework": FRAMEWORK,
            "vocab_size": int(syn0.shape[0]),
            "vector_size": int(syn0.shape[1]),
            "config": config.to_dict(auto_markers=False),
            "train_state": (train_state or TrainState(finished=True)).to_dict(),
            "digests": digests,
        }
        with open(os.path.join(tmp, "metadata.json"), "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=2)
        old = None
        if os.path.exists(path):
            old = path + f".old-{os.getpid()}"
            os.rename(path, old)
        os.rename(tmp, path)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _verify_digests(path: str, meta: Dict[str, Any]) -> None:
    """Check every recorded SHA-256 digest against the bytes on disk (checkpoints
    without a digest map pass vacuously)."""
    for rel, want in sorted((meta.get("digests") or {}).items()):
        fp = os.path.join(path, rel.replace("/", os.sep))
        if not os.path.exists(fp):
            raise CheckpointCorruptError(
                f"checkpoint {path!r}: {rel!r} is recorded in the digest map but "
                f"missing on disk — torn or partially deleted checkpoint")
        got = _sha256_file(fp)
        if got != want:
            raise CheckpointCorruptError(
                f"checkpoint {path!r}: {rel!r} content digest {got[:12]}… does not "
                f"match the recorded {want[:12]}… — corrupt; refusing to load it")


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Integrity audit without loading the matrices: metadata parses, the format
    version is readable, the layout's files exist, and every digest matches.
    Returns the parsed metadata."""
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
    if meta.get("layout", "dense") == "dense":
        required.append("syn0.npy")
    for name in required:
        if not os.path.exists(os.path.join(path, name)):
            raise CheckpointCorruptError(
                f"checkpoint {path!r}: required file {name!r} missing — partial or "
                f"torn checkpoint")
    _verify_digests(path, meta)
    return meta


def load_latest_valid(directory: str) -> str:
    """Path of the newest checkpoint under ``directory`` that verifies, ordered by
    (global_step, words_processed, normal before swap debris, mtime).

    A recovery after a dead writer (it must not race a live saver): staging
    directories (``.*.tmp-*``) are deleted, a winning ``*.old-*`` swap leftover is
    renamed back to its base name, and superseded ones are deleted."""
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
        words = [line.rstrip("\n") for line in f if line.rstrip("\n")]
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
               verify: bool = True, check_ported: bool = True) -> Dict[str, Any]:
    """Read a dense checkpoint into host arrays: words, counts, syn0, syn1 (None if not
    saved), config, train_state. ``verify`` checks the SHA-256 digests first."""
    if header is None:
        header = load_model_header(path, check_ported=check_ported)
    if header["layout"] != "dense":
        raise NotImplementedError(
            f"checkpoint {path!r} uses the {header['layout']!r} layout; the port reads "
            "the dense layout only (row-shards are multi-device work, not ported yet)")
    if verify:
        with open(os.path.join(path, "metadata.json"), "r", encoding="utf-8") as f:
            _verify_digests(path, json.load(f))
    syn0 = np.load(os.path.join(path, "syn0.npy"))
    syn1_path = os.path.join(path, "syn1.npy")
    syn1 = np.load(syn1_path) if os.path.exists(syn1_path) else None
    if syn0.shape[0] != len(header["words"]):
        raise ValueError(f"words sidecar has {len(header['words'])} entries but syn0 "
                         f"has {syn0.shape[0]} rows")
    return {"words": header["words"], "counts": header["counts"], "syn0": syn0,
            "syn1": syn1, "config": header["config"],
            "train_state": header["train_state"]}
