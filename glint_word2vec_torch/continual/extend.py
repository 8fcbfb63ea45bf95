"""Incremental vocabulary extension, ported from ``glint_word2vec_tpu/continual/extend.py``:
grow a checkpoint onto a drifted corpus.

Given a checkpoint and the word counts of a corpus tail, :func:`extend_checkpoint`

1. computes the **vocab delta** (:func:`compute_vocab_delta`): new words past
   ``min_count`` and merged counts for the surviving words;
2. builds the **extended vocabulary** with the *identity-prefix* contract
   (:func:`extended_vocabulary`): surviving words keep their exact indices (a re-sort
   by the merged counts would permute every row and invalidate every cached encode),
   new words append after them in descending tail-count order;
3. grows ``syn0``/``syn1`` by the new rows (:func:`grow_arrays`): surviving rows carried
   bit for bit (verified against the written bytes, or the parent's digests), new
   ``syn0`` rows seeded U(-0.5/D, 0.5/D) from numpy's ``default_rng([seed, V_old,
   n_new])`` (:func:`seed_new_rows`; the JAX package's stream, so an extension is
   bit-identical in both packages), new ``syn1`` rows zero;
4. appends a link to the **fingerprint lineage chain** (``metadata.json
   ["vocab_lineage"]``), which ``Word2Vec.resume`` and the delta encode read to accept
   encode caches written under any ancestor vocabulary.

Both layouts: the **row-shards** path grows per shard through the port's
:class:`..train.checkpoint.ShardedMatrixReader` and never holds a whole matrix (shards
below ``V_old`` copied verbatim and hash-verified in the copy pass, the boundary shard
sliced at ``V_old``, padding shards dropped, one new shard ``rows-<V_old>-<V_new>``).

The alias table is not stored in checkpoints: the next increment's trainer rebuilds it
from the merged counts. Extension is host work between fits, one process, no device.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from glint_word2vec_torch.data.corpus import vocab_fingerprint
from glint_word2vec_torch.data.vocab import Vocabulary, count_words
from glint_word2vec_torch.train.checkpoint import (
    FRAMEWORK,
    SHARDED_FORMAT_VERSION,
    CheckpointCorruptError,
    ShardedMatrixReader,
    TrainState,
    _format_version,
    _HashingWriter,
    _merge_extra_metadata,
    _save_npy_hashed,
    _save_words_hashed,
    _sha256_file,
    load_model,
    load_model_header,
    save_model,
)

logger = logging.getLogger("glint_word2vec_torch")

#: The only remap kind this writer emits: surviving words keep their indices, new
#: words append. Readers that meet an unknown kind must refuse, not guess.
REMAP_IDENTITY_PREFIX = "identity-prefix"


@dataclasses.dataclass
class VocabDelta:
    """The difference between a checkpoint's vocabulary and a corpus tail."""

    new_words: List[str]        # promoted words, descending tail count
    new_counts: np.ndarray      # int64 [len(new_words)]: tail counts
    merged_counts: np.ndarray   # int64 [V_old]: old counts + tail counts
    tail_words_total: int       # tail occurrences seen, dropped ones included

    @property
    def num_new(self) -> int:
        return len(self.new_words)


def compute_vocab_delta(vocab: Vocabulary, tail_counts: Mapping[str, int],
                        min_count: int) -> VocabDelta:
    """Split a tail's word counts into merged survivor counts and promoted new words.
    Promotion uses the tail count alone (a checkpoint keeps counts only for the words
    that made its vocabulary); new words sort by descending tail count, ties in
    first-seen order."""
    merged = vocab.counts.copy()
    fresh: List[tuple] = []
    total = 0
    for w, c in tail_counts.items():
        total += int(c)
        i = vocab.get(w)
        if i >= 0:
            merged[i] += int(c)
        elif c >= min_count:
            fresh.append((w, int(c)))
    fresh.sort(key=lambda wc: -wc[1])
    return VocabDelta(new_words=[w for w, _ in fresh],
                      new_counts=np.asarray([c for _, c in fresh], dtype=np.int64),
                      merged_counts=merged, tail_words_total=total)


def extended_vocabulary(vocab: Vocabulary, delta: VocabDelta) -> Vocabulary:
    """Old words at their old indices (merged counts), new words appended: the
    descending-count order of a fresh vocabulary is given up to keep row identity."""
    if not delta.num_new:
        return Vocabulary.from_words_and_counts(vocab.words, delta.merged_counts)
    return Vocabulary.from_words_and_counts(
        list(vocab.words) + list(delta.new_words),
        np.concatenate([delta.merged_counts, delta.new_counts]))


def seed_new_rows(n_new: int, vector_size: int, seed: int, old_vocab_size: int,
                  dtype=np.float32) -> np.ndarray:
    """The grown ``syn0`` rows: U(-0.5/D, 0.5/D) keyed by ``(seed, V_old, n_new)``, so
    the same extension reproduces bit for bit and a later one (another V_old) draws a
    fresh stream."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(old_vocab_size), int(n_new)])
    lim = 0.5 / float(vector_size)
    return rng.uniform(-lim, lim, size=(n_new, vector_size)).astype(dtype)


def lineage_entry(old_vocab: Vocabulary, new_vocab: Vocabulary, delta: VocabDelta,
                  tail_fingerprint: Optional[str] = None) -> Dict[str, Any]:
    """One link of the chain. ``tail_fingerprint`` names the tail this migration merged:
    a retry compares it with the chain's last link to recognise a merge already
    applied instead of counting the tail twice."""
    entry = {
        "parent_fingerprint": vocab_fingerprint(old_vocab),
        "fingerprint": vocab_fingerprint(new_vocab),
        "old_vocab_size": old_vocab.size,
        "new_vocab_size": new_vocab.size,
        "new_words": delta.num_new,
        "remap": REMAP_IDENTITY_PREFIX,
    }
    if tail_fingerprint is not None:
        entry["tail_fingerprint"] = tail_fingerprint
    return entry


def lineage_fingerprints(lineage: Sequence[Mapping[str, Any]]) -> List[str]:
    """Every fingerprint a chain names, parents and children: encode caches written
    under any of them are valid under the current vocabulary. An unknown remap kind
    could have moved ids, so nothing before it counts."""
    out: List[str] = []
    for entry in lineage:
        if entry.get("remap") != REMAP_IDENTITY_PREFIX:
            out.clear()
            continue
        for key in ("parent_fingerprint", "fingerprint"):
            fp = entry.get(key)
            if isinstance(fp, str) and fp not in out:
                out.append(fp)
    return out


def grow_arrays(syn0: np.ndarray, syn1: Optional[np.ndarray], delta: VocabDelta,
                vector_size: int, seed: int) -> tuple:
    """Dense growth: carried rows copied, never transformed; new ``syn0`` rows seeded,
    new ``syn1`` rows zero."""
    n = delta.num_new
    if n == 0:
        return syn0, syn1
    V_old, cols = syn0.shape
    new0 = np.zeros((n, cols), dtype=syn0.dtype)
    new0[:, :vector_size] = seed_new_rows(n, vector_size, seed, V_old, dtype=syn0.dtype)
    g0 = np.concatenate([np.asarray(syn0), new0])
    g1 = None
    if syn1 is not None:
        g1 = np.concatenate([np.asarray(syn1), np.zeros((n, cols), dtype=syn1.dtype)])
    return g0, g1


def extend_checkpoint(
    checkpoint_path: str,
    tail: "Iterable[Sequence[str]] | Mapping[str, int]",
    out_path: Optional[str] = None,
    min_count: Optional[int] = None,
    min_new_words: int = 1,
    tail_fingerprint: Optional[str] = None,
    verify: bool = True,
) -> Dict[str, Any]:
    """Migrate a checkpoint onto a drifted corpus: grow the vocabulary and the
    matrices, merge the counts, append the lineage link.

    ``tail``: a word -> count mapping or an iterable of token sequences (counted here).
    ``out_path`` defaults to in place, through the atomic save, so the write is also a
    publish a serving watcher picks up. ``min_count`` defaults to the checkpoint
    config's. Fewer than ``min_new_words`` promoted words grow nothing, but the counts
    still merge and a link (``new_words: 0``) is still appended. ``verify`` re-reads
    the carried rows of a dense result and compares them with the source, or checks
    every carried shard against the parent's digests in its copy pass. A tail whose
    ``tail_fingerprint`` is the chain's last link was already merged: nothing is
    written. Returns a report: sizes, new words, the link, the output path."""
    header = load_model_header(checkpoint_path, check_ported=False)
    cfg = header["config"]
    if min_count is None:
        min_count = cfg.min_count
    old_vocab = Vocabulary.from_words_and_counts(header["words"], header["counts"])
    counts = tail if isinstance(tail, Mapping) else count_words(tail)
    prior = list(header.get("vocab_lineage") or [])
    if (tail_fingerprint is not None and prior
            and prior[-1].get("tail_fingerprint") == tail_fingerprint):
        # a crashed attempt already merged this exact tail (it died between its
        # extension publish and its cursor save): merging again would count it twice
        logger.info("extension for tail %s already applied to %s; skipping the "
                    "re-merge", tail_fingerprint, checkpoint_path)
        return {
            "old_vocab_size": prior[-1]["old_vocab_size"],
            "new_vocab_size": prior[-1]["new_vocab_size"],
            "new_words": prior[-1]["new_words"],
            "tail_words_total": 0,
            "lineage_entry": prior[-1],
            "lineage_depth": len(prior),
            "path": out_path or checkpoint_path,
            "layout": header["layout"],
            "already_applied": True,
        }
    delta = compute_vocab_delta(old_vocab, counts, min_count)
    if delta.num_new < max(min_new_words, 1):
        delta = VocabDelta(new_words=[], new_counts=np.zeros(0, dtype=np.int64),
                           merged_counts=delta.merged_counts,
                           tail_words_total=delta.tail_words_total)
    new_vocab = extended_vocabulary(old_vocab, delta)
    entry = lineage_entry(old_vocab, new_vocab, delta, tail_fingerprint)
    chain = prior + [entry]
    dst = out_path or checkpoint_path
    extend = _extend_row_shards if header["layout"] == "row-shards" else _extend_dense
    extend(checkpoint_path, dst, header, new_vocab, delta, chain, header["train_state"],
           verify=verify)
    logger.info("extended checkpoint %s: vocab %d -> %d (+%d new words, %d tail "
                "occurrences) -> %s", checkpoint_path, old_vocab.size, new_vocab.size,
                delta.num_new, delta.tail_words_total, dst)
    return {
        "old_vocab_size": old_vocab.size,
        "new_vocab_size": new_vocab.size,
        "new_words": delta.num_new,
        "tail_words_total": delta.tail_words_total,
        "lineage_entry": entry,
        "lineage_depth": len(chain),
        "path": dst,
        "layout": header["layout"],
    }


def _extend_dense(src: str, dst: str, header: Dict[str, Any], new_vocab: Vocabulary,
                  delta: VocabDelta, chain: List[dict], state: TrainState,
                  verify: bool) -> None:
    data = load_model(src, header=header, verify=False)
    syn0, syn1 = grow_arrays(data["syn0"], data["syn1"], delta,
                             header["vector_size"] or data["syn0"].shape[1],
                             header["config"].seed)
    save_model(dst, new_vocab.words, new_vocab.counts, syn0, syn1, header["config"],
               state, extra_metadata={"vocab_lineage": chain})
    if verify:
        # both matrices, in the written dtype: syn1 is the state the next increment
        # trains against
        V_old = delta.merged_counts.shape[0]
        for name, src_arr in (("syn0", data["syn0"]), ("syn1", data["syn1"])):
            if src_arr is None:
                continue
            carried = np.load(os.path.join(dst, f"{name}.npy"), mmap_mode="r")[:V_old]
            if not np.array_equal(np.asarray(carried),
                                  np.asarray(src_arr, dtype=np.float32)):
                raise CheckpointCorruptError(
                    f"extended checkpoint {dst!r}: carried {name} rows are not "
                    f"bit-identical to the source — migration bug or torn write")


def _copy_shard_verified(src_file: str, dst_file: str,
                         want_digest: Optional[str]) -> str:
    """Copy one shard file, hashing in the same pass, and check the parent's recorded
    digest when there is one. Returns the digest (the bytes are the parent's)."""
    with open(src_file, "rb") as fin, open(dst_file, "wb") as fout:
        w = _HashingWriter(fout)
        shutil.copyfileobj(fin, w, length=1 << 20)
    got = w.sha.hexdigest()
    if want_digest is not None and got != want_digest:
        raise CheckpointCorruptError(
            f"shard {src_file!r} digest {got[:12]}… does not match the parent "
            f"checkpoint's recorded {want_digest[:12]}… — refusing to carry a corrupt "
            f"shard into the extended checkpoint")
    return got


def _shard_block(rows: np.ndarray, raw_dtype: np.dtype) -> np.ndarray:
    """New rows in the shards' stored dtype: a bf16 run's shards hold 2-byte voids,
    written here from the float32 rows rounded to nearest even (as numpy's bfloat16
    cast rounds)."""
    if raw_dtype != ShardedMatrixReader._VOID2:
        return rows.astype(raw_dtype)
    bits = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(torch.bfloat16)
    return bits.view(torch.int16).numpy().view(raw_dtype)


def _extend_row_shards(src: str, dst: str, header: Dict[str, Any],
                       new_vocab: Vocabulary, delta: VocabDelta, chain: List[dict],
                       state: TrainState, verify: bool) -> None:
    """Per-shard growth, one shard in memory at a time: shards below V_old copied
    verbatim (digest-checked in the copy), the boundary shard sliced at V_old (its
    stored bytes), padding-only shards dropped, one new shard of rows [V_old, V_new)."""
    with open(os.path.join(src, "metadata.json"), encoding="utf-8") as f:
        src_meta = json.load(f)
    parent_digests: Dict[str, str] = src_meta.get("digests") or {}
    cfg = header["config"]
    V_old = delta.merged_counts.shape[0]
    V_new = new_vocab.size
    vector_size = header["vector_size"] or cfg.vector_size

    parent = os.path.dirname(os.path.abspath(dst)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(dst)}.tmp-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        digests: Dict[str, str] = {}
        padded_dim = None
        for name in ("syn0", "syn1"):
            src_dir = os.path.join(src, f"{name}.shards")
            if not os.path.isdir(src_dir):
                continue
            reader = ShardedMatrixReader(src_dir)
            padded_dim = reader.cols
            raw_dtype = reader._load(reader._spans[0][2]).dtype
            dst_dir = os.path.join(tmp, f"{name}.shards")
            os.makedirs(dst_dir)
            for start, stop, fname in reader._spans:
                rel_src = f"{name}.shards/{fname}"
                if stop <= V_old:  # real rows only: carried verbatim
                    digests[rel_src] = _copy_shard_verified(
                        os.path.join(src_dir, fname), os.path.join(dst_dir, fname),
                        parent_digests.get(rel_src) if verify else None)
                elif start < V_old:  # the boundary shard: drop its padding rows
                    if verify and rel_src in parent_digests:
                        got = _sha256_file(os.path.join(src_dir, fname))
                        if got != parent_digests[rel_src]:
                            raise CheckpointCorruptError(
                                f"shard {rel_src!r} digest mismatch in {src!r} — "
                                f"refusing to slice a corrupt boundary shard")
                    m = reader._load(fname)
                    out_name = f"rows-{start:010d}-{V_old:010d}.npy"
                    digests[f"{name}.shards/{out_name}"] = _save_npy_hashed(
                        os.path.join(dst_dir, out_name),
                        np.ascontiguousarray(m[:V_old - start]))
                # start >= V_old: a padding shard, dropped
            if delta.num_new:
                block = np.zeros((delta.num_new, reader.cols), dtype=np.float32)
                if name == "syn0":
                    block[:, :vector_size] = seed_new_rows(
                        delta.num_new, vector_size, cfg.seed, V_old)
                out_name = f"rows-{V_old:010d}-{V_new:010d}.npy"
                digests[f"{name}.shards/{out_name}"] = _save_npy_hashed(
                    os.path.join(dst_dir, out_name), _shard_block(block, raw_dtype))
        digests["words"] = _save_words_hashed(os.path.join(tmp, "words"),
                                              new_vocab.words)
        digests["counts.npy"] = _save_npy_hashed(
            os.path.join(tmp, "counts.npy"), np.asarray(new_vocab.counts, dtype=np.int64))
        meta = {
            "format_version": _format_version(SHARDED_FORMAT_VERSION, state),
            "framework": FRAMEWORK,
            "layout": "row-shards",
            "vocab_size": V_new,
            "vector_size": int(vector_size),
            # the spans end at V_new: no padding rows (loaders pad for themselves)
            "padded_vocab": V_new,
            "padded_dim": int(padded_dim if padded_dim is not None else vector_size),
            "config": cfg.to_dict(auto_markers=False),
            "train_state": state.to_dict(),
            "digests": digests,
        }
        _merge_extra_metadata(meta, {"vocab_lineage": chain})
        with open(os.path.join(tmp, "metadata.json"), "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=2)
        old = None
        if os.path.exists(dst):
            old = dst + f".old-{os.getpid()}"
            os.rename(dst, old)
        os.rename(tmp, dst)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
