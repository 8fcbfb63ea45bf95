"""The append-only corpus stream, ported from ``glint_word2vec_tpu/continual/stream.py``:
fingerprinted segments, a persisted consumed-offset cursor and a delta encode pass.

New token files land in a directory (``seg-000.txt``, ``seg-001.txt``, ...), each
immutable once written: a segment whose bytes change under the cursor is an error.

- :class:`CorpusStream` lists the segments in sorted-name order;
  :func:`segment_fingerprint` is a cheap content identity (size and the CRC32 of the
  first and last MiB), the same string in both packages.
- :class:`StreamCursor` persists which segments were trained through (``cursor.json``,
  the JAX package's document, written atomically: a file written by either package
  reads in the other), and which had their counts merged (the stage marker that makes
  a retried increment count nothing twice).
- :func:`encode_delta` encodes only the new tail under the current vocabulary; a
  consumed segment's cached encode is reused when it was written under the current
  vocabulary or any ancestor in the checkpoint's lineage chain.
- :class:`ConcatCorpus` is a zero-copy ``Sequence`` over several encoded segments.
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from glint_word2vec_torch.data.corpus import (
    EncodedCorpus,
    TokenFileCorpus,
    encode_corpus,
    vocab_fingerprint,
)
from glint_word2vec_torch.data.vocab import Vocabulary

logger = logging.getLogger("glint_word2vec_torch")

_CURSOR = "cursor.json"
_FP_BYTES = 1 << 20  # head and tail window hashed per segment


def segment_fingerprint(path: str) -> str:
    """Size plus CRC32 of the first and last MiB: catches truncation, in-place edits
    and a rewrite under the same name without re-reading whole segments every poll."""
    size = os.path.getsize(path)
    h = 0
    with open(path, "rb") as f:
        h = zlib.crc32(f.read(_FP_BYTES), h)
        if size > _FP_BYTES:
            f.seek(max(size - _FP_BYTES, 0))
            h = zlib.crc32(f.read(_FP_BYTES), h)
    return f"{size}-{h:08x}"


class CorpusStream:
    """A directory of immutable token segment files (one sentence per line,
    whitespace-tokenized), consumed in sorted-name order."""

    def __init__(self, directory: str, suffix: str = ".txt"):
        self.directory = directory
        self.suffix = suffix

    def segments(self) -> List[str]:
        """Sorted segment file names currently present."""
        try:
            names = os.listdir(self.directory)
        except OSError as e:
            raise FileNotFoundError(
                f"cannot list corpus stream directory {self.directory!r}: {e}") from e
        return sorted(n for n in names if n.endswith(self.suffix) and not n.startswith("."))

    def path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def corpus(self, name: str) -> TokenFileCorpus:
        return TokenFileCorpus(self.path(name))


class StreamCursor:
    """The persisted consumed offset over a :class:`CorpusStream`.

    ``consumed`` maps a segment name to ``{"fingerprint", "vocab_fingerprint",
    "n_sentences", "total_tokens"}``; ``counted`` holds segments whose counts are
    merged into the checkpoint but whose increment has not finished (a retry refits
    without merging again; a crash between the extension publish and this marker's
    save is caught by the lineage link's ``tail_fingerprint``). Saves are atomic, and
    segments are marked consumed only after their increment, so a crash retries the
    whole increment."""

    def __init__(self, directory: str):
        self.directory = directory
        self.consumed: Dict[str, Dict[str, Any]] = {}
        self.counted: Dict[str, Dict[str, Any]] = {}
        # consumed segments whose (size, mtime_ns) matched when their content last
        # verified: an idle poll re-reads nothing, and a stat change re-verifies
        self._audit_memo: Dict[str, tuple] = {}
        os.makedirs(directory, exist_ok=True)
        p = os.path.join(directory, _CURSOR)
        if os.path.exists(p):
            with open(p, encoding="utf-8") as f:
                doc = json.load(f)
            self.consumed = doc.get("consumed", {})
            self.counted = doc.get("counted", {})

    def save(self) -> None:
        p = os.path.join(self.directory, _CURSOR)
        tmp = p + f".tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"consumed": self.consumed, "counted": self.counted}, f, indent=1)
        os.replace(tmp, p)

    def new_segments(self, stream: CorpusStream) -> List[str]:
        """Names present in the stream and not consumed, sorted, after auditing the
        consumed set: a consumed segment that vanished or changed is an error."""
        names = stream.segments()
        present = set(names)
        for name, rec in self.consumed.items():
            if name not in present:
                raise ValueError(
                    f"consumed segment {name!r} vanished from {stream.directory!r} — "
                    f"the corpus stream is append-only; restore the segment or rebuild "
                    f"the cursor")
            st = os.stat(stream.path(name))
            sig = (st.st_size, st.st_mtime_ns)
            if self._audit_memo.get(name) == sig:
                continue
            fp = segment_fingerprint(stream.path(name))
            if fp != rec.get("fingerprint"):
                raise ValueError(
                    f"consumed segment {name!r} changed content "
                    f"({rec.get('fingerprint')} -> {fp}) — the corpus stream is "
                    f"append-only; write drift as a NEW segment")
            self._audit_memo[name] = sig
        return [n for n in names if n not in self.consumed]

    def uncounted(self, names: Iterable[str]) -> List[str]:
        """The subset of ``names`` whose counts have not been merged yet."""
        return [n for n in names if n not in self.counted]

    def mark_counted(self, name: str, fingerprint: str) -> None:
        self.counted[name] = {"fingerprint": fingerprint}

    def mark_consumed(self, name: str, fingerprint: str, vocab_fp: str,
                      meta: Dict[str, Any]) -> None:
        self.consumed[name] = {
            "fingerprint": fingerprint,
            "vocab_fingerprint": vocab_fp,
            "n_sentences": int(meta.get("n_sentences", 0)),
            "total_tokens": int(meta.get("total_tokens", 0)),
        }
        self.counted.pop(name, None)  # consumed implies counted


class ConcatCorpus(Sequence):
    """Read-only concatenation of encoded segments, a ``Sequence[np.ndarray]`` like
    one :class:`EncodedCorpus`."""

    def __init__(self, parts: Iterable[Sequence]):
        self._parts = [p for p in parts if len(p)]
        self._offsets = np.cumsum([0] + [len(p) for p in self._parts])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, i: int) -> np.ndarray:
        if isinstance(i, slice):
            raise TypeError("ConcatCorpus supports integer indexing only")
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        part = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return self._parts[part][i - int(self._offsets[part])]

    @property
    def total_tokens(self) -> int:
        return sum(int(getattr(p, "total_tokens", 0)) for p in self._parts)


def _segment_cache_dir(cache_dir: str, name: str) -> str:
    return os.path.join(cache_dir, f"{name}.enc")


def encode_segment(stream: CorpusStream, name: str, vocab: Vocabulary, cache_dir: str,
                   max_sentence_length: int,
                   allowed_fingerprints: Optional[Sequence[str]] = None) -> EncodedCorpus:
    """Encode one segment under ``vocab``, reusing its cached encode when that was
    written under the current vocabulary or an allowed ancestor; a cache under any
    other vocabulary is stale and is encoded again in place."""
    enc_dir = _segment_cache_dir(cache_dir, name)
    want = vocab_fingerprint(vocab)
    allowed = set(allowed_fingerprints or ()) | {want}
    if os.path.exists(os.path.join(enc_dir, "meta.json")):
        enc = EncodedCorpus(enc_dir)
        got = enc.meta.get("vocab_fingerprint")
        if got in allowed:
            return enc
        logger.warning("segment %s encode cache was written under a non-ancestor "
                       "vocabulary (%s); re-encoding under the current one", name, got)
    return encode_corpus(stream.corpus(name), vocab, enc_dir, max_sentence_length)


def encode_delta(stream: CorpusStream, cursor: StreamCursor, vocab: Vocabulary,
                 cache_dir: str, max_sentence_length: int = 1000,
                 lineage: Optional[Sequence[str]] = None,
                 replay_segments: int = 0,
                 names: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Encode only the unconsumed tail under ``vocab``; the increment's corpus is
    (the last ``replay_segments`` consumed segments, from their caches) + (the tail).
    ``names``: the tail as already polled (the ranks of a mesh runner take rank 0's
    poll); None polls the cursor. Returns ``{"corpus": ConcatCorpus, "new": [names],
    "replayed": [names], "encoded": {name: EncodedCorpus of the tail}}``."""
    os.makedirs(cache_dir, exist_ok=True)
    new_names = list(names) if names is not None else cursor.new_segments(stream)
    encoded: Dict[str, EncodedCorpus] = {}
    parts: List[EncodedCorpus] = []
    replayed: List[str] = []
    if replay_segments > 0:
        for name in sorted(cursor.consumed)[-replay_segments:]:
            parts.append(encode_segment(stream, name, vocab, cache_dir,
                                        max_sentence_length,
                                        allowed_fingerprints=lineage))
            replayed.append(name)
    for name in new_names:
        enc = encode_segment(stream, name, vocab, cache_dir, max_sentence_length,
                             allowed_fingerprints=lineage)
        encoded[name] = enc
        parts.append(enc)
    return {"corpus": ConcatCorpus(parts), "new": new_names, "replayed": replayed,
            "encoded": encoded}
