"""Streaming corpus ingestion: train from token files with bounded host RAM. Ported
from ``glint_word2vec_tpu/data/corpus.py``; an encoded directory written by either
package is byte-identical and reads in the other.

Two streaming passes over a re-iterable corpus: :func:`..data.vocab.build_vocab` (a
Counter, O(vocab) RAM), then :func:`encode_corpus` (words -> int32 ids written straight
to disk). Training then reads the encoded sentences through ``np.memmap``;
:class:`EncodedCorpus` is a ``Sequence[np.ndarray]``, as the feeds of
:mod:`..data.pipeline` expect.

Layout of an encoded directory:

    tokens.bin   int32  [total_tokens]     all sentences concatenated
    offsets.bin  int64  [n_sentences + 1]  sentence i = tokens[offsets[i]:offsets[i+1]]
    meta.json    {"n_sentences", "total_tokens", "max_sentence_length",
                  "vocab_fingerprint"}
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from typing import Iterable, Iterator, List, Sequence

import numpy as np

from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.train.faults import maybe_fail_ingest, retry_io

logger = logging.getLogger("glint_word2vec_torch")

_TOKENS = "tokens.bin"
_OFFSETS = "offsets.bin"
_META = "meta.json"


class TokenFileCorpus:
    """Re-iterable sentence stream over a whitespace-tokenized text file, one sentence
    per line. Nothing is held in RAM: every ``__iter__`` opens the file again, so the
    vocabulary pass and the encode pass each stream it."""

    def __init__(self, path: str, lowercase: bool = False):
        self.path = path
        self.lowercase = lowercase

    def __iter__(self) -> Iterator[List[str]]:
        def _open():
            maybe_fail_ingest(f"corpus open {self.path!r}")
            return open(self.path, "r", encoding="utf-8", errors="replace")

        # only the open is retried: replaying from an arbitrary line after a failure
        # mid-read could skip sentences, so that propagates
        with retry_io(_open, what=f"open corpus {self.path!r}") as f:
            for line in f:
                if self.lowercase:
                    line = line.lower()
                toks = line.split()
                if toks:
                    yield toks


class EncodedCorpus(Sequence):
    """Memory-mapped encoded sentences: the disk-backed analog of the list that
    :func:`..data.pipeline.encode_sentences` returns."""

    def __init__(self, directory: str):
        self.directory = directory

        def _open_meta():
            maybe_fail_ingest(f"encoded-corpus meta {directory!r}")
            with open(os.path.join(directory, _META), "r", encoding="utf-8") as f:
                return json.load(f)

        self.meta = retry_io(_open_meta,
                             what=f"read encoded-corpus meta under {directory!r}")
        n = self.meta["n_sentences"]
        self._tokens = retry_io(
            lambda: np.memmap(os.path.join(directory, _TOKENS), dtype=np.int32,
                              mode="r"),
            what=f"map {_TOKENS} under {directory!r}")
        self._offsets = retry_io(
            lambda: np.memmap(os.path.join(directory, _OFFSETS), dtype=np.int64,
                              mode="r", shape=(n + 1,)),
            what=f"map {_OFFSETS} under {directory!r}")
        if int(self._offsets[-1]) != self._tokens.shape[0]:
            raise ValueError(
                f"corrupt encoded corpus at {directory}: last offset "
                f"{int(self._offsets[-1])} != token count {self._tokens.shape[0]}")

    def __len__(self) -> int:
        return self.meta["n_sentences"]

    def __getitem__(self, i: int) -> np.ndarray:
        if isinstance(i, slice):
            raise TypeError("EncodedCorpus supports integer indexing only")
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return np.asarray(self._tokens[self._offsets[i]:self._offsets[i + 1]])

    @property
    def total_tokens(self) -> int:
        return self.meta["total_tokens"]


def encode_corpus(
    sentences: Iterable[Sequence[str]],
    vocab: Vocabulary,
    out_dir: str,
    max_sentence_length: int = 1000,
    buffer_sentences: int = 8192,
) -> EncodedCorpus:
    """One streaming pass: words -> vocabulary ids (OOV dropped), chunked to
    ``max_sentence_length``, appended to disk. Peak RAM is the buffer plus the int64
    offsets (8 bytes per sentence). A token-file corpus takes the native encode pass
    when it is built; its files are identical to the Python pass's."""
    os.makedirs(out_dir, exist_ok=True)
    if isinstance(sentences, TokenFileCorpus) and not sentences.lowercase:
        from glint_word2vec_torch.data import ingest_native, native
        if ingest_native.ingest_available():
            tok_p = os.path.join(out_dir, _TOKENS)
            off_p = os.path.join(out_dir, _OFFSETS)
            # the native pass retries inside; a hard failure (None, or a spent retry
            # budget) falls through to the Python pass, which restarts clean
            try:
                res = ingest_native.encode_corpus_native(
                    sentences.path, vocab.words, max_sentence_length, tok_p, off_p,
                    native.default_threads())
            except OSError as e:
                logger.warning("native corpus encode failed after retries (%s); "
                               "falling back to the Python pass", e)
                res = None
            if res is not None:
                total_n, n_sents = res
                _write_meta(out_dir, n_sents, total_n, max_sentence_length, vocab)
                return EncodedCorpus(out_dir)
    index = vocab.index

    def python_pass() -> tuple:
        """One whole encode attempt, restartable: the tokens file is opened "wb"
        (truncating a partial attempt) and all position state is local."""
        maybe_fail_ingest(f"corpus encode into {out_dir!r}")
        offsets: List[int] = [0]
        total = 0
        buf: List[np.ndarray] = []
        buffered = 0

        with open(os.path.join(out_dir, _TOKENS), "wb") as tf:
            def flush():
                nonlocal buf, buffered
                if buf:
                    np.concatenate(buf).tofile(tf)
                    buf, buffered = [], 0

            for sentence in sentences:
                ids = [index[w] for w in sentence if w in index]
                if not ids:
                    continue
                arr = np.asarray(ids, dtype=np.int32)
                for start in range(0, len(arr), max_sentence_length):
                    chunk = arr[start:start + max_sentence_length]
                    if not chunk.size:
                        continue
                    buf.append(chunk)
                    buffered += 1
                    total += int(chunk.size)
                    offsets.append(total)
                    if buffered >= buffer_sentences:
                        flush()
            flush()
        return offsets, total

    if iter(sentences) is sentences:
        # a one-shot iterator cannot be retried: a second attempt would encode what
        # is left of it
        offsets, total = python_pass()
    else:
        offsets, total = retry_io(python_pass, what=f"encode corpus into {out_dir!r}")
    np.asarray(offsets, dtype=np.int64).tofile(os.path.join(out_dir, _OFFSETS))
    _write_meta(out_dir, len(offsets) - 1, total, max_sentence_length, vocab)
    return EncodedCorpus(out_dir)


def _write_meta(out_dir: str, n_sentences: int, total_tokens: int,
                max_sentence_length: int, vocab: Vocabulary) -> None:
    """The encoded directory's metadata, one schema for both encode paths."""
    with open(os.path.join(out_dir, _META), "w", encoding="utf-8") as f:
        json.dump({"n_sentences": n_sentences, "total_tokens": total_tokens,
                   "max_sentence_length": max_sentence_length,
                   "vocab_fingerprint": vocab_fingerprint(vocab)}, f)


def vocab_fingerprint(vocab: Vocabulary) -> str:
    """A cheap stable fingerprint of a vocabulary: ids encoded under another
    vocabulary are meaningless, so whoever reuses an encoded directory (resume)
    checks it."""
    h = zlib.crc32(("\n".join(vocab.words[:1000])).encode("utf-8"))
    h = zlib.crc32(("\n".join(vocab.words[-1000:])).encode("utf-8"), h)
    return f"{vocab.size}-{vocab.train_words_count}-{h:08x}"
