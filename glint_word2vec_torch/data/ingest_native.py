"""ctypes binding for the port's native corpus-ingest passes (``native/ingest.cpp``),
ported from ``glint_word2vec_tpu/data/ingest_native.py``.

The build contract is :mod:`.native`'s: g++ at first use into ``_build/``, plain C ABI,
the Python path when the toolchain fails or ``GLINT_DISABLE_NATIVE=1``. Only the hot
loops are native, tokenize+count and tokenize+encode over a token file; the
vocabulary's filter and sort and the encoded corpus's metadata stay in Python, so both
paths share one ordering. The native passes take ``lowercase=False`` corpora of
ASCII-whitespace tokens; a file that needs Python's tokenization (unicode whitespace,
a lone CR, invalid UTF-8) makes them return -2, and the caller takes the Python path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from glint_word2vec_torch.data.native import NATIVE_SRC, build_or_reload
from glint_word2vec_torch.lockcheck import make_lock
from glint_word2vec_torch.train.faults import maybe_fail_ingest, retry_io

logger = logging.getLogger("glint_word2vec_torch")

_ABI_VERSION = 2
_SRC = NATIVE_SRC / "ingest.cpp"

_lock = make_lock("data.ingest_native.load")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get("GLINT_DISABLE_NATIVE"):
            _load_failed = True
            return None
        lib = build_or_reload(_SRC, "glint_ingest_abi_version", _ABI_VERSION, "c++20",
                              "ingest")
        if lib is None:
            _load_failed = True
            return None
        lib.glint_ingest_count.restype = ctypes.c_int64
        lib.glint_ingest_count.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32]
        lib.glint_ingest_encode.restype = ctypes.c_int64
        lib.glint_ingest_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


def ingest_available() -> bool:
    """Whether the native ingest passes are built and loaded (builds them at first
    call)."""
    return _load() is not None


def loaded_library() -> Optional[str]:
    """The path of the loaded ingest library, or None."""
    return None if _lib is None else _lib._name


def count_words_native(corpus_path: str,
                       n_threads: int) -> Optional[Tuple[List[str], np.ndarray]]:
    """Tokenize and count ``corpus_path``: ``(words, counts)`` in first-seen file
    order, the iteration order of the Python ``Counter`` of the fallback, so
    ``Vocabulary.from_counter``'s stable sort gives the same vocabulary either way.
    None when the file needs the Python pass or the native pass fails."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native ingest passes are not available")
    with tempfile.TemporaryDirectory(prefix="glint_ingest_") as td:
        wpath = os.path.join(td, "words")
        cpath = os.path.join(td, "counts")

        def attempt() -> int:
            maybe_fail_ingest(f"native ingest count {corpus_path!r}")
            return lib.glint_ingest_count(corpus_path.encode(), wpath.encode(),
                                          cpath.encode(), np.int32(n_threads))

        n = retry_io(attempt, what=f"native ingest count {corpus_path!r}")
        if n == -2:
            logger.info("corpus %r needs Python tokenization (unicode whitespace, a "
                        "lone CR or invalid UTF-8); using the Python pass", corpus_path)
            return None
        if n < 0:
            logger.warning("native ingest count failed on %r; falling back to the "
                           "Python pass", corpus_path)
            return None
        # reads of the finished outputs: idempotent, so safe to retry
        with retry_io(lambda: open(wpath, "rb"),
                      what=f"native ingest words {wpath!r}") as f:
            raw = f.read()
        words = raw.decode("utf-8", errors="replace").split("\n")[:-1]
        counts = retry_io(lambda: np.fromfile(cpath, dtype=np.int64),
                          what=f"native ingest counts {cpath!r}")
    if len(words) != n or counts.shape[0] != n:
        logger.warning("native ingest count output inconsistent (%d words / %d counts "
                       "/ %d reported); falling back", len(words), counts.shape[0], n)
        return None
    return words, counts


def encode_corpus_native(corpus_path: str, words: List[str], max_sentence_length: int,
                         tokens_path: str, offsets_path: str,
                         n_threads: int) -> Optional[Tuple[int, int]]:
    """Tokenize and encode ``corpus_path`` against the final vocabulary ``words`` (id ==
    position), writing the tokens.bin/offsets.bin pair that ``EncodedCorpus`` maps.
    Returns ``(total_tokens, n_sentences)``, or None when the file needs the Python
    pass or the native pass fails."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native ingest passes are not available")
    with tempfile.NamedTemporaryFile(prefix="glint_vocab_", suffix=".txt",
                                     delete=False) as tf:
        vocab_path = tf.name
        tf.write("\n".join(words).encode("utf-8") + b"\n")
    try:
        nsents = ctypes.c_int64(0)

        def attempt() -> int:
            # the C pass truncates its output files on open, so a retry restarts clean
            maybe_fail_ingest(f"native ingest encode {corpus_path!r}")
            return lib.glint_ingest_encode(
                corpus_path.encode(), vocab_path.encode(), np.int32(max_sentence_length),
                tokens_path.encode(), offsets_path.encode(), np.int32(n_threads),
                ctypes.byref(nsents))

        total = retry_io(attempt, what=f"native ingest encode {corpus_path!r}")
    finally:
        os.unlink(vocab_path)
    if total == -2:
        logger.info("corpus %r needs Python tokenization (unicode whitespace, a lone CR "
                    "or invalid UTF-8); using the Python pass", corpus_path)
        return None
    if total < 0:
        logger.warning("native ingest encode failed on %r; falling back to the Python "
                       "pass", corpus_path)
        return None
    return int(total), int(nsents.value)
