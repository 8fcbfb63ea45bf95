"""ctypes binding for the port's native pair generator (``native/pairgen.cpp``), and
the g++ build that it shares with the native ingest passes (:mod:`.ingest_native`).

Ported from ``glint_word2vec_tpu/data/native.py``. Each C++ source under
``glint_word2vec_torch/native/`` is compiled with ``g++`` at first use (plain C ABI, no
Python headers) into ``glint_word2vec_torch/_build/`` (ignored by git), under a name
keyed by a hash of the source and the flags, as :mod:`..ops.kernels` names the CUDA
libraries: an edited source rebuilds, an unchanged one is reused. If g++ is missing or
the build fails, :func:`native_available` returns False and ``backend="auto"`` feeds
take the bit-identical numpy path.

``GLINT_DISABLE_NATIVE=1`` forces the numpy path; ``GLINT_NATIVE_THREADS`` sets the
generator's thread count (default: up to 8, capped by the host's cores). Both are read
as the JAX package reads them: the first at the first load, the second at every call.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import logging
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from glint_word2vec_torch.lockcheck import make_lock

logger = logging.getLogger("glint_word2vec_torch")

_PKG = Path(__file__).resolve().parent.parent
NATIVE_SRC = _PKG / "native"
BUILD_DIR = _PKG / "_build"
# _FILE_OFFSET_BITS=64: the ingest passes seek with fseeko/off_t, 64-bit on ILP32
# glibc only with this macro
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-D_FILE_OFFSET_BITS=64"]

_ABI_VERSION = 1
_SRC = NATIVE_SRC / "pairgen.cpp"

_lock = make_lock("data.native.load")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path(src: Path, std: str) -> Path:
    """Where the library of ``src`` built with ``-std=std`` lives."""
    flags = " ".join([*GXX_FLAGS, f"-std={std}"])
    key = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{key}.so"


def build_or_reload(src: Path, abi_symbol: str, abi_version: int, std: str,
                    what: str) -> Optional[ctypes.CDLL]:
    """The build-on-first-use contract of every native component: compile ``src`` with
    g++ unless its library exists, load it, check its ABI stamp, and rebuild once if
    the library is broken. Returns the CDLL, or None (with a logged warning) when g++
    fails; callers then take their Python path."""
    lib_path = library_path(src, std)

    def build() -> bool:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a name of its own per process: concurrent builders (parallel pytest workers)
        # must not interleave g++ output into one file before the atomic publish
        tmp = f"{lib_path}.tmp.{os.getpid()}"
        # sweep temp files left by builders killed mid-compile; younger ones may
        # belong to a live concurrent builder
        for stale in glob.glob(glob.escape(str(lib_path)) + ".tmp*"):
            try:
                if time.time() - os.path.getmtime(stale) > 300:
                    os.unlink(stale)
            except OSError:
                pass
        cmd = ["g++", *GXX_FLAGS, f"-std={std}", "-o", tmp, str(src)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            err = getattr(e, "stderr", b"") or b""
            logger.warning("native %s build failed (%s); using the Python path. "
                           "stderr: %s", what, e, err.decode(errors="replace")[-500:])
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        os.replace(tmp, lib_path)
        return True

    if not lib_path.exists() and not build():
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        if getattr(lib, abi_symbol)() != abi_version:
            raise OSError(f"stale {lib_path.name} ABI; rebuild")
    except OSError:
        if not build():
            return None
        lib = ctypes.CDLL(str(lib_path))
    return lib


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
        lib = build_or_reload(_SRC, "glint_pairgen_abi_version", _ABI_VERSION,
                              "c++17", "pairgen")
        if lib is None:
            _load_failed = True
            return None
        lib.glint_block_pairs.restype = ctypes.c_int64
        lib.glint_block_pairs.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # tokens, n_tokens
            ctypes.c_void_p, ctypes.c_int64,   # lengths, n_sents
            ctypes.c_void_p,                   # keep [V] f32
            ctypes.c_int32, ctypes.c_int32,    # window, legacy
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,  # seed, iter, shard
            ctypes.c_uint64,                   # token_base
            ctypes.c_int32,                    # n_threads
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out c/x/clock
            ctypes.c_int64,                    # cap
            ctypes.c_void_p,                   # out_kept
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native pair generator is built and loaded (builds it at first
    call)."""
    return _load() is not None


def loaded_library() -> Optional[str]:
    """The path of the loaded pair-generator library, or None."""
    return None if _lib is None else _lib._name


def default_threads() -> int:
    env = os.environ.get("GLINT_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(8, os.cpu_count() or 1))


def threads_per_call(workers: int) -> int:
    """C++ threads for each of ``workers`` concurrent generator calls: the
    :func:`default_threads` budget divided among them, so the pools compose instead of
    multiplying."""
    return max(1, default_threads() // max(workers, 1))


def block_pairs_native(
    tokens: np.ndarray,
    lengths: np.ndarray,
    keep: np.ndarray,
    window: int,
    seed: int,
    iteration: int,
    shard: int,
    token_base: int,
    legacy_asymmetric_window: bool,
    n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Drop-in replacement for ``pipeline._block_pairs``: the same stream, bit for bit.

    The C++ side fans out over sentence ranges and releases the GIL for the whole call
    (ctypes does). ``n_threads`` overrides :func:`default_threads` (0 = default): the
    pooled feed divides the thread budget across its concurrent calls. The stream is
    the same at any thread count (the draws are position-keyed and each range writes
    its own output slice)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native pair generator is not available (g++ build "
                           "failed or GLINT_DISABLE_NATIVE is set); use the numpy feed")
    N = int(tokens.shape[0])
    if N == 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32), np.empty(0, np.int64), 0)
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    keep = np.ascontiguousarray(keep, dtype=np.float32)
    cap = N * max(2 * window - 2, 1)  # the most pairs a token can emit
    centers = np.empty(cap, np.int32)
    contexts = np.empty(cap, np.int32)
    clock = np.empty(cap, np.int64)
    kept = ctypes.c_int64(0)
    n = lib.glint_block_pairs(
        tokens.ctypes.data, N,
        lengths.ctypes.data, int(lengths.shape[0]),
        keep.ctypes.data,
        int(window), int(bool(legacy_asymmetric_window)),
        ctypes.c_uint32(seed & 0xFFFFFFFF), ctypes.c_uint32(iteration & 0xFFFFFFFF),
        ctypes.c_uint32(shard & 0xFFFFFFFF),
        ctypes.c_uint64(token_base),
        int(n_threads) if n_threads > 0 else default_threads(),
        centers.ctypes.data, contexts.ctypes.data, clock.ctypes.data,
        cap, ctypes.byref(kept))
    if n < 0:
        raise RuntimeError("native pairgen capacity overflow")
    return centers[:n], contexts[:n], clock[:n], int(kept.value)
