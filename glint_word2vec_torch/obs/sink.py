"""Structured telemetry sink, ported from ``glint_word2vec_tpu/obs/sink.py``: a
schema-versioned, rotating JSONL run log.

- every record is one JSON line that validates against :mod:`.schema`;
- records go to a file, never to stdout (the tools' one-JSON-line stdout contract must
  survive a trainer with telemetry on);
- past ``rotate_bytes`` the active file becomes ``<path>.1`` (older segments shift up,
  the oldest past ``keep`` is dropped), so a long run's log is bounded;
- thread-safe: one reentrant lock serialises the writes (reentrant because the SIGTERM
  handler emits from the main thread, which may hold it in an interrupted ``emit``).

Writes are best effort: an I/O error is logged once and disables the sink; telemetry
never kills a run.
"""

from __future__ import annotations

import json
import logging
import os
import time

from glint_word2vec_torch.lockcheck import make_rlock
from glint_word2vec_torch.obs.schema import SCHEMA_VERSION

logger = logging.getLogger("glint_word2vec_torch")


class TelemetrySink:
    """Append-only rotating JSONL writer for one run log path."""

    def __init__(self, path: str, rotate_bytes: int = 64 << 20, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1 but got {keep}")
        self.path = path
        self.rotate_bytes = int(rotate_bytes)
        self.keep = int(keep)
        self._lock = make_rlock("obs.sink")
        self._file = None
        self._size = 0
        self._dead = False
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    @classmethod
    def _sanitize(cls, v):
        """Strict JSON: non-finite floats (a diverging run's loss) become null, which
        the schema admits wherever a number is."""
        if isinstance(v, float):
            return v if v == v and abs(v) != float("inf") else None
        if isinstance(v, dict):
            return {k: cls._sanitize(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [cls._sanitize(x) for x in v]
        return v

    def emit(self, kind: str, **fields) -> None:
        """Write one schema-stamped record. Never raises."""
        rec = {"schema": SCHEMA_VERSION, "kind": kind, "t": round(time.time(), 3),
               **self._sanitize(fields)}
        try:
            line = json.dumps(rec, allow_nan=False) + "\n"
        except (TypeError, ValueError) as e:
            logger.warning("telemetry record dropped (unserializable %s record: %s)",
                           kind, e)
            return
        with self._lock:
            if self._dead:
                return
            try:
                if self._file is None:
                    self._open()
                if self._size + len(line) > self.rotate_bytes and self._size:
                    self._rotate()
                self._file.write(line)
                self._file.flush()
                self._size += len(line)
            except OSError as e:
                self._dead = True
                logger.warning("telemetry sink disabled after write failure on %s: %s "
                               "(training continues; the run log is best-effort)",
                               self.path, e)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def __enter__(self) -> "TelemetrySink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _open(self) -> None:
        self._file = open(self.path, "a", encoding="utf-8")
        self._size = self._file.tell()

    def _rotate(self) -> None:
        self._file.close()
        self._file = None
        # <path> -> <path>.1 -> ... -> <path>.keep; os.replace drops the oldest
        for i in range(self.keep, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i}")
        self._open()
