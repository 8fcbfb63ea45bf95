"""Flight recorder, ported from ``glint_word2vec_tpu/obs/blackbox.py``: bounded rings
of recent telemetry, dumped atomically on fit death.

The recorder mirrors the tail of the telemetry stream (heartbeats, watchdog and
recovery records, one small record per dispatch round) and, when the run dies, writes
one JSON document to ``<telemetry_path>.blackbox.json`` (a temp file, then
``os.replace``), stamped with the cause:

- any exception that aborts a fit (the trainer's ``except BaseException: _abort_run();
  raise``): ``NormBlowupError``, ``NonFiniteParamsError``, feed errors,
  ``KeyboardInterrupt``;
- SIGTERM, the first signal of a preemption: the trainer's handler dumps.

The document (validated by ``obs.schema.validate_blackbox``) has ``schema``,
``kind="blackbox"``, ``t``, ``run_id``, ``cause`` (exception | signal | none), the
rings (``heartbeats``/``events`` hold the same records the sink wrote;
``dispatches``), and the at-death ``phases``/``spans``/``status`` snapshots. It exists
only with telemetry on. Feeding a ring is a lock and a deque append per round.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
import traceback
from collections import deque
from typing import Any, Dict, Optional

from glint_word2vec_torch.lockcheck import make_rlock
from glint_word2vec_torch.obs.schema import SCHEMA_VERSION
from glint_word2vec_torch.obs.sink import TelemetrySink

logger = logging.getLogger("glint_word2vec_torch")


class FlightRecorder:
    """Bounded rings of recent telemetry and per-dispatch metadata, dumped atomically
    to ``path`` on fit death."""

    def __init__(self, path: str, ring: int = 256):
        if ring <= 0:
            raise ValueError(f"blackbox ring must be positive but got {ring}")
        self.path = path
        # reentrant: the SIGTERM dump runs on the main thread, possibly inside that
        # thread's interrupted note_dispatch()/observe()
        self._lock = make_rlock("obs.blackbox")
        self._dispatches: deque = deque(maxlen=ring)
        self._heartbeats: deque = deque(maxlen=max(ring // 4, 16))
        self._events: deque = deque(maxlen=max(ring // 4, 16))
        self._run_id = ""
        self._dumped = False

    def begin_run(self, run_id: str) -> None:
        with self._lock:
            self._dispatches.clear()
            self._heartbeats.clear()
            self._events.clear()
            self._run_id = run_id
            self._dumped = False

    def observe(self, kind: str, rec: Dict[str, Any]) -> None:
        """Mirror one sink record into its ring; every kind but heartbeat rides the
        event ring."""
        entry = {"schema": SCHEMA_VERSION, "kind": kind, "t": round(time.time(), 3),
                 **rec}
        with self._lock:
            if kind == "heartbeat":
                self._heartbeats.append(entry)
            else:
                self._events.append(entry)

    def note_dispatch(self, global_step: int, real: int, dispatch_s: float,
                      wait_s: float) -> None:
        """One small record per dispatch round."""
        with self._lock:
            self._dispatches.append({
                "t": round(time.time(), 3), "step": int(global_step), "real": int(real),
                "dispatch_s": round(dispatch_s, 6), "wait_s": round(wait_s, 6)})

    @staticmethod
    def exception_cause(exc: BaseException) -> dict:
        return {
            "kind": "exception",
            "type": type(exc).__name__,
            "message": str(exc)[:2000],
            "traceback": traceback.format_exception(
                type(exc), exc, exc.__traceback__)[-20:],
        }

    @staticmethod
    def signal_cause(signum: int) -> dict:
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        return {"kind": "signal", "signal": name, "signum": int(signum)}

    def dump(self, cause: Optional[dict] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the document atomically; returns the path, or None on failure (best
        effort: forensics never mask the original failure). Once per run: the first
        cause wins."""
        with self._lock:
            if self._dumped:
                return self.path
            self._dumped = True
            doc = {
                "schema": SCHEMA_VERSION,
                "kind": "blackbox",
                "t": round(time.time(), 3),
                "run_id": self._run_id,
                "cause": cause or {"kind": "none"},
                "heartbeats": list(self._heartbeats),
                "events": list(self._events),
                "dispatches": list(self._dispatches),
            }
        if extra:
            doc.update(extra)
        tmp = f"{self.path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(TelemetrySink._sanitize(doc), f, allow_nan=False)
            os.replace(tmp, self.path)
        except (OSError, TypeError, ValueError) as e:
            logger.warning("blackbox dump failed: %s (the run's original failure is "
                           "unaffected)", e)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        logger.warning("blackbox dump written: %s (%d heartbeats, %d events, %d "
                       "dispatch records)", self.path, len(doc["heartbeats"]),
                       len(doc["events"]), len(doc["dispatches"]))
        return self.path
