"""Host trace spans, ported from ``glint_word2vec_tpu/obs/spans.py``: a small
thread-safe span API and a Chrome-trace export (``chrome://tracing`` and Perfetto load
it).

A span is one timed region on one host thread. It times the host only: a CUDA launch
returns before the card finishes, so the trainer names ``device_block`` only where it
really waits for the card (the heartbeat's metric fetch and the health probe's fetch).

- Free when disabled: ``span()`` returns a shared no-op context manager.
- Thread-safe and bounded: events land in a ring (oldest dropped past ``max_events``)
  under one reentrant lock (the SIGTERM dump reads ``span_summary`` from the main
  thread, which may hold it).

One process-wide tracer (:func:`default_tracer`) lets layers with no trainer handle
(checkpoint saves) record spans; a trainer enables and clears it per run when
telemetry or the status endpoint is on.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from glint_word2vec_torch.lockcheck import make_rlock


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP = _NoopSpan()

# span name -> time-attribution phase (obs/phases.py)
_PHASE_OF = {
    "producer_wait": "producer_wait",
    "stage_put": "stage",
    "allgather_fetch": "stage",
    "dispatch": "dispatch",
    "health_probe": "device_block",
    "device_block": "device_block",
}


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._record(self.name, self._t0, t1 - self._t0, self.args)
        return None


class Tracer:
    """Collects complete ("X") spans; exports the Chrome trace event format."""

    def __init__(self, enabled: bool = False, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = int(max_events)
        self._lock = make_rlock("obs.spans")
        self._events: "deque" = deque(maxlen=self.max_events)
        self._dropped = 0
        self._epoch = time.perf_counter()
        self._phases = None  # the running trainer's PhaseAccumulator, or None

    def configure(self, enabled: bool) -> None:
        self.enabled = enabled

    def attach_phases(self, acc) -> None:
        """Attach (None detaches) the run's PhaseAccumulator: recorded spans whose
        names map to a phase add their durations to it."""
        self._phases = acc

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._epoch = time.perf_counter()

    def span(self, name: str, **args):
        """Context manager timing one region on the calling thread."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args or None)

    def wrap_iter(self, name: str, it):
        """Wrap an iterator so each ``next()`` is a span on the consuming thread:
        handed to a producer thread, it times production where it happens. Checks
        ``enabled`` per item (feed iterators are built before a run arms the
        tracer). Closing the wrapper closes the source."""

        def gen():
            src = iter(it)
            try:
                while True:
                    with self.span(name):
                        try:
                            item = next(src)
                        except StopIteration:
                            return
                    yield item
            finally:  # closing the wrapper closes the source (its worker pool)
                close = getattr(src, "close", None)
                if close is not None:
                    close()

        return gen()

    def _record(self, name: str, t0: float, dur: float, args: Optional[dict]) -> None:
        if self._phases is not None:
            phase = _PHASE_OF.get(name)
            if phase is not None:
                self._phases.add(phase, dur)
        ev = (name, threading.get_ident(), threading.current_thread().name,
              t0 - self._epoch, dur, args)
        with self._lock:
            if len(self._events) == self.max_events:
                self._dropped += 1
            self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        return [{"name": n, "tid": tid, "thread": tname, "ts_s": ts, "dur_s": dur,
                 **({"args": a} if a else {})}
                for n, tid, tname, ts, dur, a in evs]

    def span_summary(self) -> Dict[str, dict]:
        """Per-span-name {count, total_s, max_s}: the run_end digest."""
        out: Dict[str, dict] = {}
        for ev in self.events():
            s = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            s["count"] += 1
            s["total_s"] = round(s["total_s"] + ev["dur_s"], 6)
            s["max_s"] = round(max(s["max_s"], ev["dur_s"]), 6)
        return out

    def export_chrome_trace(self, path: str) -> int:
        """Write the collected spans as a Chrome-trace JSON file; returns the event
        count. Thread ids become small ints in first-seen order, with metadata events
        naming each thread."""
        with self._lock:
            evs = list(self._events)
            dropped = self._dropped
        tid_map: Dict[int, int] = {}
        names: Dict[int, str] = {}
        trace = []
        for n, tid, tname, ts, dur, a in evs:
            small = tid_map.setdefault(tid, len(tid_map))
            names.setdefault(small, tname)
            ev = {"ph": "X", "name": n, "pid": 0, "tid": small,
                  "ts": round(ts * 1e6, 1), "dur": round(dur * 1e6, 1)}
            if a:
                ev["args"] = a
            trace.append(ev)
        meta = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": small,
                 "args": {"name": tname}} for small, tname in names.items()]
        doc = {"traceEvents": meta + trace, "displayTimeUnit": "ms",
               "otherData": {"dropped_events": dropped}}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return len(trace)


def clock_anchor() -> Dict[str, int]:
    """One simultaneous reading of the wall clock and the monotonic clock, which every
    ``run_start`` record carries (``wall_ns``, ``mono_ns``), so that a collector can
    place this process's monotonic timestamps on a wall timeline."""
    return {"wall_ns": time.time_ns(), "mono_ns": time.monotonic_ns()}


_default = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer (disabled until a telemetry-on run enables it)."""
    return _default
