"""Cross-process trace propagation, ported from ``glint_word2vec_tpu/obs/trace.py``:
one causal id per query across processes.

- a **trace context** is two short strings, ``trace_id`` (one per client query) and
  ``parent_span`` (the span id of the enclosing region); it crosses a process boundary
  as ``"trace": {"tid": ..., "ps": ...}`` on the JSON-lines protocol;
- a **trace span** is one ``trace_span`` telemetry record in the process that measured
  it: the batcher emits ``queue_wait`` and ``batch_service`` children, the service its
  ``ann_probe`` / ``exact_scan`` child. Spans carry ``mono_ns``; each process's
  ``serve_start`` / ``run_start`` carries :func:`clock_anchor` so a collector can
  align them;
- :func:`emit_publish` writes the trainer's ``publish`` record, which joins a save to
  the serving tier's reloads by its ``publish_sig``.

Free when off: a service with no telemetry sink never calls :func:`new_trace_id`, and
requests cross the wire byte-identical to the untraced protocol. Ids come from a
process-scoped counter folded with the pid and a boot nonce (no PRNG).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Optional

# process-scoped id source: pid + boot-time nonce + a monotone counter.
# Collision story: two processes share a prefix only on a pid reuse within
# the same nanosecond; within a process the counter is unique. itertools
# .count().__next__ is atomic under the GIL — no lock on the hot path.
_BOOT_NS = time.time_ns()
_COUNTER = itertools.count(1)
_PREFIX = f"{os.getpid():x}-{_BOOT_NS & 0xFFFFFFFF:08x}"


def new_trace_id() -> str:
    """One id per client query (the root of the causal tree)."""
    return f"t{_PREFIX}-{next(_COUNTER):x}"


def new_span_id() -> str:
    """One id per measured region; unique process-wide."""
    return f"s{_PREFIX}-{next(_COUNTER):x}"


def wire_context(trace_id: str, parent_span: str) -> Dict[str, str]:
    """The cross-process form: what rides the JSON-lines request as
    ``"trace"`` and what in-process replicas pass straight through."""
    return {"tid": trace_id, "ps": parent_span}


def clock_anchor() -> Dict[str, int]:
    """The per-process clock-alignment pair every ``run_start`` /
    ``serve_start`` / ``fleet_start`` record carries (additive schema
    fields): one simultaneous reading of the wall clock and the monotonic
    clock. Spans record ``mono_ns`` (monotonic — immune to NTP steps
    mid-run); the collector maps a span to fleet wall time as
    ``anchor.wall_ns + (span.mono_ns - anchor.mono_ns)``, which aligns
    processes whose wall clocks agree at anchor time and whose monotonic
    clocks drift independently afterwards."""
    return {"wall_ns": time.time_ns(), "mono_ns": time.monotonic_ns()}


class SpanEmitter:
    """Binds a telemetry sink + process label into a one-call span writer.

    Every layer that measures spans (batcher, service) holds one of
    these — or ``None`` when telemetry is off, in which case callers skip
    the whole region-timing block (the zero-cost contract is enforced by
    "no emitter, no clock read", not by a no-op object on the hot path).
    Thread-safe by construction: it only calls ``sink.emit`` (locked) and
    touches no mutable state of its own.
    """

    __slots__ = ("_sink", "process")

    def __init__(self, sink, process: str):
        self._sink = sink
        self.process = process

    def emit(self, trace_id: str, name: str, start_mono_ns: int,
             dur_ns: int, parent: Optional[str] = None,
             span_id: Optional[str] = None, **attrs) -> str:
        """Write one ``trace_span`` record; returns the span id (callers
        pass it as the ``parent`` of child spans, possibly across the
        wire). ``attrs`` are the additive labels — ``replica``, ``outcome``,
        ``op`` — the schema type-checks when present."""
        sid = span_id or new_span_id()
        self._sink.emit(
            "trace_span", trace_id=trace_id, span=sid, name=name,
            mono_ns=int(start_mono_ns), dur_ns=int(dur_ns),
            process=self.process,
            **({"parent": parent} if parent else {}), **attrs)
        return sid


def service_process_name(kind: str = "serve") -> str:
    """Default process label for span/anchor records (overridable by the
    CLI): stable within a process, distinguishable across a fleet."""
    return f"{kind}-{os.getpid()}"


def emit_publish(emit, checkpoint_path: str, step: int,
                 publisher: str = "trainer") -> Optional[str]:
    """The publish-side correlation record: one ``publish`` telemetry
    record carrying the freshly-written checkpoint's ``publish_sig`` (the
    same ``mtime_ns-inode-size`` string the serving tier's watcher and the
    CLI's stats report — serve/reload.publish_signature), so the
    collector can link trainer/ContinualRunner save → watcher detect →
    per-replica drain+reload as ONE causal chain keyed by the signature.
    ``emit(kind, **fields)`` writes the record: a sink's ``emit``, or the
    trainer's, which also feeds its flight recorder. Returns the signature
    string (None when the path is mid-swap/absent — nothing is emitted then;
    the next save re-anchors)."""
    from glint_word2vec_torch.serve.reload import (
        publish_signature, publish_signature_str)
    sig_str = publish_signature_str(publish_signature(checkpoint_path))
    if sig_str is None:
        return None
    emit("publish", publish_sig=sig_str, checkpoint=checkpoint_path,
         step=int(step), publisher=publisher)
    return sig_str
