"""Per-phase host time attribution, ported from ``glint_word2vec_tpu/obs/phases.py``:
log2 histograms over per-chunk durations.

Phases: ``producer_wait`` (fit blocked on the next chunk), ``stage`` (the feed's copy
to the card, span ``stage_put``), ``dispatch`` (a chunk's step launches) and
``device_block`` (explicit waits for the card: the health probe's fetch and the
heartbeat's metric fetch). Durations arrive through the span tracer (every span whose
name maps to a phase, ``spans._PHASE_OF``) and through direct ``add`` calls. Buckets
cover 2^-20 s (~1 µs) to 2^6 s at four per octave, 104 buckets; a bucketed quantile is
exact to one bucket (ratio <= 2^0.25). Thread-safe; a disabled accumulator costs one
attribute check per ``add``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from glint_word2vec_torch.lockcheck import make_rlock

HIST_LO = -20            # log2 seconds of the smallest bucket edge
HIST_PER_OCTAVE = 4
HIST_BUCKETS = (6 - HIST_LO) * HIST_PER_OCTAVE  # 104

PHASES = ("producer_wait", "stage", "dispatch", "device_block")


def bucket_index(seconds: float) -> int:
    """Bucket for one duration: ``floor((log2(s) - LO) * 4)``, edge-clamped."""
    if seconds <= 2.0 ** HIST_LO:
        return 0
    i = int(math.floor((math.log2(seconds) - HIST_LO) * HIST_PER_OCTAVE))
    return min(max(i, 0), HIST_BUCKETS - 1)


def bucket_upper_edge(index: int) -> float:
    """Upper duration edge (seconds) of bucket ``index``: what a bucketed quantile
    reports."""
    return 2.0 ** ((index + 1) / HIST_PER_OCTAVE + HIST_LO)


class _Phase:
    __slots__ = ("count", "total_s", "max_s", "hist")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.hist: List[int] = [0] * HIST_BUCKETS


def _hist_quantile(hist: List[int], count: int, q: float) -> float:
    """Upper edge of the bucket where the CDF crosses ``q`` of ``count``."""
    if count <= 0:
        return 0.0
    need = max(1, math.ceil(q * count))
    acc = 0
    for i, c in enumerate(hist):
        acc += c
        if acc >= need:
            return bucket_upper_edge(i)
    return bucket_upper_edge(HIST_BUCKETS - 1)


class PhaseAccumulator:
    """Thread-safe per-phase duration histograms for one trainer. The lock is
    reentrant: the SIGTERM dump snapshots the histograms from the main thread, which
    may hold it in an interrupted ``add``."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = make_rlock("obs.phases")
        self._phases: Dict[str, _Phase] = {p: _Phase() for p in PHASES}

    def clear(self) -> None:
        with self._lock:
            self._phases = {p: _Phase() for p in PHASES}

    def add(self, phase: str, seconds: float) -> None:
        if not self.enabled:
            return
        ph = self._phases.get(phase)
        if ph is None:
            return
        i = bucket_index(seconds)
        with self._lock:
            ph.count += 1
            ph.total_s += seconds
            if seconds > ph.max_s:
                ph.max_s = seconds
            ph.hist[i] += 1

    def raw_snapshot(self) -> Dict[str, tuple]:
        """A cheap copy for a later :meth:`delta`: {phase: (count, total_s, hist)}
        (``max_s`` is cumulative only)."""
        with self._lock:
            return {name: (ph.count, ph.total_s, list(ph.hist))
                    for name, ph in self._phases.items()}

    @staticmethod
    def _summarize(count: int, total_s: float, hist: List[int],
                   max_s: Optional[float] = None) -> dict:
        out = {
            "count": count,
            "total_s": round(total_s, 6),
            "p50_s": round(_hist_quantile(hist, count, 0.50), 9),
            "p99_s": round(_hist_quantile(hist, count, 0.99), 9),
            # sparse: {bucket index: count}; bucket i's upper edge is 2^((i+1)/4 - 20) s
            "hist": {str(i): c for i, c in enumerate(hist) if c},
        }
        if max_s is not None:
            out["max_s"] = round(max_s, 6)
        return out

    def summary(self) -> Dict[str, dict]:
        """Cumulative per-phase rollup (run_end, last_run_stats, statusd); phases that
        never ran are omitted."""
        with self._lock:
            return {name: self._summarize(ph.count, ph.total_s, ph.hist, ph.max_s)
                    for name, ph in self._phases.items() if ph.count}

    def delta(self, prev: Dict[str, tuple]) -> Dict[str, dict]:
        """Per-phase rollup of everything added since ``prev`` (a
        :meth:`raw_snapshot`): the heartbeat window."""
        cur = self.raw_snapshot()
        out: Dict[str, dict] = {}
        for name, (count, total_s, hist) in cur.items():
            pc, pt, ph = prev.get(name, (0, 0.0, None))
            dcount = count - pc
            if dcount <= 0:
                continue
            dhist = hist if ph is None else [a - b for a, b in zip(hist, ph)]
            out[name] = self._summarize(dcount, total_s - pt, dhist)
        return out
