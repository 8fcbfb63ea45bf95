"""Fleet SLOs, ported from ``glint_word2vec_tpu/obs/slo.py``: availability and latency
objectives with multi-window burn rates over the router's own per-query samples.

- **availability SLO**: the fraction of client queries answered. A query that exhausted
  the retry deadline, or that fleet-level load shedding refused, is bad; retries that
  succeeded are invisible here (they are the router's ``retries`` counter and its
  per-attempt trace spans);
- **latency SLO**: the fraction of answered queries under ``latency_ms``;
- **burn rate** per window = (bad fraction in the window) / (1 - objective): 1.0 spends
  the budget exactly at the objective's rate. Two windows (short and long) tell a
  transient blip from a steady leak.

The tracker is a bounded ring of ``(mono_s, ok, within_latency)`` samples under one
lock (``obs.slo``): O(1) per query, O(ring) per snapshot, monotonic time only.
``FleetRouter`` owns one tracker (``stats()["slo"]``); ``statusd.fleet_prometheus_text``
renders the ``glint_serve_fleet_slo_*`` gauges; ``obs/collect.py`` recomputes the same
objectives offline with the same :func:`burn_rates_from_samples`. Standard library and
the port's lock registry only; the same samples give the same burn rates as the JAX
package's module.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from glint_word2vec_torch.lockcheck import make_lock


class SloObjectives:
    """The objective set (constructor-level knobs, not config fields: the
    SLO is a property of a DEPLOYMENT's router, not of a trained model —
    unlike the serve_* knobs it does not travel with the checkpoint)."""

    __slots__ = ("availability", "latency_ms", "latency_target",
                 "short_window_s", "long_window_s")

    def __init__(self, availability: float = 0.999,
                 latency_ms: float = 250.0,
                 latency_target: float = 0.99,
                 short_window_s: float = 300.0,
                 long_window_s: float = 3600.0):
        if not 0.0 < availability < 1.0:
            raise ValueError(
                f"availability objective must be in (0, 1) but got "
                f"{availability}")
        if not 0.0 < latency_target < 1.0:
            raise ValueError(
                f"latency target must be in (0, 1) but got {latency_target}")
        if latency_ms <= 0:
            raise ValueError(
                f"latency_ms must be positive but got {latency_ms}")
        if not 0 < short_window_s <= long_window_s:
            raise ValueError(
                f"windows must satisfy 0 < short <= long but got "
                f"{short_window_s}/{long_window_s}")
        self.availability = float(availability)
        self.latency_ms = float(latency_ms)
        self.latency_target = float(latency_target)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)


def burn_rates_from_samples(
    samples: Sequence[Tuple[float, bool]], now: float, objective: float,
    windows: Sequence[Tuple[str, float]],
) -> Dict[str, Dict[str, Any]]:
    """The shared burn math: ``samples`` is ``(t, good)`` on ANY one clock
    ``now`` belongs to (the live tracker passes monotonic, the collector
    passes anchored wall seconds). Per window: good/bad counts, bad
    fraction, and burn = bad_fraction / (1 - objective). A window with no
    samples reports burn 0.0 (no traffic burns no budget) with
    ``samples: 0`` so consumers can tell silence from health."""
    budget = 1.0 - objective
    out: Dict[str, Dict[str, Any]] = {}
    for name, width in windows:
        lo = now - width
        good = bad = 0
        for t, ok in reversed(samples):
            if t < lo:
                break  # samples arrive in time order; the rest are older
            if ok:
                good += 1
            else:
                bad += 1
        n = good + bad
        bad_frac = (bad / n) if n else 0.0
        out[name] = {
            "window_s": width,
            "samples": n,
            "bad": bad,
            "bad_fraction": round(bad_frac, 6),
            "burn_rate": round(bad_frac / budget, 3) if budget else None,
        }
    return out


class SloTracker:
    """Per-query availability/latency sample ring + burn-rate snapshots."""

    def __init__(self, objectives: Optional[SloObjectives] = None,
                 ring: int = 65536):
        self.objectives = objectives or SloObjectives()
        self._lock = make_lock("obs.slo")
        # (mono_s, answered, within_latency) — bounded: at the ring size a
        # million-QPS tier still holds the full short window at drill scale,
        # and the TOTAL counters below never lose history
        self._samples: deque = deque(maxlen=int(ring))
        self._total = 0
        self._total_bad = 0
        self._total_slow = 0

    def note(self, ok: bool, latency_s: Optional[float] = None) -> None:
        """One client-query outcome: ``ok=False`` is a deadline-exhausted
        failure or a fleet-level refusal (the caller got no answer);
        ``latency_s`` is the end-to-end latency of an ANSWERED query."""
        within = bool(ok and latency_s is not None
                      and latency_s * 1000.0 <= self.objectives.latency_ms)
        with self._lock:
            self._samples.append((time.monotonic(), bool(ok), within))
            self._total += 1
            if not ok:
                self._total_bad += 1
            elif not within:
                self._total_slow += 1

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The SLO gauge set (stats()/statusd/fleet_slo record shape)."""
        obj = self.objectives
        with self._lock:
            samples = list(self._samples)
            total, bad, slow = self._total, self._total_bad, self._total_slow
        now = time.monotonic() if now is None else now
        windows = (("short", obj.short_window_s), ("long", obj.long_window_s))
        avail_burn = burn_rates_from_samples(
            [(t, ok) for t, ok, _ in samples], now, obj.availability, windows)
        # latency SLI is conditioned on ANSWERED queries: an unanswered
        # query already burned the availability budget — double-counting it
        # as "slow" would make the two SLOs redundant instead of layered
        lat_burn = burn_rates_from_samples(
            [(t, within) for t, ok, within in samples if ok], now,
            obj.latency_target, windows)
        answered = total - bad
        return {
            "objective_availability": obj.availability,
            "objective_latency_ms": obj.latency_ms,
            "objective_latency_target": obj.latency_target,
            "samples": total,
            "availability": round(1.0 - bad / total, 6) if total else None,
            "latency_good_fraction": (round(1.0 - slow / answered, 6)
                                      if answered else None),
            "availability_burn": avail_burn,
            "latency_burn": lat_burn,
            # budget remaining over the tracker's whole lifetime: 1.0 =
            # untouched, 0.0 = spent exactly, negative = blown
            "budget_remaining": (
                round(1.0 - (bad / total) / (1.0 - obj.availability), 4)
                if total else None),
        }

    def within_budget(self, snapshot: Optional[Dict[str, Any]] = None
                      ) -> bool:
        """The gate predicate the chaos drills and ``obs_collect --gate``
        assert: every burn window at or under 1.0 (spending faster than the
        objective allows is the alarm, regardless of absolute counts)."""
        snap = snapshot or self.snapshot()
        for burn in (snap["availability_burn"], snap["latency_burn"]):
            for w in burn.values():
                if w["burn_rate"] is not None and w["burn_rate"] > 1.0:
                    return False
        return True


def slo_gauge_lines(gauge, snap: Dict[str, Any]) -> None:
    """Render one SLO snapshot through a ``gauge(name, value, labels)``
    callable — shared by ``statusd.fleet_prometheus_text`` (live) so the
    gauge names have exactly one owner (docs/observability.md §9 table)."""
    if not snap:
        return
    gauge("glint_serve_fleet_slo_availability_objective",
          snap.get("objective_availability"))
    gauge("glint_serve_fleet_slo_availability", snap.get("availability"))
    gauge("glint_serve_fleet_slo_latency_objective_ms",
          snap.get("objective_latency_ms"))
    gauge("glint_serve_fleet_slo_latency_good_fraction",
          snap.get("latency_good_fraction"))
    gauge("glint_serve_fleet_slo_samples_total", snap.get("samples"))
    gauge("glint_serve_fleet_slo_budget_remaining",
          snap.get("budget_remaining"))
    for sli, key in (("availability", "availability_burn"),
                     ("latency", "latency_burn")):
        for window, w in (snap.get(key) or {}).items():
            gauge("glint_serve_fleet_slo_burn_rate", w.get("burn_rate"),
                  f'{{sli="{sli}",window="{window}"}}')


def flatten_burn(snap: Dict[str, Any]) -> Dict[str, Any]:
    """The compact form the ``fleet_slo`` telemetry record carries (full
    nested windows stay in stats()/statusd; the record is for trend lines)."""
    ab = snap.get("availability_burn") or {}
    lb = snap.get("latency_burn") or {}
    return {
        "objective": snap.get("objective_availability"),
        "availability": snap.get("availability"),
        "samples": int(snap.get("samples") or 0),
        "burn_short": (ab.get("short") or {}).get("burn_rate"),
        "burn_long": (ab.get("long") or {}).get("burn_rate"),
        "latency_good_fraction": snap.get("latency_good_fraction"),
        "latency_burn_short": (lb.get("short") or {}).get("burn_rate"),
    }


def slowest_k(items: List[Tuple[float, Any]], k: int) -> List[Any]:
    """Top-k by the float key, descending — the collector's exemplar
    selection (tiny helper here so collect.py and tests share one rule)."""
    return [x for _, x in sorted(items, key=lambda p: -p[0])[:max(0, k)]]
