"""Fleet timeline collector, ported from ``glint_word2vec_tpu/obs/collect.py``: N
per-process telemetry sinks (and their ``.blackbox.json`` dumps) merged into one causal
story.

- **clock alignment**: every ``run_start``/``serve_start``/``fleet_start`` carries a clock
  anchor (``obs/trace.clock_anchor``: one simultaneous ``wall_ns``/``mono_ns`` reading).
  A span's monotonic stamp lands on the fleet's wall timeline as ``anchor.wall_ns +
  (span.mono_ns - anchor.mono_ns)``, through the most recent anchor above it in its file
  (a restarted replica appends a new epoch). Records without a monotonic stamp use their
  wall-clock ``t``. The merge sorts on aligned wall time;
- **trace reassembly**: ``trace_span`` records grouped by ``trace_id``: the router's
  ``fleet_query`` root, its ``attempt`` children (a hedge loser is ``abandoned``, never
  ``failed``), and the replica-side ``queue_wait``/``batch_service``/``exact_scan``/
  ``ann_probe`` children that crossed the wire under the attempt's span id;
- **publish chains**: ``publish`` records joined to ``serve_start``/``serve_reload``/
  ``fleet_reload`` by their ``publish_sig``;
- **SLO recompute**: the availability and latency objectives over the merged
  ``fleet_query`` roots, with :func:`~glint_word2vec_torch.obs.slo
  .burn_rates_from_samples`, the live router's math;
- **exports**: a multi-track Perfetto/Chrome trace and a one-line summary with the
  slowest-K exemplar traces.

Offline, and the module itself uses the standard library only: it reads what a dead
fleet left behind and imports nothing of the serving stack.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from glint_word2vec_torch.obs.slo import (
    SloObjectives,
    burn_rates_from_samples,
    slowest_k,
)

# span outcomes that mean "the CALLER got no answer" for the offline
# availability SLI (obs/slo.py: shed and deadline-exhaustion are BAD;
# abandoned hedge losers and per-attempt failures are attempt-level churn,
# visible on the trace but invisible to the caller-facing SLO)
_BAD_ROOT_OUTCOMES = ("failed", "shed")


def scan_artifacts(paths: Iterable[str]) -> List[str]:
    """Expand directories into the artifact files the fleet leaves behind:
    ``*.jsonl`` sinks, their rotated ``*.jsonl.N`` segments, and
    ``*.blackbox.json`` dumps. Files pass through untouched; order is
    deterministic (sorted per directory)."""
    out: List[str] = []
    for p in paths:
        if not os.path.isdir(p):
            out.append(p)
            continue
        for name in sorted(os.listdir(p)):
            full = os.path.join(p, name)
            if not os.path.isfile(full):
                continue
            stem, ext = os.path.splitext(name)
            if ext == ".jsonl" or name.endswith(".blackbox.json") or (
                    ext.lstrip(".").isdigit() and stem.endswith(".jsonl")):
                out.append(full)
    return out


def _read_jsonl(path: str) -> Tuple[List[dict], int]:
    """Parsed records + count of unparseable lines (a truncated tail —
    exactly what a SIGKILL leaves — must not sink the merge)."""
    recs: List[dict] = []
    bad = 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if isinstance(rec, dict):
                recs.append(rec)
            else:
                bad += 1
    return recs, bad


def _group_files(files: List[str]) -> Dict[str, dict]:
    """Group artifact files per PROCESS log: rotated segments
    (``x.jsonl.1``...) and the blackbox dump (``x.jsonl.blackbox.json``)
    attach to their base ``x.jsonl``. Returns base-path → {"segments":
    [oldest..newest], "blackbox": path|None}."""
    groups: Dict[str, dict] = {}

    def grp(base: str) -> dict:
        return groups.setdefault(base, {"segments": [], "blackbox": None})

    rotated: List[Tuple[str, int]] = []
    for f in files:
        if f.endswith(".blackbox.json"):
            grp(f[: -len(".blackbox.json")])["blackbox"] = f
        elif f.endswith(".jsonl"):
            grp(f)  # ensure the group exists even for an empty sink
        else:
            stem, ext = os.path.splitext(f)
            if ext.lstrip(".").isdigit() and stem.endswith(".jsonl"):
                rotated.append((stem, int(ext.lstrip("."))))
                # a process killed between rotate and the lazy reopen leaves
                # ONLY .jsonl.N segments — the group must still exist
                grp(stem)
            else:
                grp(f)  # unknown extension: treat as a standalone JSONL
    for base in groups:
        segs = sorted((n for s, n in rotated if s == base), reverse=True)
        # oldest rotated segment first (.3, .2, .1), the live file last
        groups[base]["segments"] = [f"{base}.{n}" for n in segs] + (
            [base] if os.path.exists(base) or not segs else [])
    return groups


class ProcessLog:
    """One process's telemetry: its records (rotated segments folded in,
    oldest first) each stamped with its fleet-wall-timeline position, its
    track label, and its blackbox dump when the process died with one.

    Anchoring is EPOCHED, not per-file: a restarted replica appends to the
    same sink path with a fresh monotonic base, announcing itself with a
    new ``serve_start`` anchor — so each record's monotonic stamp is
    aligned through the most recent anchor ABOVE it in file order (records
    within one file are append-ordered by the process that wrote them,
    even when their monotonic values jump backwards across a restart). A
    span with a monotonic stamp but no anchor yet gets None (unanchored
    monotonic time is process-relative garbage); anchorless records fall
    back to their wall-clock ``t``."""

    def __init__(self, base: str, segments: List[str],
                 blackbox_path: Optional[str]):
        self.path = base
        self.records: List[dict] = []
        self.walls: List[Optional[int]] = []
        self.bad_lines = 0
        anchor: Optional[Tuple[int, int]] = None
        for seg in segments:
            try:
                recs, bad = _read_jsonl(seg)
            except OSError:
                continue
            self.bad_lines += bad
            for rec in recs:
                if isinstance(rec.get("wall_ns"), int) and isinstance(
                        rec.get("mono_ns"), int):
                    anchor = (rec["wall_ns"], rec["mono_ns"])
                self.records.append(rec)
                self.walls.append(_wall_ns(rec, anchor))
        self.blackbox: Optional[dict] = None
        if blackbox_path is not None:
            try:
                with open(blackbox_path, "r", encoding="utf-8") as f:
                    self.blackbox = json.load(f)
            except (OSError, json.JSONDecodeError):
                self.bad_lines += 1
        # track label: the first record naming its process, else file stem
        self.process = next(
            (r["process"] for r in self.records
             if isinstance(r.get("process"), str)),
            os.path.splitext(os.path.basename(base))[0])


def _wall_ns(rec: dict, anchor: Optional[Tuple[int, int]]) -> Optional[int]:
    mono = rec.get("mono_ns")
    if isinstance(mono, int):
        if anchor is None:
            return None
        aw, am = anchor
        return aw + (mono - am)
    t = rec.get("t")
    return int(t * 1e9) if isinstance(t, (int, float)) else None


def load_process_logs(paths: Iterable[str]) -> List[ProcessLog]:
    groups = _group_files(scan_artifacts(paths))
    logs = [ProcessLog(base, g["segments"], g["blackbox"])
            for base, g in sorted(groups.items())]
    return [pl for pl in logs if pl.records or pl.blackbox]


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------


def build_timeline(logs: List[ProcessLog]) -> dict:
    """Merge N process logs into the fleet timeline dict every consumer
    (summary, Perfetto export, gate, drill assertions) reads:

    - ``events``: every non-span record, wall-ordered, each stamped with
      ``_process`` and ``_wall_ns``;
    - ``traces``: trace_id → {"root": span|None, "spans": [all spans,
      wall-ordered], "dur_ns", "outcome", "op"};
    - ``publish_chains``: publish_sig → wall-ordered correlated records;
    - ``blackboxes``: per dead process, the dump's cause + counts.
    """
    events: List[dict] = []
    spans_by_trace: Dict[str, List[dict]] = {}
    for pl in logs:
        for rec, w in zip(pl.records, pl.walls):
            entry = dict(rec, _process=pl.process, _wall_ns=w)
            if rec.get("kind") == "trace_span":
                if w is not None:
                    spans_by_trace.setdefault(
                        rec.get("trace_id", "?"), []).append(entry)
            elif w is not None:
                events.append(entry)
    events.sort(key=lambda r: r["_wall_ns"])

    traces: Dict[str, dict] = {}
    for tid, spans in spans_by_trace.items():
        spans.sort(key=lambda s: s["_wall_ns"])
        root = next((s for s in spans if s.get("name") == "fleet_query"),
                    None)
        traces[tid] = {
            "root": root,
            "spans": spans,
            "dur_ns": (root or {}).get("dur_ns"),
            "outcome": (root or {}).get("outcome"),
            "op": (root or {}).get("op"),
        }

    chains: Dict[str, List[dict]] = {}
    for ev in events:
        sig = ev.get("publish_sig")
        if isinstance(sig, str) and ev.get("kind") in (
                "publish", "serve_start", "serve_reload", "fleet_reload"):
            chains.setdefault(sig, []).append(ev)

    blackboxes = [
        {"process": pl.process, "path": f"{pl.path}.blackbox.json",
         "cause": (pl.blackbox.get("cause") or {}),
         "events": len(pl.blackbox.get("events") or []),
         "dispatches": len(pl.blackbox.get("dispatches") or [])}
        for pl in logs if pl.blackbox is not None]

    return {"events": events, "traces": traces, "publish_chains": chains,
            "blackboxes": blackboxes,
            "processes": sorted({pl.process for pl in logs}),
            "bad_lines": sum(pl.bad_lines for pl in logs)}


# ---------------------------------------------------------------------------
# offline SLO recompute (one math with the live tracker: obs/slo.py)
# ---------------------------------------------------------------------------


def recompute_slo(timeline: dict,
                  objectives: Optional[SloObjectives] = None) -> dict:
    """The availability + latency SLO over the merged ``fleet_query`` roots
    — the same burn math the live router computes, re-derived from the
    artifacts alone so an incident review needs no surviving process.
    ``now`` is the last root's wall time: burn windows are anchored to the
    END of the storm, which is what "was the budget intact when it ended"
    means."""
    obj = objectives or SloObjectives()
    roots = [t for t in timeline["traces"].values()
             if t["root"] is not None]
    samples = sorted(
        (t["root"]["_wall_ns"] / 1e9,
         t["outcome"] not in _BAD_ROOT_OUTCOMES,
         t["outcome"] not in _BAD_ROOT_OUTCOMES
         and t["dur_ns"] is not None
         and t["dur_ns"] / 1e6 <= obj.latency_ms)
        for t in roots)
    if not samples:
        return {"samples": 0, "availability": None, "within_budget": True,
                "objective_availability": obj.availability}
    now = samples[-1][0]
    windows = (("short", obj.short_window_s), ("long", obj.long_window_s))
    avail = burn_rates_from_samples(
        [(t, ok) for t, ok, _ in samples], now, obj.availability, windows)
    lat = burn_rates_from_samples(
        [(t, within) for t, ok, within in samples if ok], now,
        obj.latency_target, windows)
    bad = sum(1 for _, ok, _ in samples if not ok)
    burns = [w["burn_rate"] for b in (avail, lat) for w in b.values()
             if w["burn_rate"] is not None]
    return {
        "samples": len(samples),
        "bad": bad,
        "availability": round(1.0 - bad / len(samples), 6),
        "objective_availability": obj.availability,
        "objective_latency_ms": obj.latency_ms,
        "availability_burn": avail,
        "latency_burn": lat,
        "within_budget": all(b <= 1.0 for b in burns),
    }


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

# non-span record kinds worth an instant marker on the Perfetto timeline
_MARKER_KINDS = ("fleet_breaker", "publish", "serve_reload", "fleet_reload",
                 "serve_start", "fleet_start", "run_start", "watchdog",
                 "recovery", "fleet_slo")


def _marker_name(ev: dict) -> str:
    k = ev["kind"]
    if k == "fleet_breaker":
        return (f"breaker {ev.get('replica', '?')} "
                f"{ev.get('from_state', '?')}->{ev.get('to_state', '?')}")
    if k == "publish":
        return f"publish sig={ev.get('publish_sig', '?')[:16]}"
    if k in ("serve_reload", "fleet_reload"):
        return f"{k} sig={str(ev.get('publish_sig', '?'))[:16]}"
    return k


def export_perfetto(timeline: dict, path: str) -> int:
    """Write the merged timeline as a Chrome-trace/Perfetto JSON: one pid
    per PROCESS (named tracks), one tid row per span kind, ``X`` duration
    events for spans (args carry trace_id/outcome/replica so Perfetto's
    search finds a query end-to-end), instant events for state transitions,
    and one instant per blackbox cause. Returns the event count. Timestamps
    are microseconds relative to the earliest record (Chrome-trace
    convention; absolute ns wall time rides in args)."""
    all_ns = [s["_wall_ns"] for t in timeline["traces"].values()
              for s in t["spans"]]
    all_ns += [e["_wall_ns"] for e in timeline["events"]]
    if not all_ns:
        t0 = 0
    else:
        t0 = min(all_ns)
    pid_of = {p: i for i, p in enumerate(timeline["processes"])}
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid,
         "args": {"name": proc}} for proc, pid in pid_of.items()]
    tid_of: Dict[Tuple[str, str], int] = {}
    tids_used: Dict[int, Dict[int, str]] = {}

    def tid(proc: str, row: str) -> int:
        key = (proc, row)
        if key not in tid_of:
            per = tids_used.setdefault(pid_of.get(proc, 0), {})
            tid_of[key] = len(per)
            per[len(per)] = row
        return tid_of[key]

    for t in timeline["traces"].values():
        for s in t["spans"]:
            proc = s["_process"]
            args = {k: s[k] for k in ("trace_id", "span", "parent",
                                      "replica", "outcome", "op")
                    if k in s}
            args["wall_ns"] = s["_wall_ns"]
            events.append({
                "ph": "X", "name": s.get("name", "span"),
                "pid": pid_of.get(proc, 0),
                "tid": tid(proc, s.get("name", "span")),
                "ts": round((s["_wall_ns"] - t0) / 1e3, 3),
                "dur": round(s.get("dur_ns", 0) / 1e3, 3),
                "args": args})
    for ev in timeline["events"]:
        if ev["kind"] not in _MARKER_KINDS:
            continue
        proc = ev["_process"]
        events.append({
            "ph": "i", "s": "p", "name": _marker_name(ev),
            "pid": pid_of.get(proc, 0), "tid": tid(proc, "events"),
            "ts": round((ev["_wall_ns"] - t0) / 1e3, 3),
            "args": {k: v for k, v in ev.items()
                     if not k.startswith("_") and k not in ("schema",)}})
    for bb in timeline["blackboxes"]:
        events.append({
            "ph": "i", "s": "g",
            "name": f"blackbox {bb['process']}: "
                    f"{bb['cause'].get('kind', '?')}",
            "pid": pid_of.get(bb["process"], 0),
            "tid": tid(bb["process"], "events"),
            # the dump has no aligned stamp of its own; park it at the end
            "ts": round((max(all_ns) - t0) / 1e3, 3) if all_ns else 0,
            "args": bb["cause"]})
    events += [{"ph": "M", "name": "thread_name", "pid": pid,
                "tid": small, "args": {"name": row}}
               for pid, rows in tids_used.items()
               for small, row in rows.items()]
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"processes": timeline["processes"],
                         "t0_wall_ns": t0}}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(events)


def _span_brief(s: dict, root_ns: Optional[int]) -> dict:
    return {
        "name": s.get("name"), "process": s["_process"],
        "offset_ms": (round((s["_wall_ns"] - root_ns) / 1e6, 3)
                      if root_ns is not None else None),
        "dur_ms": round(s.get("dur_ns", 0) / 1e6, 3),
        **{k: s[k] for k in ("replica", "outcome", "op") if k in s},
    }


def summarize(timeline: dict, slo: dict, k: int = 5) -> dict:
    """The collector's one-line report: counts, attempt-outcome census,
    breaker transitions, publish chains, the slowest-K exemplar traces
    with their full cross-process span breakdown, and the offline SLO."""
    outcomes: Dict[str, int] = {}
    n_spans = 0
    for t in timeline["traces"].values():
        for s in t["spans"]:
            n_spans += 1
            if s.get("name") == "attempt":
                oc = s.get("outcome", "?")
                outcomes[oc] = outcomes.get(oc, 0) + 1
    slowest = slowest_k(
        [(t["dur_ns"], t) for t in timeline["traces"].values()
         if t["dur_ns"] is not None and t["root"] is not None], k)
    exemplars = [{
        "trace_id": t["root"].get("trace_id"),
        "op": t["op"], "outcome": t["outcome"],
        "dur_ms": round(t["dur_ns"] / 1e6, 3),
        "spans": [_span_brief(s, t["root"]["_wall_ns"])
                  for s in t["spans"]],
    } for t in slowest]
    breakers = [
        {"t_ms": round((ev["_wall_ns"]) / 1e6, 1),
         "process": ev["_process"], "replica": ev.get("replica"),
         "transition": f"{ev.get('from_state')}->{ev.get('to_state')}"}
        for ev in timeline["events"] if ev["kind"] == "fleet_breaker"]
    chains = {
        sig: [{"kind": ev["kind"], "process": ev["_process"],
               "t_ms": round(ev["_wall_ns"] / 1e6, 1)} for ev in evs]
        for sig, evs in timeline["publish_chains"].items()}
    return {
        "processes": timeline["processes"],
        "records": len(timeline["events"]) + n_spans,
        "bad_lines": timeline["bad_lines"],
        "traces": len(timeline["traces"]),
        "spans": n_spans,
        "attempt_outcomes": outcomes,
        "breaker_transitions": breakers[:64],
        "publish_chains": chains,
        "slowest": exemplars,
        "blackboxes": [{"process": b["process"],
                        "cause": b["cause"].get("kind", "?")}
                       for b in timeline["blackboxes"]],
        "slo": slo,
    }


def collect(paths: Iterable[str],
            objectives: Optional[SloObjectives] = None,
            slowest: int = 5) -> Tuple[dict, dict]:
    """The whole pipeline: artifacts → (timeline, summary). The timeline is
    the rich in-memory form (drill assertions read it); the summary is the
    JSON-safe report."""
    timeline = build_timeline(load_process_logs(paths))
    slo = recompute_slo(timeline, objectives)
    return timeline, summarize(timeline, slo, k=slowest)
