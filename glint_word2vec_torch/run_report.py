"""Fold a telemetry JSONL run log into one summary JSON line, ported from
``tools/run_report.py``.

The machine half of post-run inspection: where :mod:`.telemetry_tail` renders for a
person, this tool reduces a whole run log (and optionally its ``.blackbox.json`` dump and
the rows of an eval-runs JSONL) into one line a script can archive, diff and gate on.
Stdout carries exactly one JSON line; progress goes to stderr.

Summary fields: the run bracket (run_id, status, steps, pairs), throughput over the
heartbeat windows (median, p10, p90, last pairs/s), the host-wait and dispatch totals
and the per-phase time rollup (from ``run_end``; summed over the heartbeat windows when
the log is truncated, the crash case the flight recorder exists for), recovery and
watchdog state, and the norm channel's trajectory (first, last, max of the syn0 and
syn1 ``max_norm``). Every field is a function of the records alone, so two folds of
one log are equal; ``wall_s``, ``pairs_per_sec``, the host totals and ``phases`` hold
the run's wall-clock readings.

Usage::

    # one run log (rotated segments are more positional paths, oldest first)
    python -m glint_word2vec_torch.run_report run.jsonl [run.jsonl.1 ...]
        [--blackbox run.jsonl.blackbox.json]
        [--eval-runs eval_runs.jsonl] [--eval-last N]

    # a fleet run: one --log a process (router, replicas, trainer); reports each
    # process's status and the merged rollup
    python -m glint_word2vec_torch.run_report --log fleet.jsonl --log replica-0.jsonl

Exit code 0 iff every log parsed and the run ended ``ok``. A log without its end bracket
(``run_end``, ``serve_end`` or ``fleet_end``) reports ``"status": "truncated"`` and exits
1. A deadline-checkpointed preemption reports ``"status": "preempted"`` with a
``"preempt"`` block (steps saved, steps lost) and exits 1 too: resuming is the
supervisor's job. In ``--log`` mode each log's ``<log>.blackbox.json`` dump is folded in
when present (a dump beside a truncated serving log is a SIGTERM's expected shape). It
runs on the host only (no device).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from glint_word2vec_torch.obs.phases import HIST_BUCKETS, PhaseAccumulator
from glint_word2vec_torch.obs.schema import validate_blackbox_file, validate_file


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[i]


def _merge_phase_windows(windows: List[dict]) -> dict:
    """Sum per-heartbeat phase rollups into one run-level rollup (used when ``run_end``,
    which carries the exact cumulative one, is missing); the bucketed quantiles are
    derived again from the merged histograms."""
    out: dict = {}
    for w in windows:
        for name, ph in (w or {}).items():
            acc = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                        "hist": [0] * HIST_BUCKETS})
            acc["count"] += int(ph.get("count", 0))
            acc["total_s"] += float(ph.get("total_s", 0.0))
            for idx, c in (ph.get("hist") or {}).items():
                i = int(idx)
                if 0 <= i < HIST_BUCKETS:
                    acc["hist"][i] += int(c)
    return {name: PhaseAccumulator._summarize(acc["count"], acc["total_s"], acc["hist"])
            for name, acc in out.items()}


def summarize(paths: List[str], blackbox: str = "", eval_runs: str = "",
              eval_last: int = 1, tolerate_torn_tail: bool = False) -> dict:
    kinds: dict = {}
    heartbeats: List[dict] = []
    run_start: Optional[dict] = None
    run_end: Optional[dict] = None
    watchdog = 0
    recoveries: List[dict] = []
    preempt: Optional[dict] = None
    schema_ok = True
    schema_errors: List[str] = []
    for path in paths:
        v = validate_file(path, tolerate_torn_tail=tolerate_torn_tail)
        schema_ok = schema_ok and v["ok"]
        schema_errors.extend(v["errors"][:5])
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue  # counted by the validator above
                kind = r.get("kind", "?")
                kinds[kind] = kinds.get(kind, 0) + 1
                if kind == "heartbeat":
                    heartbeats.append(r)
                # a fleet's sinks are serve_* and fleet_* logs: their end bracket is
                # what "the process exited cleanly" means there (no status field)
                elif kind in ("run_start", "serve_start", "fleet_start"):
                    run_start = r
                elif kind in ("run_end", "serve_end", "fleet_end"):
                    run_end = r
                elif kind == "watchdog":
                    watchdog += 1
                elif kind == "recovery":
                    recoveries.append(r)
                elif kind == "preempt":
                    preempt = r

    pps = sorted(float(h["pairs_per_sec"]) for h in heartbeats if h.get("pairs_per_sec"))
    status = run_end.get("status", "ok") if run_end else "truncated"
    phases = (run_end or {}).get("phases")
    if not phases:
        phases = _merge_phase_windows([h.get("phases") for h in heartbeats
                                       if h.get("phases")])

    def _norm_track(matrix: str) -> dict:
        vals = [h["norms"][matrix]["max_norm"] for h in heartbeats
                if (h.get("norms") or {}).get(matrix, {}).get("max_norm") is not None]
        if not vals:
            return {}
        return {"first": vals[0], "last": vals[-1], "max": max(vals)}

    report = {
        "ok": bool(schema_ok and status == "ok"),
        "paths": paths,
        "schema_valid": schema_ok,
        "schema_errors": schema_errors[:5],
        "run_id": (run_end or run_start or {}).get("run_id"),
        "status": status,
        "kinds": kinds,
        "steps": (run_end or {}).get("steps", heartbeats[-1]["step"] if heartbeats else 0),
        "pairs_trained": (run_end or {}).get("pairs_trained"),
        "wall_s": (round(run_end["t"] - run_start["t"], 3)
                   if run_end and run_start else None),
        "heartbeats": len(heartbeats),
        "pairs_per_sec": {
            "median": round(_quantile(pps, 0.5), 1),
            "p10": round(_quantile(pps, 0.10), 1),
            "p90": round(_quantile(pps, 0.90), 1),
            "last": round(pps[-1], 1) if pps else 0.0,
        } if pps else None,
        "host_wait_s_total": (run_end or {}).get("host_wait_s_total"),
        "dispatch_s_total": (run_end or {}).get("dispatch_s_total"),
        "phases": phases,
        "watchdog_fires": (watchdog if not run_end
                           else run_end.get("watchdog_fires", watchdog)),
        "recoveries": (len(recoveries) if not run_end
                       else run_end.get("recoveries", len(recoveries))),
        "lr_scale_final": (run_end or {}).get(
            "lr_scale", heartbeats[-1].get("lr_scale") if heartbeats else None),
        "norms": {m: t for m in ("syn0", "syn1") if (t := _norm_track(m))} or None,
    }
    if status == "preempted" and preempt is not None:
        # the run was asked to die and published what it could first; steps_lost is
        # what the supervisor trains again after the resume: 0 when the emergency
        # save made the deadline, else the gap back to the last periodic checkpoint
        lost = 0 if preempt.get("saved") else int(preempt.get("steps_since_save") or 0)
        report["preempt"] = {
            "saved": bool(preempt.get("saved")),
            "step": preempt.get("step"),
            "steps_saved": int(preempt.get("step") or 0) - lost,
            "steps_lost": lost,
            "checkpoint": preempt.get("checkpoint"),
        }
    if blackbox:
        bb = validate_blackbox_file(blackbox)
        report["blackbox"] = {"path": blackbox, "valid": bb["ok"], "kinds": bb["kinds"],
                              "errors": bb["errors"][:3]}
        if bb["ok"]:
            with open(blackbox, "r", encoding="utf-8") as f:
                report["blackbox"]["cause"] = json.load(f)["cause"]
    if eval_runs:
        rows = []
        try:
            with open(eval_runs, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(json.loads(line))
        except (OSError, json.JSONDecodeError) as e:
            report["eval"] = {"error": str(e)}
        else:
            keep = ("purity", "analogy_acc1", "emb_abs_max", "row_norm_max",
                    "row_norm_p99", "rows_norm_over_100", "vocab_size", "words",
                    "gen_version", "stab_ab_arm", "diverged")
            report["eval"] = [{k: r[k] for k in keep if k in r}
                              for r in rows[-max(eval_last, 1):]]
    return report


def summarize_fleet(logs: List[str]) -> dict:
    """Per-process reports and the merged rollup for a fleet run's N sinks (one
    ``--log`` a process). Each log's ``<log>.blackbox.json`` is folded in when present;
    the merged verdict is ok only when every process's is."""
    processes = {}
    for path in logs:
        name = os.path.splitext(os.path.basename(path))[0]
        if name in processes:
            # two hosts' sinks may share a basename: keep both, by path
            name = path
        bb = path + ".blackbox.json"
        # a fleet's teardown is SIGKILL: a half-written last line is expected
        rep = summarize([path], blackbox=bb if os.path.exists(bb) else "",
                        tolerate_torn_tail=True)
        # a process that died with a dump told its story; the alarm is a truncated
        # log with no dump at all
        rep["dumped"] = "blackbox" in rep
        processes[name] = rep
    merged_kinds: dict = {}
    for rep in processes.values():
        for k, n in rep["kinds"].items():
            merged_kinds[k] = merged_kinds.get(k, 0) + n

    # the fleet's verdict: every sink schema-valid with records, and no process that
    # wrote its end bracket ended "error"; "truncated" is a replica's normal end
    # (ReplicaSet.close kills it)
    def _proc_ok(r: dict) -> bool:
        return (r["schema_valid"] and sum(r["kinds"].values()) > 0
                and r["status"] != "error")

    return {
        "ok": all(_proc_ok(r) for r in processes.values()),
        "mode": "fleet",
        "processes": {n: {
            "ok": _proc_ok(r),
            "status": r["status"], "records": sum(r["kinds"].values()),
            "schema_valid": r["schema_valid"], "dumped": r["dumped"],
            **({"cause": r["blackbox"].get("cause", {}).get("kind")}
               if r.get("blackbox") else {}),
        } for n, r in processes.items()},
        "merged": {
            "logs": len(processes),
            "statuses": sorted({r["status"] for r in processes.values()}),
            "schema_valid": all(r["schema_valid"] for r in processes.values()),
            "kinds": merged_kinds,
            "dumps": sum(1 for r in processes.values() if r["dumped"]),
        },
        "detail": processes,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.run_report",
                                 description=__doc__.split("\n", 1)[0])
    ap.add_argument("paths", nargs="*",
                    help="sink JSONL file(s), oldest rotated segment first (one run's "
                         "segments; use --log for a fleet run)")
    ap.add_argument("--log", action="append", default=[],
                    help="one process's sink of a fleet run; repeatable")
    ap.add_argument("--blackbox", default="",
                    help="also validate and fold in a .blackbox.json dump")
    ap.add_argument("--eval-runs", default="",
                    help="append the last rows of an eval-runs JSONL")
    ap.add_argument("--eval-last", type=int, default=1,
                    help="how many trailing eval-runs rows to include")
    args = ap.parse_args(argv)
    if bool(args.paths) == bool(args.log):
        ap.error("pass either positional segment paths (one run) or --log per "
                 "process (a fleet run), not both or neither")
    if args.log:
        report = summarize_fleet(args.log)
    else:
        report = summarize(args.paths, blackbox=args.blackbox,
                           eval_runs=args.eval_runs, eval_last=args.eval_last)
    print(json.dumps(report, allow_nan=False))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
