"""The fleet collector's CLI, ported from ``tools/obs_collect.py``.

Merges N per-process telemetry artifacts (the router's sink, each replica's sink with its
rotated segments, trainer sinks, and any ``.blackbox.json`` dumps) into one causally
ordered fleet timeline (``obs/collect.py``): clock alignment on the ``*_start``
anchors, trace reassembly by ``trace_id``, publish chains by ``publish_sig``, and the
availability/latency SLO recomputed offline with ``obs/slo.py``'s math.

Outputs under ``--out``: ``timeline.perfetto.json`` (load it in https://ui.perfetto.dev
or chrome://tracing) and ``fleet-summary.json``. Prints one JSON line on stdout;
progress goes to stderr.

Usage::

    python -m glint_word2vec_torch.obs_collect ARTIFACT [ARTIFACT ...]
        [--out DIR] [--slowest K] [--gate]
        [--slo-availability 0.999] [--slo-latency-ms 250]
        [--slo-latency-target 0.99]
        [--slo-window-short 300] [--slo-window-long 3600]

``ARTIFACT`` is a telemetry JSONL, a ``.blackbox.json`` dump, or a directory to scan
for both. ``--gate`` makes the exit code the verdict: nonzero when a file fails schema
validation, no record was found, or an SLO burn window exceeds 1.0. It runs on the
host only (standard library; no device).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.obs_collect",
                                 description=__doc__.split("\n", 1)[0])
    ap.add_argument("artifacts", nargs="+",
                    help="telemetry JSONLs, .blackbox.json dumps, or "
                         "directories holding them")
    ap.add_argument("--out", default="",
                    help="write timeline.perfetto.json + fleet-summary.json "
                         "here (default: no files, summary on stdout only)")
    ap.add_argument("--slowest", type=int, default=5,
                    help="how many slowest-query exemplar traces to keep")
    ap.add_argument("--gate", action="store_true",
                    help="exit nonzero on schema errors, zero records, or "
                         "any SLO burn window > 1.0 (the CI verdict mode)")
    ap.add_argument("--slo-availability", type=float, default=0.999)
    ap.add_argument("--slo-latency-ms", type=float, default=250.0)
    ap.add_argument("--slo-latency-target", type=float, default=0.99)
    ap.add_argument("--slo-window-short", type=float, default=300.0)
    ap.add_argument("--slo-window-long", type=float, default=3600.0)
    args = ap.parse_args(argv)

    from glint_word2vec_torch.obs.collect import (
        collect, export_perfetto, scan_artifacts)
    from glint_word2vec_torch.obs.schema import (
        validate_blackbox_file, validate_file)
    from glint_word2vec_torch.obs.slo import SloObjectives

    files = scan_artifacts(args.artifacts)
    log(f"[collect] {len(files)} artifact file(s)")

    # the schema validator IS part of the verdict: a merged timeline built
    # from drifted records would lie with confidence. A half-written FINAL
    # line is the one exception — that's what a SIGKILL mid-flush leaves,
    # the same torn tail the merge itself tolerates
    schema_errors: list = []
    torn_tails = 0
    for f in files:
        v = (validate_blackbox_file(f) if f.endswith(".blackbox.json")
             else validate_file(f, tolerate_torn_tail=True))
        torn_tails += int(bool(v.get("torn_tail")))
        if not v["ok"]:
            schema_errors.extend(v["errors"][:3])

    objectives = SloObjectives(
        availability=args.slo_availability,
        latency_ms=args.slo_latency_ms,
        latency_target=args.slo_latency_target,
        short_window_s=args.slo_window_short,
        long_window_s=args.slo_window_long)
    timeline, summary = collect(files, objectives, slowest=args.slowest)
    summary["schema_valid"] = not schema_errors
    summary["schema_errors"] = schema_errors[:5]
    summary["torn_tails"] = torn_tails
    summary["files"] = len(files)

    gated = bool(schema_errors) or summary["records"] == 0 or not (
        summary["slo"].get("within_budget", True))
    summary["ok"] = not gated

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        perfetto = os.path.join(args.out, "timeline.perfetto.json")
        n = export_perfetto(timeline, perfetto)
        summary["perfetto"] = perfetto
        summary["perfetto_events"] = n
        with open(os.path.join(args.out, "fleet-summary.json"), "w",
                  encoding="utf-8") as f:
            json.dump(summary, f, indent=1)
        log(f"[collect] wrote {perfetto} ({n} events)")
    print(json.dumps(summary, allow_nan=False))
    if args.gate:
        return 1 if gated else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
