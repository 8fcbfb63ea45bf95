"""Tail or summarize a telemetry sink JSONL from another terminal, ported from
``tools/telemetry_tail.py``.

The human half of live inspection: while a trainer writes its run log, this tool (in a
second terminal, or on a copied file afterwards) renders the stream as compact lines
and keeps a rolling summary. The machine half is :mod:`.run_report` (one JSON line);
this tool is for people and is not held to the one-JSON-line contract.

Usage::

    python -m glint_word2vec_torch.telemetry_tail run.jsonl            # summary, exit
    python -m glint_word2vec_torch.telemetry_tail run.jsonl --follow   # live tail
    python -m glint_word2vec_torch.telemetry_tail run.jsonl --last 20  # the log's tail

A record of a kind this build does not know (the schema grows by addition) is printed
by its kind; a rotated log's older segments are more files, passed first. Exit code 0,
or 2 when a file cannot be read. It runs on the host only (no device).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional


def _fmt_hb(r: dict) -> str:
    norms = r.get("norms") or {}
    syn0 = norms.get("syn0") or {}
    extra = ""
    if syn0:
        extra = (f"  norm max {syn0.get('max_norm', 0):.3g}"
                 f" p99 {syn0.get('p99_norm', 0):.3g}")
    rec = r.get("recoveries", 0)
    scale = r.get("lr_scale", 1.0)
    state = ""
    if rec:
        state = f"  RECOVERIES {rec} lr x{scale:g}"
    elif scale is not None and scale != 1.0:
        state = f"  lr x{scale:g}"
    pps = r.get("pairs_per_sec") or 0.0
    return (f"hb    step {r.get('step', -1):>9}  "
            f"{pps:>12,.0f} pairs/s  alpha {r.get('alpha') or 0:.5f}"
            f"{extra}{state}")


def _fmt(r: dict) -> str:
    kind = r.get("kind", "?")
    if kind == "heartbeat":
        return _fmt_hb(r)
    if kind == "run_start":
        return (f"start run {r.get('run_id')}  vocab {r.get('vocab_size')}  "
                f"mesh {r.get('mesh')}")
    if kind == "run_end":
        return (f"end   run {r.get('run_id')}  status {r.get('status')}  "
                f"steps {r.get('steps')}  "
                f"{(r.get('pairs_trained') or 0):,.0f} pairs  "
                f"host-wait {r.get('host_wait_s_total')}s  "
                f"dispatch {r.get('dispatch_s_total')}s")
    if kind == "watchdog":
        return (f"WATCH step {r.get('step')}  [{r.get('policy')}] "
                f"{r.get('reason')}")
    if kind == "recovery":
        return (f"RECOV step {r.get('step')}  action {r.get('action')}  "
                f"lr x{r.get('lr_scale')}  clamp {r.get('max_row_norm')}  "
                f"({r.get('recoveries_performed')}/{r.get('max_recoveries')})")
    rest = {k: v for k, v in r.items() if k not in ("schema", "kind", "t")}
    return f"{kind:5s} {json.dumps(rest)[:120]}"


class Summary:
    """Rolling per-kind aggregation over the fields :mod:`.run_report` reports."""

    def __init__(self):
        self.kinds: dict = {}
        self.pps: list = []
        self.last_hb: Optional[dict] = None
        self.last_end: Optional[dict] = None
        self.bad_lines = 0

    def feed(self, r: dict) -> None:
        kind = r.get("kind", "?")
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        if kind == "heartbeat":
            self.last_hb = r
            if r.get("pairs_per_sec"):
                self.pps.append(float(r["pairs_per_sec"]))
        elif kind == "run_end":
            self.last_end = r

    def render(self) -> str:
        lines = [f"records: {sum(self.kinds.values())}  "
                 f"({', '.join(f'{k}={v}' for k, v in sorted(self.kinds.items()))})"]
        if self.bad_lines:
            lines.append(f"unparseable lines: {self.bad_lines} "
                         f"(truncated tail is normal on a live file)")
        if self.pps:
            s = sorted(self.pps)
            lines.append(
                f"pairs/s: median {s[len(s) // 2]:,.0f}  "
                f"p10 {s[int(len(s) * 0.1)]:,.0f}  "
                f"p90 {s[min(int(len(s) * 0.9), len(s) - 1)]:,.0f}  "
                f"last {self.pps[-1]:,.0f}")
        if self.last_hb is not None:
            lines.append("last " + _fmt_hb(self.last_hb))
            phases = self.last_hb.get("phases") or {}
            for name, ph in sorted(phases.items()):
                lines.append(
                    f"  phase {name:14s} count {ph.get('count', 0):>6}  "
                    f"total {ph.get('total_s', 0):8.3f}s  "
                    f"p50 {ph.get('p50_s', 0):.2e}s  "
                    f"p99 {ph.get('p99_s', 0):.2e}s")
        if self.last_end is not None:
            lines.append(_fmt(self.last_end))
        return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.telemetry_tail",
                                 description=__doc__.split("\n", 1)[0])
    ap.add_argument("paths", nargs="+", help="sink JSONL file(s), oldest "
                                             "rotated segment first")
    ap.add_argument("--follow", "-f", action="store_true",
                    help="keep tailing the LAST path for appended records")
    ap.add_argument("--last", type=int, default=0, metavar="N",
                    help="also print the last N records before the summary")
    ap.add_argument("--poll", type=float, default=0.5,
                    help="--follow poll interval in seconds")
    args = ap.parse_args(argv)

    summary = Summary()
    tail: list = []
    pos = 0
    for path in args.paths:
        try:
            # readline (not iteration) so f.tell() stays legal — the follow
            # loop resumes from the last COMPLETE line's end
            with open(path, "r", encoding="utf-8") as f:
                while True:
                    line = f.readline()
                    if not line:
                        break
                    if path == args.paths[-1] and line.endswith("\n"):
                        pos = f.tell()
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        r = json.loads(line)
                    except json.JSONDecodeError:
                        summary.bad_lines += 1
                        continue
                    summary.feed(r)
                    if args.last:
                        tail.append(_fmt(r))
                        del tail[:-args.last]
        except OSError as e:
            print(f"cannot read {path}: {e}", file=sys.stderr)
            return 2

    for line in tail:
        print(line)
    print(summary.render())

    if not args.follow:
        return 0
    path = args.paths[-1]
    print(f"-- following {path} (ctrl-C to stop) --", file=sys.stderr)
    try:
        while True:
            try:
                # rotation: the sink renames the active file aside and
                # recreates it (sink._rotate) — a file SMALLER than our
                # offset is the new segment, so restart from 0 instead of
                # seeking past its end (which would silently drop every
                # record below the stale offset once it regrows)
                if os.path.getsize(path) < pos:
                    print(f"-- {path} rotated, restarting from its top --",
                          file=sys.stderr)
                    pos = 0
                with open(path, "r", encoding="utf-8") as f:
                    f.seek(pos)
                    while True:
                        line = f.readline()
                        # a partial line (writer mid-append) stays unparsed
                        # and is retried whole on the next poll
                        if not line or not line.endswith("\n"):
                            break
                        pos = f.tell()
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            r = json.loads(line)
                        except json.JSONDecodeError:
                            summary.bad_lines += 1
                            continue
                        summary.feed(r)
                        print(_fmt(r), flush=True)
            except FileNotFoundError:
                pass  # rotation window — the writer will recreate it
            time.sleep(args.poll)
    except KeyboardInterrupt:
        print(summary.render())
        return 0


if __name__ == "__main__":
    sys.exit(main())
