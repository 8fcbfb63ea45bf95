"""CLI: ``python -m glint_word2vec_torch.graftcheck [--smoke] [--device cuda|cpu]
[--json-out F]``.

Prints exactly ONE JSON line on stdout; progress on stderr. Exit 1 on any unexplained
violation, baseline or registry drift, or undocumented knob. The dispatch probe builds
its trainers on ``--device`` (default ``cuda``, which fails without a card; the CPU
runs only when asked for)."""

from __future__ import annotations

import argparse
import json
import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    """Parses args, runs the sweep, and emits via ``_run``'s single JSON print —
    exactly ONE line on stdout on every exit path."""
    payload, rc = _run(argv)
    print(json.dumps(payload))
    return rc


def _run(argv) -> tuple:
    from glint_word2vec_torch.graftcheck import checker

    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.graftcheck",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="thinned lattice; the full sweep executes >= 1000 configs")
    ap.add_argument("--device", default="cuda",
                    help="the dispatch probe's device (default cuda; cpu only when "
                         "asked for)")
    ap.add_argument("--json-out", default="",
                    help="also write the JSON report to this path")
    ap.add_argument("--baseline", default="",
                    help="baseline file (default: this package's baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from this (reviewed) full run "
                         "instead of gating against it")
    ap.add_argument("--root", default=_REPO,
                    help="the repo whose docs the knob gate scans")
    args = ap.parse_args(argv)

    mode = "smoke" if args.smoke else "full"
    if args.write_baseline and mode != "full":
        checker.log("graftcheck: refusing to write a baseline from a smoke run — the "
                    "full sweep is the inventory")
        return ({"tool": "graftcheck", "ok": False,
                 "error": "write-baseline requires the full sweep"}, 2)
    checker.log(f"graftcheck: enumerating the {mode} lattice on {args.device} ...")
    report = checker.run_sweep(mode, args.device)
    if args.write_baseline:
        path = checker.write_baseline(report, args.baseline)
        checker.log(f"graftcheck: baseline written to {path}")
    report = checker.apply_gates(report, args.root, args.baseline)

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
    for v in report["violations"]:
        checker.log(f"  VIOLATION[{'baselined' if v['baselined'] else 'NEW'}]"
                    f" {v['key'][:100]}  counterexample={v['counterexample']}")
    for d in report["baseline_drift"]:
        checker.log(f"  DRIFT {d}")
    for d in report["registry_drift"]:
        checker.log(f"  REGISTRY {d}")
    if report["docs_missing"]:
        checker.log(f"  DOCS missing knob rows: {report['docs_missing']}")
    checker.log(
        f"graftcheck: {report['configs_executed']} configs executed "
        f"({report['accepted']} accepted, {report['refused_construction']} refused), "
        f"{report['probes_run']} dispatch probes, "
        f"{len(report['refusal_signatures'])} refusal signatures, "
        f"{report['unexplained_violations']} unexplained violation(s) -> "
        f"{'ok' if report['ok'] else 'FAIL'}")
    return (report, 0 if report["ok"] else 1)


if __name__ == "__main__":
    raise SystemExit(main())
