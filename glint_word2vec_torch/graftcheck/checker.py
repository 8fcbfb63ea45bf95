"""graftcheck orchestration, ported from ``tools/graftcheck/checker.py``: run the tiers,
shrink findings, gate against the port's own baseline (``baseline.json`` here).

The run is pure-functional over the tree: same tree, same mode → the same
report byte-for-byte (all enumeration is deterministic, the probe env is
fixed). Human progress goes to stderr; the CLI (__main__) prints exactly one
JSON line on stdout (graftlint R7)."""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, List

from glint_word2vec_torch.graftcheck import lattice, properties, registry
from glint_word2vec_torch.graftcheck.shrink import shrink

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")

# docs the knob gate scans: every Word2VecConfig field must appear by name in
# at least one of these (docs/configuration.md is the canonical table)
_DOC_FILES = ("docs/configuration.md", "README.md", "docs/static-analysis.md",
              "docs/robustness.md", "docs/observability.md",
              "docs/sharding.md", "docs/serving.md", "docs/continual.md")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def docs_gate(root: str) -> List[str]:
    """Every config field must be documented somewhere in the doc corpus —
    new knobs cannot ship undocumented."""
    corpus = ""
    for rel in _DOC_FILES:
        path = os.path.join(root, rel)
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                corpus += f.read()
    missing = []
    for name in sorted(registry.config_defaults()):
        if not re.search(rf"\b{re.escape(name)}\b", corpus):
            missing.append(name)
    return missing


def run_sweep(mode: str, device: str = "cuda") -> Dict:
    """Execute the lattice, the dispatch probe building its trainers on ``device``.
    Returns the full report dict (pre-baseline)."""
    import logging
    # the sweep constructs thousands of candidates; construction-time
    # advisory warnings are the candidates' normal operation, not findings
    logging.getLogger("glint_word2vec_torch").setLevel(logging.ERROR)

    cands = lattice.candidates(mode)
    probe = properties.DispatchProbe(device)

    refusal_sigs: Dict[str, Dict] = {}        # key -> {knobs, key, tier}
    violations: List[Dict] = []
    seen_violation_keys = set()
    runtime_refusals: Dict[str, int] = {}
    n_accepted = n_refused = 0

    def record_violation(prop_key: str, message: str, kwargs: Dict,
                         predicate) -> None:
        if prop_key in seen_violation_keys:
            return
        seen_violation_keys.add(prop_key)
        small = shrink(lattice.nondefault(kwargs), predicate, prop_key)
        violations.append({
            "property": prop_key.split(":", 1)[0].split("[", 1)[0],
            "key": prop_key,
            "message": message,
            "counterexample": {k: repr(v) for k, v in sorted(small.items())},
            "knobs_in_counterexample": len(small),
        })

    for i, (tier, kwargs) in enumerate(cands):
        if i and i % 250 == 0:
            log(f"graftcheck: {i}/{len(cands)} candidates "
                f"({probe.probes_run} probes, {len(violations)} violations)")
        cfg, refusal_key = properties.construct(kwargs)

        if tier == "range":
            if refusal_key is None:
                record_violation(
                    "range_check: " + ",".join(sorted(lattice.nondefault(kwargs))),
                    f"out-of-range sample accepted at construction: "
                    f"{lattice.nondefault(kwargs)}",
                    kwargs,
                    lambda kw: None if properties.construction_key(kw) else
                    "range_check: " + ",".join(sorted(lattice.nondefault(kw))))
            elif refusal_key.startswith("crashed"):
                # a non-ValueError out of __post_init__ is a violation in
                # EVERY tier — never a baselineable refusal signature (a
                # --write-baseline run must not be able to accept a crash)
                record_violation(
                    refusal_key,
                    f"construction crashed (non-ValueError) on the range "
                    f"sample {lattice.nondefault(kwargs)}",
                    kwargs, properties.construction_key)
            else:
                n_refused += 1
                _note_refusal(refusal_sigs, refusal_key, kwargs, tier)
            continue

        if refusal_key is not None:
            n_refused += 1
            if refusal_key.startswith("crashed"):
                record_violation(
                    refusal_key,
                    f"construction crashed (non-ValueError) on "
                    f"{lattice.nondefault(kwargs)}",
                    kwargs, properties.construction_key)
            else:
                _note_refusal(refusal_sigs, refusal_key, kwargs, tier)
            continue

        n_accepted += 1
        # (b)/(c)/(d): pure config-level properties on every accepted config
        for check in (properties.check_serialization,
                      properties.check_replace,
                      properties.check_ckpt_normalization):
            finding = check(cfg)
            if finding:
                key, message = finding

                def pred(kw, _check=check):
                    c, rk = properties.construct(kw)
                    if c is None:
                        return rk
                    f = _check(c)
                    return f[0] if f else None

                record_violation(key, message, kwargs, pred)

        # (a): dispatch parity via the cached Trainer probe
        dk = probe.probe_kwargs(kwargs)
        if dk is None:
            continue
        if dk.startswith("runtime_refusal"):
            runtime_refusals[dk] = runtime_refusals.get(dk, 0) + 1
            continue

        def dispatch_pred(kw):
            c, _ = properties.construct(kw)
            if c is None:
                return None  # refused at construction = parity holds there
            return probe.probe_kwargs(kw)

        record_violation(
            dk,
            f"construction accepted but dispatch refused/crashed: "
            f"{lattice.nondefault(kwargs)}",
            kwargs, dispatch_pred)

    # shrink one representative per construction-refusal signature so the
    # baseline stores minimal combos, not raw lattice rows
    signatures = []
    for key in sorted(refusal_sigs):
        entry = refusal_sigs[key]
        small = shrink(lattice.nondefault(entry["kwargs"]),
                       properties.construction_key, key)
        signatures.append({
            "knobs": sorted(small),
            "values": {k: repr(v) for k, v in sorted(small.items())},
            "key": key,
        })

    return {
        "tool": "graftcheck",
        "mode": mode,
        "device": str(probe.device),
        "knobs": len(registry.KNOBS),
        "configs_executed": len(cands),
        "accepted": n_accepted,
        "refused_construction": n_refused,
        "pairwise_pairs": lattice.pair_count(),
        "probes_run": probe.probes_run,
        "probe_cache_size": len(probe.cache),
        "runtime_refusals": dict(sorted(runtime_refusals.items())),
        "refusal_signatures": signatures,
        "violations": violations,
    }


def _note_refusal(sigs: Dict, key: str, kwargs: Dict, tier: str) -> None:
    if key not in sigs:
        sigs[key] = {"kwargs": kwargs, "tier": tier}


def apply_gates(report: Dict, root: str, baseline_path: str = "") -> Dict:
    """Registry drift, docs gate, and the committed-baseline drift gate
    (exact match on the full sweep, subset on smoke — a smoke run executes a
    thinner lattice, so signatures it does NOT see are not drift)."""
    report["registry_drift"] = registry.registry_drift()
    report["docs_missing"] = docs_gate(root)

    baseline_path = baseline_path or BASELINE_PATH
    drift: List[str] = []
    baselined_violations = {}
    if not os.path.exists(baseline_path):
        # fail CLOSED, like graftlint's baseline gate
        drift.append(f"baseline file not found: {baseline_path} "
                     f"(regenerate with --write-baseline after review)")
    else:
        with open(baseline_path, "r", encoding="utf-8") as f:
            baseline = json.load(f)
        want = {s["key"]: s for s in baseline.get("refusal_signatures", [])}
        have = {s["key"]: s for s in report["refusal_signatures"]}
        for key in sorted(set(have) - set(want)):
            drift.append(f"NEW refusal signature not in baseline: "
                         f"{have[key]['knobs']} ({key[:70]}...)")
        if report["mode"] == "full":
            for key in sorted(set(want) - set(have)):
                drift.append(f"baselined refusal signature no longer "
                             f"observed: {want[key]['knobs']} ({key[:70]}...)")
        for key in set(want) & set(have):
            if sorted(want[key].get("knobs", [])) != have[key]["knobs"]:
                drift.append(f"refusal signature changed minimal knob set: "
                             f"{want[key].get('knobs')} -> "
                             f"{have[key]['knobs']} ({key[:70]}...)")
        baselined_violations = {
            v["key"]: v for v in baseline.get("violations", [])
            if v.get("justification")}

    unexplained = [v for v in report["violations"]
                   if v["key"] not in baselined_violations]
    for v in report["violations"]:
        v["baselined"] = v["key"] in baselined_violations

    report["baseline_drift"] = drift
    report["unexplained_violations"] = len(unexplained)
    report["ok"] = (not unexplained and not drift
                    and not report["registry_drift"]
                    and not report["docs_missing"])
    return report


def write_baseline(report: Dict, baseline_path: str = "") -> str:
    """Regenerate the committed baseline from a reviewed FULL run. Keeps any
    justified violations already present (the justification is the reviewed
    part; the tool never invents one)."""
    baseline_path = baseline_path or BASELINE_PATH
    old_violations = []
    if os.path.exists(baseline_path):
        with open(baseline_path, "r", encoding="utf-8") as f:
            old_violations = json.load(f).get("violations", [])
    payload = {
        "_comment": "graftcheck committed baseline — refusal_signatures is "
                    "the reviewed inventory of minimal refused knob combos "
                    "(drift in either direction fails the full sweep); "
                    "violations lists property violations accepted with a "
                    "written justification (should stay empty).",
        "mode": report["mode"],
        "refusal_signatures": [
            {"knobs": s["knobs"], "values": s["values"], "key": s["key"]}
            for s in report["refusal_signatures"]],
        "violations": old_violations,
    }
    with open(baseline_path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return baseline_path
