"""graftlint engine: file discovery and scopes, rule running, suppressions, reporting.

Ported from ``tools/graftlint/engine.py``; the design is the same:

- **Rules are AST visitors over one module** (``check(ctx) -> [Finding]``), except
  *repo rules* (``repo_rule = True``), which see the repo root and may cross-reference
  files (R3 walks what a CUDA graph captures across modules, R8 diffs the config and
  trainer refusal matrices, R9/R10 build the lock graph).
- **Suppression syntax** (enforced): a finding is suppressed only by a directive **with
  a written justification** on the flagged line or the line directly above::

      x = torch.cumsum(totals, 0)  # graftlint: disable=R4 -- caller picks dtype

  A directive without the ``-- justification`` text is itself a finding (rule
  ``SUP``).
- **Baseline**: the committed suppression inventory (``baseline.json`` beside this
  module) pins the multiset of (path, rule) pairs allowed to be suppressed; a drift in
  either direction fails, and a missing baseline fails closed.

**Scopes.** The lint scans ``glint_word2vec_torch/`` and ``chip_smoke.py``, skipping
``glint_word2vec_torch/graftlint/`` itself (its rules discuss the patterns they
forbid), ``__pycache__`` and ``_build/``. Inside the package, :data:`TOOL_SCOPE` lists
the port's copies of the JAX repo's ``tools/*.py`` (and the port's own profiling
tools): they are the *tool scope*, where the JAX tool's per-tool rule (R7) applies,
and the rest of the package is the *library scope*, where the library rules apply, as
``tools/`` and ``glint_word2vec_tpu/`` split the JAX repo. ``chip_smoke.py`` is in
neither, as ``bench.py`` in the JAX repo is outside the library.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence

LIB = "glint_word2vec_torch/"

# The port's copies of tools/*.py (tools/graftcheck/ included) and its own profiling
# tools: the tool scope. A literal, held to the tree by ToolScopeStaleness (rules.py).
TOOL_SCOPE = (
    LIB + "chaos_run.py",
    LIB + "continual_run.py",
    LIB + "eval_quality.py",
    LIB + "fleet_run.py",
    LIB + "obs_collect.py",
    LIB + "racecheck.py",
    LIB + "run_report.py",
    LIB + "serve_checkpoint.py",
    LIB + "servebench.py",
    LIB + "stepaudit.py",
    LIB + "telemetry_run.py",
    LIB + "telemetry_tail.py",
    LIB + "train_run.py",
    LIB + "graftcheck/",
    LIB + "stepprof.py",
    LIB + "scatterprobe.py",
)

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\s]+?)"
    r"(?:\s*--\s*(.*?))?\s*$")


def in_tool_scope(path: str) -> bool:
    """True for the port's tools (:data:`TOOL_SCOPE`; a trailing ``/`` is a package)."""
    return any(path == t or (t.endswith("/") and path.startswith(t))
               for t in TOOL_SCOPE)


def in_library(path: str) -> bool:
    """True for the port's library code: the package minus its tools."""
    return path.startswith(LIB) and not in_tool_scope(path)


@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    col: int
    message: str
    suppressed: bool = False
    justification: Optional[str] = None

    def key(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintReport:
    findings: List[Finding]
    files_scanned: int

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    def to_dict(self) -> dict:
        counts: Dict[str, int] = {}
        for f in self.unsuppressed:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "tool": "graftlint",
            "package": LIB.rstrip("/"),
            "files_scanned": self.files_scanned,
            "unsuppressed": [f.to_dict() for f in self.unsuppressed],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "counts_unsuppressed": counts,
            "ok": not self.unsuppressed,
        }


class ModuleContext:
    """Everything a per-file rule sees: path, parsed AST, raw lines."""

    def __init__(self, path: str, text: str):
        self.path = path.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def qualname(self, node: ast.AST) -> str:
        """Dotted name of the innermost enclosing function/class chain."""
        parts: List[str] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def enclosing_function(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None


def _parse_suppressions(lines: Sequence[str]):
    """line (1-based) -> (set of rule ids, justification or None)."""
    out = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        just = (m.group(2) or "").strip() or None
        out[i] = (rules, just)
    return out


def apply_suppressions(ctx_lines: Sequence[str],
                       findings: List[Finding]) -> List[Finding]:
    """Mark the findings a justified directive covers; an unjustified directive that
    would cover one is a ``SUP`` finding of its own."""
    sup = _parse_suppressions(ctx_lines)
    extra: List[Finding] = []
    seen_invalid = set()
    for f in findings:
        for line in (f.line, f.line - 1):
            entry = sup.get(line)
            if not entry:
                continue
            rules, just = entry
            if f.rule in rules or "all" in rules:
                if just:
                    f.suppressed = True
                    f.justification = just
                elif line not in seen_invalid:
                    seen_invalid.add(line)
                    extra.append(Finding(
                        rule="SUP", path=f.path, line=line, col=0,
                        message="suppression directive without a justification (use "
                                "`# graftlint: disable=Rn -- why`)"))
                break
    return findings + extra


def lint_text(text: str, virtual_path: str, rules=None) -> List[Finding]:
    """Lint one source string as if it lived at ``virtual_path`` (the unit the fixture
    tests drive). Repo rules are skipped (no repo here)."""
    from glint_word2vec_torch.graftlint.rules import ALL_RULES
    rules = [r for r in (rules or ALL_RULES) if not getattr(r, "repo_rule", False)]
    ctx = ModuleContext(virtual_path, text)
    findings: List[Finding] = []
    for rule in rules:
        if rule.applies(ctx.path):
            findings.extend(rule.check(ctx))
    return apply_suppressions(ctx.lines, findings)


# Tests and fixtures are out of scope (bad fixtures must lint dirty), and so is the
# lint itself (its rules discuss the patterns they forbid).
_SCAN_DIRS = ("glint_word2vec_torch",)
_SCAN_TOP = ("chip_smoke.py",)
_SKIP_DIRS = ("__pycache__", "_build")
_SKIP_PATHS = (os.path.join("glint_word2vec_torch", "graftlint"),)


def iter_source_files(root: str):
    for top in _SCAN_TOP:
        p = os.path.join(root, top)
        if os.path.exists(p):
            yield p
    for d in _SCAN_DIRS:
        base = os.path.join(root, d)
        for dirpath, dirnames, filenames in os.walk(base):
            rel = os.path.relpath(dirpath, root)
            dirnames[:] = sorted(
                x for x in dirnames if x not in _SKIP_DIRS
                and os.path.join(rel, x) not in _SKIP_PATHS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_repo(root: str, rules=None) -> LintReport:
    """Every rule over the scanned tree under ``root``. The repo rules share one index
    of the tree (:class:`.concurrency.TreeIndex`), built once."""
    from glint_word2vec_torch.graftlint.concurrency import TreeIndex
    from glint_word2vec_torch.graftlint.rules import ALL_RULES
    rules = list(rules or ALL_RULES)
    file_rules = [r for r in rules if not getattr(r, "repo_rule", False)]
    repo_rules = [r for r in rules if getattr(r, "repo_rule", False)]
    findings: List[Finding] = []
    contexts: Dict[str, ModuleContext] = {}
    for path in iter_source_files(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        try:
            ctx = ModuleContext(rel, text)
        except SyntaxError as e:
            findings.append(Finding(rule="AST", path=rel, line=e.lineno or 0, col=0,
                                    message=f"syntax error: {e.msg}"))
            continue
        contexts[rel] = ctx
        per_file: List[Finding] = []
        for rule in file_rules:
            if rule.applies(rel):
                per_file.extend(rule.check(ctx))
        findings.extend(apply_suppressions(ctx.lines, per_file))
    index = TreeIndex(root, contexts) if repo_rules else None
    for rule in repo_rules:
        findings.extend(rule.check_repo(root, index))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintReport(findings=findings, files_scanned=len(contexts))


def suppressed_inventory(report: LintReport) -> Dict[str, List[str]]:
    """The baseline shape: rule -> sorted list of paths (one entry per suppressed
    finding: a multiset, so a second suppression in the same file is still drift)."""
    inv: Dict[str, List[str]] = {}
    for f in report.suppressed:
        inv.setdefault(f.rule, []).append(f.path)
    return {k: sorted(v) for k, v in sorted(inv.items())}


def check_baseline(report: LintReport, baseline_path: str) -> List[str]:
    """Compare the suppression inventory against the committed baseline; returns
    human-readable drift messages (empty = clean)."""
    with open(baseline_path, "r", encoding="utf-8") as f:
        want = json.load(f).get("suppressed", {})
    have = suppressed_inventory(report)
    drift: List[str] = []
    for rule in sorted(set(want) | set(have)):
        w, h = want.get(rule, []), have.get(rule, [])
        if w != h:
            drift.append(
                f"suppression drift for {rule}: baseline {w} vs tree {h} (update "
                f"glint_word2vec_torch/graftlint/baseline.json in the same change, "
                f"with the justification)")
    return drift


BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.graftlint",
                                 description="the port's repo-invariant static lint")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--json", action="store_true",
                    help="print the JSON report as one line on stdout (default: "
                         "human-readable text on stderr only)")
    ap.add_argument("--json-out", default="",
                    help="also write the JSON report to this path")
    ap.add_argument("--baseline", default="",
                    help="fail on suppression drift against this baseline file "
                         "(default: the committed baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the baseline drift check")
    args = ap.parse_args(argv)

    report = lint_repo(args.root)
    drift: List[str] = []
    if not args.no_baseline:
        baseline = args.baseline or BASELINE
        if os.path.exists(baseline):
            drift = check_baseline(report, baseline)
        else:
            # fail closed: a deleted or mistyped baseline must not silently disable
            # the inventory gate; skipping it is an explicit --no-baseline
            drift = [f"baseline file not found: {baseline} (pass --no-baseline to "
                     f"skip the drift check)"]

    payload = report.to_dict()
    payload["baseline_drift"] = drift
    payload["ok"] = payload["ok"] and not drift
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
    for f in report.unsuppressed:
        print(f"{f.path}:{f.line}:{f.col}: {f.rule}: {f.message}", file=sys.stderr)
    for msg in drift:
        print(f"baseline: {msg}", file=sys.stderr)
    print(f"graftlint: {report.files_scanned} files, {len(report.unsuppressed)} "
          f"unsuppressed finding(s), {len(report.suppressed)} suppressed, "
          f"{len(drift)} baseline drift(s)", file=sys.stderr)
    if args.json:
        print(json.dumps(payload))
    return 0 if payload["ok"] else 1
