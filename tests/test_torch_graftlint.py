"""The port's static lint (``glint_word2vec_torch/graftlint``) on the CPU: it gives the JAX
tool's rule ids and lines on the JAX fixtures of every rule that carries over unchanged
in meaning (R1, R5, R7, R8, R9-R11, R1 staleness); each torch twin (R2, R3, R4, R6) fires
on its bad fixture (``tests/fixtures/lint_torch/``) and is silent on its good one; a
seeded violation of each rule in a copy of the port is found; the real tree lints clean
against the port's baseline, and R3 walks what the trainer's CUDA graphs capture; the
command line prints one JSON line and fails closed without its baseline.

The whole tree is linted once per module (``tree``), and the seeded copy once."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from glint_word2vec_torch.graftlint import concurrency as pc
from glint_word2vec_torch.graftlint import engine as pe
from glint_word2vec_torch.graftlint import rules as pr
from tools.graftlint import concurrency as jc
from tools.graftlint import engine as je
from tools.graftlint import rules as jr

REPO = Path(__file__).resolve().parent.parent
JAX_FIXTURES = REPO / "tests" / "fixtures" / "lint"
FIXTURES = REPO / "tests" / "fixtures" / "lint_torch"
JAX, PORT = "glint_word2vec_tpu/", "glint_word2vec_torch/"


@pytest.fixture(scope="module")
def tree():
    """One lint of the real tree and its index, shared by the module's tests."""
    return pe.lint_repo(str(REPO)), pc.TreeIndex(str(REPO))


def _keys(findings, rule=None, strip=""):
    return sorted((f.rule, f.path.replace(strip, "", 1), f.line) for f in findings
                  if rule is None or f.rule == rule)


# -- parity with the JAX tool ----------------------------------------------------------

# rule -> the JAX fixture's virtual path and the port's counterpart
_PARITY_FILES = {
    "R1": (JAX + "ops/somefile.py", PORT + "ops/somefile.py"),
    "R5": (JAX + "data/somefile.py", PORT + "data/somefile.py"),
    "R7": ("tools/run_report.py", PORT + "run_report.py"),
    "R11": (JAX + "serve/somefile.py", PORT + "serve/somefile.py"),
}


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", sorted(_PARITY_FILES))
def test_per_file_rules_match_the_jax_tool(rule, kind):
    text = (JAX_FIXTURES / f"{rule.lower()}_{kind}.py").read_text()
    jpath, ppath = _PARITY_FILES[rule]
    want = [(f.rule, f.line) for f in je.lint_text(text, jpath) if f.rule == rule]
    got = [(f.rule, f.line) for f in pe.lint_text(text, ppath) if f.rule == rule]
    assert sorted(got) == sorted(want)
    assert bool(got) == (kind == "bad")


def _port_copy(src: Path, dst: Path) -> Path:
    """A JAX fixture mini-repo as the port's: the package directory and every path in
    the text renamed."""
    for path in src.rglob("*.py"):
        rel = str(path.relative_to(src)).replace("glint_word2vec_tpu", "glint_word2vec_torch")
        out = dst / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(path.read_text().replace(JAX, PORT))
    return dst


def _knob_sets(findings):
    return sorted(tuple(re.findall(r"'(\w+)'", f.message.split("validation")[-1]))
                  for f in findings)


@pytest.mark.parametrize("fixture", ["r8_bad", "r8_good", "r9_bad", "r9_good", "r10_bad",
                                     "r10_good"])
def test_repo_rules_match_the_jax_tool(fixture, tmp_path):
    jrule, prule = {"r8": (jr.R8RefusalParity(), pr.R8RefusalParity()),
                    "r9": (jc.R9LockOrder(), pc.R9LockOrder()),
                    "r10": (jc.R10HandlerSafety(), pc.R10HandlerSafety())}[
        fixture.split("_")[0]]
    want = jrule.check_repo(str(JAX_FIXTURES / fixture))
    got = prule.check_repo(str(_port_copy(JAX_FIXTURES / fixture, tmp_path)))
    assert _keys(got, strip=PORT) == _keys(want, strip=JAX)
    assert bool(got) == fixture.endswith("bad")
    if fixture == "r8_bad":  # the same knob combinations
        assert _knob_sets(got) == _knob_sets(want)


def test_r1_staleness_matches_the_jax_tool():
    """The same dead entries, at the same places, on the real tree; the port's real
    allowlist has none."""
    dead = [("serve/batcher.py", "BatchingScheduler.no_such_method"),
            ("no/such/file.py", "whatever"), ("train/supervisor.py", "BeaconBoard.start")]
    want = jc.R1Staleness(allowlist=[(JAX + p, q) for p, q in dead]).check_repo(str(REPO))
    got = pc.R1Staleness(allowlist=[(PORT + p, q) for p, q in dead]).check_repo(str(REPO))
    assert _keys(got, strip=PORT) == _keys(want, strip=JAX) and len(got) == 2
    assert pc.R1Staleness().check_repo(str(REPO)) == []


def test_suppression_needs_a_justification():
    src = (FIXTURES / "r4_bad.py").read_text()
    anchor = "    prefix = torch.cumsum(rows, 0)"
    vpath = PORT + "ops/somefile.py"
    justified = src.replace(anchor, "    # graftlint: disable=R4 -- fixture\n" + anchor)
    out = [f for f in pe.lint_text(justified, vpath) if f.line == 8]
    assert out and all(f.suppressed and f.justification == "fixture" for f in out)
    silent = src.replace(anchor, anchor + "  # graftlint: disable=R4")
    out = pe.lint_text(silent, vpath)
    assert [f for f in out if f.rule == "R4" and f.line == 7 and not f.suppressed]
    assert [f for f in out if f.rule == "SUP"]


# -- the torch twins -------------------------------------------------------------------

_TWIN_FILES = {"R2": PORT + "ops/somefile.py", "R4": PORT + "ops/somefile.py",
               "R6": PORT + "train/trainer.py"}


@pytest.mark.parametrize("rule", sorted(_TWIN_FILES))
def test_twin_fires_on_bad_and_not_on_good(rule):
    bad = pe.lint_text((FIXTURES / f"{rule.lower()}_bad.py").read_text(), _TWIN_FILES[rule])
    good = pe.lint_text((FIXTURES / f"{rule.lower()}_good.py").read_text(),
                        _TWIN_FILES[rule])
    lines = {"R2": [3, 10, 11, 12, 13], "R4": [7, 12], "R6": [9, 10, 11, 12]}[rule]
    assert sorted(f.line for f in bad if f.rule == rule) == lines
    assert [f for f in good if f.rule == rule] == []


def _r3(fixture: str):
    body = PORT + "train/body.py"
    rule = pr.R3CaptureDiscipline(roots=[(body, "Trainer._chunk_body")],
                                  sites=[(body, "Trainer._capture")])
    return rule.check_repo(str(FIXTURES / fixture))


def test_r3_fires_across_modules_and_through_values():
    """The body's own syncs, a helper in another module reached by an imported name, by
    its module and as a function handed back as a value, and a capture begun outside
    the declared sites."""
    found = {(f.path.rsplit("/", 1)[-1], f.line): f.message for f in _r3("r3_bad")}
    assert sorted(found) == [("body.py", 13), ("body.py", 14), ("body.py", 17),
                             ("helper.py", 9), ("helper.py", 13), ("helper.py", 17)]
    assert "synchronize" in found[("body.py", 13)] and ".item()" in found[("body.py", 14)]
    assert "capture_begin" in found[("body.py", 17)]
    assert "reads a device value" in found[("helper.py", 9)]
    assert "sizes its output" in found[("helper.py", 13)]
    assert "host clock" in found[("helper.py", 17)]
    assert "helper.py:pick -> " in found[("helper.py", 17)]


def test_r3_prunes_what_a_capture_cannot_reach():
    """The good twin keeps every sync in an arm a capture never takes: a tensor off the
    card, float64 parameters, a Python scalar narrowed by isinstance."""
    assert _r3("r3_good") == []


def test_r3_flags_a_stale_root():
    rule = pr.R3CaptureDiscipline(roots=[(PORT + "train/body.py", "Trainer._gone")],
                                  sites=[])
    out = rule.check_repo(str(FIXTURES / "r3_good"))
    assert [f.message for f in out if "stale capture root" in f.message]


# -- the real tree ---------------------------------------------------------------------


def test_tree_lints_clean_against_the_baseline(tree):
    report, _ = tree
    assert not report.unsuppressed, "\n".join(f.key() for f in report.unsuppressed)
    assert pe.check_baseline(report, pe.BASELINE) == []
    assert all(f.justification for f in report.suppressed)
    assert report.files_scanned >= 85
    scanned = {os.path.relpath(p, REPO).replace(os.sep, "/")
               for p in pe.iter_source_files(str(REPO))}
    assert "chip_smoke.py" in scanned
    assert not any(p.startswith((PORT + "graftlint/", "tests/", "tools/")) or "_build/" in p
                   for p in scanned)


def test_r3_reaches_the_captured_steps_and_not_the_plain_versions(tree):
    _, index = tree
    reached, _ = pr.R3CaptureDiscipline().reach(index)
    labels = {fn.label for fn, _ in reached.values()}
    for want in ["train/trainer.py:Trainer._chunk_body", "train/trainer.py:Trainer._step_fn",
                 "train/trainer.py:Trainer._flush_hot", "ops/sgns.py:sgns_step_core",
                 "ops/sgns.py:sgns_step_shared_scatter_", "ops/sgns.py:cbow_step_core",
                 "ops/sgns.py:cbow_step_shared_core", "ops/sgns.py:hot_flush",
                 "ops/cbow_banded.py:cbow_step_banded_core",
                 "ops/fused_sgns.py:fused_sgns_shared_step",
                 "ops/sgns_shard.py:make_sharded_sgns_step",
                 "ops/sgns_shard.py:make_sharded_per_pair_step",
                 "ops/sgns_shard.py:owner_local_scatter_add_",
                 "ops/scatter.py:scatter_add_rows_", "ops/scatter.py:_Stream.fit"]:
        assert PORT + want in labels, want
    for plain in ["ops/scatter.py:scatter_add_rows_reference", "ops/sgns_shard.py:_plain_scatter",
                  "ops/scatter.py:_live_in_range", "ops/scatter.py:scatter_add_rows_grouped"]:
        assert PORT + plain not in labels, plain
    assert pr.R3CaptureDiscipline()._sites(index) == []


# -- a seeded violation of each rule, in a copy of the port ----------------------------

_SEEDED_MODULE = '''
import collections
import signal
import threading

from glint_word2vec_torch.lockcheck import make_lock


class Seeded:
    def __init__(self):
        self._lock = make_lock("fleet.router")
        self._ring = collections.deque()
        self._t = threading.Thread(target=self.run, daemon=True)

    def run(self):
        self._ring.append(1)

    def handler(self, signum, frame):
        with self._lock:
            pass

    def install(self):
        signal.signal(signal.SIGTERM, self.handler)
'''


def _edit(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert old in text, (path, old)
    path.write_text(text.replace(old, new, 1))


def test_a_seeded_violation_of_each_rule_is_found(tmp_path):
    shutil.copytree(REPO / "glint_word2vec_torch", tmp_path / "glint_word2vec_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    port = tmp_path / "glint_word2vec_torch"
    with open(port / "data" / "vocab.py", "a") as f:                          # R1
        f.write("\n\ndef _seeded_pool():\n    import concurrent.futures\n"
                "    return concurrent.futures.ThreadPoolExecutor(2)\n")
    _edit(port / "train" / "supervisor.py", "    def start(self", "    def begin(self")  # R1
    with open(port / "ops" / "sampler.py", "a") as f:                          # R2
        f.write("\n\ndef _seeded_draw(n):\n    return torch.rand(n)\n")
    _edit(port / "ops" / "sgns.py", "def hot_flush(mat: torch.Tensor, slab: torch.Tensor)"
          " -> torch.Tensor:\n", "def hot_flush(mat: torch.Tensor, slab: torch.Tensor)"
          " -> torch.Tensor:\n    slab.sum().item()\n")                         # R3
    with open(port / "ops" / "pairgen.py", "a") as f:                          # R4
        f.write("\n\ndef _seeded_prefix(x):\n    return torch.cumsum(x, 0)\n")
    with open(port / "data" / "corpus.py", "a") as f:                          # R5
        f.write("\n\ndef _seeded_read(p):\n    with open(p) as f:\n        return f.read()\n")
    # R6: the multi-segment bases as the prologue copied them before this change
    _edit(port / "train" / "trainer.py",
          'return rows, arrays["sub_bases"].reshape(-1), arrays["win_bases"].reshape(-1)',
          'return rows, *(torch.from_numpy(np.tile(np.asarray(chunk[k], np.int64), n))'
          '.to(self.device) for k in ("sub_bases", "win_bases"))')
    _edit(port / "run_report.py", "def main(", "def _seeded():\n    print('hi')\n\n\n"
          "def main(")                                                          # R7
    _edit(port / "train" / "trainer.py", "    def _flush_hot(self) -> None:\n",
          "    def _seeded_refusal(self):\n        cfg = self.config\n        if "
          "cfg.io_workers > 1 and cfg.heartbeat_every_steps > 3:\n"
          "            raise ValueError('x')\n\n"
          "    def _flush_hot(self) -> None:\n")                                  # R8
    _edit(port / "config.py", "    vector_size: int = 100",
          "    brand_new_knob: int = 0\n    vector_size: int = 100")              # R8
    (port / "obs" / "seeded.py").write_text(_SEEDED_MODULE)                   # R9-R11
    _edit(port / "obs" / "sink.py", "\nimport ", "\nimport threading\n_raw = threading.Lock()"
          "\nimport ")                                                           # R9
    (port / "telemetry_tail.py").rename(port / "telemetry_tail_old.py")        # SCOPE

    report = pe.lint_repo(str(tmp_path))
    found = {(f.rule, f.path) for f in report.unsuppressed}
    for rule, path in [("R1", "data/vocab.py"), ("R1", "train/supervisor.py"),
                       ("R2", "ops/sampler.py"), ("R3", "ops/sgns.py"),
                       ("R4", "ops/pairgen.py"), ("R5", "data/corpus.py"),
                       ("R6", "train/trainer.py"), ("R7", "run_report.py"),
                       ("R8", "train/trainer.py"), ("R8", "graftcheck/registry.py"),
                       ("R9", "obs/sink.py"), ("R9", "obs/seeded.py"),
                       ("R10", "obs/seeded.py"), ("R11", "obs/seeded.py"),
                       ("SCOPE", "telemetry_tail.py")]:
        assert (rule, PORT + path) in found, (rule, path, sorted(found))
    msgs = " ".join(f.message for f in report.unsuppressed)
    assert "stale R1 allowlist entry" in msgs and "brand_new_knob" in msgs
    assert "['heartbeat_every_steps', 'io_workers']" in msgs
    assert pe.check_baseline(report, pe.BASELINE) == []  # no suppression moved


# -- the command line ------------------------------------------------------------------


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "glint_word2vec_torch.graftlint", *args],
                          capture_output=True, text=True, timeout=300, cwd=str(REPO),
                          env=env)


def test_cli_prints_one_json_line_and_exits_0(tmp_path):
    out = tmp_path / "report.json"
    r = _cli("--json", "--json-out", str(out))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert payload["ok"] and payload["tool"] == "graftlint"
    assert payload["unsuppressed"] == [] and payload["baseline_drift"] == []
    assert payload["files_scanned"] >= 85 and payload["package"] == "glint_word2vec_torch"
    assert json.loads(out.read_text()) == payload
    assert "0 unsuppressed finding(s)" in r.stderr


def test_missing_baseline_fails_closed():
    r = _cli("--json", "--baseline", "glint_word2vec_torch/graftlint/no-such-baseline.json")
    assert r.returncode == 1
    payload = json.loads(r.stdout)
    assert not payload["ok"] and "baseline file not found" in payload["baseline_drift"][0]
    assert "baseline file not found" in r.stderr
