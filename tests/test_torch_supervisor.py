"""The port's training supervisor (``glint_word2vec_torch/train/supervisor.py``) and its
CLI (``python -m glint_word2vec_torch.train_run``) against the JAX package's.

Ported from ``tests/test_supervisor.py``, on the CPU: a SIGTERM landing inside the
checkpoint-save window (both orderings) leaves old-or-new verified, never torn; the
restart, quarantine and gang state machine over scripted ``python -c`` children; the
liveness beacons; the injected stall; the ``glint_supervisor_*`` gauges, equal to the
JAX function's text on the same snapshot; the config's three ``supervisor_*`` checks,
raised by both packages with the same messages; and the three drills of
``train_run --smoke --device cpu`` (a real fit of the port, preempted, stalled and
crash-looped under the supervisor).

Two groups of the JAX file are left out: the ``run_report`` cases (that report is
``tools/run_report.py``, which the port has no counterpart of) and the ``chaos_run``
CLI case (the chaos drill is ROADMAP queue A6b.2)."""

import json
import os
import subprocess
import sys
import time

import pytest

from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.obs.schema import validate_file
from glint_word2vec_torch.obs.statusd import supervisor_prometheus_text
from glint_word2vec_torch.train import faults
from glint_word2vec_torch.train.checkpoint import load_latest_valid, verify_checkpoint
from glint_word2vec_torch.train.supervisor import (
    MITIGATE_ENV,
    PEER_ABORT_EXIT,
    BeaconBoard,
    PeerDeathError,
    TrainingSupervisor,
)
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.obs.statusd import (
    supervisor_prometheus_text as j_supervisor_prometheus_text,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT_ENV = ("GLINT_FAULT_CRASH_AT_STEP", "GLINT_FAULT_CRASH_SIGNAL",
             "GLINT_FAULT_CRASH_POINT", "GLINT_FAULT_STALL_AT_STEP",
             "GLINT_FAULT_STALL_S", MITIGATE_ENV)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for name in FAULT_ENV:
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    yield
    faults.reset()


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", **extra}


# -- the config's supervisor_* checks ---------------------------------------------------


@pytest.mark.parametrize("field,value", [
    ("supervisor_stall_s", 0.0), ("supervisor_stall_s", -1.0),
    ("supervisor_stall_s", 0.5), ("supervisor_max_restarts", -1),
    ("supervisor_max_restarts", 0), ("supervisor_loop_window", 1),
    ("supervisor_loop_window", 0), ("supervisor_loop_window", 2),
])
def test_supervisor_config_checks_match(field, value):
    """Both packages refuse the same bad values with the same message and accept the
    same good ones."""
    errors = []
    for cls in (JConfig, TConfig):
        try:
            cls(**{field: value})
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    ok = {"supervisor_stall_s": value > 0, "supervisor_max_restarts": value >= 0,
          "supervisor_loop_window": value >= 2}[field]
    assert (errors[1] is None) == ok, errors


# -- SIGTERM inside the checkpoint-save window ----------------------------------------

_SAVE_CHILD = """
import sys
import numpy as np
from glint_word2vec_torch import Word2Vec
rng = np.random.default_rng(0)
sents = [[f"w{i}" for i in rng.integers(0, 30, 20)] for _ in range(120)]
Word2Vec(vector_size=8, pairs_per_batch=128, window=3, num_iterations=2,
         steps_per_dispatch=2, heartbeat_every_steps=2, subsample_ratio=0.0,
         prefetch_chunks=0, min_count=1, seed=1, device="cpu").fit(
    sents, checkpoint_path=sys.argv[1], checkpoint_every_steps=2)
print("WORKER SURVIVED (the fault did not fire)")
"""


@pytest.mark.parametrize("point", ["save:staged@2", "save:swap@2"])
def test_sigterm_during_save_window(tmp_path, point):
    """A preemption SIGTERM landing mid-save, before the staged directory is blessed
    ("staged") or inside the swap's torn window ("swap"), with no handler installed
    (no telemetry): the process dies where the signal lands, and load_latest_valid
    reclaims the debris and returns a checkpoint that verifies (the old one or the new
    one, never a torn hybrid)."""
    workdir = tmp_path / "w"
    workdir.mkdir()
    proc = subprocess.run(
        [sys.executable, "-c", _SAVE_CHILD, str(workdir / "ck")],
        env=_env(GLINT_FAULT_CRASH_POINT=point, GLINT_FAULT_CRASH_SIGNAL="TERM"),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode in (-15, 143), proc.stderr[-800:]
    assert "SURVIVED" not in proc.stdout
    meta = verify_checkpoint(load_latest_valid(str(workdir)))
    step = meta["train_state"]["global_step"]
    assert step > 0 and not meta["train_state"]["finished"], meta
    entries = os.listdir(workdir)
    assert not any(".tmp-" in e for e in entries), entries


# -- the supervisor state machine (scripted children) ---------------------------------


def _child(script: str) -> list:
    return [sys.executable, "-c", script]


def _supervisor(tmp_path, commands, **kw):
    kw.setdefault("poll_s", 0.02)
    kw.setdefault("term_grace_s", 0.3)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_cap_s", 0.05)
    workdir = str(tmp_path)
    logs = kw.pop("child_logs", [os.path.join(workdir, f"c{i}.jsonl")
                                 for i in range(len(commands))])
    return TrainingSupervisor(commands, workdir, child_logs=logs, **kw)


def test_clean_child_is_ok(tmp_path):
    sup = _supervisor(tmp_path, [_child("raise SystemExit(0)")], max_restarts=3,
                      stall_s=30.0)
    v = sup.run()
    assert v.status == "ok" and v.attempts == 1
    assert not os.path.exists(os.path.join(str(tmp_path), "verdict.json"))


def test_deterministic_crash_loop_quarantines(tmp_path):
    """The same exit code at the same step bucket on every attempt: after loop_window
    identical signatures the ladder engages mitigations and clears the window; after a
    second full window it halts with a quarantine verdict."""
    sup = _supervisor(tmp_path, [_child("raise SystemExit(7)")], max_restarts=6,
                      stall_s=30.0, loop_window=2)
    v = sup.run()
    assert v.status == "quarantined"
    assert v.classification == "deterministic-crash-loop"
    assert v.attempts == 4 <= 6  # 2 per ladder stage, well under budget
    assert [rung["stage"] for rung in v.ladder] == [1, 2]
    assert "rc7" in v.signature
    assert sup.env.get(MITIGATE_ENV) == "1"
    with open(os.path.join(str(tmp_path), "verdict.json")) as f:
        doc = json.load(f)
    assert doc["status"] == "quarantined" and doc["signature"] == v.signature


def test_nondeterministic_crashes_exhaust_budget(tmp_path):
    """Different signatures never match the loop window: restarts run until the budget
    is spent, then gave-up."""
    script = "import os; raise SystemExit(int(os.environ['RC']))"
    sup = _supervisor(tmp_path, [_child(script)], max_restarts=2, stall_s=30.0,
                      loop_window=2, env_for_attempt=lambda a: {"RC": str(40 + a)})
    v = sup.run()
    assert v.status == "gave-up"
    assert v.classification == "restart-budget-exhausted"
    assert v.attempts == 3  # the first + max_restarts


def test_stall_detected_killed_and_resumed(tmp_path):
    script = ("import os, time\n"
              "if os.environ.get('STALL') == '1':\n"
              "    time.sleep(60)\n")
    sup = _supervisor(tmp_path, [_child(script)], max_restarts=3, stall_s=0.4,
                      env_for_attempt=lambda a: {"STALL": "1" if a == 0 else "0"})
    t0 = time.monotonic()
    v = sup.run()
    took = time.monotonic() - t0
    assert v.status == "ok" and v.attempts == 2
    assert v.history[0]["cls"] == "stall"
    assert sup.stalls == 1
    assert took < 10.0, f"stall kill path took {took:.1f}s"


def test_peer_death_restarts_whole_gang(tmp_path):
    """A gang member exiting with the peer-abort code is a victim, not the cause: the
    attempt classes as peer-death and the whole gang restarts together."""
    script = "import os\nraise SystemExit(int(os.environ['MY_RC']))\n"
    sup = _supervisor(tmp_path, [_child(script), _child(script)], max_restarts=3,
                      stall_s=30.0, env_for_attempt=lambda a: {
                          "MY_RC": str(PEER_ABORT_EXIT) if a == 0 else "0"})
    v = sup.run()
    assert v.status == "ok" and v.attempts == 2
    assert v.history[0]["cls"] == "peer-death"


def test_gang_partial_death_kills_survivors(tmp_path):
    """One member crashing while the other would run on: the supervisor reaps the
    survivor itself and classes the attempt by the member that died on its own."""
    sup = _supervisor(tmp_path, [_child("raise SystemExit(9)"),
                                 _child("import time; time.sleep(60)")],
                      max_restarts=0, stall_s=30.0)
    t0 = time.monotonic()
    v = sup.run()
    took = time.monotonic() - t0
    assert v.status == "gave-up" and v.attempts == 1
    assert v.history[0]["cls"] == "crash"
    assert "rc9" in v.history[0]["signature"]
    assert took < 10.0, f"survivor reap took {took:.1f}s"


def test_gang_member_finishing_first_is_not_a_death(tmp_path):
    """A member that exits 0 has finished: its peer, still running, is left to finish,
    and the attempt is ok (the JAX supervisor TERMs the peer and classes a crash when
    the clean exits land one poll apart)."""
    sup = _supervisor(tmp_path, [_child("raise SystemExit(0)"),
                                 _child("import time; time.sleep(0.5)")],
                      max_restarts=0, stall_s=30.0)
    v = sup.run()
    assert v.status == "ok" and v.attempts == 1
    assert v.history[0]["rc"] == 0


# -- beacon board -----------------------------------------------------------------------


def test_beacons_fresh_and_not_yet_joined(tmp_path):
    b0 = BeaconBoard(str(tmp_path), 0, 3, interval_s=10.0)
    b0._touch()
    # peer 1 joined and is fresh; peer 2 never joined (a slow start)
    BeaconBoard(str(tmp_path), 1, 3, interval_s=10.0)._touch()
    assert b0.stale_peers(60.0) == []
    b0.check_or_raise()


def test_beacon_stale_mtime_raises(tmp_path):
    b0 = BeaconBoard(str(tmp_path), 0, 2, interval_s=0.1)
    b0._touch()
    b1 = BeaconBoard(str(tmp_path), 1, 2, interval_s=0.1)
    b1._touch()
    old = time.time() - 3600
    os.utime(b1.path_for(1), (old, old))
    assert b0.stale_peers(b0.stale_after) == [1]
    with pytest.raises(PeerDeathError):
        b0.check_or_raise()


def test_beacon_seen_then_vanished_is_dead(tmp_path):
    b0 = BeaconBoard(str(tmp_path), 0, 2, interval_s=10.0)
    b0._touch()
    b1 = BeaconBoard(str(tmp_path), 1, 2, interval_s=10.0)
    b1._touch()
    assert b0.stale_peers(60.0) == []          # observes peer 1
    os.remove(b1.path_for(1))                  # a clean file, a dead process
    assert b0.stale_peers(60.0) == [1]


def test_beacon_stop_removes_own_file(tmp_path):
    b0 = BeaconBoard(str(tmp_path), 0, 1, interval_s=0.05).start()
    assert os.path.exists(b0.path_for(0))
    b0.stop()
    assert not os.path.exists(b0.path_for(0))


# -- the injected stall fault -----------------------------------------------------------


def test_maybe_stall_fires_once_at_step():
    faults.configure(stall_at_step=3, stall_s=0.3)
    assert faults.maybe_stall(2) == 0.0
    t0 = time.monotonic()
    assert faults.maybe_stall(3) == pytest.approx(0.3)
    assert time.monotonic() - t0 >= 0.3
    assert faults.maybe_stall(3) == 0.0  # once: the resume must run


# -- the gauges -------------------------------------------------------------------------


def test_supervisor_prometheus_text(tmp_path):
    sup = _supervisor(tmp_path, [_child("raise SystemExit(0)")], max_restarts=0,
                      stall_s=30.0)
    sup.run()
    snap = sup.status_snapshot()
    text = supervisor_prometheus_text(snap)
    assert "glint_supervisor_up 1" in text
    assert "glint_supervisor_attempts_total 1" in text
    assert "glint_supervisor_quarantined 0" in text
    assert text == j_supervisor_prometheus_text(snap)
    busy = {**snap, "attempts": 4, "restarts": 3, "stalls": 1, "preempts": 2,
            "ladder_stage": 2, "quarantined": True, "last_step": 1234, "child_up": 2}
    assert supervisor_prometheus_text(busy) == j_supervisor_prometheus_text(busy)


# -- the CLI ---------------------------------------------------------------------------


def test_train_run_supervises_a_command(tmp_path):
    """The generic mode: a command (split as a shell splits it) under the supervisor,
    one JSON line on stdout, the supervisor's records valid under the port's schema."""
    tel = str(tmp_path / "sup.jsonl")
    proc = subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.train_run",
         "--cmd", f"{sys.executable} -c 'raise SystemExit(0)'",
         "--log", str(tmp_path / "child.jsonl"), "--telemetry", tel,
         "--workdir", str(tmp_path / "w")],
        env=_env(), cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-800:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["ok"] and out["mode"] == "supervise" and out["attempts"] == 1
    assert validate_file(tel)["ok"]
    kinds = [json.loads(line)["kind"] for line in open(tel)]
    assert kinds == ["supervisor_start", "supervisor_exit", "supervisor_end"]


def test_train_run_refuses_bad_supervisor_knobs(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.train_run", "--loop-window", "1",
         "--smoke", "--device", "cpu"],
        env=_env(), cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "supervisor_loop_window must be >= 2" in proc.stderr


def test_train_run_smoke_on_the_cpu(tmp_path):
    """The three drills on a real fit of the port (the JAX drills' assertions): the
    preempted fit resumes in 2 attempts to the twin's final step and purity, the stall
    is detected and resumed, the crash loop is quarantined at 4 attempts with the
    ladder [1, 2]; every supervisor sink validates."""
    proc = subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.train_run", "--smoke", "--device",
         "cpu", "--workdir", str(tmp_path / "w")],
        env=_env(), cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0 and len(lines) == 1, proc.stdout + proc.stderr[-2000:]
    rep = json.loads(lines[0])
    assert rep["ok"]
    pre = rep["preempt"]
    assert pre["attempts"] == 2 and pre["final_step"] == pre["twin_step"]
    assert pre["preempt"]["saved"] and pre["preempt"]["steps_since_save"] <= 2
    assert pre["purity"] >= min(0.75, pre["twin_purity"])
    assert rep["stall"]["attempts"] == 2
    assert rep["crashloop"]["attempts"] == 4 and rep["crashloop"]["ladder"] == [1, 2]
    assert rep["crashloop"]["signature"] == "crash:rc-9@s4"
    for name in ("preempt", "stall", "crashloop"):
        log = tmp_path / "w" / name / "run.jsonl"
        assert validate_file(str(log))["ok"], name
