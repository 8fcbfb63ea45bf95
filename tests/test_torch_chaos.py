"""The port's chaos drill (``python -m glint_word2vec_torch.chaos_run``) on the CPU.

Ported from ``tests/test_faults.py::test_chaos_runner_smoke``: the scripted fault
schedule passes end to end through the real entry point (worker processes, replica
processes and services inside), here with ``--smoke --device cpu`` over every phase but
the three ``train-*`` ones, which ``tests/test_torch_supervisor.py`` already runs through
the same drill functions (``train_run.run_preempt_drill``, ``run_stall_drill``,
``run_crashloop_drill``). The phase table is the JAX drill's, every phase ported.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PHASES = ["crash-resume", "corrupt-fallback", "nan-rollback", "nan-halt", "norm-blowup",
          "norm-recover", "blackbox", "serve-reload", "continual-drift", "fleet-kill",
          "flaky-ingest", "train-preempt", "train-stall", "train-crashloop"]
RUN_HERE = [p for p in PHASES if not p.startswith("train-")]


def _run(*args, timeout=300):
    # one intra-op thread in each process of the tree: its replicas and workers run
    # beside the other test files' workers, and their tensors are small
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "glint_word2vec_torch.chaos_run", *args],
                          capture_output=True, text=True, env=env, cwd=str(REPO),
                          timeout=timeout)


def test_chaos_lists_the_jax_drills_phases():
    r = _run("--list")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == PHASES
    jax = subprocess.run([sys.executable, str(REPO / "tools" / "chaos_run.py"), "--list"],
                         capture_output=True, text=True, cwd=str(REPO), timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert jax.returncode == 0, jax.stderr[-2000:]
    assert jax.stdout.split() == PHASES


def test_chaos_refuses_what_is_not_ported():
    """Every phase is ported: ``continual-drift`` runs alone and passes (its continual_run
    process SIGTERM'd mid-increment, the retry growing V under a live service); an unknown
    phase is refused by name."""
    from glint_word2vec_torch.chaos_run import NOT_PORTED, NOTES
    assert NOT_PORTED == {} and NOTES == {}
    r = _run("--only", "continual-drift", "--device", "cpu")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    res = json.loads(r.stdout)
    assert res["phases"] == {"continual-drift": "PASS"}
    assert "SIGTERM: crash_at_step 1" in r.stderr
    r = _run("--only", "no-such-phase", "--device", "cpu")
    assert r.returncode == 2 and r.stdout == "" and "unknown phase" in r.stderr


def test_chaos_runner_smoke(tmp_path):
    """End to end: every phase run here passes, serve-reload with its two V-grew
    epilogues and continual-drift among them; one JSON line names them and the phases
    not asked for."""
    r = _run("--smoke", "--device", "cpu", "--workdir", str(tmp_path / "chaos"),
             "--only", ",".join(RUN_HERE))
    lines = r.stdout.strip().splitlines()
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["ok"] and res["device"] == "cpu"
    assert res["passed"] == res["run"] == len(RUN_HERE)
    assert list(res["phases"]) == RUN_HERE
    assert all(v.startswith("PASS") for v in res["phases"].values()), res["phases"]
    assert res["phases"]["serve-reload"] == res["phases"]["continual-drift"] == "PASS"
    assert res["not_run"] == {p: "not asked for" for p in PHASES if p not in RUN_HERE}
    assert "[chaos] OK" in r.stderr
