"""The port's fault plan and fault-tolerance runtime against the JAX package's.

The plan's fields, environment names and hooks (crash points with ``@N``, NaN and
scale injections, the sliced stall, the checkpoint corruption) behave as the JAX
package's; the non-finite rollback and the norm watchdog's recovery ladder, on the toy
trainer of ``tests/test_obs.py`` from the same injected parameters in each package,
give the same rollback and recovery counts, the same final ``global_step`` (past the
2^22 lattice jump), the same heartbeat steps and alphas, the same recovery records and
the same parameters within 1e-5 (each step differs by f32 reassociation only); a
SIGKILL inside the torn window of a save, in a child process that imports torch only,
leaves a directory that ``load_latest_valid`` and ``Word2Vec.resume`` recover from;
and a SIGTERM under ``checkpoint_on_preempt`` leaves an emergency checkpoint, a
``preempt`` record and a blackbox dump that both packages' validators accept."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.ops import prng as tprng
from glint_word2vec_torch.train import faults as tfaults
from glint_word2vec_torch.train.checkpoint import (
    load_latest_valid, load_model, verify_checkpoint)
from glint_word2vec_torch.train.trainer import NonFiniteParamsError, Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
from glint_word2vec_tpu.ops import prng as jprng
from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair
from glint_word2vec_tpu.train import faults as jfaults
from glint_word2vec_tpu.train.trainer import Trainer as JTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT_ENV = ("GLINT_FAULT_CRASH_AT_STEP", "GLINT_FAULT_CRASH_SIGNAL",
             "GLINT_FAULT_CRASH_POINT", "GLINT_FAULT_CORRUPT_CKPT_BYTES",
             "GLINT_FAULT_FAIL_INGEST_FIRST_N", "GLINT_FAULT_NAN_AT_STEP",
             "GLINT_FAULT_STALL_AT_STEP", "GLINT_FAULT_STALL_S",
             "GLINT_FAULT_SCALE_PARAMS_AT_STEP", "GLINT_FAULT_SCALE_PARAMS_FACTOR",
             "GLINT_FAULT_SCALE_PARAMS_TIMES")


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for name in FAULT_ENV:
        monkeypatch.delenv(name, raising=False)
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The toy's tensors are tiny: one intra-op thread runs them several times faster
    than a pool, and a pool oversubscribes the cores when pytest runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the plan ------------------------------------------------------------------------


def test_fault_plan_fields_match():
    tf = {f.name: f.default for f in dataclasses.fields(tfaults.FaultPlan)}
    jf = {f.name: f.default for f in dataclasses.fields(jfaults.FaultPlan)}
    assert tf == jf


@pytest.mark.parametrize("env", [
    {},
    {"GLINT_FAULT_CRASH_AT_STEP": "12", "GLINT_FAULT_CRASH_SIGNAL": "TERM",
     "GLINT_FAULT_CRASH_POINT": "save:swap@3", "GLINT_FAULT_CORRUPT_CKPT_BYTES": "4"},
    {"GLINT_FAULT_NAN_AT_STEP": "8", "GLINT_FAULT_STALL_AT_STEP": "5",
     "GLINT_FAULT_STALL_S": "0.5", "GLINT_FAULT_SCALE_PARAMS_AT_STEP": "6",
     "GLINT_FAULT_SCALE_PARAMS_FACTOR": "1e3", "GLINT_FAULT_SCALE_PARAMS_TIMES": "3",
     "GLINT_FAULT_FAIL_INGEST_FIRST_N": "2"},
    {"GLINT_FAULT_NAN_AT_STEP": "x", "GLINT_FAULT_STALL_S": "y",
     "GLINT_FAULT_SCALE_PARAMS_TIMES": "0"},
], ids=["empty", "crash", "injections", "malformed"])
def test_env_plan_matches(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert (dataclasses.asdict(tfaults.active_plan())
            == dataclasses.asdict(jfaults.active_plan()))


@pytest.mark.parametrize("spec", ["save:swap", "save:swap@3", "save:swap@x", "a@b@2",
                                  "save:staged@0"])
def test_crash_point_spec_parses_the_same(spec):
    assert tfaults._parse_point(spec) == jfaults._parse_point(spec)


def test_injection_hooks_fire_as_scripted():
    """NaN once at the first round reaching its step; the scale at the first and at
    each later round until its count is spent; the same answers in both packages."""
    plan = dict(nan_at_step=5, scale_params_at_step=7, scale_params_factor=10.0,
                scale_params_times=3)
    tfaults.configure(**plan)
    jfaults.configure(**plan)
    for step in (2, 4, 6, 8, 9, 10, 12, 14):
        assert tfaults.take_nan_injection(step) == jfaults.take_nan_injection(step)
        assert tfaults.take_scale_injection(step) == jfaults.take_scale_injection(step)
    tfaults.configure(**plan)
    assert [tfaults.take_scale_injection(s) for s in (6, 7, 8, 9, 10)] == [
        0.0, 10.0, 10.0, 10.0, 0.0]
    assert [tfaults.take_nan_injection(s) for s in (4, 5, 6)] == [False, True, False]


def test_stall_is_sliced_and_fires_once():
    tfaults.configure(stall_at_step=3, stall_s=0.3)
    assert tfaults.maybe_stall(2) == 0.0
    import time
    t0 = time.monotonic()
    assert tfaults.maybe_stall(3) == pytest.approx(0.3)
    assert time.monotonic() - t0 >= 0.3
    assert tfaults.maybe_stall(4) == 0.0


def test_crash_point_counts_passes(monkeypatch):
    """``name@k`` kills at the k-th pass only (the kill itself is replaced here)."""
    crashes = []
    monkeypatch.setattr(tfaults, "_crash_now", crashes.append)
    tfaults.configure(crash_point="save:swap@3")
    for _ in range(2):
        tfaults.crash_point("save:swap")
        tfaults.crash_point("save:staged")
    assert crashes == []
    tfaults.crash_point("save:swap")
    assert crashes == ["crash_point save:swap (hit 3)"]


def test_corrupt_checkpoint_flips_the_same_bytes(tmp_path):
    """The scripted corruption is a function of the file's size: the same bytes flip
    in both packages, and the digests catch it."""
    from glint_word2vec_torch.train.checkpoint import (
        CheckpointCorruptError, save_model)
    rng = np.random.default_rng(0)
    syn0 = rng.normal(size=(40, 8)).astype(np.float32)
    paths = []
    for name in ("t", "j"):
        p = str(tmp_path / name)
        save_model(p, [f"w{i}" for i in range(40)], np.arange(40, 0, -1), syn0, None,
                   TConfig(vector_size=8))
        paths.append(p)
    tfaults.configure(corrupt_checkpoint_bytes=3)
    jfaults.configure(corrupt_checkpoint_bytes=3)
    tfaults.corrupt_checkpoint(paths[0])
    jfaults.corrupt_checkpoint(paths[1])
    a, b = (open(os.path.join(p, "syn0.npy"), "rb").read() for p in paths)
    assert a == b
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(paths[0])


def test_errors_are_the_trainers():
    from glint_word2vec_torch.obs.watch import NormBlowupError as W
    from glint_word2vec_torch.train import trainer
    assert trainer.NonFiniteParamsError is tfaults.NonFiniteParamsError
    assert trainer.NormBlowupError is tfaults.NormBlowupError is W


def test_hash_lattice_past_the_rollback_jump():
    """A rollback jumps the counter past 2^22: the hash draws there are the JAX
    package's (whose trainer stages the counter as int32), up to 2^31 - 1."""
    for counter in (1 << 22, (1 << 22) + 7, (2 << 22) + 3, (1 << 31) - 1):
        want = np.asarray(jprng.hash_bits(5, 1, counter, (64,)))
        got = tprng.hash_bits(5, 1, counter, (64,), "cpu").numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


# -- the runtime knobs' validation ------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"norm_watch": "bogus"}, {"recover_lr_backoff": 0.0}, {"recover_lr_backoff": 1.5},
    {"max_recoveries": -1}, {"norm_watch_threshold": 0.0}, {"norm_watch_max": -1.0},
    {"norm_watch_frac": 0.0}, {"telemetry_rotate_bytes": 0}, {"profile_steps": -1},
    {"status_port": 70000}, {"blackbox_ring": 0}, {"preempt_deadline_s": 0.0},
    {"nonfinite_policy": "retry"}, {"rollback_history": 0},
    {"norm_watch": "recover", "hot_rows": 8},
    {"norm_watch": "recover", "use_pallas": True},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_runtime_validation_messages_match(kw):
    with pytest.raises(ValueError) as j:
        JConfig(pairs_per_batch=8192, **kw)
    with pytest.raises(ValueError) as t:
        TConfig(pairs_per_batch=8192, **kw)
    assert str(t.value) == str(j.value)


# -- rollback and recovery against the JAX trainer ----------------------------------------


def _toy(tmp=None, **knobs):
    """The JAX suite's toy (tests/test_obs.py): 30 words, 250 sentences, D=8, B=128,
    per-pair negatives, 2 iterations, 2 steps a chunk, a heartbeat every 2; the same
    parameters injected into both packages; with ``tmp``, each writes its run log
    there (``j.jsonl``, ``t.jsonl``)."""
    rng = np.random.default_rng(0)
    sents = [[f"w{i}" for i in rng.integers(0, 30, 20)] for _ in range(250)]
    jv, tv = j_build_vocab(sents, 1), t_build_vocab(sents, 1)
    enc = encode_sentences(sents, tv, 1000)
    r = np.random.default_rng(3)
    init = (r.uniform(-0.05, 0.05, (tv.size, 8)).astype(np.float32),
            r.normal(0, 0.05, (tv.size, 8)).astype(np.float32))
    cfg = dict(vector_size=8, pairs_per_batch=128, window=3, num_iterations=2,
               steps_per_dispatch=2, heartbeat_every_steps=2, subsample_ratio=0.0,
               prefetch_chunks=0, seed=1, **knobs)
    log = (lambda n: {"telemetry_path": str(tmp / f"{n}.jsonl")}) if tmp else (
        lambda n: {})
    jt = JTrainer(JConfig(**cfg, **log("j")), jv,
                  params=JPair(jnp.asarray(init[0]), jnp.asarray(init[1])))
    tt = TTrainer(TConfig(**cfg, **log("t")), tv, params=(init[0].copy(), init[1].copy()),
                  device="cpu")
    return jt, tt, enc


def _fit_both(jt, tt, enc, plan):
    """Fit each trainer under the same fault plan; returns each one's exception."""
    errs = []
    for t, f in ((jt, jfaults), (tt, tfaults)):
        f.configure(**plan)
        try:
            t.fit(enc)
            errs.append(None)
        except (NonFiniteParamsError, jfaults.NonFiniteParamsError,
                tfaults.NormBlowupError, jfaults.NormBlowupError) as e:
            errs.append(e)
        f.reset()
    return errs


def _assert_same_run(jt, tt, params=True):
    assert tt.global_step == jt.global_step
    assert tt.rollbacks_performed == jt.rollbacks_performed
    assert tt.recoveries_performed == jt.recoveries_performed
    assert tt._lr_scale == jt._lr_scale
    assert tuple(tt._stabilizers) == tuple(jt._stabilizers)
    jh, th = list(jt.heartbeats), list(tt.heartbeats)
    assert [h.global_step for h in th] == [h.global_step for h in jh]
    assert [(h.alpha, h.lr_scale, h.recoveries) for h in th] == [
        (h.alpha, h.lr_scale, h.recoveries) for h in jh]
    if params:
        jp, tp = jt.unpadded_params(), tt.unpadded_params()
        np.testing.assert_allclose(tp.syn0.numpy(), np.asarray(jp.syn0), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tp.syn1.numpy(), np.asarray(jp.syn1), atol=1e-5,
                                   rtol=0)
    assert tt.last_run_stats.keys() == jt.last_run_stats.keys()


@pytest.mark.parametrize("history,feed", [(1, "host"), (2, "host"), (2, "device")])
def test_rollback_matches_jax(history, feed):
    """The device pair feed too: after the 2^22 jump its negatives (hash counter
    global_step + 1) and its blocks' lattice bases stay the JAX package's."""
    jt, tt, enc = _toy(nonfinite_policy="rollback", rollback_history=history,
                       device_pairgen=feed == "device")
    assert _fit_both(jt, tt, enc, dict(nan_at_step=6)) == [None, None]
    assert tt.rollbacks_performed == 1
    assert tt.global_step > 1 << 22
    assert torch.isfinite(tt.params.syn0).all() and torch.isfinite(tt.params.syn1).all()
    _assert_same_run(jt, tt)


@pytest.mark.parametrize("max_rollbacks", [0, 2])
def test_rollback_budget_matches_jax(max_rollbacks):
    """NaN at every round from step 6 on (the injection re-armed before each round)
    until the budget or the ring is spent: the same error, word for word."""
    jt, tt, enc = _toy(nonfinite_policy="rollback", max_rollbacks=max_rollbacks)
    errs = []
    for t, f in ((jt, jfaults), (tt, tfaults)):
        f.configure(nan_at_step=6)
        real = t._finish_round

        def finish(*a, _real=real, _f=f, **kw):
            _f._counters.pop("nan_done", None)  # re-arm: NaN at every round
            return _real(*a, **kw)

        t._finish_round = finish
        with pytest.raises(Exception) as e:
            t.fit(enc)
        errs.append(e.value)
    assert type(errs[1]).__name__ == type(errs[0]).__name__ == "NonFiniteParamsError"
    assert str(errs[1]) == str(errs[0])
    assert tt.rollbacks_performed == jt.rollbacks_performed


def test_halt_diagnostic_matches_jax():
    jt, tt, enc = _toy(nonfinite_policy="halt")
    errs = _fit_both(jt, tt, enc, dict(nan_at_step=8))
    assert str(errs[1]) == str(errs[0]) and "syn0" in str(errs[1])
    assert tt.global_step == jt.global_step


def _records(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _assert_same_record(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "t":
            continue
        if k == "channels":
            for name in ("syn0", "syn1"):
                for ch, v in want[k][name].items():
                    np.testing.assert_allclose(got[k][name][ch], v, rtol=1e-6)
            assert got[k]["finite"] == want[k]["finite"]
        else:
            assert got[k] == want[k], k


def test_recovery_matches_jax(tmp_path):
    jt, tt, enc = _toy(tmp_path, norm_watch="recover")
    assert _fit_both(jt, tt, enc, dict(scale_params_at_step=6)) == [None, None]
    assert tt.recoveries_performed == 1 and tt._lr_scale == 0.5
    assert tt._stabilizers.max_row_norm == tt.config.norm_watch_threshold
    assert tt.global_step > 1 << 22
    _assert_same_run(jt, tt)
    jrec, trec = (_records(str(tmp_path / f"{n}.jsonl"), "recovery") for n in "jt")
    assert len(trec) == len(jrec) == 1
    _assert_same_record(trec[0], jrec[0])
    jw, tw = (_records(str(tmp_path / f"{n}.jsonl"), "watchdog") for n in "jt")
    assert [r["reason"] for r in tw] == [r["reason"] for r in jw]


@pytest.mark.parametrize("max_recoveries", [1, 4])
def test_recovery_exhaustion_matches_jax(tmp_path, max_recoveries):
    """A blowup at every round from step 6 on: the budget (max_recoveries=1) or the
    ring (4) runs out, and both packages raise the same NormBlowupError after the same
    records."""
    jt, tt, enc = _toy(tmp_path, norm_watch="recover", max_recoveries=max_recoveries)
    errs = _fit_both(jt, tt, enc, dict(scale_params_at_step=6, scale_params_times=99))
    assert type(errs[0]).__name__ == type(errs[1]).__name__ == "NormBlowupError"
    assert str(errs[1]) == str(errs[0])
    _assert_same_run(jt, tt, params=False)
    jrec, trec = (_records(str(tmp_path / f"{n}.jsonl"), "recovery") for n in "jt")
    assert len(trec) == len(jrec) >= 2 and trec[-1]["action"] == "halt"
    for got, want in zip(trec, jrec):
        _assert_same_record(got, want)
    ends = _records(str(tmp_path / "t.jsonl"), "run_end")
    assert [e["status"] for e in ends] == ["error"]


# -- crash and preemption in child processes ---------------------------------------------


_CHILD = """
import sys
import numpy as np
from glint_word2vec_torch import Word2Vec
rng = np.random.default_rng(0)
sents = [[f"w{{i}}" for i in rng.integers(0, 30, 20)] for _ in range(250)]
Word2Vec(vector_size=8, pairs_per_batch=128, window=3, num_iterations=2,
         steps_per_dispatch=2, heartbeat_every_steps=2, subsample_ratio=0.0,
         min_count=1, seed=1, device="cpu"{knobs}).fit(
    sents, checkpoint_path=sys.argv[1], checkpoint_every_steps=4)
print("UNREACHABLE")
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "glint_word2vec_tpu")]
"""


def _child(tmp_path, env, knobs=""):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", **env}
    return subprocess.run([sys.executable, "-c", _CHILD.format(knobs=knobs),
                           str(tmp_path / "ck")], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)


def test_sigkill_in_the_torn_window_resumes(tmp_path):
    """SIGKILL inside the third save's swap (the checkpoint renamed aside, its
    replacement staged): the path is gone, load_latest_valid restores the
    predecessor, it verifies, and Word2Vec.resume finishes the run from it."""
    from glint_word2vec_torch import Word2Vec
    proc = _child(tmp_path, {"GLINT_FAULT_CRASH_POINT": "save:swap@3"})
    assert proc.returncode in (-9, 137), proc.stderr[-800:]
    assert "UNREACHABLE" not in proc.stdout
    names = os.listdir(tmp_path)
    assert "ck" not in names
    assert any(".old-" in n for n in names) and any(".tmp-" in n for n in names)
    got = load_latest_valid(str(tmp_path))
    assert got == str(tmp_path / "ck")
    verify_checkpoint(got)
    state = load_model(got)["train_state"]
    assert state.global_step == 8 and not state.finished  # the 2nd save's step
    rng = np.random.default_rng(0)
    sents = [[f"w{i}" for i in rng.integers(0, 30, 20)] for _ in range(250)]
    model = Word2Vec.resume(got, sents, device="cpu")
    assert model.train_state.finished
    assert np.isfinite(model.syn0.numpy()).all()


def test_sigterm_preemption_saves_and_dumps(tmp_path):
    """SIGTERM at the end of the round reaching step 6 (the fault plan's TERM) with
    checkpoint_on_preempt and telemetry: the handler arms the deadline, the round's
    end saves, records preempt and run_end "preempted", and the process dies of the
    signal; the log and the handler's dump validate under both packages'
    validators."""
    from glint_word2vec_torch.obs import schema as tschema
    from glint_word2vec_tpu.obs import schema as jschema
    log = str(tmp_path / "run.jsonl")
    proc = _child(tmp_path, {"GLINT_FAULT_CRASH_AT_STEP": "6",
                             "GLINT_FAULT_CRASH_SIGNAL": "TERM"},
                  f", checkpoint_on_preempt=True, telemetry_path={log!r}")
    assert proc.returncode == -15, proc.stderr[-800:]
    ck = str(tmp_path / "ck")
    verify_checkpoint(ck)
    assert load_model(ck)["train_state"].global_step == 6
    for schema in (tschema, jschema):
        assert schema.validate_file(log)["ok"]
        assert schema.validate_blackbox_file(log + ".blackbox.json")["ok"]
    pre = _records(log, "preempt")
    assert len(pre) == 1 and pre[0]["saved"] and pre[0]["step"] == 6
    assert pre[0]["steps_since_save"] == 0
    assert [r["status"] for r in _records(log, "run_end")] == ["preempted"]
    doc = json.load(open(log + ".blackbox.json"))
    assert doc["cause"]["signal"] == "SIGTERM"  # the handler's dump: the first wins
    assert doc["status"]["status"] == "running"
