"""The chaos drill, ported from ``tools/chaos_run.py``: small runs of the port driven
through a scripted fault schedule end to end, checking that the fault-tolerance layer
holds. Every fault is deterministic (``train/faults.py``), with no sleep or kill-timing
race:

1. **crash-resume**: a worker process trains with periodic checkpoints and is
   SIGKILLed inside the second checkpoint's swap window (old checkpoint renamed aside,
   its replacement not yet in place). ``load_latest_valid`` reclaims the debris and
   restores the renamed-aside checkpoint, the run resumes from it, and the finished
   checkpoint's digests verify.
2. **corrupt-fallback**: a newer checkpoint saved with scripted bit flips is rejected
   on its digests; ``load_latest_valid`` falls back to the older clean one.
3. **nan-rollback / nan-halt**: NaN injected into the parameters at a scripted step;
   ``nonfinite_policy="rollback"`` finishes finite, ``"halt"`` fails fast.
4. **norm-blowup**: the parameters scaled by 1e6 at a scripted step, a finite blowup.
   ``nonfinite_policy`` alone stays silent, ``norm_watch="warn"`` records firings and
   finishes, ``norm_watch="halt"`` fails fast.
5. **norm-recover**: the same blowup under ``norm_watch="recover"`` rolls back, backs
   the learning rate off, engages the row-norm clamp and finishes finite; a run that
   blows up again past ``max_recoveries`` halts.
6. **blackbox**: a SIGTERM'd telemetry-on worker and an injected blowup under
   ``norm_watch="halt"`` each leave a schema-valid ``<telemetry>.blackbox.json`` with
   at least one heartbeat and the terminal cause.
7. **serve-reload**: a trainer thread publishes checkpoints every few steps while a
   query storm runs against an ``EmbeddingService`` watching the same path: no failed
   or refused query, at least 3 observed hot reloads, every superseded model released.
   Then two V-grew epilogues: ``continual.extend_checkpoint`` grows the vocabulary
   between publishes, and the service reloads at the new V and serves a brand-new
   word; a second service on the int8 arm reloads another extension at the same arm,
   its index rebuilt at the new V with recall measured again.
8. **continual-drift**: the closed continual loop under a fault: a base fit, a segment
   with unseen words, a ``python -m glint_word2vec_torch.continual_run`` process
   SIGTERM'd by the fault plan inside its increment (after the extension's publish)
   leaves a checkpoint that verifies and an unconsumed cursor; the retried increment
   grows V with its lineage link, and a live service reloads the grown model and
   answers a new word, an old word keeping its cluster.
9. **fleet-kill**: the serving fleet's drill (``fleet_run.run_smoke``): a replica
   SIGKILLed mid-storm, no failed client query, the breaker open -> half-open ->
   closed, a 3-publish rolling reload at N-1 capacity or more.
10. **flaky-ingest**: the first N ingest I/O attempts raise; the bounded backoff absorbs
    them.
11. **train-preempt / train-stall / train-crashloop**: the training supervisor's three
    drills (``train_run.run_preempt_drill``, ``run_stall_drill``,
    ``run_crashloop_drill``), with the port's 30 s stall horizon
    (``train_run.STALL_S``).

Usage::

    python -m glint_word2vec_torch.chaos_run [--smoke] [--device cuda|cpu]
        [--only NAME[,NAME...]] [--workdir DIR]
    python -m glint_word2vec_torch.chaos_run --list

Every fit and service runs on ``--device`` (the card by default). Progress and one line
per phase go to stderr; stdout carries one JSON line. Exit code 0 iff every phase run
passed; 2 for an unknown phase.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# the directory holding the package, for the worker processes
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# phases of the JAX drill that need a part of the port still to come (name ->
# reason), and notes printed beside a phase's PASS: every phase is ported
NOT_PORTED: dict = {}
NOTES: dict = {}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def toy_sentences(n_sentences: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [[f"w{i}" for i in rng.integers(0, 30, 20)] for _ in range(n_sentences)]


def toy_config(policy: str = "halt", **kw):
    from glint_word2vec_torch.config import Word2VecConfig
    return Word2VecConfig(
        vector_size=8, pairs_per_batch=128, window=3, num_iterations=2,
        steps_per_dispatch=2, heartbeat_every_steps=2, subsample_ratio=0.0,
        prefetch_chunks=0, seed=1, nonfinite_policy=policy, **kw)


def _host(t) -> np.ndarray:
    return t.float().cpu().numpy()


def _fit(sentences, cfg, device: str, **kw):
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.train.trainer import Trainer
    vocab = build_vocab(sentences, min_count=1)
    enc = encode_sentences(sentences, vocab, 1000)
    trainer = Trainer(cfg, vocab, device=device)
    trainer.fit(enc, **kw)
    return trainer


def _worker_cmd(kind: str, workdir: str, n_sentences: int, device: str) -> list:
    return [sys.executable, "-m", "glint_word2vec_torch.chaos_run", "--worker", kind,
            "--workdir", workdir, "--sentences", str(n_sentences), "--device", device]


def _worker_env(**faults) -> dict:
    path = os.pathsep.join(p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, **faults)


def worker_crash(workdir: str, n_sentences: int, device: str) -> None:
    """The crashing training leg, run as a worker process with
    ``GLINT_FAULT_CRASH_POINT=save:swap@2``: the first periodic save completes and the
    second dies mid-swap. Never returns normally."""
    _fit(toy_sentences(n_sentences), toy_config(), device,
         checkpoint_path=os.path.join(workdir, "ck"), checkpoint_every_steps=2)
    # graftlint: disable=R7 -- a worker child's stdout, which the drill does not parse (it reads the exit code); the JSON line is the parent's
    print("WORKER SURVIVED (fault did not fire)", flush=True)
    sys.exit(3)


def worker_blackbox(workdir: str, n_sentences: int, device: str) -> None:
    """The SIGTERM'd telemetry-on leg of the blackbox phase, run with
    ``GLINT_FAULT_CRASH_AT_STEP`` and ``GLINT_FAULT_CRASH_SIGNAL=TERM``: the trainer's
    SIGTERM hook must dump the flight recorder before the process dies. Never returns
    normally."""
    _fit(toy_sentences(n_sentences),
         toy_config(telemetry_path=os.path.join(workdir, "run.jsonl")), device)
    # graftlint: disable=R7 -- a worker child's stdout, which the drill does not parse (it reads the exit code); the JSON line is the parent's
    print("WORKER SURVIVED (fault did not fire)", flush=True)
    sys.exit(3)


def phase_crash_resume(workdir: str, n_sentences: int, device: str) -> str:
    from glint_word2vec_torch.models.estimator import Word2Vec
    from glint_word2vec_torch.train.checkpoint import load_latest_valid, verify_checkpoint

    rc = subprocess.call(_worker_cmd("crash", workdir, n_sentences, device),
                         env=_worker_env(GLINT_FAULT_CRASH_POINT="save:swap@2"))
    if rc not in (-9, 137):
        return f"worker exited {rc}, expected SIGKILL (-9/137)"
    entries = sorted(os.listdir(workdir))
    if not any(".old-" in e or ".tmp-" in e for e in entries):
        return f"no interrupted-save debris found ({entries}) — fault missed"
    ck = load_latest_valid(workdir)
    meta = verify_checkpoint(ck)
    step = meta["train_state"]["global_step"]
    if meta["train_state"]["finished"] or step <= 0:
        return f"recovered checkpoint is not a mid-run state (step {step})"
    model = Word2Vec.resume(ck, toy_sentences(n_sentences), checkpoint_every_steps=2,
                            device=device)
    if not model.train_state.finished:
        return "resumed run did not finish"
    verify_checkpoint(ck)  # the finished save must verify too
    if not np.isfinite(_host(model.syn0)).all():
        return "resumed run produced non-finite embeddings"
    return ""


def phase_corrupt_fallback(workdir: str) -> str:
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.train import faults
    from glint_word2vec_torch.train.checkpoint import (TrainState, load_latest_valid,
                                                       save_model)

    words = ["a", "b", "c"]
    counts = np.array([3, 2, 1])
    syn0 = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
    cfg = Word2VecConfig(vector_size=8)
    save_model(os.path.join(workdir, "ck-a"), words, counts, syn0, -syn0, cfg,
               TrainState(global_step=10))
    faults.configure(corrupt_checkpoint_bytes=3)
    try:
        save_model(os.path.join(workdir, "ck-b"), words, counts, syn0, -syn0, cfg,
                   TrainState(global_step=20))
    finally:
        faults.reset()
    got = load_latest_valid(workdir)
    if os.path.basename(got) != "ck-a":
        return f"picked {got!r}; expected the older clean ck-a (ck-b is corrupt)"
    return ""


def phase_nan(policy: str, device: str) -> str:
    from glint_word2vec_torch.train import faults
    from glint_word2vec_torch.train.faults import NonFiniteParamsError

    faults.configure(nan_at_step=8)
    try:
        trainer = _fit(toy_sentences(200, seed=2), toy_config(policy), device)
    except NonFiniteParamsError as e:
        faults.reset()
        if policy == "halt":
            return "" if "non-finite parameters" in str(e) else \
                f"halt diagnostic unclear: {e}"
        return f"rollback run raised instead of recovering: {e}"
    finally:
        faults.reset()
    if policy == "halt":
        return "halt run finished instead of raising"
    if not np.isfinite(_host(trainer.params.syn0)).all():
        return "rollback run ended with non-finite params"
    if trainer.rollbacks_performed < 1:
        return "rollback run never rolled back (fault missed)"
    return ""


def phase_norm_blowup(device: str) -> str:
    """Scale the parameters by 1e6 mid-run, a finite norm blowup: the non-finite guard
    alone stays silent, ``norm_watch='warn'`` records firings and finishes,
    ``norm_watch='halt'`` fails fast."""
    from glint_word2vec_torch.train import faults
    from glint_word2vec_torch.train.faults import NormBlowupError

    # 1. nonfinite halt alone: silent (the blowup is finite)
    faults.configure(scale_params_at_step=8)
    try:
        trainer = _fit(toy_sentences(200, seed=2), toy_config("halt"), device)
    except Exception as e:  # noqa: BLE001 — any raise here is the failure
        return f"nonfinite_policy='halt' fired on a FINITE blowup: {e}"
    finally:
        faults.reset()
    if not np.isfinite(_host(trainer.params.syn0)).all():
        return "scaled params went non-finite — injection no longer finite"
    if trainer.norm_watchdog.fires:
        return "watchdog fired with norm_watch='off'"

    # 2. warn: fires, training continues to completion
    faults.configure(scale_params_at_step=8)
    try:
        trainer = _fit(toy_sentences(200, seed=2),
                       toy_config("halt", norm_watch="warn"), device)
    finally:
        faults.reset()
    if trainer.norm_watchdog.fires < 1:
        return "norm_watch='warn' never fired on the injected blowup"

    # 3. halt: fail fast with the diagnostic
    faults.configure(scale_params_at_step=8)
    try:
        _fit(toy_sentences(200, seed=2), toy_config("halt", norm_watch="halt"), device)
    except NormBlowupError as e:
        return "" if "finite norm blowup" in str(e) else \
            f"halt diagnostic unclear: {e}"
    finally:
        faults.reset()
    return "norm_watch='halt' finished instead of raising"


def phase_norm_recover(device: str) -> str:
    """The injected finite blowup drives the ladder: the watchdog fires, the run rolls
    back to a ring snapshot, the learning rate backs off, the row-norm clamp engages,
    and the fit completes finite; a run that blows up again past its recovery budget
    halts."""
    from glint_word2vec_torch.train import faults
    from glint_word2vec_torch.train.faults import NormBlowupError

    # 1. recover. nonfinite_policy stays 'halt' on purpose: the ring must arm for the
    #    watchdog's consumer
    faults.configure(scale_params_at_step=8)
    try:
        trainer = _fit(toy_sentences(200, seed=2),
                       toy_config("halt", norm_watch="recover"), device)
    except Exception as e:  # noqa: BLE001 — a recover run must not raise
        return f"norm_watch='recover' raised instead of recovering: {e}"
    finally:
        faults.reset()
    if trainer.recoveries_performed < 1:
        return "recover run finished but never recovered (fault missed?)"
    if trainer.norm_watchdog.fires < 1:
        return "recover run finished without a watchdog firing"
    syn0 = _host(trainer.params.syn0)
    if not np.isfinite(syn0).all():
        return "recovered run ended with non-finite params"
    norms = np.linalg.norm(syn0.astype(np.float64), axis=1)
    if norms.max() > trainer.config.norm_watch_threshold * 1.001:
        return (f"recovered run still carries blown rows "
                f"(max norm {norms.max():.3g}) — mitigation not engaged?")
    if trainer._lr_scale >= 1.0:
        return "recovery did not back the learning rate off"
    if not trainer._stabilizers.max_row_norm:
        return "recovery did not engage max_row_norm"

    # 2. budget exhaustion: the blowup fires again every round (times=99), so past
    #    max_recoveries the ladder halts
    faults.configure(scale_params_at_step=8, scale_params_times=99)
    try:
        _fit(toy_sentences(200, seed=2),
             toy_config("halt", norm_watch="recover", max_recoveries=2), device)
    except NormBlowupError as e:
        return "" if "budget exhausted" in str(e) else \
            f"exhaustion diagnostic unclear: {e}"
    except Exception as e:  # noqa: BLE001
        return f"budget exhaustion raised the wrong error: {e}"
    finally:
        faults.reset()
    return "budget-exhaustion run finished instead of halting"


def phase_blackbox(workdir: str, n_sentences: int, device: str) -> str:
    """A SIGTERM'd worker and an injected finite blowup (NormBlowupError through the
    abort path) each leave a schema-valid ``<telemetry_path>.blackbox.json`` with the
    ring contents (at least one heartbeat) and the terminal cause."""
    from glint_word2vec_torch.obs.schema import validate_blackbox_file
    from glint_word2vec_torch.train import faults
    from glint_word2vec_torch.train.faults import NormBlowupError

    # 1. SIGTERM at a scripted step, in a worker process: the signal hook dumps
    crash_dir = os.path.join(workdir, "crash")
    os.makedirs(crash_dir, exist_ok=True)
    rc = subprocess.call(_worker_cmd("blackbox", crash_dir, n_sentences, device),
                         env=_worker_env(GLINT_FAULT_CRASH_AT_STEP="8",
                                         GLINT_FAULT_CRASH_SIGNAL="TERM"))
    if rc not in (-15, 143):
        return f"worker exited {rc}, expected SIGTERM (-15/143)"
    dump = os.path.join(crash_dir, "run.jsonl.blackbox.json")
    if not os.path.exists(dump):
        return "SIGTERM'd run left no blackbox dump"
    v = validate_blackbox_file(dump)
    if not v["ok"]:
        return f"crash dump not schema-valid: {v['errors'][:3]}"
    with open(dump) as f:
        doc = json.load(f)
    if doc["cause"] != {"kind": "signal", "signal": "SIGTERM", "signum": 15}:
        return f"crash dump cause wrong: {doc['cause']}"
    if len(doc["heartbeats"]) < 1:
        return "crash dump carries no heartbeats"
    if not doc["dispatches"]:
        return "crash dump carries no dispatch records"

    # 2. an injected finite blowup rides the abort path: the dump's terminal cause is
    #    the exception, and its event ring holds the watchdog record
    blow_dir = os.path.join(workdir, "blowup")
    os.makedirs(blow_dir, exist_ok=True)
    run_log = os.path.join(blow_dir, "run.jsonl")
    faults.configure(scale_params_at_step=8)
    try:
        _fit(toy_sentences(n_sentences, seed=2),
             toy_config("halt", norm_watch="halt", telemetry_path=run_log), device)
        return "norm_watch='halt' finished instead of raising"
    except NormBlowupError:
        pass
    except Exception as e:  # noqa: BLE001
        return f"blowup raised the wrong error: {e}"
    finally:
        faults.reset()
    dump = run_log + ".blackbox.json"
    if not os.path.exists(dump):
        return "blowup run left no blackbox dump"
    v = validate_blackbox_file(dump)
    if not v["ok"]:
        return f"blowup dump not schema-valid: {v['errors'][:3]}"
    with open(dump) as f:
        doc = json.load(f)
    cause = doc["cause"]
    if cause.get("kind") != "exception" or cause.get("type") != "NormBlowupError":
        return f"blowup dump cause wrong: {cause}"
    if len(doc["heartbeats"]) < 1:
        return "blowup dump carries no heartbeats"
    kinds = [e["kind"] for e in doc["events"]]
    if "watchdog" not in kinds:
        return f"blowup dump events missing the watchdog record ({kinds})"
    if "run_end" not in kinds:
        return f"blowup dump events missing the terminal run_end ({kinds})"
    return ""


def phase_serve_reload(workdir: str, n_sentences: int, device: str) -> str:
    """The trainer publishes checkpoints mid-query-storm. The service answers every
    query (no error, no refusal, no torn read across the swap), observes at least 3
    hot reloads through the watcher, and releases every superseded model once its
    leases drain."""
    import threading

    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.serve import EmbeddingService
    from glint_word2vec_torch.train.trainer import Trainer

    sents = toy_sentences(n_sentences, seed=4)
    vocab = build_vocab(sents, min_count=1)
    cfg = toy_config()
    enc = encode_sentences(sents, vocab, cfg.max_sentence_length)
    trainer = Trainer(cfg, vocab, device=device)
    ck = os.path.join(workdir, "ck")
    trainer.save_checkpoint(ck)  # the service needs a first publish to boot

    service = EmbeddingService(
        checkpoint=ck, ann=True, watch=True, reload_poll_s=0.02,
        max_batch=16, max_delay_ms=1.0, device=device)
    fit_err, query_errs = [], []
    queries = [0]

    def fit():
        try:
            # a checkpoint every 4 global steps: many publishes race the watcher's
            # reloads and the storm
            trainer.fit(enc, checkpoint_path=ck, checkpoint_every_steps=4)
            trainer.save_checkpoint(ck)
        except Exception as e:  # noqa: BLE001 — reported through fit_err
            fit_err.append(e)

    t = threading.Thread(target=fit)
    words = {f"w{i}" for i in range(30)}
    storm_on = threading.Event()
    storm_on.set()

    def storm(ci: int):
        i = 0
        while storm_on.is_set() or i == 0:
            i += 1
            try:
                res = service.synonyms(f"w{(ci * 7 + i) % 30}", 5)
                if len(res) != 5 or not all(
                        w in words and np.isfinite(s) for w, s in res):
                    query_errs.append(f"bad result: {res}")
            except Exception as e:  # noqa: BLE001 — any raise is the failure
                query_errs.append(f"{type(e).__name__}: {e}")
            queries[0] += 1

    clients = [threading.Thread(target=storm, args=(c,)) for c in range(3)]
    t.start()
    for c in clients:
        c.start()
    t.join()
    # the check needs >= 3 OBSERVED publishes; a reload (load + index build) may
    # outlast the whole toy fit on a loaded host, so keep publishing until the watcher
    # has observed three, up to a deadline
    deadline = time.monotonic() + 60
    while service.stats()["reloads"] < 3 and time.monotonic() < deadline:
        trainer.save_checkpoint(ck)
        settle = time.monotonic() + 2
        while (service.stats()["reloads"] < 3
               and time.monotonic() < min(settle, deadline)):
            time.sleep(0.05)
    storm_on.clear()
    for c in clients:
        c.join()
    try:
        if fit_err:
            return f"trainer died under the storm: {fit_err[0]}"
        if query_errs:
            return (f"{len(query_errs)} failed queries during publishes "
                    f"(first: {query_errs[0]})")
        stats = service.stats()
        # a reload may still be landing: its swap releases the old model before the
        # reload is counted, so give the two counts a bounded wait to meet
        deadline = time.monotonic() + 10
        while (stats["models_released"] != stats["reloads"]
               and time.monotonic() < deadline):
            time.sleep(0.05)
            stats = service.stats()
        if stats["refused"]:
            return f"{stats['refused']} queries refused (queue never fills here)"
        if stats["reloads"] < 3:
            return (f"only {stats['reloads']} hot-reloads observed across "
                    f"the publish storm (need >= 3)")
        if stats["models_released"] != stats["reloads"]:
            return (f"buffer leak: {stats['reloads']} reloads but only "
                    f"{stats['models_released']} old models released")
        if queries[0] < 50:
            return f"storm too thin ({queries[0]} queries) to prove overlap"
        return (_vgrew_epilogue(service, ck)
                or _vgrew_quant_epilogue(ck, device))
    finally:
        service.close()


def _wait_words(service, want: int, seconds: float = 30.0) -> int:
    """The service's vocabulary size once it reaches ``want``, or at the deadline."""
    deadline = time.monotonic() + seconds
    while service.info()["num_words"] != want and time.monotonic() < deadline:
        time.sleep(0.05)
    return service.info()["num_words"]


def _vgrew_epilogue(service, ck: str) -> str:
    """The vocabulary grows between publishes: the watcher reloads at the new V with
    a fresh index, counts a vocabulary change, and serves the brand-new word."""
    from glint_word2vec_torch.continual import extend_checkpoint
    rep = extend_checkpoint(ck, {"brandnew0": 50, "brandnew1": 40}, min_count=1)
    got = _wait_words(service, rep["new_vocab_size"])
    if got != rep["new_vocab_size"]:
        return (f"service never reloaded the V-grew publish (serving {got} words, want "
                f"{rep['new_vocab_size']})")
    if service.stats()["vocab_change_reloads"] < 1:
        return "V-grew reload not counted as a vocab change"
    res = service.synonyms("brandnew0", 3)
    if not res or not all(np.isfinite(s) for _, s in res):
        return f"new-vocab word query failed after the V-grew reload: {res}"
    return ""


def _vgrew_quant_epilogue(ck: str, device: str) -> str:
    """A second service on the int8 arm: another extension reloads it at the same arm,
    its index rebuilt at the new V with recall measured again (floor 0: a toy
    vocabulary's probe loss is about the scale, not the quantizer), and the brand-new
    word serves through the quantized index."""
    from glint_word2vec_torch.continual import extend_checkpoint
    from glint_word2vec_torch.serve import EmbeddingService
    qsvc = EmbeddingService(checkpoint=ck, ann=True, watch=True, reload_poll_s=0.02,
                            max_batch=16, max_delay_ms=1.0, ann_quant="int8",
                            ann_recall_floor=0.0, device=device)
    try:
        before = qsvc.info()["ann"]
        if before.get("quant") != "int8":
            return f"quantized service built arm {before.get('quant')!r}"
        rep = extend_checkpoint(ck, {"brandnew2": 30}, min_count=1)
        got = _wait_words(qsvc, rep["new_vocab_size"])
        if got != rep["new_vocab_size"]:
            return (f"quantized service never reloaded the V-grew publish (serving "
                    f"{got} words, want {rep['new_vocab_size']})")
        after = qsvc.info()["ann"]
        if after.get("quant") != "int8":
            return (f"V-grew reload changed the quant arm: {before.get('quant')!r} -> "
                    f"{after.get('quant')!r}")
        if after.get("rows") != rep["new_vocab_size"]:
            return f"quantized index not rebuilt at the new V (index rows {after.get('rows')})"
        if not isinstance(after.get("recall_at_10"), float):
            return ("quantized V-grew rebuild did not re-measure recall: "
                    f"{after.get('recall_at_10')!r}")
        qres = qsvc.synonyms("brandnew2", 3)
        if not qres or not all(np.isfinite(s) for _, s in qres):
            return f"new-vocab word query failed through the quantized index: {qres}"
    finally:
        qsvc.close()
    return ""


def phase_continual_drift(workdir: str, n_sentences: int, device: str) -> str:
    """The closed continual loop under a fault: base fit -> a segment with unseen
    words -> a continual_run process SIGTERM'd inside its increment must leave a checkpoint that
    verifies and an unconsumed cursor -> the retried increment grows V (lineage
    recorded, carried rows verified by the extension) -> a live service reloads the
    grown model and answers a new word, an old word's neighbours still in its
    cluster."""
    from glint_word2vec_torch.continual import ContinualRunner, StreamCursor
    from glint_word2vec_torch.continual_run import (_CLUSTER_A, _NEW_WORDS,
                                                    _write_cluster_segment)
    from glint_word2vec_torch.serve import EmbeddingService
    from glint_word2vec_torch.train.checkpoint import (load_latest_valid,
                                                       load_model_header,
                                                       verify_checkpoint)

    corpus_dir = os.path.join(workdir, "corpus")
    work_dir = os.path.join(workdir, "work")
    ck = os.path.join(workdir, "publish", "ck")
    os.makedirs(corpus_dir, exist_ok=True)
    _write_cluster_segment(os.path.join(corpus_dir, "seg-000.txt"), n_sentences, seed=1)
    overrides = dict(vector_size=16, min_count=2, window=3, num_iterations=2,
                     pairs_per_batch=128, subsample_ratio=0.0, seed=1,
                     prefetch_chunks=0, steps_per_dispatch=2, heartbeat_every_steps=2)
    runner = ContinualRunner(ck, corpus_dir, work_dir, config_overrides=overrides,
                             checkpoint_every_steps=4, device=device)
    base = runner.ensure_base()
    v_base = base["vocab_size"]
    _write_cluster_segment(os.path.join(corpus_dir, "seg-001.txt"), n_sentences, seed=2,
                           extra_a_words=_NEW_WORDS)

    # 1. SIGTERM mid-increment: the process extends, starts the increment's fit and
    # dies at a scripted step; global_step continues from the base checkpoint, so the
    # increment's first round reaches step 1
    rc = subprocess.call(
        [sys.executable, "-m", "glint_word2vec_torch.continual_run", "--checkpoint", ck,
         "--corpus-dir", corpus_dir, "--work-dir", work_dir, "--max-increments", "1",
         "--idle-polls", "1", "--device", device],
        env=_worker_env(GLINT_FAULT_CRASH_AT_STEP="1", GLINT_FAULT_CRASH_SIGNAL="TERM"),
        stdout=subprocess.DEVNULL)
    if rc not in (-15, 143):
        return f"continual_run exited {rc}, expected SIGTERM (-15/143)"
    # resumable: the publish path (or its swap debris) verifies, and the cursor did
    # not consume the tail
    try:
        verify_checkpoint(load_latest_valid(os.path.dirname(ck)))
    except (FileNotFoundError, ValueError) as e:
        return f"no resumable checkpoint after mid-increment SIGTERM: {e}"
    if "seg-001.txt" in StreamCursor(work_dir).consumed:
        return "SIGTERM'd increment was marked consumed (not resumable)"

    # 2. retry the increment in this process, a live service watching
    service = EmbeddingService(checkpoint=ck, ann=True, watch=True, reload_poll_s=0.05,
                               max_batch=16, max_delay_ms=1.0, device=device)
    try:
        with ContinualRunner(ck, corpus_dir, work_dir, config_overrides=overrides,
                             checkpoint_every_steps=4, device=device) as runner2:
            rep = runner2.run_once()
        if rep["action"] != "increment":
            return f"retried increment did not run: {rep}"
        header = load_model_header(ck)
        if header["vocab_size"] <= v_base:
            return (f"vocab did not grow across the increment ({v_base} -> "
                    f"{header['vocab_size']})")
        lineage = header["vocab_lineage"]
        if not lineage or lineage[0].get("remap") != "identity-prefix":
            return f"fingerprint lineage missing/wrong: {lineage}"
        if _wait_words(service, header["vocab_size"]) != header["vocab_size"]:
            return "serve replica never hot-reloaded the grown model"
        res = service.synonyms(_NEW_WORDS[0], 4)
        if not res or not all(np.isfinite(s) for _, s in res):
            return f"new-word query failed on the grown model: {res}"
        old = service.synonyms(_CLUSTER_A[0], 4)
        a_like = set(_CLUSTER_A) | set(_NEW_WORDS)
        if sum(1 for w, _ in old if w in a_like) < 2:
            return (f"old word {_CLUSTER_A[0]!r} lost its cluster after the "
                    f"increment: {old}")
        if service.stats()["refused"]:
            return "queries refused during the continual publishes"
        # the cursor's JSON round-trips: the next run starts clean
        with open(os.path.join(work_dir, "cursor.json")) as f:
            doc = json.load(f)
        if "seg-001.txt" not in doc.get("consumed", {}):
            return "completed increment did not consume its segment"
    finally:
        service.close()
        runner.close()
    return ""


def phase_fleet_kill(workdir: str, n_sentences: int, device: str) -> str:
    """The serving fleet under a replica's death: the fleet-kill drill of ``python -m
    glint_word2vec_torch.fleet_run`` (``fleet_run.run_smoke``) with 3 replica processes
    on ``device``."""
    from glint_word2vec_torch.fleet_run import run_smoke
    try:
        rep = run_smoke(workdir, n_sentences, replicas=3, device=device)
    except AssertionError as e:
        return str(e)
    except Exception as e:  # noqa: BLE001 — any raise is the failure
        return f"{type(e).__name__}: {e}"
    if rep.get("failed_queries") != 0:
        return f"failed queries: {rep}"
    return ""


def _phase_supervisor(drill, workdir: str, n_sentences: int, device: str) -> str:
    """One of the training supervisor's drills (``train_run``), reporting its first
    broken invariant."""
    os.makedirs(workdir, exist_ok=True)
    try:
        drill(workdir, n_sentences, device=device)
    except AssertionError as e:
        return str(e)
    except Exception as e:  # noqa: BLE001 — any raise is the failure
        return f"{type(e).__name__}: {e}"
    return ""


def phase_flaky_ingest(workdir: str) -> str:
    from glint_word2vec_torch.data.corpus import encode_corpus
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.train import faults

    sents = toy_sentences(50, seed=3)
    vocab = build_vocab(sents, min_count=1)
    faults.configure(fail_ingest_first_n=2)
    try:
        enc = encode_corpus(sents, vocab, os.path.join(workdir, "enc"))
    except OSError as e:
        return f"retry wrapper did not absorb 2 injected faults: {e}"
    finally:
        faults.reset()
    if len(enc) != len(sents):
        return f"encoded {len(enc)} sentences, expected {len(sents)}"
    return ""


def phase_table(workdir: str, n_sentences: int, device: str) -> list:
    """(name, callable) for every phase of the JAX drill, in its order."""
    from glint_word2vec_torch import train_run

    def sub(name: str) -> str:
        path = os.path.join(workdir, name)
        os.makedirs(path, exist_ok=True)
        return path

    return [
        ("crash-resume",
         lambda: phase_crash_resume(sub("p1"), n_sentences, device)),
        ("corrupt-fallback", lambda: phase_corrupt_fallback(sub("p2"))),
        ("nan-rollback", lambda: phase_nan("rollback", device)),
        ("nan-halt", lambda: phase_nan("halt", device)),
        ("norm-blowup", lambda: phase_norm_blowup(device)),
        ("norm-recover", lambda: phase_norm_recover(device)),
        ("blackbox", lambda: phase_blackbox(sub("p5"), n_sentences, device)),
        ("serve-reload",
         lambda: phase_serve_reload(sub("p6"), n_sentences, device)),
        ("continual-drift",
         lambda: phase_continual_drift(sub("p7"), n_sentences, device)),
        ("fleet-kill",
         lambda: phase_fleet_kill(sub("p8"), min(n_sentences, 300), device)),
        ("flaky-ingest", lambda: phase_flaky_ingest(sub("p4"))),
        ("train-preempt",
         lambda: _phase_supervisor(train_run.run_preempt_drill, sub("p9"),
                                   min(n_sentences, 200), device)),
        ("train-stall",
         lambda: _phase_supervisor(train_run.run_stall_drill, sub("p10"),
                                   min(n_sentences, 200), device)),
        ("train-crashloop",
         lambda: _phase_supervisor(train_run.run_crashloop_drill, sub("p11"),
                                   min(n_sentences, 200), device)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.chaos_run",
                                 description=__doc__.split("\n", 1)[0])
    ap.add_argument("--smoke", action="store_true", help="small corpus, fast phases")
    ap.add_argument("--workdir", default="",
                    help="working directory (default: a fresh temporary one)")
    ap.add_argument("--worker", choices=["crash", "blackbox"],
                    help="internal: run a fault-target worker leg")
    ap.add_argument("--sentences", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated phase names to run (default: every ported "
                         "phase)")
    ap.add_argument("--list", action="store_true",
                    help="print the phase names and exit")
    ap.add_argument("--device", default="cuda",
                    help="where every fit and service runs (default the card; 'cpu' "
                         "runs the plain versions)")
    args = ap.parse_args(argv)

    n_sentences = args.sentences or (300 if args.smoke else 1500)
    if args.worker == "crash":
        worker_crash(args.workdir, n_sentences, args.device)
        return 3  # unreachable
    if args.worker == "blackbox":
        worker_blackbox(args.workdir, n_sentences, args.device)
        return 3  # unreachable

    names = [name for name, _ in phase_table("", 0, args.device)]
    if args.list:
        for name in names:
            # graftlint: disable=R7 -- --list prints the phase names, one a line, and runs no drill: not the JSON mode
            print(name)
        return 0
    if args.only:
        want = [p.strip() for p in args.only.split(",") if p.strip()]
        unknown = sorted(set(want) - set(names))
        if unknown:
            log(f"[chaos] unknown phase(s): {unknown} — available: {', '.join(names)}")
            return 2
    else:
        want = [n for n in names if n not in NOT_PORTED]

    workdir = args.workdir or tempfile.mkdtemp(prefix="glint_chaos_")
    os.makedirs(workdir, exist_ok=True)
    results, seconds = {}, {}
    try:
        for name, fn in phase_table(workdir, n_sentences, args.device):
            if name not in want:
                continue
            t0 = time.monotonic()
            err = fn()
            seconds[name] = round(time.monotonic() - t0, 3)
            note = f" ({NOTES[name]})" if name in NOTES and not err else ""
            results[name] = ("PASS" + note) if not err else f"FAIL: {err}"
            log(f"[chaos] {name:18s} {results[name]} [{seconds[name]}s]")
    finally:
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    failures = sum(not r.startswith("PASS") for r in results.values())
    log(f"[chaos] {'OK' if not failures else 'FAILED'} "
        f"({len(results) - failures}/{len(results)} phases passed)")
    print(json.dumps({"ok": not failures, "device": args.device,
                      "passed": len(results) - failures, "run": len(results),
                      "phases": results, "seconds": seconds,
                      "not_run": {n: NOT_PORTED.get(n, "not asked for")
                                  for n in names if n not in results}}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
