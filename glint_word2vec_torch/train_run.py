"""Supervised training CLI, ported from ``tools/train_run.py``: run a fit under the
:class:`~glint_word2vec_torch.train.supervisor.TrainingSupervisor`'s die -> diagnose ->
resume loop (preemption-deadline checkpoints, decorrelated-jitter restarts, hang
detection, crash-loop quarantine, gang restarts on a peer's death).

Stdout carries exactly one JSON line; progress goes to stderr.

Usage::

    # supervise a training command (a gang: repeat --cmd/--log); --cmd is split as a
    # shell would split it (shlex)
    python -m glint_word2vec_torch.train_run --cmd "python my_fit.py" --log run.jsonl \\
        --checkpoint-dir ckpts [--max-restarts N] [--stall-s S] [--loop-window W] \\
        [--workdir DIR] [--telemetry sup.jsonl] [--status-port P]

    # the supervisor drills, on the card unless --device cpu: a SIGTERM'd fit saves
    # within its deadline and resumes to an uninterrupted twin's final step and purity
    # gate; an injected in-step stall is detected, killed and resumed; a
    # deterministic crash loop is quarantined with a verdict in bounded attempts
    python -m glint_word2vec_torch.train_run --smoke [--device cpu]
    python -m glint_word2vec_torch.train_run --drill preempt|stall|crashloop

Exit code 0 iff the supervised run ended "ok" (or every assertion of the drills
passed).
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import shutil
import sys
import tempfile

# the directory holding the package, for the drills' worker processes
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the drills' corpus and config ----------------------------------------------------

# two co-occurrence clusters that never share a sentence: the purity gate only needs
# nearest neighbours to stay inside their own cluster, a structure even a
# two-iteration toy fit learns, and one that a resume which lost progress (or trained
# the wrong batches) breaks
_CLUSTER_A = [f"a{i}" for i in range(15)]
_CLUSTER_B = [f"b{i}" for i in range(15)]


def cluster_sentences(n_sentences: int, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_sentences):
        pool = _CLUSTER_A if s % 2 == 0 else _CLUSTER_B
        out.append([pool[j] for j in rng.integers(0, len(pool), 20)])
    return out


def drill_config(**kw):
    from glint_word2vec_torch.config import Word2VecConfig
    return Word2VecConfig(
        vector_size=16, pairs_per_batch=128, window=3, num_iterations=2,
        steps_per_dispatch=2, heartbeat_every_steps=2, subsample_ratio=0.0,
        prefetch_chunks=0, seed=1, min_count=1, **kw)


def _cluster_purity(words, syn0) -> float:
    """Mean fraction of each probe word's top-4 cosine neighbours that sit in its own
    cluster."""
    import numpy as np
    idx = {w: i for i, w in enumerate(words)}
    emb = np.asarray(syn0, np.float64)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    fracs = []
    for cluster in (_CLUSTER_A, _CLUSTER_B):
        for probe in cluster[:3]:
            i = idx[probe]
            sims = emb @ emb[i]
            sims[i] = -np.inf
            top = np.argsort(-sims)[:4]
            fracs.append(sum(1 for j in top if words[j] in cluster) / 4.0)
    return float(np.mean(fracs))


# the stall drill's stall_s: silence past it, counted from the worker's spawn, is a hang
STALL_S = 30.0


# -- the worker -----------------------------------------------------------------------

def worker_fit(workdir: str, n_sentences: int, device: str) -> int:
    """One supervised fit attempt: resume from the newest verified checkpoint under
    ``<workdir>/ckpt`` when there is one, else fit fresh (the ``load_latest_valid``
    contract the supervisor restarts around). Honours the mitigation ladder
    (``GLINT_SUPERVISOR_MITIGATE=1`` engages ``norm_watch="recover"``) and exits
    PEER_ABORT_EXIT on a peer-death abort."""
    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.train.checkpoint import load_latest_valid
    from glint_word2vec_torch.train.supervisor import (
        MITIGATE_ENV, PEER_ABORT_EXIT, PeerDeathError)

    ckdir = os.path.join(workdir, "ckpt")
    os.makedirs(ckdir, exist_ok=True)
    sentences = cluster_sentences(n_sentences, seed=3)
    mitigate = os.environ.get(MITIGATE_ENV) == "1"
    overrides = {"norm_watch": "recover"} if mitigate else {}
    note = " (mitigations engaged)" if mitigate else ""
    try:
        existing = load_latest_valid(ckdir)
    except FileNotFoundError:
        existing = None
    try:
        if existing is not None:
            log(f"[worker] resuming from {existing}{note}")
            Word2Vec.resume(existing, sentences, checkpoint_every_steps=4,
                            config_overrides=overrides or None, device=device)
        else:
            log(f"[worker] fresh fit{note}")
            cfg = drill_config(telemetry_path=os.path.join(workdir, "run.jsonl"),
                               checkpoint_on_preempt=True, **overrides)
            Word2Vec(cfg, device=device).fit(
                sentences, checkpoint_path=os.path.join(ckdir, "model"),
                checkpoint_every_steps=4)
    except PeerDeathError as e:
        log(f"[worker] peer death: {e}")
        return PEER_ABORT_EXIT
    return 0


# -- the drills' supervision ----------------------------------------------------------

def _drill_supervisor(workdir: str, n_sentences: int, device: str, telemetry, **kw):
    from glint_word2vec_torch.train.supervisor import TrainingSupervisor
    cmd = [sys.executable, "-m", "glint_word2vec_torch.train_run", "--worker", "fit",
           "--workdir", workdir, "--sentences", str(n_sentences), "--device", device]
    path = os.pathsep.join(p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)
    env = {**kw.pop("env", {}), "PYTHONPATH": path}
    return TrainingSupervisor(
        [cmd], workdir, child_logs=[os.path.join(workdir, "run.jsonl")],
        checkpoint_dir=os.path.join(workdir, "ckpt"), telemetry=telemetry,
        poll_s=0.1, term_grace_s=2.0, backoff_base_s=0.02, backoff_cap_s=0.2, seed=7,
        env=env, **kw)


def _final_header(workdir: str):
    from glint_word2vec_torch.train.checkpoint import load_latest_valid, load_model_header
    return load_model_header(load_latest_valid(os.path.join(workdir, "ckpt")))


def _supervise(workdir: str, n_sentences: int, device: str, **kw):
    from glint_word2vec_torch.obs.sink import TelemetrySink
    sink = TelemetrySink(os.path.join(workdir, "supervisor.jsonl"))
    try:
        return _drill_supervisor(workdir, n_sentences, device, sink, **kw).run()
    finally:
        sink.close()


def _records(path: str, kind: str) -> list:
    with open(path, encoding="utf-8") as f:
        return [r for r in map(json.loads, f) if r.get("kind") == kind]


def run_preempt_drill(workdir: str, n_sentences: int = 200, device: str = "cuda") -> dict:
    """SIGTERM mid-fit (the scripted crash_at_step, which the handler defers into the
    preemption-deadline path) -> emergency checkpoint published and verified with at
    most one dispatch chunk lost -> the supervisor resumes -> the final model reaches
    the uninterrupted twin's final step and passes the same purity gate."""
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.train.checkpoint import load_model
    from glint_word2vec_torch.train.trainer import Trainer

    # the uninterrupted twin, in process: same corpus and config seed
    sentences = cluster_sentences(n_sentences, seed=3)
    vocab = build_vocab(sentences, min_count=1)
    twin = Trainer(drill_config(), vocab, device=device)
    twin.fit(encode_sentences(sentences, vocab, 1000))
    twin_step = int(twin.global_step)
    twin_purity = _cluster_purity(vocab.words,
                                  twin.unpadded_params().syn0.float().cpu().numpy())
    log(f"[preempt] twin finished: step={twin_step} purity={twin_purity:.3f}")
    assert twin_purity >= 0.75, f"twin purity {twin_purity:.3f} too weak to gate on"

    def fault_env(attempt: int) -> dict:
        if attempt == 0:
            # a deterministic preemption: the scripted self-SIGTERM fires in
            # _finish_round, the fit's handler defers it, and the same round's tail
            # drains the emergency save
            return {"GLINT_FAULT_CRASH_AT_STEP": "6", "GLINT_FAULT_CRASH_SIGNAL": "TERM"}
        return {"GLINT_FAULT_CRASH_AT_STEP": ""}

    verdict = _supervise(workdir, n_sentences, device, max_restarts=3, stall_s=60.0,
                         env_for_attempt=fault_env)
    assert verdict.status == "ok", f"supervised run failed: {verdict}"
    assert verdict.attempts == 2, \
        f"expected exactly 2 attempts (preempt + resume), got {verdict}"
    first = verdict.history[0]
    assert first["cls"] == "preempt", \
        f"first attempt classed {first['cls']!r}, want preempt: {verdict}"
    pre = _records(os.path.join(workdir, "run.jsonl"), "preempt")
    assert pre, "no preempt record in the worker sink"
    pre = pre[-1]
    assert pre["saved"], f"emergency checkpoint missed the deadline: {pre}"
    # at most one dispatch chunk (steps_per_dispatch=2) of progress at risk
    assert pre["steps_since_save"] <= 2, f"lost too much progress: {pre}"
    ts = _final_header(workdir)["train_state"]
    assert ts.finished, f"final checkpoint not finished: {ts}"
    assert int(ts.global_step) == twin_step, \
        f"resumed final step {ts.global_step} != twin {twin_step}"
    data = load_model(os.path.join(workdir, "ckpt", "model"))
    purity = _cluster_purity(data["words"], data["syn0"])
    gate = min(0.75, twin_purity)
    assert purity >= gate, f"resumed purity {purity:.3f} under the twin's gate {gate:.3f}"
    log(f"[preempt] PASS: resumed to step {ts.global_step}, purity {purity:.3f} "
        f"(twin {twin_purity:.3f})")
    return {"ok": True, "twin_step": twin_step, "final_step": int(ts.global_step),
            "purity": round(purity, 4), "twin_purity": round(twin_purity, 4),
            "preempt": {k: pre[k] for k in ("step", "saved", "steps_since_save")},
            "attempts": verdict.attempts}


def run_stall_drill(workdir: str, n_sentences: int = 200, device: str = "cuda") -> dict:
    """An injected in-step stall (faults.maybe_stall) wedges the fit; the supervisor's
    hang watchdog must detect the silence within 2 x stall_s, capture a diagnostic
    (SIGTERM -> flight-recorder dump, then SIGKILL), count it as a failure, and resume
    to completion."""
    def fault_env(attempt: int) -> dict:
        if attempt == 0:
            return {"GLINT_FAULT_STALL_AT_STEP": "6", "GLINT_FAULT_STALL_S": "120"}
        return {"GLINT_FAULT_STALL_AT_STEP": ""}

    # the horizon sits above the worker's start-up (imports, the card's context, the
    # vocabulary) before its first telemetry record: the JAX drill's 2 s does not
    stall_s = STALL_S
    verdict = _supervise(workdir, n_sentences, device, max_restarts=3, stall_s=stall_s,
                         env_for_attempt=fault_env)
    assert verdict.status == "ok", f"supervised run failed: {verdict}"
    assert verdict.attempts == 2, \
        f"expected exactly 2 attempts (stall + resume), got {verdict}"
    first = verdict.history[0]
    assert first["cls"] == "stall", \
        f"first attempt classed {first['cls']!r}, want stall: {verdict}"
    stalls = _records(os.path.join(workdir, "supervisor.jsonl"), "supervisor_stall")
    assert stalls, "no supervisor_stall record"
    stall_rec = stalls[-1]
    assert stall_rec["stalled_s"] <= 2 * stall_s + 1.0, \
        f"stall detected too late: {stall_rec}"
    assert os.path.exists(os.path.join(workdir, "run.jsonl.blackbox.json")), \
        "the stalled child left no flight-recorder dump (the TERM diagnostic was lost)"
    ts = _final_header(workdir)["train_state"]
    assert ts.finished, "the resumed run did not finish"
    log(f"[stall] PASS: detected after {stall_rec['stalled_s']:.1f}s at step "
        f"{stall_rec['last_step']}, resumed to completion")
    return {"ok": True, "stalled_s": stall_rec["stalled_s"],
            "last_step": stall_rec["last_step"], "final_step": int(ts.global_step),
            "attempts": verdict.attempts}


def run_crashloop_drill(workdir: str, n_sentences: int = 200,
                        device: str = "cuda") -> dict:
    """The same deterministic crash (SIGKILL at a scripted step) on every attempt: the
    supervisor must class the repeated (cause, step) signature as a deterministic
    loop, walk the ladder (stage 1 mitigations, stage 2 halt), and quarantine with a
    machine-readable verdict in bounded attempts."""
    max_restarts = 6
    verdict = _supervise(workdir, n_sentences, device, max_restarts=max_restarts,
                         stall_s=60.0, loop_window=2,
                         env={"GLINT_FAULT_CRASH_AT_STEP": "6",
                              "GLINT_FAULT_CRASH_SIGNAL": "KILL"})
    assert verdict.status == "quarantined", \
        f"deterministic loop not quarantined: {verdict}"
    assert verdict.classification == "deterministic-crash-loop", \
        f"wrong classification: {verdict}"
    assert verdict.attempts <= max_restarts, \
        f"quarantine took {verdict.attempts} attempts (> {max_restarts})"
    stages = [rung["stage"] for rung in verdict.ladder]
    assert stages == [1, 2], f"the ladder did not walk 1 -> 2: {verdict.ladder}"
    vpath = os.path.join(workdir, "verdict.json")
    assert os.path.exists(vpath), "no machine-readable verdict.json"
    with open(vpath, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["status"] == "quarantined" and doc["signature"], \
        f"verdict.json incomplete: {doc}"
    log(f"[crashloop] PASS: quarantined {doc['signature']!r} after "
        f"{verdict.attempts} attempts")
    return {"ok": True, "attempts": verdict.attempts, "signature": doc["signature"],
            "ladder": stages}


DRILLS = {"preempt": run_preempt_drill, "stall": run_stall_drill,
          "crashloop": run_crashloop_drill}


def run_smoke(workdir: str, n_sentences: int = 200, device: str = "cuda") -> dict:
    """All three drills, one report; every supervisor sink must validate against the
    port's schema (the supervisor_* kinds)."""
    from glint_word2vec_torch.obs.schema import validate_file
    report = {}
    for name, fn in DRILLS.items():
        sub = os.path.join(workdir, name)
        os.makedirs(sub, exist_ok=True)
        log(f"[smoke] --- {name} drill ---")
        report[name] = fn(sub, n_sentences, device)
    for name in DRILLS:
        v = validate_file(os.path.join(workdir, name, "supervisor.jsonl"))
        assert v["ok"], f"{name} supervisor sink schema-invalid: {v['errors'][:3]}"
    report["ok"] = all(r.get("ok") for r in report.values())
    return report


# -- the generic supervised run ---------------------------------------------------------

def run_supervised(args) -> dict:
    from glint_word2vec_torch.obs.sink import TelemetrySink
    from glint_word2vec_torch.obs.statusd import StatusServer, supervisor_prometheus_text
    from glint_word2vec_torch.train.supervisor import TrainingSupervisor
    workdir = args.workdir or tempfile.mkdtemp(prefix="glint_train_run_")
    os.makedirs(workdir, exist_ok=True)
    sink = TelemetrySink(args.telemetry) if args.telemetry else None
    statusd = None
    try:
        sup = TrainingSupervisor(
            [shlex.split(c) for c in args.cmd], workdir, child_logs=args.log,
            checkpoint_dir=args.checkpoint_dir, telemetry=sink,
            max_restarts=args.max_restarts, stall_s=args.stall_s,
            loop_window=args.loop_window, seed=args.seed)
        if args.status_port:
            statusd = StatusServer(args.status_port, sup.status_snapshot,
                                   metrics_fn=supervisor_prometheus_text).start()
        verdict = sup.run()
    finally:
        if statusd is not None:
            statusd.stop()
        if sink is not None:
            sink.close()
    return {"ok": verdict.status == "ok", "mode": "supervise", **verdict.to_dict()}


def main(argv=None) -> int:
    from glint_word2vec_torch.config import Word2VecConfig
    defaults = Word2VecConfig()
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--cmd", action="append", default=[],
                    help="training command to supervise (repeat for a multi-process "
                         "gang)")
    ap.add_argument("--log", action="append", default=[],
                    help="telemetry sink path the matching --cmd writes (the "
                         "supervisor's progress and classification window)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="directory load_latest_valid resumes from (and the restart "
                         "audit verifies)")
    ap.add_argument("--telemetry", default="",
                    help="write supervisor_* telemetry records here")
    ap.add_argument("--status-port", type=int, default=0,
                    help="> 0: serve glint_supervisor_* gauges on 127.0.0.1:<port>")
    ap.add_argument("--max-restarts", type=int, default=defaults.supervisor_max_restarts)
    ap.add_argument("--stall-s", type=float, default=defaults.supervisor_stall_s)
    ap.add_argument("--loop-window", type=int, default=defaults.supervisor_loop_window)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="run the three supervisor drills in a temporary directory")
    ap.add_argument("--drill", choices=sorted(DRILLS), help="run one drill")
    ap.add_argument("--worker", choices=["fit"],
                    help="internal: one supervised fit attempt of the drills")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--sentences", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="where the drills' fits run: the card unless 'cpu' (passed "
                         "through to the worker)")
    args = ap.parse_args(argv)
    # the checks the JAX config makes of the same three knobs
    Word2VecConfig(supervisor_max_restarts=args.max_restarts,
                   supervisor_stall_s=args.stall_s,
                   supervisor_loop_window=args.loop_window)

    if args.worker == "fit":
        return worker_fit(args.workdir, args.sentences, args.device)

    if args.smoke or args.drill:
        from glint_word2vec_torch.device import resolve_device
        resolve_device(args.device)  # no card: refuse here, before any drill
        workdir = args.workdir or tempfile.mkdtemp(prefix="glint_sup_")
        os.makedirs(workdir, exist_ok=True)
        try:
            if args.drill:
                out = DRILLS[args.drill](workdir, args.sentences, args.device)
            else:
                out = run_smoke(workdir, args.sentences, args.device)
        except AssertionError as e:
            out = {"ok": False, "error": str(e)}
        finally:
            if not args.workdir:
                shutil.rmtree(workdir, ignore_errors=True)
    else:
        if not args.cmd:
            ap.error("pass --cmd (with --log per command) to supervise a run, or "
                     "--smoke / --drill for the drills")
        if len(args.log) != len(args.cmd):
            ap.error("need exactly one --log per --cmd")
        out = run_supervised(args)
    print(json.dumps(out))
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
