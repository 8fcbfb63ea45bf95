"""Preemption-safe training supervision, ported from
``glint_word2vec_tpu/train/supervisor.py``: the die -> diagnose -> resume loop.

A synchronous fit dies wholesale when its process does. This module is the layer that
brings a long fit back:

- :class:`TrainingSupervisor` runs a fit (or a gang of them) as subprocesses, watches
  step progress through each child's telemetry sink, and owns the restart policy:
  resume from ``load_latest_valid`` with decorrelated-jitter backoff
  (``serve/reload.decorrelated_jitter``, the curve the serving watcher retries with),
  class every death (clean exit, preemption with an emergency checkpoint, hang, crash,
  peer death), and escalate a DETERMINISTIC crash loop (the same signature
  ``loop_window`` times in a row) up a ladder instead of restarting forever: stage 1
  sets ``GLINT_SUPERVISOR_MITIGATE=1`` for every later attempt (the worker engages the
  trainer's recovery knobs), stage 2 halts with a machine-readable ``verdict.json``.

- :class:`BeaconBoard` is the peer-death protocol of a multi-process fit: each process
  heartbeats a small file under ``<checkpoint dir>/beacons/``, and a stale beacon
  raises :class:`PeerDeathError` before the next collective would hang; a survivor
  already wedged inside one is hard-exited by the board's writer thread with
  :data:`PEER_ABORT_EXIT`. The port's trainer does not use it yet (``peer_beacon_s``
  belongs to multi-process fits and is refused by the config).

The one difference from the JAX package: a gang member that exits 0 has finished, not
died, so it does not fail the attempt and its peers are left to finish (the JAX
supervisor TERMs them, and classes the attempt a crash when the members' clean exits
land one poll apart).

Driven by ``python -m glint_word2vec_torch.train_run``.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from glint_word2vec_torch.train.checkpoint import load_latest_valid, verify_checkpoint

logger = logging.getLogger("glint_word2vec_torch")

# rc a gang member exits with when it aborts BECAUSE a peer died (the worker's
# PeerDeathError path, or the BeaconBoard watcher's hard exit): distinct from any
# Python or signal rc, so the supervisor can tell the victim from the cause
PEER_ABORT_EXIT = 43

# set by the supervisor from ladder stage 1 on; the worker honours it by engaging the
# trainer's recovery knobs
MITIGATE_ENV = "GLINT_SUPERVISOR_MITIGATE"


class PeerDeathError(RuntimeError):
    """A peer process of a multi-process fit stopped heartbeating its beacon: raised by
    the main thread's board check, so that the fit aborts instead of hanging in the
    next collective."""


class BeaconBoard:
    """Per-process liveness beacons beside the checkpoint directory.

    Each process owns ``p<index>.beacon`` and touches it every ``interval_s`` from a
    daemon writer thread. Staleness is mtime-based (the files sit on the shared
    checkpoint filesystem, the one surface every gang member can reach):

    - :meth:`check_or_raise` (the main thread, before every collective) raises
      :class:`PeerDeathError` once a peer's beacon is older than ``stale_after`` =
      6 x interval: wide enough that a GC pause or a slow flush never trips it, narrow
      enough that survivors abort long before any collective timeout;
    - the writer thread doubles as a watchdog: at 2 x ``stale_after`` it assumes the
      main thread is wedged inside the dead peer's collective and hard-exits with
      :data:`PEER_ABORT_EXIT` (``os._exit``: no exception unwinds a thread blocked in
      native code).

    A beacon file never observed is "not yet joined", not dead: gang members start at
    slightly different times. One seen and then gone counts as dead (a clean shutdown
    removes it only after the fit left its collective loop)."""

    def __init__(self, directory: str, process_index: int, num_processes: int,
                 interval_s: float, stale_factor: float = 6.0,
                 hard_factor: float = 2.0):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0 but got {interval_s}")
        self.directory = directory
        self.index = int(process_index)
        self.num = int(num_processes)
        self.interval_s = float(interval_s)
        self.stale_after = stale_factor * self.interval_s
        self.hard_after = hard_factor * self.stale_after
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seen: set = set()  # peer indices observed at least once

    def path_for(self, index: int) -> str:
        return os.path.join(self.directory, f"p{index}.beacon")

    def start(self) -> "BeaconBoard":
        os.makedirs(self.directory, exist_ok=True)
        self._touch()
        self._thread = threading.Thread(target=self._run, name=f"beacon-p{self.index}",
                                        daemon=True)
        self._thread.start()
        return self

    def _touch(self) -> None:
        # an atomic replace, so a reader never stats a half-created file; the payload
        # is for humans (staleness reads only the mtime)
        path = self.path_for(self.index)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(f"{os.getpid()} {time.time():.3f}\n")
            os.replace(tmp, path)
        except OSError as e:  # beacon I/O must never kill the fit itself
            logger.warning("beacon touch failed: %s", e)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._touch()
            dead = self.stale_peers(self.hard_after)
            if dead:
                logger.critical(
                    "peer beacon(s) %s stale past the hard limit (%.1fs) with the main "
                    "thread unresponsive: assuming it is wedged in the dead peer's "
                    "collective; hard-exiting rc=%d for the supervisor to restart the "
                    "gang", dead, self.hard_after, PEER_ABORT_EXIT)
                os._exit(PEER_ABORT_EXIT)

    def stale_peers(self, horizon_s: float) -> List[int]:
        """Peer indices whose beacon is older than ``horizon_s`` (or was seen once and
        has since vanished). Never includes self."""
        now = time.time()
        out: List[int] = []
        for i in range(self.num):
            if i == self.index:
                continue
            try:
                mtime = os.stat(self.path_for(i)).st_mtime
            except OSError:
                if i in self._seen:
                    out.append(i)  # seen, then vanished: dead
                continue           # never seen: not yet joined
            self._seen.add(i)
            if now - mtime > horizon_s:
                out.append(i)
        return out

    def check_or_raise(self) -> None:
        dead = self.stale_peers(self.stale_after)
        if dead:
            raise PeerDeathError(
                f"peer process(es) {dead} stopped heartbeating their liveness beacon "
                f"(> {self.stale_after:.1f}s stale): aborting before the next "
                "collective would hang forever")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, 2 * self.interval_s))
            self._thread = None
        try:
            os.remove(self.path_for(self.index))
        except OSError:
            pass


class _SinkTail:
    """Incremental reader of one child's telemetry JSONL sink: the last observed step,
    the current attempt's run_end status and any ``preempt`` record, the supervisor's
    only window into a child it must never block on. Byte-offset based, so it keeps
    reading the same file across attempts (each attempt appends its own run
    bracket)."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._buf = b""
        self.records = 0          # total parsed (the progress heartbeat)
        self.last_step = 0
        self.run_end_status: Optional[str] = None
        self.preempt: Optional[dict] = None

    def begin_attempt(self) -> None:
        self.run_end_status = None
        self.preempt = None

    def poll(self) -> int:
        """Parse the complete lines appended since the last poll; returns how many."""
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                data = f.read()
        except OSError:
            return 0
        if not data:
            return 0
        self._pos += len(data)
        self._buf += data
        lines = self._buf.split(b"\n")
        self._buf = lines.pop()  # a torn tail: a write still in flight
        n = 0
        for raw in lines:
            if not raw.strip():
                continue
            try:
                r = json.loads(raw)
            except (ValueError, UnicodeDecodeError):
                continue
            n += 1
            kind = r.get("kind")
            if kind == "heartbeat":
                self.last_step = max(self.last_step, int(r.get("step") or 0))
            elif kind == "preempt":
                self.preempt = r
                self.last_step = max(self.last_step, int(r.get("step") or 0))
            elif kind == "run_end":
                self.run_end_status = r.get("status")
                self.last_step = max(self.last_step, int(r.get("steps") or 0))
        self.records += n
        return n


@dataclass
class AttemptResult:
    """One attempt's post-mortem, as the supervisor saw it."""
    attempt: int
    rc: int                  # gang: the root-cause member's rc
    cls: str                 # ok | preempt | stall | crash | peer-death
    step: int                # last telemetry step observed across the gang
    signature: str = ""      # the crash-loop key ("" for ok/preempt)
    stalled_s: float = 0.0
    preempt: Optional[dict] = None   # the trainer's preempt record, if any


@dataclass
class SupervisorVerdict:
    """What :meth:`TrainingSupervisor.run` returns, and for the halting outcomes what
    lands in ``<workdir>/verdict.json`` for a caller to gate on."""
    status: str              # ok | quarantined | gave-up
    attempts: int
    final_step: int
    classification: str = ""         # e.g. "deterministic-crash-loop"
    signature: str = ""
    ladder: List[dict] = field(default_factory=list)
    history: List[dict] = field(default_factory=list)
    progress_lost_steps: int = 0     # across all observed preemptions

    def to_dict(self) -> dict:
        return {"status": self.status, "attempts": self.attempts,
                "final_step": self.final_step, "classification": self.classification,
                "signature": self.signature, "ladder": self.ladder,
                "history": self.history,
                "progress_lost_steps": self.progress_lost_steps}


class TrainingSupervisor:
    """Run a fit (a gang of fits) under restart supervision.

    ``commands``: one argv per gang member, usually one. The worker must itself resume
    from the newest checkpoint under ``checkpoint_dir`` when there is one (the
    ``load_latest_valid`` contract; ``train_run --worker fit`` is the canonical shape).

    ``child_logs``: the telemetry sink each member writes: the supervisor's progress
    window (hang detection) and its evidence (``preempt`` records, run_end statuses,
    and the ``<log>.blackbox.json`` dump that names a crash's cause).

    Classes, in priority order:

    - killed by the stall watchdog (no telemetry progress for ``stall_s``; SIGTERM
      first so the flight recorder dumps, SIGKILL after ``term_grace_s``) -> ``stall``
    - rc ``-SIGTERM`` with a ``preempted`` run_end -> ``preempt``
    - every failing member exited :data:`PEER_ABORT_EXIT` -> ``peer-death`` (the
      cause died without a story)
    - anything else -> ``crash``, with a signature of the blackbox cause (exception
      type or signal) and the last observed step bucketed to ``step_slop``.

    The same ``crash``/``stall`` signature ``loop_window`` times in a row is a
    deterministic loop: stage 1 sets ``GLINT_SUPERVISOR_MITIGATE=1`` for every later
    attempt and clears the window; a loop that survives it reaches stage 2, a halt
    with a quarantine verdict. ``max_restarts`` bounds the restarts regardless."""

    def __init__(self, commands: Sequence[Sequence[str]], workdir: str,
                 child_logs: Sequence[str], checkpoint_dir: str = "", telemetry=None,
                 max_restarts: int = 8, stall_s: float = 300.0, loop_window: int = 3,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 seed: int = 0, env: Optional[Dict[str, str]] = None,
                 env_for_attempt: Optional[Callable[[int], Dict[str, str]]] = None,
                 poll_s: float = 0.25, term_grace_s: float = 5.0, step_slop: int = 4):
        if len(commands) != len(child_logs):
            raise ValueError(
                f"{len(commands)} commands but {len(child_logs)} child logs: the "
                "supervisor needs one sink path per gang member")
        self.commands = [list(c) for c in commands]
        self.workdir = workdir
        self.child_logs = list(child_logs)
        self.checkpoint_dir = checkpoint_dir
        self._telemetry = telemetry
        self.max_restarts = int(max_restarts)
        self.stall_s = float(stall_s)
        self.loop_window = int(loop_window)
        self.poll_s = float(poll_s)
        self.term_grace_s = float(term_grace_s)
        self.step_slop = max(1, int(step_slop))
        self.env = dict(env or {})
        self.env_for_attempt = env_for_attempt
        self._backoff_base = float(backoff_base_s)
        self._backoff_cap = float(backoff_cap_s)
        self._seed = int(seed)
        # live counters (status_snapshot / supervisor_prometheus_text)
        self.attempts = 0
        self.restarts = 0
        self.stalls = 0
        self.preempts = 0
        self.ladder_stage = 0
        self.quarantined = False
        self.last_step = 0
        self.child_up = 0

    # -- telemetry -----------------------------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        if self._telemetry is not None:
            self._telemetry.emit(kind, **fields)

    def status_snapshot(self) -> dict:
        """Live gauges for a StatusServer beside the supervisor."""
        return {"up": 1, "attempts": self.attempts, "restarts": self.restarts,
                "stalls": self.stalls, "preempts": self.preempts,
                "ladder_stage": self.ladder_stage, "quarantined": self.quarantined,
                "last_step": self.last_step, "child_up": self.child_up}

    # -- the loop ------------------------------------------------------------------

    def run(self) -> SupervisorVerdict:
        self._emit("supervisor_start", commands=len(self.commands),
                   max_restarts=self.max_restarts, stall_s=self.stall_s)
        # imported here: the serving package imports the model, which imports train/
        from glint_word2vec_torch.serve.reload import decorrelated_jitter

        backoff = decorrelated_jitter(self._backoff_base, self._backoff_cap,
                                      np.random.default_rng(self._seed))
        tails = [_SinkTail(p) for p in self.child_logs]
        window: List[str] = []       # trailing failure signatures
        history: List[dict] = []
        ladder: List[dict] = []
        lost = 0
        attempt = 0
        while True:
            if attempt > 0:
                self.restarts += 1
                delay = float(next(backoff))
                self._emit("supervisor_restart", attempt=attempt,
                           backoff_s=round(delay, 4), resume_step=self._resume_step())
                time.sleep(delay)
            res = self._run_attempt(attempt, tails)
            self.attempts = attempt + 1
            self.last_step = max(self.last_step, res.step)
            history.append({"attempt": res.attempt, "rc": res.rc, "cls": res.cls,
                            "step": res.step, "signature": res.signature})
            self._emit("supervisor_exit", attempt=res.attempt, rc=res.rc, cls=res.cls,
                       step=res.step)
            if res.cls == "ok":
                return self._finish(SupervisorVerdict(
                    status="ok", attempts=self.attempts, final_step=self.last_step,
                    history=history, progress_lost_steps=lost))
            if res.cls == "preempt":
                self.preempts += 1
                if res.preempt is not None and not res.preempt.get("saved"):
                    lost += int(res.preempt.get("steps_since_save") or 0)
                # an eviction is external, not a bug: it never feeds the loop window
            elif res.cls != "peer-death":
                # (a peer death restarts the whole gang from the last verified
                # checkpoint; its cause died story-less, so it matches no signature)
                if res.cls == "stall":
                    self.stalls += 1
                window = (window + [res.signature])[-self.loop_window:]
                if len(window) == self.loop_window and len(set(window)) == 1:
                    # the same failure at the same place loop_window times running
                    self.ladder_stage += 1
                    ladder.append({"stage": self.ladder_stage, "attempt": attempt,
                                   "signature": res.signature})
                    self._emit("supervisor_quarantine", signature=res.signature,
                               attempts=self.attempts, ladder_stage=self.ladder_stage)
                    if self.ladder_stage == 1:
                        logger.warning("deterministic failure loop %r: engaging "
                                       "mitigations (%s=1) and retrying",
                                       res.signature, MITIGATE_ENV)
                        self.env[MITIGATE_ENV] = "1"
                        window.clear()
                    else:
                        self.quarantined = True
                        return self._finish(SupervisorVerdict(
                            status="quarantined", attempts=self.attempts,
                            final_step=self.last_step,
                            classification="deterministic-crash-loop",
                            signature=res.signature, ladder=ladder, history=history,
                            progress_lost_steps=lost))
            if attempt >= self.max_restarts:
                return self._finish(SupervisorVerdict(
                    status="gave-up", attempts=self.attempts, final_step=self.last_step,
                    classification="restart-budget-exhausted", signature=res.signature,
                    ladder=ladder, history=history, progress_lost_steps=lost))
            attempt += 1

    def _finish(self, verdict: SupervisorVerdict) -> SupervisorVerdict:
        self._emit("supervisor_end", status=verdict.status, attempts=verdict.attempts,
                   final_step=verdict.final_step)
        if verdict.status != "ok":
            # the machine-readable halt verdict a caller gates on
            os.makedirs(self.workdir, exist_ok=True)
            path = os.path.join(self.workdir, "verdict.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(verdict.to_dict(), f, indent=2, sort_keys=True)
            logger.warning("supervisor verdict %r written to %s", verdict.status, path)
        return verdict

    def _resume_step(self) -> int:
        """Step of the checkpoint the next attempt will resume from (0 = cold start).
        It verifies the publish, so a preemption's emergency save is audited before
        anything trusts it."""
        if not self.checkpoint_dir:
            return 0
        try:
            meta = verify_checkpoint(load_latest_valid(self.checkpoint_dir))
        except (OSError, ValueError) as e:  # nothing verifies: a cold start
            logger.info("no resumable checkpoint yet (%s)", e)
            return 0
        return int((meta.get("train_state") or {}).get("global_step") or 0)

    # -- one attempt ---------------------------------------------------------------

    def _attempt_env(self, attempt: int) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.env)
        if self.env_for_attempt is not None:
            env.update(self.env_for_attempt(attempt))
        return env

    def _run_attempt(self, attempt: int, tails: List[_SinkTail]) -> AttemptResult:
        env = self._attempt_env(attempt)
        for t in tails:
            t.poll()           # drain the previous attempts' records
            t.begin_attempt()
        procs = [subprocess.Popen(cmd, env=env) for cmd in self.commands]
        self.child_up = len(procs)
        killed_by_us = [False] * len(procs)
        stall_fired = False
        stalled_s = 0.0
        last_activity = time.monotonic()
        while True:
            rcs = [p.poll() for p in procs]
            self.child_up = sum(rc is None for rc in rcs)
            if sum(t.poll() for t in tails):
                last_activity = time.monotonic()
                self.last_step = max(self.last_step, max(t.last_step for t in tails))
            if not self.child_up:
                break
            if len(procs) > 1 and any(rc not in (None, 0) for rc in rcs):
                # the gang rule: one death fails the whole attempt; the survivors are
                # TERMed (eligible for an emergency checkpoint) rather than left to
                # find the stale beacon one collective later
                self._kill(procs, killed_by_us)
                break
            silence = time.monotonic() - last_activity
            if silence > self.stall_s:
                stall_fired = True
                stalled_s = silence
                last = max((t.last_step for t in tails), default=0)
                self._emit("supervisor_stall", attempt=attempt, last_step=last,
                           stalled_s=round(silence, 3))
                logger.warning(
                    "no telemetry progress for %.1fs (> stall_s=%.1fs) at step %d: "
                    "requesting a flight-recorder dump (SIGTERM) then killing",
                    silence, self.stall_s, last)
                self._kill(procs, killed_by_us)
                break
            time.sleep(self.poll_s)
        rcs = [p.wait() for p in procs]
        self.child_up = 0
        for t in tails:
            t.poll()
        step = max((t.last_step for t in tails), default=0)
        return self._classify(attempt, rcs, killed_by_us, stall_fired, stalled_s, tails,
                              step)

    def _kill(self, procs, killed_by_us) -> None:
        """SIGTERM the live members (the diagnostic request: the fit's handler dumps
        its flight recorder, and with checkpoint_on_preempt drains an emergency save),
        then SIGKILL whatever outlives the grace: a stalled process is wedged by
        definition and may never honour the TERM."""
        for i, p in enumerate(procs):
            if p.poll() is None:
                killed_by_us[i] = True
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + self.term_grace_s
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.05))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                except OSError:
                    pass

    def _classify(self, attempt: int, rcs: List[int], killed_by_us: List[bool],
                  stall_fired: bool, stalled_s: float, tails: List[_SinkTail],
                  step: int) -> AttemptResult:
        bucket = step - step % self.step_slop
        if stall_fired:
            return AttemptResult(attempt=attempt, rc=min(rcs), cls="stall", step=step,
                                 signature=f"stall@s{bucket}", stalled_s=stalled_s)
        if all(rc == 0 for rc in rcs):
            return AttemptResult(attempt=attempt, rc=0, cls="ok", step=step)
        # the root cause: the first member that failed on its OWN (not TERMed by the
        # gang rule, not a peer-death victim)
        own = [(i, rc) for i, rc in enumerate(rcs)
               if rc != 0 and not killed_by_us[i] and rc != PEER_ABORT_EXIT]
        if not own:
            if PEER_ABORT_EXIT in rcs:
                return AttemptResult(attempt=attempt, rc=PEER_ABORT_EXIT,
                                     cls="peer-death", step=step)
            own = [(i, rc) for i, rc in enumerate(rcs) if rc != 0]
        idx, rc = own[0]
        tail = tails[idx]
        if (rc == -signal.SIGTERM and not killed_by_us[idx]
                and tail.run_end_status == "preempted"):
            return AttemptResult(attempt=attempt, rc=rc, cls="preempt", step=step,
                                 preempt=tail.preempt)
        cause = self._blackbox_cause(self.child_logs[idx]) or f"rc{rc}"
        return AttemptResult(attempt=attempt, rc=rc, cls="crash", step=step,
                             signature=f"crash:{cause}@s{bucket}")

    @staticmethod
    def _blackbox_cause(log_path: str) -> str:
        """The crash-loop signature's cause half, from the dump the dying fit left
        beside its sink (``<log>.blackbox.json``, obs/blackbox.py)."""
        try:
            with open(log_path + ".blackbox.json", "r", encoding="utf-8") as f:
                cause = json.load(f).get("cause") or {}
        except (OSError, ValueError):
            return ""
        kind = cause.get("kind") or ""
        detail = cause.get("type") or cause.get("signal") or ""
        return f"{kind}:{detail}" if detail else str(kind)
