"""Deterministic fault injection and bounded retry, ported from
``glint_word2vec_tpu/train/faults.py``.

The single switchboard the runtime consults at each fault point, so that a test can
script "crash during the second checkpoint swap" or "fail the first two ingest reads"
without flaky kill timing. Fault points (environment for subprocess tests,
:func:`configure` in process; all off by default and free when off), with the JAX
package's names:

- ``GLINT_FAULT_CRASH_AT_STEP=N``: kill this process at the end of the round that
  reaches global step >= N (``Trainer._finish_round``). ``GLINT_FAULT_CRASH_SIGNAL=
  TERM|INT|KILL`` (default KILL) picks the signal; TERM is the catchable first warning
  of a preemption, the path of the flight recorder's SIGTERM hook.
- ``GLINT_FAULT_CRASH_POINT=name[@k]``: kill at the k-th (default first) pass through
  the named point. A dense checkpoint save has ``save:arrays-written`` (data files
  staged, no metadata), ``save:staged`` (the staging directory complete, no swap) and
  ``save:swap`` (the previous checkpoint renamed aside, its replacement not in place:
  the torn window).
- ``GLINT_FAULT_CORRUPT_CKPT_BYTES=N``: after every completed save, flip N bytes of one
  array file at offsets derived from its size (bit rot the digests must catch).
- ``GLINT_FAULT_FAIL_INGEST_FIRST_N=N``: the first N guarded ingest I/O attempts raise
  :class:`InjectedFault` (an ``OSError``), exercising the retry wrappers of ``data/``.
- ``GLINT_FAULT_NAN_AT_STEP=N``: the trainer writes NaN into ``syn0[0, 0]`` at the
  first round whose global step reaches N (once).
- ``GLINT_FAULT_STALL_AT_STEP=N`` (``GLINT_FAULT_STALL_S``, default 30): the trainer
  sleeps inside the round that reaches step N (once), in sub-second slices so that a
  signal handler still runs.
- ``GLINT_FAULT_SCALE_PARAMS_AT_STEP=N`` (``GLINT_FAULT_SCALE_PARAMS_FACTOR``, default
  1e6; ``GLINT_FAULT_SCALE_PARAMS_TIMES``, default 1): the trainer multiplies both
  matrices by the factor at the first round reaching step N, and at each later round
  until the count is spent: a finite norm blowup, the norm watchdog's channel.

SIGKILL is deliberate: no ``finally``, no atexit, no flush, as an OOM kill.
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
import signal
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

logger = logging.getLogger("glint_word2vec_torch")

T = TypeVar("T")


class InjectedFault(OSError):
    """A scripted fault: an OSError, so the retry paths treat it as a transient I/O
    failure."""


class NonFiniteParamsError(RuntimeError):
    """The parameters went non-finite under ``nonfinite_policy='halt'`` (or
    ``'rollback'`` found no snapshot left, or spent its budget)."""


class NormBlowupError(RuntimeError):
    """The norm watchdog fired under ``norm_watch='halt'`` (or ``'recover'`` spent its
    budget): a finite norm blowup, which the non-finite guard cannot see."""


@dataclasses.dataclass
class FaultPlan:
    """One scripted fault schedule; zeros and empties = no faults."""

    crash_at_step: int = 0
    crash_signal: str = "KILL"     # KILL, TERM (catchable) or INT
    crash_point: str = ""          # e.g. "save:swap" or "save:swap@2"
    corrupt_checkpoint_bytes: int = 0
    fail_ingest_first_n: int = 0
    nan_at_step: int = 0
    scale_params_at_step: int = 0
    stall_at_step: int = 0
    stall_s: float = 30.0
    scale_params_factor: float = 1e6
    scale_params_times: int = 1    # rounds the scale injection fires


_override: Optional[FaultPlan] = None
_counters: dict = {}


def configure(**kwargs) -> FaultPlan:
    """Install an in-process fault plan (tests); it overrides the environment until
    :func:`reset`. Resets the hit counters."""
    global _override
    _override = FaultPlan(**kwargs)
    _counters.clear()
    return _override


def reset() -> None:
    """Clear the in-process plan and the hit counters (the environment still
    applies)."""
    global _override
    _override = None
    _counters.clear()


def _env_int(name: str) -> int:
    v = os.environ.get(name, "")
    try:
        return int(v) if v else 0
    except ValueError:
        logger.warning("ignoring non-integer %s=%r", name, v)
        return 0


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    try:
        return float(v) if v else default
    except ValueError:
        logger.warning("ignoring non-float %s=%r", name, v)
        return default


def active_plan() -> FaultPlan:
    """The in-process plan if set, else the environment's (read at every call: the
    fault points sit on cold paths)."""
    if _override is not None:
        return _override
    return FaultPlan(
        crash_at_step=_env_int("GLINT_FAULT_CRASH_AT_STEP"),
        crash_signal=os.environ.get("GLINT_FAULT_CRASH_SIGNAL", "KILL"),
        crash_point=os.environ.get("GLINT_FAULT_CRASH_POINT", ""),
        corrupt_checkpoint_bytes=_env_int("GLINT_FAULT_CORRUPT_CKPT_BYTES"),
        fail_ingest_first_n=_env_int("GLINT_FAULT_FAIL_INGEST_FIRST_N"),
        nan_at_step=_env_int("GLINT_FAULT_NAN_AT_STEP"),
        stall_at_step=_env_int("GLINT_FAULT_STALL_AT_STEP"),
        stall_s=_env_float("GLINT_FAULT_STALL_S", 30.0),
        scale_params_at_step=_env_int("GLINT_FAULT_SCALE_PARAMS_AT_STEP"),
        scale_params_factor=_env_float("GLINT_FAULT_SCALE_PARAMS_FACTOR", 1e6),
        scale_params_times=max(_env_int("GLINT_FAULT_SCALE_PARAMS_TIMES"), 1),
    )


def _crash_now(reason: str) -> None:
    # stderr directly: logging handlers may buffer, and after SIGKILL nothing runs
    sig = {"KILL": signal.SIGKILL, "TERM": signal.SIGTERM,
           "INT": signal.SIGINT}.get(active_plan().crash_signal.upper(), signal.SIGKILL)
    os.write(2, f"[glint-fault] SIG{signal.Signals(sig).name[3:]}: {reason}\n".encode())
    os.kill(os.getpid(), sig)


def crash_at_step(global_step: int) -> None:
    """Trainer hook: die when the run reaches the scripted global step."""
    p = active_plan()
    if p.crash_at_step and global_step >= p.crash_at_step:
        _crash_now(f"crash_at_step {p.crash_at_step} (global_step {global_step})")


def _parse_point(spec: str) -> Tuple[str, int]:
    if "@" in spec:
        name, _, nth = spec.rpartition("@")
        try:
            return name, max(1, int(nth))
        except ValueError:
            return spec, 1
    return spec, 1


def crash_point(name: str) -> None:
    """Named crash point (e.g. inside a checkpoint save): dies on the k-th pass when
    the plan scripts ``name@k`` (default k=1)."""
    p = active_plan()
    if not p.crash_point:
        return
    want, nth = _parse_point(p.crash_point)
    if want != name:
        return
    hits = _counters.get(("point", name), 0) + 1
    _counters[("point", name)] = hits
    if hits >= nth:
        _crash_now(f"crash_point {name} (hit {hits})")


def take_nan_injection(global_step: int) -> bool:
    """Trainer hook: True once, at the first round whose global step reaches the
    scripted ``nan_at_step``."""
    p = active_plan()
    if not p.nan_at_step or global_step < p.nan_at_step:
        return False
    if _counters.get("nan_done"):
        return False
    _counters["nan_done"] = True
    logger.warning("injecting NaN into params at global step %d (scripted "
                   "nan_at_step=%d)", global_step, p.nan_at_step)
    return True


def maybe_stall(global_step: int) -> float:
    """Trainer hook: sleep ``stall_s`` seconds at the first round whose global step
    reaches ``stall_at_step`` (once per process); returns the stall (0.0 = did not
    fire). The sleep is sliced, so a signal handler that interrupts it returns to the
    stall: the round stays wedged for the whole duration, as a hung collective."""
    p = active_plan()
    if not p.stall_at_step or global_step < p.stall_at_step:
        return 0.0
    if _counters.get("stall_done"):
        return 0.0
    _counters["stall_done"] = True
    logger.warning("injecting %.1fs in-step stall at global step %d (scripted "
                   "stall_at_step=%d)", p.stall_s, global_step, p.stall_at_step)
    end = time.monotonic() + p.stall_s
    while True:
        left = end - time.monotonic()
        if left <= 0:
            break
        time.sleep(min(left, 0.25))
    return float(p.stall_s)


def take_scale_injection(global_step: int) -> float:
    """Trainer hook: the scripted factor at the first round whose global step reaches
    ``scale_params_at_step`` and, with ``scale_params_times > 1``, at each later round
    until the count is spent; 0.0 otherwise."""
    p = active_plan()
    if not p.scale_params_at_step or global_step < p.scale_params_at_step:
        return 0.0
    done = _counters.get("scale_done", 0)
    if done >= max(p.scale_params_times, 1):
        return 0.0
    _counters["scale_done"] = done + 1
    logger.warning(
        "injecting finite param blowup (x%g) at global step %d (scripted "
        "scale_params_at_step=%d, firing %d/%d)", p.scale_params_factor, global_step,
        p.scale_params_at_step, done + 1, max(p.scale_params_times, 1))
    return float(p.scale_params_factor)


def maybe_fail_ingest(what: str) -> None:
    """Ingest-I/O hook: raise :class:`InjectedFault` for the first
    ``fail_ingest_first_n`` guarded attempts."""
    p = active_plan()
    if not p.fail_ingest_first_n:
        return
    n = _counters.get("ingest", 0)
    if n >= p.fail_ingest_first_n:
        return
    _counters["ingest"] = n + 1
    raise InjectedFault(f"injected ingest fault {n + 1}/{p.fail_ingest_first_n}: {what}")


def corrupt_checkpoint(path: str) -> None:
    """Post-save hook: flip ``corrupt_checkpoint_bytes`` bytes of one array file of
    the checkpoint at ``path``, at offsets that are a function of the file's size (the
    JAX package's, so a scripted corruption is the same in both)."""
    n = active_plan().corrupt_checkpoint_bytes
    if not n:
        return
    target = None
    for cand in ("syn0.npy", "syn1.npy", "counts.npy"):
        if os.path.exists(os.path.join(path, cand)):
            target = os.path.join(path, cand)
            break
    if target is None:
        shards = os.path.join(path, "syn0.shards")
        if os.path.isdir(shards):
            names = sorted(f for f in os.listdir(shards) if f.endswith(".npy"))
            if names:
                target = os.path.join(shards, names[0])
    if target is None:
        logger.warning("corrupt_checkpoint: no array file under %r", path)
        return
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        for i in range(n):
            # inside the payload (past the ~128-byte .npy header)
            off = 128 + (size // 3 + i * 7919) % max(size - 129, 1)
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    logger.warning("corrupt_checkpoint: flipped %d byte(s) of %s", n, target)


def retry_io(
    fn: Callable[[], T],
    what: str,
    attempts: int = 5,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
) -> T:
    """Run ``fn`` with bounded exponential backoff: the retry contract of every flaky
    I/O surface in ``data/`` (corpus opens, encoded-corpus maps, native ingest passes).
    Delays are deterministic. Permanent errors (missing path, permissions, disk full,
    read-only file system) fail at once: no retry can succeed, and an encode attempt
    restarts a whole pass. Re-raises the last error once the budget is spent."""
    permanent_types = (FileNotFoundError, PermissionError, IsADirectoryError,
                       NotADirectoryError)
    permanent_errnos = (errno.ENOENT, errno.EACCES, errno.EISDIR, errno.ENOSPC,
                        errno.EROFS)
    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:
            last = e
            if (isinstance(e, permanent_types)
                    or getattr(e, "errno", None) in permanent_errnos
                    or i == attempts - 1):
                break
            delay = min(base_delay * (2.0 ** i), max_delay)
            logger.warning("%s failed (%s); retry %d/%d in %.2fs", what, e, i + 1,
                           attempts - 1, delay)
            time.sleep(delay)
    raise last
