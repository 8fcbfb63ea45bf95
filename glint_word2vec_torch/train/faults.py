"""Fault injection and bounded retry for the port's ingest I/O, ported from
``glint_word2vec_tpu/train/faults.py`` (``maybe_fail_ingest``, ``retry_io``).

Only the ingest field of the fault plan is ported: ``GLINT_FAULT_FAIL_INGEST_FIRST_N=N``
(or :func:`configure` in-process) makes the first N guarded ingest I/O attempts raise
:class:`InjectedFault`, an ``OSError``, so that the retry wrappers of ``data/`` can be
tested without flaky I/O. The plan's other fields (crash points, checkpoint corruption,
NaN and stall injection) wait for the runtime layers of ROADMAP queue A6.
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

logger = logging.getLogger("glint_word2vec_torch")

T = TypeVar("T")


class InjectedFault(OSError):
    """A scripted fault: an OSError, so the retry paths treat it as a transient I/O
    failure."""


@dataclasses.dataclass
class FaultPlan:
    """One scripted fault schedule; zero = no faults."""

    fail_ingest_first_n: int = 0


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


def active_plan() -> FaultPlan:
    """The in-process plan if set, else the environment's (read at every call)."""
    if _override is not None:
        return _override
    return FaultPlan(fail_ingest_first_n=_env_int("GLINT_FAULT_FAIL_INGEST_FIRST_N"))


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
