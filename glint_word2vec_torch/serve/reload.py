"""Zero-downtime hot reload, ported from ``glint_word2vec_tpu/serve/reload.py``:
swap-window-safe loading, a lease-counted serving handle, and the checkpoint-publish
watcher.

The trainer's atomic save (``train/checkpoint.py``) gives serving a clean publish
signal: a completed save replaces the checkpoint directory in two renames (``path`` to
``path.old-<pid>``, the staged ``.tmp-*`` to ``path``), so ``<path>/metadata.json``
changes identity exactly once per publish, and is briefly ABSENT inside the swap
window. This module owns the serving side of that protocol:

- :func:`load_with_retry`, the one owner of the swap-window retry: transient
  mid-swap failures retry over the window with decorrelated-jitter backoff
  (:func:`decorrelated_jitter`, which the supervisor will reuse); permanent problems
  surface at once. It loads onto ``device`` (the card unless the caller asks for the
  CPU).
- :func:`publish_signature` / :func:`publish_signature_str`: the publish identity and
  its one wire form.
- :class:`ServingHandle`: the atomically swappable ``(model, index)`` pair with lease
  counting: a dispatch leases the current pair for its whole batch, ``swap()`` installs
  the new pair for FUTURE batches, and the old model's tensors are released only when
  its last lease ends. Nothing under the handle's lock touches the card.
- :class:`CheckpointWatcher`: a poll thread that stats the publish signal and calls
  the service's reload (load, index build and swap in the background).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np

from glint_word2vec_torch.lockcheck import make_lock

logger = logging.getLogger("glint_word2vec_torch")


def decorrelated_jitter(base: float, cap: float, rng) -> Iterator[float]:
    """AWS-style decorrelated-jitter backoff delays: each delay is drawn
    ``uniform(base, 3 × previous)``, capped at ``cap``.

    Replicas watching one publish path hit the same swap window at the same poll
    tick; a fixed retry interval keeps them phase-locked (the thundering herd).
    Decorrelation spreads the rounds apart while keeping the expected delay near
    the base; the cap bounds the tail.

    ``rng`` is an explicitly seeded ``np.random.Generator`` (the R2
    determinism contract — tests pin the exact sequence per seed; production
    callers seed per process so processes genuinely decorrelate)."""
    prev = base
    while True:
        prev = min(cap, float(rng.uniform(base, max(base, prev * 3))))
        yield prev


def load_with_retry(path: str, plan=None, attempts: int = 8,
                    delay: float = 0.25, max_delay: float = 2.0,
                    rng=None, device="cuda"):
    """Load a checkpoint onto ``device``, absorbing the trainer's atomic-swap window.

    A load landing inside the swap window sees a missing path or a half-listed
    directory; only such transient failures retry: a missing path, half-written
    JSON, a metadata/words pair read across the two renames (the loader's
    vocab_size/words ValueError), and a digest mismatch (two atomic saves, one
    straddling reader: publish N's metadata with publish N+1's arrays). Real
    corruption keeps failing and raises once the budget is spent; permanent
    problems raise at once. A load that succeeded is always one self-consistent
    publish.

    ``plan`` (a mesh of several ranks; every rank calls this alike): each rank loads
    its rows (``Word2VecModel.load(plan=)``), and after each attempt one all_reduce
    over the world takes the worst outcome (loaded, transient, permanent), so the
    ranks retry together, succeed together or raise together; a rank whose own
    attempt succeeded while a peer's failed drops its model and raises (or retries)
    with the others.

    The backoff between attempts is :func:`decorrelated_jitter` over
    ``[delay, max_delay]``. Pass a seeded ``rng`` to pin the sequence (tests); the
    default seeds from the pid and the clock, so each process draws its own."""
    from glint_word2vec_torch.models.word2vec import Word2VecModel
    from glint_word2vec_torch.train.checkpoint import CheckpointCorruptError
    if rng is None:
        # seeded Generator (R2): decorrelation across processes is the
        # point, so the seed folds in process identity + time
        rng = np.random.default_rng((os.getpid(), time.monotonic_ns()))
    delays = decorrelated_jitter(delay, max_delay, rng)
    if plan is not None and plan.size > 1:
        return _load_together(path, plan, attempts, delays, device)
    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            return Word2VecModel.load(path, plan=plan, device=device)
        except (FileNotFoundError, json.JSONDecodeError,
                CheckpointCorruptError) as e:
            last = e
        except ValueError as e:
            if "vocab_size" not in str(e) and "words" not in str(e):
                raise
            last = e
        if i == attempts - 1:
            raise last
        time.sleep(next(delays))


_LOADED, _TRANSIENT, _PERMANENT = 0, 1, 2


def _load_outcome(path: str, plan, device):
    """(model or None, error or None, outcome) of one load attempt on this rank."""
    from glint_word2vec_torch.models.word2vec import Word2VecModel
    from glint_word2vec_torch.train.checkpoint import CheckpointCorruptError
    try:
        return Word2VecModel.load(path, plan=plan, device=device), None, _LOADED
    except (FileNotFoundError, json.JSONDecodeError, CheckpointCorruptError) as e:
        return None, e, _TRANSIENT
    except ValueError as e:
        transient = "vocab_size" in str(e) or "words" in str(e)
        return None, e, _TRANSIENT if transient else _PERMANENT
    except Exception as e:  # noqa: BLE001 — raised below, on every rank together
        return None, e, _PERMANENT


def _load_together(path: str, plan, attempts: int, delays, device):
    """:func:`load_with_retry` on a mesh: every attempt's worst outcome over the
    world decides every rank's next move."""
    import torch

    from glint_word2vec_torch.parallel import distributed

    last: Optional[BaseException] = None
    for i in range(attempts):
        model, err, outcome = _load_outcome(path, plan, device)
        worst = torch.tensor([outcome], dtype=torch.int64)
        distributed.COLLECTIVES.all_reduce(worst, distributed.host_group(),
                                           op=torch.distributed.ReduceOp.MAX)
        if int(worst) == _LOADED:
            return model
        if model is not None:
            model.stop()
        last = err or RuntimeError(
            f"a peer rank's load of {path!r} failed; this rank's attempt succeeded")
        if int(worst) == _PERMANENT or i == attempts - 1:
            raise last
        time.sleep(next(delays))
    raise last


def publish_signature(checkpoint_path: str) -> Optional[Tuple[int, int, int]]:
    """The checkpoint's current publish identity (``metadata.json``
    mtime/inode/size), or None while absent / mid-swap. Capture this
    BEFORE loading and record it as served AFTER the load succeeds — a
    publish landing during a slow load/index build then still differs
    from the recorded signature and re-fires (capturing after the load
    would permanently swallow it)."""
    try:
        st = os.stat(os.path.join(checkpoint_path, "metadata.json"))
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_ino, st.st_size)


def publish_signature_str(sig: Optional[Tuple[int, int, int]]
                          ) -> Optional[str]:
    """The signature's stable wire/telemetry form (``mtime_ns-inode-size``),
    or None while unknown (in-memory model, or captured mid-swap). ONE
    owner: the CLI's ``stats`` reply, the trainer's ``publish`` record and
    every ``publish_sig`` telemetry field format through here, in both
    packages, because publish chains are joined by string equality."""
    return None if sig is None else "-".join(str(x) for x in sig)


class _Slot:
    """One (model, index) generation plus its lease count. ``refs`` starts
    at 1 — the handle's own reference; ``swap`` drops it."""

    __slots__ = ("model", "index", "refs")

    def __init__(self, model, index):
        self.model = model
        self.index = index
        self.refs = 1


class ServingHandle:
    """Atomically swappable (model, index) with lease-counted release."""

    def __init__(self, model, index=None):
        self._lock = make_lock("serve.handle")
        self._current: Optional[_Slot] = _Slot(model, index)
        self.models_released = 0
        self.swaps = 0

    @contextlib.contextmanager
    def lease(self) -> Iterator[Tuple[Any, Any]]:
        """Pin the CURRENT generation for the duration of one batch: the
        yielded pair stays alive (buffers un-released) until the context
        exits, even if a swap lands mid-batch."""
        with self._lock:
            slot = self._current
            if slot is None:
                raise RuntimeError("serving handle is stopped")
            slot.refs += 1
        try:
            yield slot.model, slot.index
        finally:
            self._release(slot)

    def _release(self, slot: _Slot) -> None:
        with self._lock:
            slot.refs -= 1
            drained = slot.refs == 0
            if drained:
                self.models_released += 1
        if drained:
            # outside the lock: stop() drops the model's tensors
            try:
                slot.model.stop()
            except Exception:  # noqa: BLE001 — release is best-effort
                logger.warning("old serving model release failed",
                               exc_info=True)

    def swap(self, model, index=None) -> None:
        """Install a new generation. Future leases see the new pair
        immediately; the old generation is released when its in-flight
        leases drain (possibly right here, if none are in flight)."""
        new = _Slot(model, index)
        with self._lock:
            old = self._current
            if old is None:
                raise RuntimeError("serving handle is stopped")
            self._current = new
            self.swaps += 1
        self._release(old)  # drop the handle's own reference

    def stop(self) -> None:
        """Release the current generation (after in-flight leases drain)
        and refuse further leases. Idempotent."""
        with self._lock:
            old = self._current
            self._current = None
        if old is not None:
            self._release(old)

    def detach(self) -> None:
        """Refuse further leases WITHOUT releasing the current model — for
        callers that own the model's lifecycle themselves (a service built
        over an in-memory ``model=`` keeps the caller's buffers alive; the
        bench reuses one matrix across service arms)."""
        with self._lock:
            self._current = None


class CheckpointWatcher:
    """Publish-signal poller: fires ``on_publish()`` when the checkpoint's
    ``metadata.json`` changes identity (mtime/inode/size), i.e. once per
    completed trainer save. The mid-swap ABSENT state is not a signal —
    the next poll after the swap completes sees the new identity."""

    def __init__(self, checkpoint_path: str,
                 on_publish: Callable[[], None],
                 poll_s: float = 0.5,
                 loaded_signature: Optional[Tuple[int, int, int]] = None,
                 name: str = "glint-serve-watcher"):
        """``loaded_signature`` is the :func:`publish_signature` captured
        BEFORE the caller loaded the model it is now serving — a publish
        that landed during that load then differs and fires on the first
        poll. None (nothing served yet) makes the first poll fire on any
        existing checkpoint."""
        if poll_s <= 0:
            raise ValueError(f"poll_s must be positive but got {poll_s}")
        self._path = checkpoint_path
        self._on_publish = on_publish
        self._poll_s = float(poll_s)
        self._name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._loaded_sig = loaded_signature

    def _signature(self) -> Optional[Tuple[int, int, int]]:
        return publish_signature(self._path)

    def mark_loaded(self, signature: Optional[Tuple[int, int, int]]) -> None:
        """Record ``signature`` (captured BEFORE the explicit reload that
        just succeeded — see :func:`publish_signature`) as served, so the
        watcher does not re-fire on it."""
        self._loaded_sig = signature

    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name=self._name, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> int:
        """Returns the number of leaked threads (0/1)."""
        self._stop.set()
        leaked = 0
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30)
            if t.is_alive():
                leaked = 1
                logger.warning("checkpoint watcher thread leaked "
                               "(join timeout)")
        return leaked

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            sig = self._signature()
            if sig is None or sig == self._loaded_sig:
                continue
            try:
                self._on_publish()
            except Exception:  # noqa: BLE001 — a failed reload must not
                # kill serving; the CURRENT model keeps answering and the
                # next poll retries (a newer publish may fix it)
                logger.warning("hot-reload failed; still serving the "
                               "previous model", exc_info=True)
                continue
            # record the signature captured BEFORE the load: if the trainer
            # published again mid-load, the next poll re-fires
            self._loaded_sig = sig
