"""The training loop's declared host-sync and transfer sites.

Each place where the loop may read a device value on the host, wait for the card, or
copy host data to the device runs inside ``with trainer.sync_sites(name)``:

- ``stage``: a chunk's host arrays into pinned memory and onto the card, non-blocking
  (the producer thread's ``Trainer._stage``, or ``Trainer._device_arrays`` on the
  consumer);
- ``heartbeat``: the heartbeat's read of the chunk's last loss and mean f_pos;
- ``probe``: the health probe's drain of the queue and its one fetch;
- ``index_check``: the scatter kernels' index check, at a heartbeat and at the fit's end;
- ``fit_end``: the fit's closing synchronize and the device pair feed's settled counts;
- ``checkpoint``: a save's copy of the parameters to the host;
- ``snapshot``: a copy of the parameters into the rollback ring;
- ``graph_rebase``: the wait for the old graphs' last replay before a recapture;
- ``diagnostic``: the non-finite counts of a halt's message.

A mark costs a thread-local store and restore; it changes nothing the fit computes.
The transfer-contract audit (``python -m glint_word2vec_torch.stepaudit``) reads
:attr:`SyncSites.current` to tell a declared event from an undeclared one, and may set
:attr:`SyncSites.witness` to lift a process-wide sync witness (the card's sync debug
mode) inside the blocking sites only.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, Optional


class SyncSites:
    """The declared-site marker of one trainer; the current site is per thread."""

    def __init__(self) -> None:
        self._local = threading.local()
        # an audit's context-manager factory, entered around a blocking site's body
        self.witness: Optional[Callable[[], contextlib.AbstractContextManager]] = None

    @property
    def current(self) -> Optional[str]:
        """The innermost site the calling thread is in, or None."""
        return getattr(self._local, "site", None)

    @contextlib.contextmanager
    def __call__(self, site: str, blocking: bool = False) -> Iterator[None]:
        prev = getattr(self._local, "site", None)
        self._local.site = site
        try:
            if blocking and self.witness is not None:
                with self.witness():
                    yield
            else:
                yield
        finally:
            self._local.site = prev
