"""Serving from a mesh of ranks: the exact arm of a model whose rows are spread over
the ranks of a ``torch.distributed`` world (``python -m
glint_word2vec_torch.serve_checkpoint CK --mesh DxM``), the port's form of the JAX
package's service on a ``plan``.

Every model op on a :class:`..models.word2vec.ShardedWord2VecModel` is a collective
that every rank calls with the same arguments. A service has one front end, on rank 0,
whose batcher and reload threads call the model whenever a request or a publish comes;
the other ranks (the *followers*) call nothing of their own. So rank 0 announces each
collective op before it runs it: :class:`MeshLeader` broadcasts ``(op, generation,
arguments)`` over the world's host group, under one lock so that the announcements and
the collectives that follow them keep one order on every rank, and :func:`follow` is
the followers' loop that receives each announcement and runs the same op on its own
rows. The control plane is one ``broadcast_object`` a request batch; the data plane is
the op's own collectives over the model axis.

Generations: a load (the service's first, a reload on the publish signal, or the
explicit ``reload`` op) is decided on rank 0 and announced, and every rank loads the
new checkpoint under the next generation number (through
:func:`.reload.load_with_retry`, whose retry decisions the ranks take together). Each op
names the generation it runs on, and a generation is released on every rank only when
rank 0's serving handle releases it (its last lease ended), so a batch that started on
the old model finishes on the old model on every rank and no answer mixes two
versions.

The ANN arm is rank 0's alone: its index is a host object, built from the checkpoint's
files on rank 0 (``serve/service.py``), and probing it is no collective.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from glint_word2vec_torch.lockcheck import make_lock

logger = logging.getLogger("glint_word2vec_torch")


def _announce(msg):
    """Rank 0's ``msg`` on every rank of the world (its host group)."""
    from glint_word2vec_torch.parallel import distributed

    return distributed.COLLECTIVES.broadcast_object(msg, distributed.host_group())


class MeshLeader:
    """Rank 0's side of a mesh service: loads and model ops announced to the
    followers, then run here, one at a time."""

    def __init__(self, plan, device):
        if plan.rank != 0:
            raise ValueError("the mesh service's front end runs on rank 0; the other "
                             "ranks run serve.mesh.follow")
        self.plan, self.device = plan, device
        self._lock = make_lock("serve.mesh")
        self._gen = 0
        self._closed = False

    def load(self, path: str) -> "LeadModel":
        """Load ``path`` onto the mesh under a new generation, on every rank
        (:func:`.reload.load_with_retry`: retried together, raised together)."""
        from glint_word2vec_torch.serve.reload import load_with_retry

        with self._lock:
            self._check_open()
            self._gen += 1
            gen = self._gen
            _announce(("load", gen, path))
            model = load_with_retry(path, plan=self.plan, device=self.device)
        return LeadModel(self, gen, model)

    def run(self, gen: int, model, op: str, args: tuple) -> Any:
        """``model.op(*args)`` on every rank."""
        with self._lock:
            self._check_open()
            _announce(("op", gen, op, args))
            return getattr(model, op)(*args)

    def release(self, gen: int) -> None:
        """Every rank drops generation ``gen``."""
        with self._lock:
            if not self._closed:
                _announce(("release", gen))

    def close(self) -> None:
        """End the followers' loops (idempotent)."""
        with self._lock:
            if not self._closed:
                self._closed = True
                _announce(("stop",))

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("the mesh service is closed")


class LeadModel:
    """Rank 0's handle of one generation of a sharded model: the attributes a service
    reads (vocabulary, config, sizes, device, the host ANN index) are local; each
    collective op is announced to the followers (:meth:`MeshLeader.run`)."""

    def __init__(self, leader: MeshLeader, gen: int, model):
        self._leader, self.gen, self._model = leader, gen, model
        self.vocab, self.config = model.vocab, model.config
        self.train_state, self.device = model.train_state, model.device
        self.num_words, self.vector_size = model.num_words, model.vector_size

    def _run(self, op: str, *args):
        return self._leader.run(self.gen, self._model, op, args)

    def transform(self, word: str):
        return self._run("transform", word)

    def find_synonyms_batch(self, queries, num: int, chunk: int = 128,
                            ann: bool = False, nprobe: Optional[int] = None):
        if ann:  # the host index: rank 0's alone, no collective
            return self._model.find_synonyms_batch(queries, num, chunk, True, nprobe)
        return self._run("find_synonyms_batch", list(queries), num, chunk)

    def attach_ann(self, index) -> None:
        self._model.attach_ann(index)

    @property
    def ann(self):
        return self._model.ann

    def stop(self) -> None:
        """Release this generation on every rank."""
        self._leader.release(self.gen)
        self._model.stop()


def follow(plan, device) -> None:
    """A follower's loop: receive each announcement of rank 0 and run it on this
    rank's rows, until rank 0 announces the end. A failed load or op raised on rank 0
    as well (the ranks hold the same arguments and agree on loads), so here it is
    logged and the loop goes on."""
    from glint_word2vec_torch.serve.reload import load_with_retry

    models = {}
    try:
        while True:
            msg = _announce(None)
            kind = msg[0]
            if kind == "stop":
                return
            if kind == "load":
                _, gen, path = msg
                try:
                    models[gen] = load_with_retry(path, plan=plan, device=device)
                except Exception:  # noqa: BLE001 — rank 0 raises it to its caller
                    logger.warning("rank %d: load of %s failed", plan.rank, path,
                                   exc_info=True)
            elif kind == "op":
                _, gen, op, args = msg
                try:
                    getattr(models[gen], op)(*args)
                except Exception:  # noqa: BLE001 — rank 0 answers its client
                    logger.debug("rank %d: %s failed", plan.rank, op, exc_info=True)
            elif kind == "release":
                m = models.pop(msg[1], None)
                if m is not None:
                    m.stop()
    finally:
        for m in models.values():
            m.stop()
