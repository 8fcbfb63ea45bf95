"""Multi-process scaffolding, ported from ``glint_word2vec_tpu/parallel/distributed.py``
to ``torch.distributed``.

The reference keeps its two matrices row-sharded across parameter servers and ships
indices and scalar coefficients between them. Here a multi-GPU run is N identical
processes, one a card (a *rank*), joined into one ``torch.distributed`` world, and the
(data, model) mesh (:mod:`.mesh`) lays the ranks out on two axes. Only the per-rank
input feed and the step's few collectives cross between ranks.

Launch, one command a rank (``GLINT_*`` are the JAX package's variables):

    GLINT_COORDINATOR=host0:12355 GLINT_NUM_PROCESSES=4 GLINT_PROCESS_ID=$i \\
        python train.py ...

or ``torchrun --nproc-per-node 4 train.py ...`` (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), or the same values passed to :func:`initialize`.
With none of them, :func:`initialize` does nothing and the run is a world of one.

Every collective the port issues goes through :data:`COLLECTIVES` (a
:class:`Collectives`), which counts each call by operation and mesh axis: the port's form
of the JAX package's HLO collective audit (``tools/collectives.py``), read by the tests
and the smoke. A collective on a group whose backend is gloo, given a tensor on the
card, is staged through host memory (a copy to the host, the gloo collective, a copy
back): that is how ranks that share one card run, since NCCL refuses two ranks on one
device. The wall seconds those staged calls take (after the stream has drained, so
the card's queued work is not counted) accumulate in ``COLLECTIVES.staged_s``.

The feed's :func:`allgather` packs a round's arrays into one byte buffer, so a round
is one collective. It is blocking, as the JAX package's ``_fit_sharded`` calls
``process_allgather``. Its split-phase form, :func:`allgather_start` (launch, a
``torch.distributed`` work handle) and :func:`allgather_fetch` (wait and unpack), is
the sharded token-block feed's: it launches the next round's gather one round ahead
(``config.sharded_prefetch``).
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("glint_word2vec_torch")

_ENV_COORD = "GLINT_COORDINATOR"
_ENV_NPROC = "GLINT_NUM_PROCESSES"
_ENV_PID = "GLINT_PROCESS_ID"
DEFAULT_TIMEOUT_S = 600.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join this process to the world. Returns whether a multi-process world is up.

    Resolution order: explicit arguments, then ``GLINT_COORDINATOR`` /
    ``GLINT_NUM_PROCESSES`` / ``GLINT_PROCESS_ID``, then torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` (``env://``). With none of them set this is a
    no-op: a world of one, so library code may call it unconditionally. A second call
    in an initialised process does nothing.

    ``backend``: NCCL when ``device`` is a card, gloo on the CPU, unless named.
    ``init_method`` (e.g. ``file:///tmp/store``, as the tests meet) replaces the
    coordinator's ``tcp://`` address. ``timeout_s`` bounds every collective: a rank
    that waits longer on a dead peer raises instead of hanging."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None and num_processes is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
                and "MASTER_ADDR" in os.environ:
            init_method = "env://"
            num_processes = int(os.environ["WORLD_SIZE"])
            process_id = int(os.environ["RANK"])
        else:
            logger.debug("distributed.initialize: single-process run, nothing to do")
            return False
    if init_method is None or num_processes is None or process_id is None:
        raise ValueError(
            "distributed.initialize needs an address (coordinator_address, "
            f"init_method or ${_ENV_COORD}), a world size (num_processes or "
            f"${_ENV_NPROC}) and a rank (process_id or ${_ENV_PID}); got "
            f"init_method={init_method!r}, num_processes={num_processes!r}, "
            f"process_id={process_id!r}")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("distributed: rank %d/%d, backend %s", dist.get_rank(),
                dist.get_world_size(), backend)
    return num_processes > 1


def shutdown() -> None:
    """Leave the world (a no-op when none is up)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return world_size() > 1


class Collectives:
    """The one interface the port's collectives go through, with a count of each call
    by (operation, axis): ``all_reduce``, ``all_gather``, ``all_to_all``,
    ``broadcast_object`` and ``barrier`` on a process group (``None``: the world), and
    of each tensor collective's input bytes (``nbytes``, by the same key). A gloo group
    given a tensor on the card is staged through host memory; ``staged_s`` and
    ``staged_calls`` count those calls' wall seconds and number. The counts are per
    process."""

    def __init__(self):
        self.counts: Counter = Counter()
        self.nbytes: Counter = Counter()
        self.staged_s = 0.0
        self.staged_calls = 0

    def reset(self) -> None:
        self.counts.clear()
        self.nbytes.clear()
        self.staged_s = 0.0
        self.staged_calls = 0

    @staticmethod
    def _staged(t: torch.Tensor, group) -> bool:
        return t.is_cuda and dist.get_backend(group) == "gloo"

    def _begin_staging(self, t: torch.Tensor) -> float:
        # the card's queued work drains before the clock starts: staging is what the
        # copies and the host collective take, not the steps before them
        # graftlint: disable=R3 -- gloo staging, never captured: a mesh's chunk runs eagerly (Trainer._run_chunk); capture on a mesh (A9b.5) is over NCCL
        torch.cuda.current_stream(t.device).synchronize()
        # graftlint: disable=R3 -- gloo staging, never captured: a mesh's chunk runs eagerly (Trainer._run_chunk); capture on a mesh (A9b.5) is over NCCL
        return time.perf_counter()

    def _end_staging(self, t0: float) -> None:
        # graftlint: disable=R3 -- gloo staging, never captured: a mesh's chunk runs eagerly (Trainer._run_chunk); capture on a mesh (A9b.5) is over NCCL
        self.staged_s += time.perf_counter() - t0
        self.staged_calls += 1

    def all_reduce(self, t: torch.Tensor, group=None, axis: str = "world",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Sum ``t`` over ``group`` in place; returns ``t``."""
        self.counts[("all_reduce", axis)] += 1
        self.nbytes[("all_reduce", axis)] += t.numel() * t.element_size()
        if not self._staged(t, group):
            dist.all_reduce(t, op=op, group=group)
            return t
        t0 = self._begin_staging(t)
        # graftlint: disable=R3 -- gloo staging, never captured: a mesh's chunk runs eagerly (Trainer._run_chunk); capture on a mesh (A9b.5) is over NCCL
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
        self._end_staging(t0)
        return t

    def all_gather(self, t: torch.Tensor, group=None, axis: str = "world") -> torch.Tensor:
        """The group's ``t`` concatenated along dim 0 in rank order (tiled)."""
        self.counts[("all_gather", axis)] += 1
        self.nbytes[("all_gather", axis)] += t.numel() * t.element_size()
        staged = self._staged(t, group)
        if staged:
            t0 = self._begin_staging(t)
            # graftlint: disable=R3 -- gloo staging, never captured: a mesh's chunk runs eagerly (Trainer._run_chunk); capture on a mesh (A9b.5) is over NCCL
            src = t.cpu()
        else:
            src = t.contiguous()
        out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, src, group=group)
        cat = torch.cat(out)
        if staged:
            cat = cat.to(t.device)
            self._end_staging(t0)
        return cat

    def all_to_all(self, t: torch.Tensor, group=None, axis: str = "world") -> torch.Tensor:
        """Split ``t`` along dim 0 into one equal part a rank of ``group``, send part j
        to rank j, and return the parts received, concatenated in rank order
        (``all_to_all_single``)."""
        self.counts[("all_to_all", axis)] += 1
        self.nbytes[("all_to_all", axis)] += t.numel() * t.element_size()
        staged = self._staged(t, group)
        if staged:
            t0 = self._begin_staging(t)
            src = t.cpu()
        else:
            src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        if staged:
            out = out.to(t.device)
            self._end_staging(t0)
        return out

    def broadcast_object(self, obj, group=None, axis: str = "world"):
        """Rank 0's picklable ``obj`` on every rank of ``group`` (a gloo group: host
        objects), the control plane of the ranks' decisions."""
        self.counts[("broadcast", axis)] += 1
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=group)
        return box[0]

    def barrier(self, group=None, axis: str = "world") -> None:
        """Every rank of ``group`` reaches this point before any leaves it. Runs on a
        host tensor through a gloo group, and through a one-element all_reduce on the
        card under NCCL."""
        self.counts[("barrier", axis)] += 1
        if dist.get_backend(group) == "nccl":
            dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
            torch.cuda.synchronize()
        else:
            dist.barrier(group=group)


COLLECTIVES = Collectives()

_HOST_GROUP = None


def host_group():
    """A gloo group over the whole world for host arrays (the feed's allgather, the
    checkpoint barriers): the default group itself when it is gloo, one made once
    otherwise (NCCL moves only tensors on the card)."""
    global _HOST_GROUP
    if dist.get_backend() == "gloo":
        return None
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def _pack(host_tree: Dict[str, np.ndarray]):
    """One uint8 buffer of the dict's arrays (C order, in key order) and its layout:
    every rank's round has the same shapes and dtypes, so one buffer a rank gathers
    them all."""
    layout, parts = [], []
    for name in sorted(host_tree):
        a = np.ascontiguousarray(host_tree[name])
        layout.append((name, a.shape, a.dtype, a.nbytes))
        parts.append(a.reshape(-1).view(np.uint8))
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8), layout


def _unpack(buf: np.ndarray, layout) -> Dict[str, np.ndarray]:
    """The packed arrays of [n, nbytes] ``buf``, each with a leading [n] axis."""
    out, off = {}, 0
    n = buf.shape[0]
    for name, shape, dtype, nbytes in layout:
        out[name] = buf[:, off:off + nbytes].copy().view(dtype).reshape((n, *shape))
        off += nbytes
    return out


def allgather(host_tree: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Allgather a dict of per-process host arrays over the world: every array with a
    leading [world] axis in rank order (the JAX package's ``process_allgather(
    tiled=False)`` layout). A world of one gathers nothing: the arrays are stacked."""
    if not is_multiprocess():
        return {k: np.expand_dims(np.asarray(v), 0) for k, v in host_tree.items()}
    buf, layout = _pack(host_tree)
    src = torch.from_numpy(buf)
    COLLECTIVES.counts[("all_gather", "world")] += 1
    out = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(out, src, group=host_group())
    return _unpack(torch.stack(out).numpy(), layout)


class PendingGather:
    """An allgather in flight (:func:`allgather_start`): its work handle (None in a
    world of one), the output buffers and the packing layout."""

    def __init__(self, work, out, layout, local=None):
        self.work, self.out, self.layout, self.local = work, out, layout, local


def allgather_start(host_tree: Dict[str, np.ndarray]) -> PendingGather:
    """Launch :func:`allgather` of ``host_tree`` without waiting for it (an
    ``async_op`` collective on the host group); :func:`allgather_fetch` waits and
    unpacks. The JAX package's ``allgather_start``. Every rank must start its gathers
    in one order, as with every collective."""
    if not is_multiprocess():
        return PendingGather(None, None, None,
                             {k: np.expand_dims(np.asarray(v), 0)
                              for k, v in host_tree.items()})
    buf, layout = _pack(host_tree)
    src = torch.from_numpy(buf)
    COLLECTIVES.counts[("all_gather", "world")] += 1
    out = [torch.empty_like(src) for _ in range(world_size())]
    work = dist.all_gather(out, src, group=host_group(), async_op=True)
    return PendingGather(work, out, layout)


def allgather_fetch(pending: PendingGather) -> Dict[str, np.ndarray]:
    """Wait for a gather :func:`allgather_start` launched; its arrays with the leading
    [world] axis, as :func:`allgather` returns them."""
    if pending.work is None:
        return pending.local
    pending.work.wait()
    return _unpack(torch.stack(pending.out).numpy(), pending.layout)


def local_sgd_delta_merge(start, local, group, num_shards: int, axis: str = "data"):
    """The local-SGD merge (``config.sync_every``): reconcile ``num_shards`` diverged
    replicas with ONE all_reduce over ``group`` (the data axis), in place on each
    tensor of ``local``::

        local <- start + all_reduce(local - start) * (1 / num_shards)

    the mean of the replicas' deltas applied to the common window-start state, in the
    parameters' dtype. The all_reduce hands every rank the same sum and ``start`` is
    replicated over the axis, so the merged replicas are bit-identical; 1/num_shards is
    exact at every power-of-2 shard count; a row clamp holds under the merge (a convex
    combination of rows in the ball stays in it). All the tensors of ``local`` ride one
    collective (flattened together). ``num_shards == 1`` returns ``local`` as it is."""
    if num_shards == 1:
        return local
    deltas = torch.cat([(loc - s).reshape(-1) for s, loc in zip(start, local)])
    COLLECTIVES.all_reduce(deltas, group, axis)
    scale = 1.0 / float(num_shards)
    off = 0
    for s, loc in zip(start, local):
        n = loc.numel()
        torch.add(s, deltas[off:off + n].view_as(loc), alpha=scale, out=loc)
        off += n
    return local


def put_global(plan, arrays: Dict[str, object], sharding,
               device=None) -> Dict[str, torch.Tensor]:
    """Carve this rank's part out of full (global-shape) arrays, the same on every
    rank: ``sharding`` is one :class:`.mesh.Sharding` for every array, or a dict keyed
    like ``arrays``. A numpy array becomes a contiguous host tensor; a torch tensor is
    carved as a view. Each part goes to ``device`` (None: it stays where it is)."""
    out = {}
    for k, v in arrays.items():
        spec = sharding[k] if isinstance(sharding, dict) else sharding
        if isinstance(v, torch.Tensor):
            part = plan.carve(v, spec)
        else:
            part = torch.from_numpy(np.ascontiguousarray(plan.carve(np.asarray(v), spec)))
        out[k] = part if device is None else part.to(device)
    return out
