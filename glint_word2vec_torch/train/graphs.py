"""One dispatch per chunk: the trainer's chunk bodies captured as CUDA graphs.

The JAX trainer compiles a chunk of ``steps_per_dispatch`` steps into one program
(``glint_word2vec_tpu/train/trainer.py``: ``Trainer._build_step`` wraps them in
``jax.lax.scan``) and builds it twice, with and without the step metrics
(``_dispatch_step_fn`` picks the metrics-elided twin for a chunk no heartbeat samples).
On a CUDA device the port's counterpart is a CUDA graph of the trainer's chunk body
(``Trainer._chunk_body``): the K steps, their hot-row flushes and the stacking of their
metrics, replayed once per chunk. :class:`ChunkGraphs` keeps those graphs for one
trainer:

- **two twins**, the full-metrics body and the metrics-elided one, in one memory pool
  (``torch.cuda.graph_pool_handle()``): they never run at once, and each graph's output
  (the [K, 3] metrics) is read before the next replay of either;
- **a key** from the trainer (``Trainer._graph_key``): the step form, ``with_metrics``,
  K, the stabilizers, the hot-row cadence, the dtypes, and the identity (address, shape,
  dtype) of the parameters, the hot-row slabs and the trainer's fixed input buffers.
  Every such change drops the graphs of the old key and captures anew: a restore of a
  snapshot (the live pair becomes another tensor), a recovery that engages
  ``max_row_norm`` (the shared step moves from the fused kernel to its scatter form), a
  new placement of the parameters, a new trainer on load or resume. The JAX trainer
  rebuilds its step functions at the same points;
- **a warm-up before every capture**: the body runs once, eagerly, on the capture
  stream, with every gate of the steps (the masks, and the center and token slots of
  the banded step) set to 0, i.e. as K padded steps, which are exact no-ops on finite
  parameters (``tests/test_torch_graph.py``). That sizes the row-scatter kernel's state
  for the capture stream (``ops/scatter._Stream``), raises the fused kernel's
  shared-memory limit and creates the stream's cuBLAS workspace before the capture, as
  PyTorch's graph notes prescribe, without training anything twice;
- **capture in "thread_local" mode**: the producer thread keeps staging chunks (pinned
  host buffers, copies on its own stream) while the consumer captures, and under the
  default "global" mode those calls would invalidate the capture. Only the capturing
  thread's calls are checked; the producer never touches the capture stream or the
  graphs' inputs (the prologue copies each staged chunk into the fixed buffers on the
  consumer's stream first);
- **launch counts**: the kernels' wrappers count a launch in Python, which runs once, at
  capture, where nothing is launched. The capture's counts are taken back and added once
  per replay, so ``fused_sgns_shared_step.launches`` and
  ``scatter_add_rows_.launches`` keep counting what ran on the card (the warm-up's
  launches ran, and count).

There is no fallback: a capture or a replay that fails raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, NamedTuple, Tuple

import torch

from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
from glint_word2vec_torch.ops.scatter import scatter_add_rows_

# the wrappers' launch counters: (function, attribute)
_COUNTERS = ((fused_sgns_shared_step, "launches"), (fused_sgns_shared_step, "bf16_launches"),
             (scatter_add_rows_, "launches"), (scatter_add_rows_, "bf16_launches"))


def launch_counts() -> Tuple[int, ...]:
    """The kernels' launch counters, in ``_COUNTERS`` order."""
    return tuple(getattr(fn, attr) for fn, attr in _COUNTERS)


def _add_launches(delta: Tuple[int, ...], times: int = 1) -> None:
    for (fn, attr), d in zip(_COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + d * times)


class _Graph(NamedTuple):
    """One captured body: the graph, its output (the [K, 3] metrics, overwritten by
    every replay of either twin) and the launches one replay makes."""

    graph: torch.cuda.CUDAGraph
    out: torch.Tensor
    launches: Tuple[int, ...]


class ChunkGraphs:
    """The captured chunk bodies of one trainer on one CUDA device, keyed by
    ``(base, with_metrics)``: at most the two twins of one base at a time.
    ``captures`` and ``replays`` count since the last :meth:`reset_counts`."""

    def __init__(self, device: torch.device, sync_sites):
        self.device = device
        self._sites = sync_sites  # the trainer's declared sync sites
        self.stream = torch.cuda.Stream(device=device)  # warm-ups and captures
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[Tuple[Hashable, bool], _Graph] = {}
        self.captures = 0
        self.replays = 0

    def reset_counts(self) -> None:
        self.captures = self.replays = 0

    def run(self, key: Tuple[Hashable, bool], body: Callable[[], torch.Tensor],
            gates: List[torch.Tensor]) -> torch.Tensor:
        """Replay the graph of ``key`` (capturing it first if there is none) and return
        its output. ``body()`` enqueues the K steps on the current stream and returns
        their metrics; ``gates`` are the input buffers the warm-up zeroes (and
        restores), so that it runs K exact no-op steps."""
        g = self._graphs.get(key)
        if g is None:
            if any(k[0] != key[0] for k in self._graphs):
                # another base: the old graphs point at tensors the trainer dropped.
                # Their last replay finishes before their pool is handed back
                with self._sites("graph_rebase", blocking=True):
                    torch.cuda.current_stream(self.device).synchronize()
                self._graphs.clear()
                self._pool = torch.cuda.graph_pool_handle()
            g = self._graphs[key] = self._capture(body, gates)
        g.graph.replay()
        _add_launches(g.launches)
        self.replays += 1
        return g.out

    def _capture(self, body: Callable[[], torch.Tensor],
                 gates: List[torch.Tensor]) -> _Graph:
        consumer = torch.cuda.current_stream(self.device)
        saved = [t.clone() for t in gates]
        for t in gates:
            t.zero_()
        self.stream.wait_stream(consumer)
        with torch.cuda.stream(self.stream):
            body()  # the warm-up: K padded steps, exact no-ops
        consumer.wait_stream(self.stream)
        for t, s in zip(gates, saved):
            t.copy_(s)
        del saved
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end, not the torch.cuda.graph context: that one synchronizes the
        # card and empties the device and the pinned-host caches at every capture (the
        # producer's staging buffers among them), which the warm-up makes unnecessary
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                out = body()
            finally:
                graph.capture_end()
        launches = tuple(a - b for a, b in zip(launch_counts(), before))
        _add_launches(launches, -1)  # the capture launched nothing
        self.captures += 1
        return _Graph(graph, out, launches)
