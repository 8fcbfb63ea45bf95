"""The serving tier, ported from ``glint_word2vec_tpu/serve/`` (``docs/serving.md``).

Five layers, usable alone or through :class:`EmbeddingService`:

- :mod:`.batcher`: a bounded-queue, deadline-based micro-batcher that coalesces
  concurrent queries into one dispatch, refusing fast (429-style) when full;
- :mod:`.ann`: the IVF index (seeded k-means, packed inverted lists) on the host,
  ``nprobe``-tunable, its recall@10 measured against the exact oracle at build;
- :mod:`.quant`: its int8 and PQ storage arms, gated by recall, and the shard-native
  build from a row-shards checkpoint;
- :mod:`.reload`: the swap-window-safe loader, the lease-counted serving handle and
  the checkpoint-publish watcher (zero-downtime hot reload);
- :mod:`.service`: the assembled service around a model on the card, with ``serve_*``
  telemetry and ``glint_serve_*`` gauges;
- :mod:`.fleet`: N replicas behind a router (health probes, circuit breakers,
  deadline-budgeted retries, hedging, load shedding, the rolling reload), with
  ``fleet_*`` telemetry and ``glint_serve_fleet_*`` gauges.
"""

from glint_word2vec_torch.serve.ann import (
    IvfIndex,
    RecallFloorError,
    auto_centroids,
    auto_nprobe,
    build_ivf,
)
from glint_word2vec_torch.serve.batcher import (
    BatchingScheduler,
    ServerOverloaded,
    ServiceClosed,
)
from glint_word2vec_torch.serve.fleet import (
    CircuitBreaker,
    FleetOverloaded,
    FleetRouter,
    NoHealthyReplicas,
    ReplicaSet,
    fleet_knobs_from_checkpoint,
)
from glint_word2vec_torch.serve.quant import (
    Int8Storage,
    PQStorage,
    ShardRowFetch,
    auto_pq_m,
    build_ivf_from_shards,
)
from glint_word2vec_torch.serve.reload import (
    CheckpointWatcher,
    ServingHandle,
    decorrelated_jitter,
    load_with_retry,
)
from glint_word2vec_torch.serve.service import EmbeddingService

__all__ = [
    "IvfIndex", "build_ivf", "auto_centroids", "auto_nprobe",
    "RecallFloorError", "build_ivf_from_shards", "auto_pq_m",
    "Int8Storage", "PQStorage", "ShardRowFetch",
    "BatchingScheduler", "ServerOverloaded", "ServiceClosed",
    "CheckpointWatcher", "ServingHandle", "load_with_retry",
    "decorrelated_jitter",
    "EmbeddingService",
    "CircuitBreaker", "FleetOverloaded", "FleetRouter", "NoHealthyReplicas",
    "ReplicaSet", "fleet_knobs_from_checkpoint",
]
