"""Hyperparameter surface, ported from ``glint_word2vec_tpu/config.py``.

Same fields, defaults, AUTO rules and ``to_dict``/``from_dict`` key set as the JAX
package, because checkpoints of either package carry the config and must load in the
other. The field comments there hold the provenance of every default; this module
repeats only what the port does differently.

The port implements the single-device skip-gram step with a shared negative pool. A
knob that would change the results of training and is not ported yet raises
:class:`NotImplementedError` naming it, at construction, when set off its default; it
is never silently ignored. Knobs that only change wall clock in the JAX package
(``producer_workers``, ``io_workers``, ``prefetch_chunks``: the JAX package guarantees
bit-identical results at any value) are accepted and run serially.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Knobs not ported yet, refused off their default (ROADMAP queue A names the slice
# each one lands in).
_UNPORTED = (
    "cbow", "cbow_update", "device_pairgen", "duplicate_scaling", "fused_logits",
    "bf16_chain", "hot_rows", "use_pallas", "param_dtype", "compute_dtype",
    "logits_dtype", "step_lowering", "sync_every", "num_model_shards",
    "num_data_shards", "embedding_partition", "sharded_checkpoint", "max_row_norm",
    "update_clip", "row_l2", "norm_watch", "telemetry_path", "profile_dir",
    "status_port", "checkpoint_on_preempt", "peer_beacon_s",
    "serve_max_batch", "serve_max_delay_ms", "serve_queue_depth",
    "serve_ann_centroids", "serve_ann_nprobe", "serve_ann_quant", "serve_ann_pq_m",
    "serve_ann_rerank", "serve_ann_recall_floor", "serve_ann_max_densify_bytes",
    "serve_reload_poll_s", "serve_fleet_replicas", "serve_fleet_probe_s",
    "serve_fleet_breaker_failures", "serve_fleet_breaker_reset_s",
    "serve_fleet_hedge_ms", "serve_fleet_retry_deadline_s",
)


@dataclasses.dataclass
class Word2VecConfig:
    """Configuration for word2vec training; see the JAX package's field comments.

    ``check_ported`` (init-only, not a field): False skips the refusal of unported
    knobs. Only checkpoint readers pass it, so that a model trained with a path the
    port does not have yet (e.g. the per-pair step) can still be loaded for the
    model ops, which do not depend on it.
    """

    # --- core hyperparameters (reference defaults) ---
    vector_size: int = 100
    learning_rate: float = 0.01875
    num_partitions: int = 1
    num_iterations: int = 1
    min_count: int = 5
    max_sentence_length: int = 1000
    window: int = 5
    batch_size: int = 50
    negatives: int = 5
    subsample_ratio: float = -1.0   # -1 = AUTO: 1e-3, which the Trainer may lower
    seed: int = 0

    # --- sharding / deployment (the port runs on one device) ---
    num_model_shards: int = 1
    num_data_shards: int = 1
    embedding_partition: str = "rows"
    mesh_shape: Optional[Tuple[int, int]] = None
    step_lowering: str = "gspmd"
    sync_every: int = 1

    # --- negative-sampling table ---
    unigram_table_size: int = 100_000_000
    sample_power: float = 0.75

    # --- step geometry and numerics ---
    pairs_per_batch: int = 8192
    sigmoid_mode: str = "exact"     # "exact" or "clipped" (sigma saturates past +-6)
    allow_unstable: bool = False
    duplicate_scaling: bool = False
    negative_pool: int = -1         # -1 = AUTO (see __post_init__ and the Trainer)
    pad_vector_to_lanes: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    logits_dtype: str = "float32"
    fused_logits: bool = False
    bf16_chain: bool = False
    hot_rows: int = 0
    hot_flush_every: int = 0        # inert while hot_rows == 0
    use_pallas: bool = False        # the TPU kernel switch; on CUDA the hand-written
                                    # kernel is the default shared-pool step
    sharded_checkpoint: bool = False
    cbow: bool = False
    cbow_update: str = "scatter"
    shuffle: bool = True

    # --- lr decay and dispatch ---
    min_alpha_factor: float = 1e-4
    decay_interval_words: int = 10_000
    steps_per_dispatch: int = 16
    heartbeat_every_steps: int = 100
    prefetch_chunks: int = 8        # wall clock only: the port's feed is serial
    profile_dir: str = ""
    feed_consistency_check: bool = False  # multi-process only: inert here
    shard_input: bool = True              # multi-process only: inert here
    device_pairgen: bool = False
    tokens_per_step: int = 0              # device_pairgen only: inert here

    # --- host data plane (wall clock only; the port runs serially) ---
    producer_workers: int = 1
    io_workers: int = 1
    sharded_prefetch: bool = True         # multi-process only: inert here

    # --- fault tolerance ---
    nonfinite_policy: str = "halt"  # "halt" and "none" are ported, "rollback" is not
    rollback_history: int = 2
    max_rollbacks: int = 8

    # --- run telemetry ---
    telemetry_path: str = ""
    telemetry_rotate_bytes: int = 64 << 20
    heartbeat_ring: int = 512
    norm_watch: str = "off"
    norm_watch_threshold: float = 100.0
    norm_watch_frac: float = 0.01
    norm_watch_max: float = 1000.0
    max_row_norm: float = 0.0
    update_clip: float = 0.0
    row_l2: float = 0.0
    recover_lr_backoff: float = 0.5
    max_recoveries: int = 4
    profile_steps: int = 0
    status_port: int = 0
    blackbox_ring: int = 256

    # --- preemption and supervisor (supervisor_* are read by the supervisor
    # process only) ---
    checkpoint_on_preempt: bool = False
    preempt_deadline_s: float = 30.0
    peer_beacon_s: float = 0.0
    supervisor_stall_s: float = 300.0
    supervisor_max_restarts: int = 8
    supervisor_loop_window: int = 3

    # --- serving tier (not ported) ---
    serve_max_batch: int = 64
    serve_max_delay_ms: float = 2.0
    serve_queue_depth: int = 256
    serve_ann_centroids: int = 0
    serve_ann_nprobe: int = 0
    serve_ann_quant: str = "f32"
    serve_ann_pq_m: int = 0
    serve_ann_rerank: int = 0
    serve_ann_recall_floor: float = -1.0
    serve_ann_max_densify_bytes: int = 8 << 30
    serve_reload_poll_s: float = 0.5
    serve_fleet_replicas: int = 3
    serve_fleet_probe_s: float = 0.5
    serve_fleet_breaker_failures: int = 3
    serve_fleet_breaker_reset_s: float = 2.0
    serve_fleet_hedge_ms: float = -1.0
    serve_fleet_retry_deadline_s: float = 10.0

    # --- continual training (read by the continual driver only) ---
    continual_min_new_words: int = 1
    continual_lr_rewarm: float = 1.0
    continual_iterations: int = 1
    continual_replay_segments: int = 0
    continual_poll_s: float = 2.0

    check_ported: dataclasses.InitVar[bool] = True

    def __post_init__(self, check_ported: bool) -> None:
        if check_ported:
            self._refuse_unported()
        _validate_ranges(self)
        # remembered so the Trainer may auto-lower an AUTO ratio (explicit values are
        # refused instead)
        self._auto_subsample = self.subsample_ratio == -1.0
        if self._auto_subsample:
            self.subsample_ratio = 1e-3
        if not (0 <= self.subsample_ratio <= 1):
            raise ValueError(
                f"subsample_ratio must be in [0, 1] (or -1 for auto) "
                f"but got {self.subsample_ratio}")
        # remembered so replace() re-derives the pool when the batch geometry changes
        self._auto_pool = self.negative_pool == -1
        if self.negative_pool == -1:
            if self.cbow and self.duplicate_scaling:
                self.negative_pool = 0
            elif (self.pairs_per_batch < 4096 and not self.use_pallas
                    and self.cbow_update != "banded"
                    and self.step_lowering != "shard_map"):
                # small batches take the reference's per-pair path
                self.negative_pool = 0
            else:
                # smallest multiple of 128 keeping the pool-row load
                # pairs_per_batch * negatives / pool <= 600
                p_min = -(-self.pairs_per_batch * self.negatives // 600)
                self.negative_pool = max(128, 128 * (-(-p_min // 128)))
        if self.negative_pool < 0:
            raise ValueError(
                f"negative_pool must be nonnegative (or -1 for auto) "
                f"but got {self.negative_pool}")
        if check_ported and self.negative_pool == 0:
            raise NotImplementedError(
                "negative_pool resolves to 0 (the per-pair step: pairs_per_batch < 4096 "
                "with an AUTO pool, or negative_pool=0) and the per-pair step is not "
                "ported to glint_word2vec_torch yet; set negative_pool > 0 or "
                "pairs_per_batch >= 4096")

    def _refuse_unported(self) -> None:
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name in _UNPORTED:
            value = getattr(self, name)
            if value != defaults[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported to glint_word2vec_torch yet "
                    f"(default {defaults[name]!r}); see ROADMAP.md queue A")
        if self.mesh_shape is not None and tuple(self.mesh_shape) != (1, 1):
            raise NotImplementedError(
                f"mesh_shape={self.mesh_shape!r}: the port trains on one device; "
                "multi-device meshes are not ported yet")
        if self.nonfinite_policy == "rollback":
            raise NotImplementedError(
                "nonfinite_policy='rollback' (snapshot ring + lattice re-seed) is not "
                "ported to glint_word2vec_torch yet; use 'halt' or 'none'")

    def replace(self, **kwargs) -> "Word2VecConfig":
        # keep AUTO-ness: a resolved AUTO value must re-derive on the new config
        if getattr(self, "_auto_pool", False) and "negative_pool" not in kwargs:
            kwargs["negative_pool"] = -1
        if getattr(self, "_auto_subsample", False) and "subsample_ratio" not in kwargs:
            kwargs["subsample_ratio"] = -1.0
        return dataclasses.replace(self, **kwargs)

    def to_dict(self, auto_markers: bool = True) -> dict:
        """All fields. ``auto_markers=False`` (checkpoints) stores the RESOLVED
        subsample ratio and pool instead of the -1 AUTO markers."""
        d = dataclasses.asdict(self)
        if auto_markers and getattr(self, "_auto_subsample", False):
            d["subsample_ratio"] = -1.0
        if auto_markers and getattr(self, "_auto_pool", False):
            d["negative_pool"] = -1
        return d

    @classmethod
    def from_dict(cls, d: dict, check_ported: bool = True) -> "Word2VecConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        clean = {k: v for k, v in d.items() if k in fields}
        if "mesh_shape" in clean and clean["mesh_shape"] is not None:
            clean["mesh_shape"] = tuple(clean["mesh_shape"])
        if (clean.get("cbow") and clean.get("duplicate_scaling")
                and clean.get("negative_pool", 0) > 0
                and clean.get("cbow_update", "scatter") == "scatter"):
            # the JAX package's normalization of old cbow+duplicate_scaling configs
            clean["negative_pool"] = 0
        return cls(**clean, check_ported=check_ported)


def _validate_ranges(c: Word2VecConfig) -> None:
    """The JAX package's range checks for the knobs the port reads."""
    positive = ("vector_size", "learning_rate", "num_partitions", "max_sentence_length",
                "window", "batch_size", "negatives", "unigram_table_size",
                "pairs_per_batch", "steps_per_dispatch", "heartbeat_every_steps",
                "producer_workers", "io_workers", "heartbeat_ring",
                "rollback_history", "num_model_shards", "num_data_shards",
                "sync_every")
    for name in positive:
        if getattr(c, name) <= 0:
            raise ValueError(f"{name} must be positive but got {getattr(c, name)}")
    nonnegative = ("num_iterations", "min_count", "prefetch_chunks", "tokens_per_step",
                   "hot_rows", "hot_flush_every", "max_rollbacks")
    for name in nonnegative:
        if getattr(c, name) < 0:
            raise ValueError(f"{name} must be nonnegative but got {getattr(c, name)}")
    if c.window > 127:
        raise ValueError(f"window must be <= 127 but got {c.window}")
    if c.sigmoid_mode not in ("exact", "clipped"):
        raise ValueError(
            f"sigmoid_mode must be 'exact' or 'clipped' but got {c.sigmoid_mode!r}")
    if c.nonfinite_policy not in ("halt", "rollback", "none"):
        raise ValueError(
            f"nonfinite_policy must be 'halt', 'rollback', or 'none' "
            f"but got {c.nonfinite_policy!r}")
