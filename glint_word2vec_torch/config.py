"""Hyperparameter surface, ported from ``glint_word2vec_tpu/config.py``.

Same fields, defaults, AUTO rules and ``to_dict``/``from_dict`` key set as the JAX
package, because checkpoints of either package carry the config and must load in the
other. The field comments there hold the provenance of every default; this module
repeats only what the port does differently.

The port implements the single-device steps: skip-gram with a shared negative pool or
with per-pair negatives (``negative_pool`` resolving to 0), fed by host pairs or, with
``device_pairgen``, by token blocks the card expands into pairs; scatter CBOW with
either pool, and banded CBOW (``cbow_update="banded"``) on halo-overlapped token
blocks; each with the in-step stabilizers (``max_row_norm``, ``update_clip``,
``row_l2``) and, where the JAX package has it, ``duplicate_scaling``; each in float32
or bfloat16 (``param_dtype``, ``compute_dtype``, ``logits_dtype``), and the skip-gram
steps with the step restructurings ``fused_logits``, ``bf16_chain`` and ``hot_rows``
(the JAX package's selection matrix, copied by :func:`_validate_restructurings`). A knob that would
change the results of training and is not ported yet raises :class:`NotImplementedError` naming it, at construction, when set off its
default; it is never silently ignored. The host data plane's knobs change wall clock
only, in both packages (the results are bit-identical at any value):
``prefetch_chunks``, ``producer_workers`` and ``io_workers`` (vocabulary counting,
checkpoint and export I/O) mean what they mean in the JAX package. So do the runtime
layer's knobs (``nonfinite_policy`` with ``rollback``, ``norm_watch`` and its recovery
ladder, ``telemetry_path``, ``status_port``, ``checkpoint_on_preempt``), with
``profile_dir`` recording a ``torch.profiler`` trace where the JAX package records a
``jax.profiler`` one.

On a (data, model) mesh of ranks (``num_data_shards`` x ``num_model_shards``, or
``mesh_shape``; one rank a card, ``parallel/``) the port trains every step form
row-sharded: skip-gram with the shared pool or per pair, scatter CBOW with either pool,
banded CBOW, ``duplicate_scaling`` where the JAX package has it, with ``sync_every``
(local SGD), ``shard_input``, ``device_pairgen``, ``sharded_prefetch``,
``sharded_checkpoint`` and ``peer_beacon_s`` as in the JAX package. ``step_lowering``
takes both values and the JAX package's selection matrix (:func:`_validate_mesh`); the
port has one schedule for both, the owner-local one. ``embedding_partition="cols"``
(the reference's column layout: partial dot products summed over the model axis) trains
every synchronous form, with the JAX package's refusals (``sharded_checkpoint``,
``hot_rows``, ``step_lowering="shard_map"`` and with it ``sync_every > 1``);
``hot_rows`` on a mesh raises the JAX package's own refusal. The
serving tier's ``serve_*`` knobs, the fleet's ``serve_fleet_*`` among them, are
read only by :mod:`.serve`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Knobs not ported, refused off their default: use_pallas, by design (ROADMAP C).
_UNPORTED = ("use_pallas",)


@dataclasses.dataclass
class Word2VecConfig:
    """Configuration for word2vec training; see the JAX package's field comments.

    ``check_ported`` (init-only, not a field): False skips the refusal of unported
    knobs. Only checkpoint readers pass it, so that a model trained with a path the
    port does not have yet (e.g. a multi-device mesh) can still be loaded for the model
    ops, which do not depend on it.
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

    # --- sharding / deployment (a mesh of ranks, one a device: parallel/) ---
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
    prefetch_chunks: int = 8        # chunks a producer thread assembles (and, on the
                                    # card, stages) ahead; 0 = on the calling thread
    profile_dir: str = ""           # torch.profiler's Chrome trace goes here
    feed_consistency_check: bool = False  # debug, multi-process: every round's feed
                                          # fingerprinted and compared across ranks
                                          # (one tiny allgather a round)
    shard_input: bool = True              # multi-process: each rank feeds its 1/W
    device_pairgen: bool = False          # the card expands token blocks into pairs
    tokens_per_step: int = 0              # device_pairgen: token slots per step; 0 =
                                          # sized by the Trainer for ~93% pair fill

    # --- host data plane (wall clock only) ---
    producer_workers: int = 1             # feed slabs generated on a thread pool
    io_workers: int = 1                   # vocabulary counting, checkpoint and
                                          # export I/O threads
    sharded_prefetch: bool = True         # the mesh token feed: rounds staged one
                                          # ahead on a thread (with prefetch_chunks)

    # --- fault tolerance ---
    nonfinite_policy: str = "halt"
    rollback_history: int = 2
    max_rollbacks: int = 8

    # --- run telemetry (glint_word2vec_torch/obs; snapshots stay on the device) ---
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

    # --- preemption and supervisor (supervisor_* are the defaults of
    # train_run's flags, read by no fit; peer_beacon_s arms a multi-process fit's
    # liveness beacons) ---
    checkpoint_on_preempt: bool = False
    preempt_deadline_s: float = 30.0
    peer_beacon_s: float = 0.0
    supervisor_stall_s: float = 300.0
    supervisor_max_restarts: int = 8
    supervisor_loop_window: int = 3

    # --- serving tier (read by the serving process and the fleet's router, never by
    # the trainer; serve/) ---
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
        if self.embedding_partition not in ("rows", "cols"):
            raise ValueError(
                f"embedding_partition must be 'rows' or 'cols', "
                f"got {self.embedding_partition!r}")
        # before the unported knobs, so that their combinations with use_pallas get
        # the JAX package's answer; each matrix in the JAX package's order, so that a
        # config with several faults gets its first refusal too
        _validate_cbow(self)
        _validate_stabilizers(self)
        _validate_dtypes(self)
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
        # after the pool resolves (bf16_chain reads it), before the unported knobs
        _validate_restructurings(self)
        _validate_mesh(self)
        _validate_device_pairgen(self)
        _validate_layout(self)
        if check_ported:
            self._refuse_unported()
        _validate_ranges(self)

    def _refuse_unported(self) -> None:
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name in _UNPORTED:
            value = getattr(self, name)
            if value != defaults[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported to glint_word2vec_torch "
                    f"(default {defaults[name]!r}); see ROADMAP.md "
                    "section C")

    @property
    def mesh_size(self) -> Tuple[int, int]:
        """The (data, model) mesh the config asks for: ``mesh_shape``, else
        (num_data_shards, num_model_shards)."""
        if self.mesh_shape is not None:
            return tuple(self.mesh_shape)
        return (self.num_data_shards, self.num_model_shards)

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


def _validate_cbow(c: Word2VecConfig) -> None:
    """The JAX package's CBOW update-path checks, copied as they stand."""
    if c.cbow_update not in ("scatter", "banded"):
        raise ValueError(
            f"cbow_update must be 'scatter' or 'banded' "
            f"but got {c.cbow_update!r}")
    if c.cbow_update == "banded":
        if not c.cbow:
            raise ValueError(
                "cbow_update='banded' requires cbow=True — the knob "
                "selects the CBOW step formulation")
        if c.duplicate_scaling:
            raise ValueError(
                "cbow_update='banded' does not support "
                "duplicate_scaling=True: mean-update semantics are only "
                "implemented on the scatter path (its per-context-set "
                "occurrence counts have no banded form) — use "
                "cbow_update='scatter'")
        if c.use_pallas:
            raise ValueError(
                "cbow_update='banded' is an XLA path; use_pallas=True "
                "(the fused SGNS kernel) does not apply to CBOW")
        if c.negative_pool == 0:
            raise ValueError(
                "cbow_update='banded' requires the shared-pool estimator "
                "(negative_pool > 0, or -1 for auto); per-example "
                "negatives (negative_pool=0) are scatter-path only")
        if c.tokens_per_step:
            raise ValueError(
                "cbow_update='banded' derives its token-block size from "
                "pairs_per_batch + window; tokens_per_step is the "
                "device_pairgen knob — leave it 0")
        if c.window < 2:
            raise ValueError(
                "cbow_update='banded' with window=1 emits no contexts at "
                "all under the reference's legacy asymmetric window "
                "(b = nextInt(1) = 0 always) — use window >= 2")
    if c.use_pallas and c.cbow:
        raise ValueError(
            "use_pallas=True is not implemented for CBOW — the fused "
            "kernel is SGNS-only; use the XLA CBOW paths "
            "(cbow_update='scatter'/'banded')")
    if c.cbow and c.duplicate_scaling and c.negative_pool > 0:
        raise ValueError(
            "CBOW with duplicate_scaling=True implements mean semantics "
            "per-example only; an explicit negative_pool > 0 would be "
            "silently ignored — set negative_pool=0 (or -1 for auto, "
            "which resolves to 0 here)")


def _validate_stabilizers(c: Word2VecConfig) -> None:
    """The JAX package's refusals of the stabilizers and ``duplicate_scaling`` beside
    ``use_pallas``, and its ranges of the stabilizers, copied as they stand."""
    if c.use_pallas:
        if c.duplicate_scaling:
            raise ValueError(
                "duplicate_scaling is not implemented for use_pallas=True "
                "— the fused kernel applies sum semantics only; use the "
                "XLA path or bound the row loads via "
                "negative_pool/subsample_ratio instead")
        if c.max_row_norm or c.update_clip or c.row_l2:
            raise ValueError(
                "the in-step stabilizers (max_row_norm/update_clip/"
                "row_l2) are not implemented for use_pallas=True — the "
                "fused kernel owns its own update math; use the XLA "
                "paths, which compile the stabilizers into every "
                "lowering (ops/sgns.py)")
        if c.norm_watch == "recover":
            raise ValueError(
                "norm_watch='recover' auto-engages max_row_norm, which "
                "the fused pallas kernel does not implement — use "
                "norm_watch='warn'/'halt' with use_pallas=True, or the "
                "XLA paths for auto-recovery")
    if c.max_row_norm < 0:
        raise ValueError(
            f"max_row_norm must be nonnegative (0 = off) but got {c.max_row_norm}")
    if c.update_clip < 0:
        raise ValueError(
            f"update_clip must be nonnegative (0 = off) but got {c.update_clip}")
    if not (0 <= c.row_l2 < 1):
        raise ValueError(f"row_l2 must be in [0, 1) (0 = off) but got {c.row_l2}")


def _validate_dtypes(c: Word2VecConfig) -> None:
    """The JAX package's dtype string checks, copied as they stand."""
    for name in ("param_dtype", "compute_dtype", "logits_dtype"):
        value = getattr(c, name)
        if value not in ("float32", "bfloat16"):
            raise ValueError(
                f"{name} must be 'float32' or 'bfloat16' but got {value!r}")


def _validate_restructurings(c: Word2VecConfig) -> None:
    """The JAX package's step-restructuring selection matrix (``fused_logits``,
    ``bf16_chain``, ``hot_rows`` against CBOW, ``use_pallas``, ``duplicate_scaling``,
    the stabilizers, ``norm_watch="recover"``, shard_map, the column layout and
    multi-shard meshes; ``hot_flush_every`` dividing ``steps_per_dispatch``), copied
    as it stands, classes and messages included. Runs on the resolved pool."""
    if c.fused_logits:
        if c.use_pallas:
            raise ValueError(
                "fused_logits=True is an XLA-chain restructuring; "
                "use_pallas=True owns the whole step — drop one")
        if c.cbow:
            raise ValueError(
                "fused_logits=True is implemented for the SGNS logit "
                "chains only (per-pair and shared-pool); CBOW keeps the "
                "classic chain — set fused_logits=False")
        if c.duplicate_scaling:
            raise ValueError(
                "fused_logits=True does not support duplicate_scaling="
                "True: mean-update semantics read the per-pair "
                "coefficient arrays the fused chain eliminates — use "
                "the classic chain")
    if c.bf16_chain:
        if c.use_pallas:
            raise ValueError(
                "bf16_chain=True is an XLA-chain restructuring; "
                "use_pallas=True owns the whole step — drop one")
        if c.cbow:
            raise ValueError(
                "bf16_chain=True is implemented for the SGNS paths "
                "only; CBOW keeps the classic chain — set "
                "bf16_chain=False")
        if c.compute_dtype != "bfloat16":
            raise ValueError(
                "bf16_chain=True requires compute_dtype='bfloat16' — "
                "with float32 compute there is no reduced-precision "
                "chain to carry end-to-end")
        if c.negative_pool != 0 and c.logits_dtype != "bfloat16":
            raise ValueError(
                "bf16_chain=True with a shared negative pool requires "
                "logits_dtype='bfloat16': a float32 [B, pool] logit "
                "chain would silently keep the dense traffic the knob "
                "exists to remove")
    if c.hot_rows < 0:
        raise ValueError(
            f"hot_rows must be nonnegative (0 = off) "
            f"but got {c.hot_rows}")
    if c.hot_flush_every < 0:
        raise ValueError(
            f"hot_flush_every must be nonnegative (0 = auto: once per "
            f"dispatch chunk) but got {c.hot_flush_every}")
    if not c.hot_rows:
        return
    if c.use_pallas:
        raise ValueError(
            "hot_rows is not implemented for use_pallas=True — the "
            "fused kernel owns its own update math; use the XLA "
            "SGNS paths")
    if c.cbow:
        raise ValueError(
            "hot_rows is implemented for the SGNS paths only; CBOW "
            "keeps the classic per-step scatters — set hot_rows=0")
    if c.duplicate_scaling:
        raise ValueError(
            "hot_rows does not support duplicate_scaling=True: "
            "mean-update scaling and cross-step slab accumulation "
            "compose into semantics nothing has EVAL evidence for — "
            "use one or the other")
    if c.step_lowering == "shard_map":
        raise ValueError(
            "hot_rows has no shard_map form: the hot slab is the "
            "global index prefix [0, K), which under the rows "
            "layout lives entirely on model shard 0 — owner-local "
            "accumulation would serialize every hot update onto one "
            "shard (documented refusal, docs/sharding.md); use "
            "step_lowering='gspmd' on a single device")
    if c.embedding_partition == "cols":
        raise ValueError(
            "hot_rows requires the rows layout (the slab is a "
            "whole-row prefix block); embedding_partition='cols' "
            "owns columns — use 'rows'")
    if c.num_model_shards > 1 or c.num_data_shards > 1:
        raise ValueError(
            "hot_rows is the single-chip step restructuring "
            "(PERF.md §11); multi-shard meshes keep the classic "
            "scatters — set hot_rows=0 or use a 1x1 mesh")
    if c.mesh_shape is not None and tuple(c.mesh_shape) != (1, 1):
        raise ValueError(
            "hot_rows is the single-chip step restructuring "
            f"(PERF.md §11); mesh_shape={c.mesh_shape} keeps the "
            "classic scatters — set hot_rows=0 or use (1, 1)")
    if c.max_row_norm or c.update_clip or c.row_l2:
        raise ValueError(
            "hot_rows is incompatible with the in-step stabilizers "
            "(max_row_norm/update_clip/row_l2): the post-scatter "
            "touched-row pass would measure hot rows missing their "
            "pending slab deltas — clamping a partial row is the "
            "silent-distortion class the stabilizers exist to "
            "prevent; use one or the other")
    if c.norm_watch == "recover":
        raise ValueError(
            "hot_rows is incompatible with norm_watch='recover' "
            "(the recovery ladder auto-engages max_row_norm, which "
            "has no hot-row form); use norm_watch='warn'/'halt' or "
            "hot_rows=0")
    if c.hot_flush_every and (
            c.hot_flush_every > c.steps_per_dispatch
            or c.steps_per_dispatch % c.hot_flush_every):
        raise ValueError(
            f"hot_flush_every={c.hot_flush_every} must divide "
            f"steps_per_dispatch={c.steps_per_dispatch}: the hot "
            f"slab lives in the dispatch chunk's scan carry and "
            f"every chunk flushes at its end, so the cadence cannot "
            f"exceed or straddle the chunk (0 = auto: once per "
            f"chunk)")


def _validate_mesh(c: Word2VecConfig) -> None:
    """The JAX package's ``step_lowering`` and ``sync_every`` selection matrices, and
    its column-layout checkpoint refusal, copied as they stand (classes and messages
    included). ``step_lowering="gspmd"`` on a mesh runs the same owner-local schedule
    in the port (it has no compiler to choose another)."""
    if c.step_lowering not in ("gspmd", "shard_map"):
        raise ValueError(
            f"step_lowering must be 'gspmd' or 'shard_map' "
            f"but got {c.step_lowering!r}")
    if c.step_lowering == "shard_map":
        if c.cbow:
            raise ValueError(
                "step_lowering='shard_map' is implemented for the "
                "shared-pool skip-gram step only; CBOW runs under GSPMD "
                "(step_lowering='gspmd')")
        if c.use_pallas:
            raise ValueError(
                "step_lowering='shard_map' and use_pallas=True both claim "
                "the step lowering; the pallas kernel is single-device "
                "only — drop one")
        if c.duplicate_scaling:
            raise ValueError(
                "step_lowering='shard_map' does not support "
                "duplicate_scaling=True: mean-update semantics need global "
                "in-batch occurrence counts, a [V]-sized cross-shard psum "
                "the explicit schedule exists to avoid — use 'gspmd'")
        if c.negative_pool == 0:
            raise ValueError(
                "step_lowering='shard_map' requires the shared-pool "
                "estimator (negative_pool > 0, or -1 for auto at "
                "pairs_per_batch >= 4096); per-pair negatives "
                "(negative_pool=0) are GSPMD-path only")
        if c.embedding_partition != "rows":
            raise ValueError(
                "step_lowering='shard_map' is the rows-layout schedule "
                "(owner-local row scatters); embedding_partition="
                f"{c.embedding_partition!r} keeps GSPMD")
    if c.sync_every <= 0:
        raise ValueError(
            f"sync_every must be positive (1 = synchronous) "
            f"but got {c.sync_every}")
    if c.sync_every > 1:
        if c.step_lowering != "shard_map":
            raise ValueError(
                f"sync_every={c.sync_every} (local-SGD) requires "
                f"step_lowering='shard_map': the k owner-local steps "
                f"reuse the explicit schedule's owner-local gather/"
                f"scatter machinery, which has no GSPMD form (and no "
                f"CBOW form — CBOW runs under GSPMD); got "
                f"step_lowering={c.step_lowering!r}")
        if c.device_pairgen:
            raise ValueError(
                f"sync_every={c.sync_every} (local-SGD) supports the "
                f"host packed-pair feed only; device_pairgen's token-"
                f"block chunks have no windowed form")
        if c.steps_per_dispatch % c.sync_every:
            raise ValueError(
                f"sync_every={c.sync_every} must divide "
                f"steps_per_dispatch={c.steps_per_dispatch}: the "
                f"local-SGD window lives inside the dispatch chunk's "
                f"scan and every chunk ends merged, so the merge cadence "
                f"cannot exceed or straddle the chunk (snapshot-ring/"
                f"rollback/preemption saves land on merge boundaries "
                f"only)")


def _validate_layout(c: Word2VecConfig) -> None:
    """The JAX package's checks of the layout beside the checkpoint format and of the
    data axis, copied as they stand."""
    if c.embedding_partition == "cols" and c.sharded_checkpoint:
        raise ValueError(
            "embedding_partition='cols' does not support "
            "sharded_checkpoint=True: row-shards checkpoints need each "
            "process to own whole rows (design rationale: PERF.md §7); "
            "use 'rows'")
    if c.num_data_shards <= 0:
        raise ValueError(
            f"num_data_shards must be positive but got {c.num_data_shards}")


def _validate_device_pairgen(c: Word2VecConfig) -> None:
    """The JAX package's four device_pairgen refusals, copied as they stand. The
    port's prefix sums are exact at any size, but it refuses the same 2^24 bound so
    that both packages accept the same configs."""
    if not c.device_pairgen:
        return
    if c.cbow:
        raise ValueError(
            "device_pairgen is skip-gram only (CBOW batches are grouped windows the "
            "device generator does not produce)")
    if c.use_pallas:
        raise ValueError(
            "device_pairgen is not supported with use_pallas — the fused kernel owns "
            "the whole step and consumes host pairs; drop one")
    if c.window == 1:
        raise ValueError(
            "device_pairgen with window=1 emits no pairs at all under the reference's "
            "legacy asymmetric window (b = nextInt(1) = 0 always, and the right bound "
            "is exclusive) — use window >= 2")
    if c.tokens_per_step > 0 and c.tokens_per_step * (2 * c.window - 1) >= 1 << 24:
        raise ValueError(
            f"tokens_per_step={c.tokens_per_step} with window={c.window} overflows the "
            f"device generator's exact-f32 prefix-sum bound (T * (2*window - 1) must "
            f"stay below 2^24); lower tokens_per_step or split the batch")


def _validate_ranges(c: Word2VecConfig) -> None:
    """The JAX package's range checks for the knobs the port reads."""
    positive = ("vector_size", "learning_rate", "num_partitions", "max_sentence_length",
                "window", "batch_size", "negatives", "unigram_table_size",
                "pairs_per_batch", "steps_per_dispatch", "heartbeat_every_steps",
                "heartbeat_ring", "rollback_history", "num_model_shards",
                "num_data_shards", "sync_every")
    for name in positive:
        if getattr(c, name) <= 0:
            raise ValueError(f"{name} must be positive but got {getattr(c, name)}")
    nonnegative = ("num_iterations", "min_count", "tokens_per_step", "hot_rows",
                   "hot_flush_every", "max_rollbacks")
    for name in nonnegative:
        if getattr(c, name) < 0:
            raise ValueError(f"{name} must be nonnegative but got {getattr(c, name)}")
    if c.prefetch_chunks < 0:
        raise ValueError(f"prefetch_chunks must be nonnegative (0 = synchronous) "
                         f"but got {c.prefetch_chunks}")
    if c.producer_workers < 1:
        raise ValueError(f"producer_workers must be >= 1 (1 = serial producer) "
                         f"but got {c.producer_workers}")
    if c.io_workers < 1:
        raise ValueError(f"io_workers must be >= 1 (1 = serial I/O) "
                         f"but got {c.io_workers}")
    if c.window > 127:
        raise ValueError(f"window must be <= 127 but got {c.window}")
    if c.sigmoid_mode not in ("exact", "clipped"):
        raise ValueError(
            f"sigmoid_mode must be 'exact' or 'clipped' but got {c.sigmoid_mode!r}")
    if c.nonfinite_policy not in ("halt", "rollback", "none"):
        raise ValueError(
            f"nonfinite_policy must be 'halt', 'rollback', or 'none' "
            f"but got {c.nonfinite_policy!r}")
    _validate_runtime(c)
    _validate_serving(c)
    _validate_continual(c)


def _validate_runtime(c: Word2VecConfig) -> None:
    """The JAX package's range checks of the runtime layer's knobs, copied as they
    stand."""
    if c.norm_watch not in ("off", "warn", "recover", "halt"):
        raise ValueError(
            f"norm_watch must be 'off', 'warn', 'recover', or 'halt' "
            f"but got {c.norm_watch!r}")
    if not (0 < c.recover_lr_backoff <= 1):
        raise ValueError(
            f"recover_lr_backoff must be in (0, 1] but got {c.recover_lr_backoff}")
    if c.max_recoveries < 0:
        raise ValueError(
            f"max_recoveries must be nonnegative but got {c.max_recoveries}")
    if c.norm_watch_threshold <= 0:
        raise ValueError(
            f"norm_watch_threshold must be positive but got {c.norm_watch_threshold}")
    if c.norm_watch_max <= 0:
        raise ValueError(f"norm_watch_max must be positive but got {c.norm_watch_max}")
    if not (0 < c.norm_watch_frac <= 1):
        raise ValueError(
            f"norm_watch_frac must be in (0, 1] but got {c.norm_watch_frac}")
    if c.telemetry_rotate_bytes <= 0:
        raise ValueError(
            f"telemetry_rotate_bytes must be positive "
            f"but got {c.telemetry_rotate_bytes}")
    if c.profile_steps < 0:
        raise ValueError(f"profile_steps must be nonnegative but got {c.profile_steps}")
    if not (0 <= c.status_port <= 65535):
        raise ValueError(
            f"status_port must be in [0, 65535] (0 = off) but got {c.status_port}")
    if c.blackbox_ring <= 0:
        raise ValueError(f"blackbox_ring must be positive but got {c.blackbox_ring}")
    if c.preempt_deadline_s <= 0:
        raise ValueError(
            f"preempt_deadline_s must be positive but got {c.preempt_deadline_s}")
    if c.peer_beacon_s < 0:
        raise ValueError(
            f"peer_beacon_s must be nonnegative (0 = off) but got {c.peer_beacon_s}")
    if c.supervisor_stall_s <= 0:
        raise ValueError(
            f"supervisor_stall_s must be positive but got {c.supervisor_stall_s}")
    if c.supervisor_max_restarts < 0:
        raise ValueError(
            f"supervisor_max_restarts must be nonnegative "
            f"but got {c.supervisor_max_restarts}")
    if c.supervisor_loop_window < 2:
        # 1 would class every second failure as a deterministic loop
        raise ValueError(
            f"supervisor_loop_window must be >= 2 but got {c.supervisor_loop_window}")


def _validate_serving(c: Word2VecConfig) -> None:
    """The JAX package's range checks of the serving tier's knobs, copied as they
    stand."""
    if c.serve_max_batch <= 0:
        raise ValueError(
            f"serve_max_batch must be positive but got {c.serve_max_batch}")
    if c.serve_max_delay_ms < 0:
        raise ValueError(
            f"serve_max_delay_ms must be nonnegative (0 = dispatch immediately) "
            f"but got {c.serve_max_delay_ms}")
    if c.serve_queue_depth <= 0:
        raise ValueError(
            f"serve_queue_depth must be positive but got {c.serve_queue_depth}")
    if c.serve_ann_centroids < 0:
        raise ValueError(
            f"serve_ann_centroids must be nonnegative (0 = auto) "
            f"but got {c.serve_ann_centroids}")
    if c.serve_ann_nprobe < 0:
        raise ValueError(
            f"serve_ann_nprobe must be nonnegative (0 = auto) "
            f"but got {c.serve_ann_nprobe}")
    if c.serve_ann_quant not in ("f32", "int8", "pq"):
        raise ValueError(
            f"serve_ann_quant must be one of 'f32', 'int8', 'pq' "
            f"but got {c.serve_ann_quant!r}")
    if c.serve_ann_pq_m < 0:
        raise ValueError(
            f"serve_ann_pq_m must be nonnegative (0 = auto ~D/8) "
            f"but got {c.serve_ann_pq_m}")
    if c.serve_ann_rerank < -1:
        raise ValueError(
            f"serve_ann_rerank must be -1 (off), 0 (auto), or a "
            f"positive shortlist size but got {c.serve_ann_rerank}")
    if not (c.serve_ann_recall_floor == -1.0
            or 0.0 <= c.serve_ann_recall_floor <= 1.0):
        raise ValueError(
            f"serve_ann_recall_floor must be -1 (auto per-arm floor) "
            f"or in [0, 1] (0 = disabled) "
            f"but got {c.serve_ann_recall_floor}")
    if c.serve_ann_max_densify_bytes < 0:
        raise ValueError(
            f"serve_ann_max_densify_bytes must be nonnegative "
            f"(0 = unlimited) but got {c.serve_ann_max_densify_bytes}")
    if c.serve_reload_poll_s <= 0:
        raise ValueError(
            f"serve_reload_poll_s must be positive but got {c.serve_reload_poll_s}")
    if c.serve_fleet_replicas <= 0:
        raise ValueError(
            f"serve_fleet_replicas must be positive "
            f"but got {c.serve_fleet_replicas}")
    if c.serve_fleet_probe_s <= 0:
        raise ValueError(
            f"serve_fleet_probe_s must be positive "
            f"but got {c.serve_fleet_probe_s}")
    if c.serve_fleet_breaker_failures <= 0:
        raise ValueError(
            f"serve_fleet_breaker_failures must be positive "
            f"but got {c.serve_fleet_breaker_failures}")
    if c.serve_fleet_breaker_reset_s <= 0:
        raise ValueError(
            f"serve_fleet_breaker_reset_s must be positive "
            f"but got {c.serve_fleet_breaker_reset_s}")
    if c.serve_fleet_hedge_ms < 0 and c.serve_fleet_hedge_ms != -1.0:
        raise ValueError(
            f"serve_fleet_hedge_ms must be -1 (auto: p99-derived), "
            f"0 (off), or a positive delay in ms "
            f"but got {c.serve_fleet_hedge_ms}")
    if c.serve_fleet_retry_deadline_s <= 0:
        raise ValueError(
            f"serve_fleet_retry_deadline_s must be positive "
            f"but got {c.serve_fleet_retry_deadline_s}")


def _validate_continual(c: Word2VecConfig) -> None:
    """The JAX package's range checks of the continual runner's knobs, copied as they
    stand."""
    if c.continual_min_new_words <= 0:
        raise ValueError(
            f"continual_min_new_words must be positive "
            f"but got {c.continual_min_new_words}")
    if c.continual_lr_rewarm <= 0:
        raise ValueError(
            f"continual_lr_rewarm must be positive but got {c.continual_lr_rewarm}")
    if c.continual_iterations <= 0:
        raise ValueError(
            f"continual_iterations must be positive but got {c.continual_iterations}")
    if c.continual_replay_segments < 0:
        raise ValueError(
            f"continual_replay_segments must be nonnegative "
            f"but got {c.continual_replay_segments}")
    if c.continual_poll_s <= 0:
        raise ValueError(
            f"continual_poll_s must be positive but got {c.continual_poll_s}")
