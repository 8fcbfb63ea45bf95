"""The (data, model) mesh and the embedding geometry, ported from
``glint_word2vec_tpu/parallel/mesh.py``.

The reference shards its two matrices over ``numParameterServers`` servers. Here the
servers are the ranks of a ``torch.distributed`` world (:mod:`.distributed`), one a
card, laid out on two axes:

- ``model``: the embedding rows are split into ``num_model`` contiguous blocks; the
  rank at model index m owns rows ``[m·Vs, (m+1)·Vs)`` of both matrices, ``Vs =
  Vp / num_model`` (the padded vocabulary divides it);
- ``data``: the batch is split into ``num_data`` contiguous slices, and the ranks of
  one model index hold replicas of the same row block.

The column layout (``embedding_partition="cols"``, :attr:`MeshPlan.embedding_cols`,
the reference's own scheme) splits the columns instead: the rank at model index m owns
columns ``[m·Dc, (m+1)·Dc)`` of every row, ``Dc = Dp / num_model``, and the step sums
its partial dot products over the model axis (``ops/sgns_shard.py``).

Rank r sits at (data r // num_model, model r % num_model): the row-major order in which
the JAX package's ``make_mesh`` reshapes its devices. The plan owns one process group
per model-axis row of the grid and one per data-axis column (``torch.distributed
.new_group``; an axis of size 1 has none) and the carving rules (:class:`Sharding`).

Unlike the JAX ``Trainer``, which drops to a 1x1 mesh when more shards are asked for
than devices exist, a mesh here must cover the world exactly: one rank is one device,
so ``num_data × num_model ≠ world size`` raises.

The padding helpers keep the JAX package's padded shapes, so that parameters are
shape-identical between the two packages (checkpoints, interop, equivalence tests).
Padded rows are never indexed by the feed and padded columns stay zero (every product
with them vanishes), so both are sliced off on export.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Sharding(NamedTuple):
    """How a global array is split over the mesh: along ``dim`` over ``axis``
    (``None``: replicated)."""

    axis: Optional[str]
    dim: int = 0


class LocalShards(NamedTuple):
    """A rank's own row blocks of syn0 and syn1 ([Vs, Dp] each; syn1 may be None), as
    :func:`..train.checkpoint.load_params_into_plan` streams them: the ``Trainer``
    takes them as they are instead of carving full matrices."""

    syn0: Any
    syn1: Any


@dataclass(frozen=True, eq=False)
class MeshPlan:
    """A (data, model) mesh over the world's ranks, with this rank's place in it and
    the process groups of its two axes."""

    num_data: int
    num_model: int
    rank: int = 0
    model_group: Any = field(default=None, repr=False)
    data_group: Any = field(default=None, repr=False)

    @property
    def size(self) -> int:
        return self.num_data * self.num_model

    @property
    def data_index(self) -> int:
        return self.rank // self.num_model

    @property
    def model_index(self) -> int:
        return self.rank % self.num_model

    @property
    def embedding(self) -> Sharding:
        """Row-sharded [V, D] embeddings over the model axis, replicated over data."""
        return Sharding(MODEL_AXIS, 0)

    @property
    def embedding_cols(self) -> Sharding:
        """Column-sharded [V, D] embeddings over the model axis, replicated over data:
        the reference's layout (each server holds a slice of every vector's columns)."""
        return Sharding(MODEL_AXIS, 1)

    @property
    def batch(self) -> Sharding:
        """[B, ...] batches split over the data axis, replicated over model."""
        return Sharding(DATA_AXIS, 0)

    @property
    def batch_stacked(self) -> Sharding:
        """[K, B, ...] chunks of batches: the batch axis split over data."""
        return Sharding(DATA_AXIS, 1)

    @property
    def replicated(self) -> Sharding:
        return Sharding(None)

    def rows(self, padded_vocab: int) -> tuple:
        """This rank's row range ``(lo, hi)`` of a [padded_vocab, D] matrix."""
        if padded_vocab % self.num_model:
            raise ValueError(f"padded vocabulary {padded_vocab} is not divisible by "
                             f"num_model={self.num_model}")
        vs = padded_vocab // self.num_model
        return self.model_index * vs, (self.model_index + 1) * vs

    def cols(self, padded_dim: int) -> tuple:
        """This rank's column range ``(lo, hi)`` of a [V, padded_dim] matrix under the
        column layout."""
        if padded_dim % self.num_model:
            raise ValueError(f"padded vector dim {padded_dim} is not divisible by "
                             f"num_model={self.num_model}")
        dc = padded_dim // self.num_model
        return self.model_index * dc, (self.model_index + 1) * dc

    def carve(self, a, spec: Sharding):
        """This rank's block of the global array ``a`` (numpy or torch) under
        ``spec``: a view, not a copy."""
        if spec.axis is None:
            return a
        n, idx = ((self.num_model, self.model_index) if spec.axis == MODEL_AXIS
                  else (self.num_data, self.data_index))
        size = a.shape[spec.dim]
        if size % n:
            raise ValueError(f"dim {spec.dim} of size {size} is not divisible by "
                             f"{n} shards of the {spec.axis} axis")
        w = size // n
        sl = [slice(None)] * a.ndim
        sl[spec.dim] = slice(idx * w, (idx + 1) * w)
        return a[tuple(sl)]


def make_mesh(num_data: int = 1, num_model: Optional[int] = None) -> MeshPlan:
    """Build the (data, model) mesh over every rank of the world (a world of one when
    ``torch.distributed`` is not initialised). ``num_model=None`` takes the ranks the
    data axis leaves. Every rank must call it, in the same order as its other group
    constructions: it makes the axes' process groups."""
    from glint_word2vec_torch.parallel import distributed
    import torch.distributed as dist

    world = distributed.world_size()
    if num_model is None:
        if world % num_data:
            raise ValueError(f"{world} ranks not divisible by num_data={num_data}")
        num_model = world // num_data
    if num_data < 1 or num_model < 1:
        raise ValueError(f"mesh axes must be positive, got {num_data}x{num_model}")
    if num_data * num_model != world:
        raise ValueError(
            f"mesh {num_data}x{num_model} (num_data_shards x num_model_shards) needs "
            f"{num_data * num_model} ranks, one a device, but this world has {world} "
            "(start one process a rank, and call parallel.distributed.initialize "
            "first); the port never falls back to fewer devices than the mesh asks "
            "for")
    r = distributed.rank()
    if world == 1:
        return MeshPlan(1, 1, 0)
    grid = np.arange(world).reshape(num_data, num_model)
    model_group = data_group = None
    if num_model > 1:
        for row in grid:  # every rank makes every group, in one order
            g = dist.new_group([int(x) for x in row])
            if r in row:
                model_group = g
    if num_data > 1:
        for col in grid.T:
            g = dist.new_group([int(x) for x in col])
            if r in col:
                data_group = g
    return MeshPlan(num_data, num_model, r, model_group, data_group)


def shard_params(params, plan: MeshPlan, device=None,
                 spec: Optional[Sharding] = None) -> LocalShards:
    """This rank's blocks of an EmbeddingPair of full [Vp, Dp] matrices (numpy or
    torch) under ``spec`` (default ``plan.embedding``, the row blocks;
    ``plan.embedding_cols`` for the column blocks), each copied to ``device`` as a
    contiguous tensor of its own: :meth:`MeshPlan.carve` of columns is a strided view,
    and the row-scatter kernel takes only contiguous matrices."""
    spec = plan.embedding if spec is None else spec
    out = []
    for m in params:
        if m is None:
            out.append(None)
            continue
        blk = plan.carve(m, spec)
        t = (blk if isinstance(blk, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(blk)))
        t = t.to(device) if device is not None else t
        out.append(t.clone(memory_format=torch.contiguous_format))
    return LocalShards(*out)


def shard_batch(batch: dict, plan: MeshPlan) -> dict:
    """This rank's data slice of each [B, ...] array of ``batch``."""
    return {k: plan.carve(v, plan.batch) for k, v in batch.items()}


def pad_dim_to_lanes(vector_size: int, enabled: bool = True) -> int:
    """Physical embedding minor dim: ``vector_size`` rounded up to a multiple of 128
    when enabled (D=300 -> 384), the JAX package's lane-padded width."""
    return -(-vector_size // 128) * 128 if enabled else vector_size


def pad_vocab_for_sharding(vocab_size: int, num_model: int = 1, multiple: int = 8) -> int:
    """Smallest padded row count divisible by ``num_model`` and ``multiple``."""
    lcm = math.lcm(num_model, multiple)
    return -(-vocab_size // lcm) * lcm


def gather_cols(m: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """The whole [Vp, Dp] matrix from the column blocks [Vp, Dc] of the model axis:
    one all_gather over it (a collective every rank of the axis calls)."""
    from glint_word2vec_torch.parallel.distributed import COLLECTIVES

    if plan.num_model == 1:
        return m
    n, dc = m.shape
    g = COLLECTIVES.all_gather(m, plan.model_group, MODEL_AXIS)       # [M·Vp, Dc]
    return g.view(plan.num_model, n, dc).permute(1, 0, 2).reshape(n, plan.num_model * dc)


def cols_to_rows(m: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """This rank's row block [Vp / M, Dp] of a matrix held as column blocks [Vp, Dc]
    over the model axis: one all_to_all over it, rank j receiving every rank's columns
    of row block j (a collective every rank of the axis calls)."""
    from glint_word2vec_torch.parallel.distributed import COLLECTIVES

    if plan.num_model == 1:
        return m
    n, dc = m.shape
    vs = n // plan.num_model
    got = COLLECTIVES.all_to_all(m, plan.model_group, MODEL_AXIS)     # [M·Vs, Dc]
    return got.view(plan.num_model, vs, dc).permute(1, 0, 2).reshape(
        vs, plan.num_model * dc)
