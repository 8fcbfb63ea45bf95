"""Row scatter-add: the port's CUDA kernel and its wrapper.

Source note. ``csrc/scatter_rows.cu`` replaces the TPU kernel
``tools/pallas_vmem_scatter.py:58`` (``kernel``, the Pallas probe that streams Zipf-hot
update rows through on-chip memory and adds each one to an ``[H, D]`` accumulator). It
computes ``mat[idx[i], :] += upd[i, :]`` in place, duplicates summed, which is what
every ``.at[].add`` of the JAX package's per-pair skip-gram and scatter CBOW steps
computes; the probe is the special case of a zeroed target. The plain version is
:func:`scatter_add_rows_reference`, ``index_add_``, which is also the one PyTorch call
that computes the same function.

What bounds it on an H100: bytes. The update rows are read once and each distinct
target row is read and written once: at the per-pair syn1 shape (49152 rows of 384 f32)
~135 MB, ~40 µs at 3.35 TB/s, with almost no arithmetic. A kernel that adds each update
row to its target with atomics is held back by the L2's atomic rate instead
(``scatterprobe.py --variants``), so the kernel groups the live slots by target row and
gives every distinct row one owner, which sums its updates in registers and writes the
row once; rows with more than ``CHUNK`` updates are split over several owners, which
add their partial sums with one atomic each. That pays where the slots outnumber the
target's rows (``GROUP_RATIO``). Where they do not, as in every step of the model's
1M-word vocabulary, the grouping's fixed cost exceeds what it saves, and the call runs
in one launch that groups only each warp's 32 slots and adds each group's sum with
atomics. The source's header gives the design and the measurements.
:func:`scatter_add_rows_grouped` is the grouped path's arithmetic in plain torch.

Rows with ``live == 0`` are skipped: the steps' padded slots (the masked tail, CBOW's
empty context slots) all carry index 0, the most frequent word, with an update of
exactly zero. Skipping differs from the JAX step only where the update is not finite
(``0·NaN`` is NaN there); the trainer's ``nonfinite_policy="halt"`` guard catches that
case.

Out-of-range indices are not written. The kernel sets a flag in mapped host memory
instead, and the check completes asynchronously, so as not to stall the stream after
every launch: the wrapper raises ``IndexError`` at its first call after a launch has
set the flag, and :func:`check_errors` synchronises the device and then reads it. CPU
tensors are checked before anything is written.

State. A one-launch call needs no state. A grouped one needs two int32 ``[V]`` tables that every call leaves zeroed, and scratch for
its grouping. :class:`_Stream` holds them per (device, stream), so calls on two streams
never share them; they are allocated once, grow with V and with the number of slots,
and are never cleared by the host. The wrapper's CUDA path runs no torch op and
allocates nothing once they exist: one ctypes call enqueues the one or four launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from glint_word2vec_torch.ops import kernels

_F32, _I64 = torch.float32, torch.int64

KERNEL_SOURCE = "glint_word2vec_torch/csrc/scatter_rows.cu"
REPLACES = "tools/pallas_vmem_scatter.py:58"
CHUNK = 8  # most update rows one owner sums; hotter rows are split over owners
# Calls with at least this many slots per target row are grouped by row in four
# launches; the others run in one launch that groups each warp's 32 slots (the source's
# header says why).
GROUP_RATIO = 2


def scatter_add_rows_reference(mat: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                               live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``mat.index_add_(0, idx, upd)``. ``live`` is accepted and
    ignored: a row the kernel skips carries an update of zero."""
    return mat.index_add_(0, idx, upd)


def _live_in_range(mat: torch.Tensor, idx: torch.Tensor,
                   live: Optional[torch.Tensor]) -> torch.Tensor:
    """The positions of the slots that write: the live ones (all without ``live``).
    Raises ``IndexError`` if one of them indexes outside ``[0, V)``."""
    keep = (torch.arange(idx.shape[0], device=idx.device) if live is None
            else torch.nonzero(live != 0).reshape(-1))
    rows = idx if live is None else idx[keep]
    if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= mat.shape[0]):
        raise IndexError(f"scatter_add_rows_: an index lies outside [0, {mat.shape[0]})")
    return keep


def scatter_add_rows_grouped(mat: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                             live: Optional[torch.Tensor] = None,
                             chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, in place on ``mat``: the live slots
    grouped by row in slot order, each row's slots cut into chunks of at most
    ``chunk``, each chunk summed in fp32 from zero in slot order, and the chunk sums
    added to the row one at a time, in chunk order. The kernel takes the slots of a row
    in the order of its integer atomics and adds a hot row's chunk sums with atomics,
    so this is one of the orders it may take. Nothing on the training path calls it."""
    _check(mat, idx, upd, live)
    keep = _live_in_range(mat, idx, live)
    rows, order = torch.sort(idx[keep], stable=True)
    slots = keep[order]
    uniq, counts = torch.unique_consecutive(rows, return_counts=True)
    if uniq.numel() == 0:
        return mat
    n_chunks = (counts + chunk - 1) // chunk
    first_slot = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rank = torch.arange(rows.numel(), device=rows.device) - first_slot
    first_chunk = torch.cumsum(n_chunks, 0) - n_chunks
    owner = torch.repeat_interleave(first_chunk, counts) + rank // chunk
    partial = torch.zeros((int(n_chunks.sum()), mat.shape[1]), dtype=mat.dtype,
                          device=mat.device)
    step = rank % chunk
    for t in range(min(chunk, int(counts.max()))):
        at = step == t  # one slot per chunk: a plain elementwise add each
        partial[owner[at]] += upd[slots[at]]
    for j in range(int(n_chunks.max())):
        has = n_chunks > j  # distinct rows: one fp32 add per element
        mat.index_add_(0, uniq[has], partial[first_chunk[has] + j])
    return mat


class _Stream:
    """The kernel's state on one (device, stream): the two zeroed int32 [V] tables,
    the grouping's scratch and the mapped error flag. Calls on one stream run in
    order, so they may share the tables."""

    def __init__(self, device: torch.device, lib: ctypes.CDLL):
        self.device = device
        self.lib = lib
        with torch.cuda.device(device):
            host = lib.glint_scatter_flag_create()
        if not host:
            raise RuntimeError("scatter_rows: could not allocate its error flag")
        self.flag = ctypes.c_int.from_address(host)
        self.flag_dev = lib.glint_scatter_flag_device(host)
        if not self.flag_dev:
            raise RuntimeError("scatter_rows: the error flag has no device address")
        self.rows = self.slots = 0  # the sizes the buffers fit
        self.tables = self.scratch = None
        self.ptrs = (0, 0, 0)

    def fit(self, V: int, N: int) -> Tuple[int, int, int]:
        """Device pointers of (count, pos, scratch) for a grouped call over N slots of
        a [V, D] matrix, grown first if they are too small."""
        if V <= self.rows and N <= self.slots:
            return self.ptrs
        if V > self.rows:
            self.rows = V
            self.tables = torch.zeros((2, V), dtype=torch.int32, device=self.device)
        if N > self.slots:
            self.slots = N
            size = self.lib.glint_scatter_scratch_bytes(N)
            # zeroed: its head holds the counters, which every call leaves at zero
            self.scratch = torch.zeros(size, dtype=torch.uint8, device=self.device)
        self.ptrs = (self.tables[0].data_ptr(), self.tables[1].data_ptr(),
                     self.scratch.data_ptr())
        return self.ptrs

    def raise_if_set(self) -> None:
        """Raise ``IndexError`` (once) if a launch that has run found an index
        outside ``[0, V)``."""
        if self.flag.value:
            self.flag.value = 0
            raise IndexError("scatter_add_rows_: an index lay outside [0, V); the "
                             "kernel skipped those rows")


_streams: Dict[Tuple[int, int], _Stream] = {}


def check_errors() -> None:
    """Wait for the index checks of every launch so far and raise ``IndexError`` if
    one of them found an index outside ``[0, V)``."""
    for state in _streams.values():
        torch.cuda.synchronize(state.device)
        state.raise_if_set()


def _check(mat: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
           live: Optional[torch.Tensor]) -> None:
    N, dev = idx.shape[0] if idx.dim() == 1 else -1, mat.device
    if (mat.dtype is _F32 and upd.dtype is _F32 and idx.dtype is _I64
            and idx.device == dev and upd.device == dev and mat.dim() == 2
            and mat.is_contiguous() and idx.is_contiguous() and upd.is_contiguous()
            and upd.shape == (N, mat.shape[1])
            and (live is None or (live.dtype is _F32 and live.device == dev
                                  and live.is_contiguous() and live.shape == (N,)))):
        return  # the common case, in one expression: the wrapper's host time counts
    for name, t, dtype in (("mat", mat, _F32), ("idx", idx, _I64), ("upd", upd, _F32),
                           ("live", live, _F32)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, mat on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mat.dim() != 2:
        raise ValueError(f"mat must be [V, D], got {tuple(mat.shape)}")
    if N < 0 or tuple(upd.shape) != (N, mat.shape[1]):
        raise ValueError(f"idx {tuple(idx.shape)} and upd {tuple(upd.shape)} must be "
                         f"[N] and [N, {mat.shape[1]}]")
    raise ValueError(f"live must be [{N}], got {tuple(live.shape)}")


def scatter_add_rows_(mat: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                      live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mat[idx[i]] += upd[i]`` in place for every ``i`` with ``live[i] != 0`` (every
    ``i`` without ``live``), duplicates summed; returns ``mat``. ``mat`` f32 [V, D],
    ``idx`` int64 [N], ``upd`` f32 [N, D], ``live`` f32 [N], all contiguous, on one
    device; V and N below 2^31.

    CPU tensors take the plain version. CUDA tensors launch the kernel on the current
    stream, and a build or launch failure raises: there is no fallback."""
    _check(mat, idx, upd, live)
    if not mat.is_cuda:
        if mat.device.type != "cpu":
            raise ValueError(f"no kernel for device {mat.device}")
        keep = _live_in_range(mat, idx, live)
        if live is not None:
            idx, upd = idx[keep], upd[keep]
        return scatter_add_rows_reference(mat, idx, upd)
    (V, D), N = mat.shape, idx.shape[0]
    if V >= 1 << 31 or N >= 1 << 31:
        raise ValueError(f"the kernel takes V and N below 2^31, got V={V}, N={N}")
    if N == 0:
        return mat
    device = mat.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    key = (device, stream)
    state = _streams.get(key)
    if state is None:
        state = _streams[key] = _Stream(mat.device, kernels.load("scatter_rows"))
    state.raise_if_set()
    grouped = N >= GROUP_RATIO * V
    count, pos, scratch = state.fit(V, N) if grouped else (None, None, None)
    err = state.lib.glint_scatter_rows(
        mat.data_ptr(), idx.data_ptr(), upd.data_ptr(),
        None if live is None else live.data_ptr(), N, V, D, CHUNK, grouped, count,
        pos, scratch, state.flag_dev, stream)
    if err != 0:
        del _streams[key]  # a launch that did not run may have left the tables dirty
        raise RuntimeError(f"scatter_rows kernel launch failed: cudaError {err}")
    scatter_add_rows_.launches += 1
    return mat


# Wrapper calls that launched the kernel (one per call on CUDA tensors; each call
# enqueues one CUDA launch, or four when grouped: rank, plan, place, reduce).
scatter_add_rows_.launches = 0
