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
~75 MB of update rows plus the targets, ~25-30 µs at 3.35 TB/s, with almost no
arithmetic. The design is the simple one: one warp per update row, 16-byte loads and
vector fp32 ``atomicAdd`` into the target row, so duplicates resolve in L2 without a
sort. Rows with ``live == 0`` are skipped: the steps' padded slots (the masked tail,
CBOW's empty context slots) all carry index 0, the most frequent word, with an update
of exactly zero, and would otherwise pile tens of thousands of atomics onto one row.
Skipping differs from the JAX step only where the update is not finite (``0·NaN`` is
NaN there); the trainer's ``nonfinite_policy="halt"`` guard catches that case.

Out-of-range indices are not written. The kernel sets a flag on the device instead, and
the check completes asynchronously, so as not to stall the stream after every launch:
the wrapper copies the flag to pinned host memory behind each launch and raises
``IndexError`` at its first call after that copy has landed, and :func:`check_errors`
waits for it. CPU tensors are checked before anything is written.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from glint_word2vec_torch.ops import kernels

KERNEL_SOURCE = "glint_word2vec_torch/csrc/scatter_rows.cu"
REPLACES = "tools/pallas_vmem_scatter.py:58"
ROWS_PER_BLOCK = 32  # update rows per CUDA block (8 warps, 4 rows each)


def scatter_add_rows_reference(mat: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                               live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``mat.index_add_(0, idx, upd)``. ``live`` is accepted and
    ignored: a row the kernel skips carries an update of zero."""
    return mat.index_add_(0, idx, upd)


class _FlagState:
    """The device error flag of one card and the pinned host copy behind its last
    launch."""

    def __init__(self, device: torch.device):
        self.flag = torch.zeros(1, dtype=torch.int32, device=device)
        self.host = torch.zeros(1, dtype=torch.int32).pin_memory()
        self.event: Optional[torch.cuda.Event] = None

    def raise_if_set(self, wait: bool) -> None:
        if self.event is None:
            return
        if wait:
            self.event.synchronize()
        elif not self.event.query():
            return
        if int(self.host[0]):
            self.flag.zero_()
            self.host.zero_()
            self.event = None
            raise IndexError("scatter_add_rows_: an index lay outside [0, V); the "
                             "kernel skipped those rows")


_flags: Dict[int, _FlagState] = {}


def check_errors() -> None:
    """Wait for the index checks of every launch so far and raise ``IndexError`` if
    one of them found an index outside ``[0, V)``."""
    for state in _flags.values():
        state.raise_if_set(wait=True)


def _check(mat: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
           live: Optional[torch.Tensor]) -> None:
    for name, t, dtype in (("mat", mat, torch.float32), ("idx", idx, torch.int64),
                           ("upd", upd, torch.float32), ("live", live, torch.float32)):
        if t is None:
            continue
        if t.device != mat.device:
            raise ValueError(f"{name} is on {t.device}, mat on {mat.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mat.dim() != 2:
        raise ValueError(f"mat must be [V, D], got {tuple(mat.shape)}")
    N = idx.shape[0] if idx.dim() == 1 else -1
    if N < 0 or tuple(upd.shape) != (N, mat.shape[1]):
        raise ValueError(f"idx {tuple(idx.shape)} and upd {tuple(upd.shape)} must be "
                         f"[N] and [N, {mat.shape[1]}]")
    if live is not None and tuple(live.shape) != (N,):
        raise ValueError(f"live must be [{N}], got {tuple(live.shape)}")


def scatter_add_rows_(mat: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                      live: Optional[torch.Tensor] = None,
                      rows_per_block: int = ROWS_PER_BLOCK) -> torch.Tensor:
    """``mat[idx[i]] += upd[i]`` in place for every ``i`` with ``live[i] != 0`` (every
    ``i`` without ``live``), duplicates summed; returns ``mat``. ``mat`` f32 [V, D],
    ``idx`` int64 [N], ``upd`` f32 [N, D], ``live`` f32 [N], all contiguous, on one
    device.

    CPU tensors take the plain version. CUDA tensors launch the kernel, and a build or
    launch failure raises: there is no fallback. ``rows_per_block`` only changes how
    the kernel splits the rows over blocks."""
    _check(mat, idx, upd, live)
    if mat.device.type == "cpu":
        if live is not None:
            keep = live != 0
            idx, upd = idx[keep], upd[keep]
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= mat.shape[0]):
            raise IndexError(f"scatter_add_rows_: an index lies outside "
                             f"[0, {mat.shape[0]})")
        return scatter_add_rows_reference(mat, idx, upd)
    if mat.device.type != "cuda":
        raise ValueError(f"no kernel for device {mat.device}")
    if idx.shape[0] == 0:
        return mat
    state = _flags.get(mat.device.index)
    if state is None:
        state = _flags[mat.device.index] = _FlagState(mat.device)
    state.raise_if_set(wait=False)
    lib = kernels.load("scatter_rows")
    V, D = mat.shape
    vec = int(D % 4 == 0 and mat.data_ptr() % 16 == 0 and upd.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(mat.device)
    err = lib.glint_scatter_rows(
        mat.data_ptr(), idx.data_ptr(), upd.data_ptr(),
        live.data_ptr() if live is not None else None, idx.shape[0], V, D,
        rows_per_block, vec, state.flag.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: cudaError {err}")
    scatter_add_rows_.launches += 1
    state.host.copy_(state.flag, non_blocking=True)
    state.event = torch.cuda.Event()
    state.event.record(stream)
    return mat


# Kernel launches (one per call on CUDA tensors).
scatter_add_rows_.launches = 0
