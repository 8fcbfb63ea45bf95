"""The transfer-contract audit, ported from ``tools/stepaudit.py``: what the training
loop actually does on the device, checked against what it promises.

It runs a scripted multi-chunk fit of each single-device step variant through the real
trainer (its feed, its staging, its chunk graphs on the card) under two interception
modes, a ``TorchDispatchMode`` (every aten op) and a ``TorchFunctionMode`` (the Python
surface's host reads: ``item``, ``tolist``, ``numpy``, ``float()``, ``bool()``), each
event recorded with the function of the port that caused it and the trainer's declared
site it ran in (``train/syncsites.py``). The JAX tool's four contracts, carried over to
one device:

(a) **in place** (what donation means here): ``syn0``/``syn1`` keep their storage
    across the fit, and no op outputs a new tensor of the parameters' [V, D] shape. On the card, the fit's peak allocated memory less its
    start stays below one matrix.
(b) **transfers and syncs**: no host read (``_local_scalar_dense``, a device-to-host
    copy, a data-dependent shape such as ``nonzero`` or a boolean mask, ``tolist`` and
    the like) and no host-to-device copy outside a declared site (on the CPU, where no
    copy crosses devices, a tensor made from host data, ``lift_fresh``, is the
    transfer). A declared site may do only what it declares: ``stage`` copies to the
    device, each copy from pinned memory and non-blocking, and reads nothing; every
    other site reads or waits and copies nothing to the device. On the card the sync debug mode is a second witness
    (``torch.cuda.set_sync_debug_mode("warn")``, its warnings recorded; lifted inside
    the declared blocking sites), and the explicit ``synchronize`` calls are counted.
    The report gives the declared syncs per chunk, per site: the number a later change
    to the loop must not raise unawares.
(c) **dtype**: no float64 tensor of more than 16 elements, and in bf16 mode no dense
    float32 tensor of [V, D]. Only the sites that copy the parameters by design
    (``snapshot``, ``checkpoint``) are exempt from (c) and from (a)'s output check. Chunk bodies replay as CUDA graphs
    on the card, so the modes see a body's ops at its warm-up and capture.
(d) **recompilation**, which is graph capture here: on the card a multi-chunk fit with a
    short last chunk captures exactly one graph per metrics twin it used (at most the
    two, ``train/graphs.py``), and a recovery recaptures exactly the twins used after
    it (``Trainer.restore_captures``). On the CPU there are no graphs and (d) is
    ``null``.

Run::

    python -m glint_word2vec_torch.stepaudit [--smoke] [--device cuda|cpu]
        [--only VARIANT[,...]] [--json-out PATH]

On the card the default geometry is the real one (V=1,000,000, d=300, B=8192, K=16:
:func:`full_geometry`); ``--smoke`` is the tiny one the CPU tests run.

Progress goes to stderr; stdout carries one JSON line. Exit code 0 iff every contract
held on every variant audited.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

VARIANTS = ("shared", "per_pair", "cbow_shared", "cbow_per_example", "cbow_banded",
            "shared_stab", "shared_bf16_chain", "shared_hot", "device_pairgen")

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
_SELF = os.path.abspath(__file__)
# frames the events' origin skips: torch's own, the standard library's, this module's
_SKIP = (os.path.dirname(os.path.abspath(torch.__file__)),
         os.path.dirname(os.path.abspath(contextlib.__file__)))
# f64 tensors up to this many elements are scalars and small stacks (the probe's [5])
F64_SMALL = 16
# fits of one variant, a sentence more each, until the scripted fit ends on a short chunk
SHORT_CHUNK_TRIES = 4
# the declared sites that copy the parameters by design: exempt from the output checks
PARAM_COPY_SITES = ("snapshot", "checkpoint")

# aten ops whose result's shape depends on the data: on the card they wait for it
_DYNAMIC = {"nonzero", "masked_select", "unique", "_unique", "_unique2",
            "unique_consecutive", "unique_dim", "argwhere"}
_FN_READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
             torch.Tensor.__float__, torch.Tensor.__int__, torch.Tensor.__bool__,
             torch.Tensor.__index__}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _variant_config_kwargs(variant: str) -> dict:
    pool = dict(negative_pool=16)
    return {
        "shared": pool,
        "per_pair": dict(negative_pool=0),
        "cbow_shared": dict(cbow=True, **pool),
        "cbow_per_example": dict(cbow=True, negative_pool=0),
        "cbow_banded": dict(cbow=True, cbow_update="banded", **pool),
        "shared_stab": dict(max_row_norm=50.0, update_clip=0.5, row_l2=1e-4, **pool),
        "shared_bf16_chain": dict(param_dtype="bfloat16", compute_dtype="bfloat16",
                                  logits_dtype="bfloat16", fused_logits=True,
                                  bf16_chain=True, **pool),
        "shared_hot": dict(hot_rows=8, hot_flush_every=2, **pool),
        "device_pairgen": dict(device_pairgen=True, **pool),
    }[variant]


def smoke_geometry(device_type: str = "cpu") -> dict:
    """The tiny scripted fit. No intermediate of the steps may share the parameters'
    padded [V, D] shape by chance: V=200 pads to itself, while B x C etc. stay below
    it. On the card V is 200,000, so that one matrix outweighs the fit's fixed
    allocations (the chunk buffers, the graph pool, the BLAS workspace: ~34 MB) and
    the peak-memory half of (a) tests something."""
    return dict(v=200 if device_type == "cpu" else 200_000, d=16, b=16, k=4,
                heartbeat=8, sentences=68, length=12)


def full_geometry(device_type: str = "cuda") -> dict:
    """The audit's default fit. On the card the full width of the model the port
    serves (V=1,000,000, d=300) at the trainer's B=8192 and K=16: 69,000 sentences make
    three full chunks, both metrics twins and a short last chunk. On the CPU a
    mid-size fit, a few times the smoke's."""
    if device_type == "cuda":
        return dict(v=1_000_000, d=300, b=8192, k=16, heartbeat=32, sentences=69_000,
                    length=13)
    return dict(v=1000, d=32, b=64, k=4, heartbeat=8, sentences=192, length=13)


def _toy_problem(geom: dict):
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import Vocabulary

    rng = np.random.default_rng(0)
    V = geom["v"]
    words = [f"w{i}" for i in range(V)]
    vocab = Vocabulary.from_words_and_counts(words, rng.integers(1, 100, V))
    sents = rng.integers(0, V, (geom["sentences"], geom["length"]))
    return vocab, encode_sentences([[words[i] for i in s] for s in sents], vocab, 1000)


def _plain_codes() -> set:
    """The kernel wrappers: on the CPU they run their plain versions, which read the
    host for their index checks and (the shared step) build the new pair functionally,
    where on the card the kernel stands and does neither."""
    from glint_word2vec_torch.ops.fused_sgns import fused_sgns_shared_step
    from glint_word2vec_torch.ops.scatter import scatter_add_rows_
    return {fused_sgns_shared_step.__code__, scatter_add_rows_.__code__}


def _origin(plain_codes: set):
    """(``file:function:line`` of the innermost frame on the calling thread's stack
    that is neither torch's, the standard library's nor this module's; whether a
    kernel wrapper is on that stack)."""
    f = sys._getframe(2)
    where = None
    while f is not None:
        code = f.f_code
        if where is None:
            fn = os.path.abspath(code.co_filename)
            if fn != _SELF and not fn.startswith(_SKIP):
                rel = (os.path.relpath(fn, _ROOT) if fn.startswith(_ROOT)
                       else os.path.basename(fn))
                where = f"{rel}:{code.co_qualname}:{f.f_lineno}"
        if code in plain_codes:
            return where or "?", True
        f = f.f_back
    return where or "?", False


class Recorder:
    """The events of one audited fit: host reads, transfers and explicit syncs, each
    with its declared site (or None) and where it came from, plus the contract
    violations (c) and (a) found in op outputs. Thread-safe enough for its use: list
    appends under the interpreter lock, per-thread state in a ``threading.local``."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.device = trainer.device
        self.bf16 = trainer.param_dtype == torch.bfloat16
        self.shapes = {(trainer.padded_vocab, trainer.padded_dim),
                       (trainer.vocab.size, trainer.config.vector_size)}
        self.events: List[dict] = []
        self.out_of_place: List[str] = []
        self.f64: List[str] = []
        self.dense_f32: List[str] = []
        # on the CPU: events under a kernel wrapper, whose plain version runs there
        self._plain = _plain_codes() if self.device.type == "cpu" else set()
        self.plain_version: Dict[str, int] = {}
        self._local = threading.local()

    def site(self) -> Optional[str]:
        return self.trainer.sync_sites.current

    def on_device(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t.device.type == self.device.type

    def in_fn_read(self) -> bool:
        return getattr(self._local, "fn_read", 0) > 0

    def _plain_note(self, what: str) -> None:
        self.plain_version[what] = self.plain_version.get(what, 0) + 1

    def note(self, kind: str, op: str, blocking: bool = True) -> None:
        where, plain = _origin(self._plain)
        if plain:
            self._plain_note(kind)
            return
        self.events.append({"kind": kind, "op": op, "site": self.site(),
                            "blocking": bool(blocking), "where": where,
                            "thread": threading.current_thread().name})

    def check_outputs(self, op: str, out) -> None:
        if self.site() in PARAM_COPY_SITES:
            return
        outs = out if isinstance(out, (tuple, list)) else (out,)
        params = None
        for t in outs:
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            shape = tuple(t.shape)
            found = []
            if t.dtype == torch.float64 and t.numel() > F64_SMALL:
                found.append(self.f64)
            if self.bf16 and t.dtype == torch.float32 and shape in self.shapes:
                found.append(self.dense_f32)
            if shape in self.shapes:
                if params is None:
                    params = {p.untyped_storage().data_ptr()
                              for p in self.trainer.params}
                if t.untyped_storage().data_ptr() not in params:
                    found.append(self.out_of_place)
            if found:
                where, plain = _origin(self._plain)
                for sink in found:
                    if plain:
                        self._plain_note("out_of_place" if sink is self.out_of_place
                                         else "dtype")
                    else:
                        sink.append(f"aten.{op} -> {t.dtype}{list(shape)} at {where}")


class _Dispatch(TorchDispatchMode):
    """Every aten op: host reads, transfers, data-dependent shapes, output checks."""

    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec, name = self.rec, func.overloadpacket.__name__
        if name == "_local_scalar_dense":
            if rec.on_device(args[0]) and not rec.in_fn_read():
                rec.note("read", name)
        elif (name in _DYNAMIC
              or (name == "repeat_interleave" and kwargs.get("output_size") is None
                  and func._overloadname in ("Tensor", "self_Tensor"))
              or (name in ("index", "index_put", "index_put_") and any(
                  isinstance(i, torch.Tensor) and i.dtype == torch.bool
                  for i in (args[1] or ())))):
            if rec.on_device(args[0]):
                rec.note("read", name)
        elif name in ("_to_copy", "copy_") and rec.device.type != "cpu":
            if name == "_to_copy":
                src = args[0]
                dst = torch.device(kwargs.get("device") or src.device)
                non_blocking = kwargs.get("non_blocking", False)
            else:
                src, dst = args[1], args[0].device
                non_blocking = (args[2] if len(args) > 2
                                else kwargs.get("non_blocking", False))
            if src.device.type == "cpu" and dst.type == rec.device.type:
                rec.note("transfer", name,
                         blocking=not (non_blocking and src.is_pinned()))
            elif (src.device.type == rec.device.type and dst.type == "cpu"
                  and not rec.in_fn_read()):
                rec.note("read", name)
        elif name == "lift_fresh" and rec.device.type == "cpu":
            rec.note("transfer", name, blocking=False)
        out = func(*args, **kwargs)
        rec.check_outputs(name, out)
        return out


class _Function(TorchFunctionMode):
    """The Python surface's host reads of a device tensor."""

    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        if func in _FN_READS and args and rec.on_device(args[0]):
            rec.note("read", func.__name__)
            local = rec._local
            local.fn_read = getattr(local, "fn_read", 0) + 1
            try:
                return func(*args, **kwargs)
            finally:
                local.fn_read -= 1
        return func(*args, **kwargs)


@contextlib.contextmanager
def _modes(rec: Recorder):
    with _Function(rec), _Dispatch(rec):
        yield


@contextlib.contextmanager
def audited(trainer):
    """Run the trainer's fit under the audit; yields the :class:`Recorder`. On the
    card it also stages on the producer thread under the modes, counts the explicit
    synchronize calls, and records the sync debug mode's warnings (lifted inside the
    declared blocking sites)."""
    rec = Recorder(trainer)
    restore = []
    cuda = trainer.device.type == "cuda"
    if cuda:
        orig_stage = trainer._stage

        def staged(chunks):
            it = orig_stage(chunks)
            while True:
                with _modes(rec):
                    chunk = next(it, None)
                if chunk is None:
                    return
                yield chunk

        trainer._stage = staged
        restore.append(lambda: delattr(trainer, "_stage"))
        for owner, attr in ((torch.cuda, "synchronize"), (torch.cuda.Stream, "synchronize"),
                            (torch.cuda.Event, "synchronize")):
            orig = getattr(owner, attr)

            def counting(*a, _orig=orig, _attr=f"{owner.__name__}.{attr}", **kw):
                rec.note("sync", _attr)
                return _orig(*a, **kw)

            setattr(owner, attr, counting)
            restore.append(lambda o=owner, a=attr, f=orig: setattr(o, a, f))

        @contextlib.contextmanager
        def lifted():
            torch.cuda.set_sync_debug_mode(0)
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("warn")

        trainer.sync_sites.witness = lifted
        restore.append(lambda: setattr(trainer.sync_sites, "witness", None))
    caught: list = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with _modes(rec):
                    yield rec
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
    finally:
        for undo in reversed(restore):
            undo()
        # the mode's own notice ("a prototype feature") is not a witness
        rec.witness = [str(w.message)[:200] for w in caught
                       if "called a synchronizing" in str(w.message)]


def _allowed(e: dict) -> bool:
    """Whether a declared site may do this: ``stage`` makes only non-blocking copies
    to the device, every other site only reads or waits."""
    if e["site"] == "stage":
        return e["kind"] == "transfer" and not e["blocking"]
    return e["kind"] in ("read", "sync")


def _transfers_report(rec: Recorder, chunks: int, error: Optional[str]) -> dict:
    undeclared = [e for e in rec.events if e["site"] is None]
    misplaced = [e for e in rec.events if e["site"] is not None and not _allowed(e)]
    declared: Dict[str, Dict[str, int]] = {}
    for e in rec.events:
        if e["site"] is not None:
            per = declared.setdefault(e["site"], {})
            per[e["kind"]] = per.get(e["kind"], 0) + 1
    n = max(chunks, 1)
    syncs = sum(1 for e in rec.events if e["site"] is not None
                and e["kind"] in ("read", "sync"))
    h2d = [e for e in rec.events if e["site"] is not None and e["kind"] == "transfer"]
    witness = getattr(rec, "witness", None) if rec.device.type == "cuda" else None
    return {
        "ok": bool(error is None and not undeclared and not misplaced and not witness),
        "error": error,
        "undeclared": [f"{e['kind']} {e['op']} at {e['where']} ({e['thread']})"
                       for e in undeclared[:10]],
        "undeclared_count": len(undeclared),
        "misplaced": [f"{'blocking ' if e['blocking'] else ''}{e['kind']} {e['op']} in "
                      f"{e['site']} at {e['where']} ({e['thread']})"
                      for e in misplaced[:10]],
        "misplaced_count": len(misplaced),
        "declared": declared,
        "declared_syncs_per_chunk": round(syncs / n, 4),
        "declared_syncs_per_chunk_by_site": {
            site: round(sum(c for k, c in per.items() if k in ("read", "sync")) / n, 4)
            for site, per in sorted(declared.items())},
        "h2d_per_chunk": round(len(h2d) / n, 4),
        "blocking_h2d": sum(1 for e in h2d if e["blocking"]),
        "witness": (None if rec.device.type != "cuda"
                    else {"mode": "warn", "undeclared": len(witness or []),
                          "messages": (witness or [])[:3]}),
    }


def audit_variant(variant: str, geom: dict, device,
                  problems: Optional[dict] = None) -> dict:
    """The four contracts for one step variant; every leaf is JSON-serializable.
    Raises nothing on a contract failure: the ``ok`` fields carry it, so one broken
    contract still reports the other three.

    The scripted fit must end on a short chunk (the padded replay on the card, the real
    steps only in the eager body): where the geometry's corpus happens to fill its last
    chunk, the fit runs again on one more sentence, up to ``SHORT_CHUNK_TRIES`` fits.
    ``problems`` (sentence count -> vocabulary and encoded corpus) lets a caller share
    the corpora between variants."""
    problems = {} if problems is None else problems
    for extra in range(SHORT_CHUNK_TRIES):
        g = dict(geom, sentences=geom["sentences"] + extra)
        if g["sentences"] not in problems:
            problems[g["sentences"]] = _toy_problem(g)
        res = _audit_once(variant, g, device, problems[g["sentences"]])
        if res["short_last_chunk"] or res["transfers"]["error"]:
            break
    return res


def _audit_once(variant: str, geom: dict, device, problem) -> dict:
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.train.trainer import Trainer

    vocab, enc = problem
    cfg = Word2VecConfig(
        vector_size=geom["d"], min_count=1, pairs_per_batch=geom["b"],
        num_iterations=1, window=2, steps_per_dispatch=geom["k"],
        heartbeat_every_steps=geom["heartbeat"], subsample_ratio=0.0, seed=3,
        **_variant_config_kwargs(variant))
    trainer = Trainer(cfg, vocab, device=device)
    cuda = trainer.device.type == "cuda"
    ptrs = [p.untyped_storage().data_ptr() for p in trainer.params]
    matrix_bytes = trainer.params.syn0.numel() * trainer.params.syn0.element_size()
    reals: List[int] = []
    twins: set = set()
    orig_run, orig_key = trainer._run_chunk, trainer._graph_key

    def run_chunk(chunk):
        reals.append(int(chunk["real"]))
        return orig_run(chunk)

    def graph_key(with_metrics):
        twins.add(bool(with_metrics))
        return orig_key(with_metrics)

    trainer._run_chunk, trainer._graph_key = run_chunk, graph_key
    if cuda:
        torch.cuda.synchronize(trainer.device)
        start = torch.cuda.memory_allocated(trainer.device)
        torch.cuda.reset_peak_memory_stats(trainer.device)
    error = None
    t0 = time.perf_counter()
    with audited(trainer) as rec:
        try:
            trainer.fit(enc)
        except Exception as e:  # noqa: BLE001 — reported, not raised (see docstring)
            error = f"{type(e).__name__}: {e}"[:500]
    seconds = time.perf_counter() - t0
    del trainer._run_chunk, trainer._graph_key
    peak_over = (torch.cuda.max_memory_allocated(trainer.device) - start
                 if cuda else None)
    ptr_stable = [p.untyped_storage().data_ptr() for p in trainer.params] == ptrs
    in_place = {
        "ok": bool(ptr_stable and not rec.out_of_place
                   and (peak_over is None or peak_over < matrix_bytes)),
        "storage_stable": ptr_stable,
        "out_of_place": rec.out_of_place[:5],
        "peak_over_start_bytes": peak_over,
        "matrix_bytes": int(matrix_bytes),
    }
    dtype = {
        "ok": not rec.f64 and not rec.dense_f32,
        "f64_free": not rec.f64,
        "f64": rec.f64[:5],
        "dense_f32_vd_free": (not rec.dense_f32) if rec.bf16 else None,
        "dense_f32": rec.dense_f32[:5],
    }
    short_last = bool(reals) and reals[-1] < cfg.steps_per_dispatch
    if cuda:
        captures = trainer.graph_captures
        recompile = {"ok": bool(captures == len(twins) <= 2 and short_last
                                and len(reals) >= 2),
                     "captures": int(captures), "expected": len(twins),
                     "twins": sorted(twins), "replays": int(trainer.graph_replays)}
    else:
        recompile = None
    transfers = _transfers_report(rec, len(reals), error)
    transfers["plain_version_events"] = rec.plain_version
    return {
        "variant": variant,
        "sentences": geom["sentences"],
        "step_form": trainer._step_form(),
        "device": str(trainer.device),
        "steps": int(trainer.global_step),
        "chunks": len(reals),
        "chunk_steps": reals[-4:],
        "short_last_chunk": short_last,
        "fit_seconds": round(seconds, 3),
        "in_place": in_place,
        "transfers": transfers,
        "dtype": dtype,
        "recompile": recompile,
        "ok": bool(in_place["ok"] and transfers["ok"] and dtype["ok"]
                   and len(reals) >= 2 and short_last
                   and (recompile is None or recompile["ok"])),
    }


def audit_recover_rebuild(geom: dict, device, problem=None) -> dict:
    """The recovery ladder under a scripted finite blowup (``train.faults`` scale
    injection): exactly one recovery, the clamp engaged at the watchdog threshold, and,
    on the card, the graphs captured once per twin before the restore and recaptured
    exactly once per twin used after it (the restored pair is another tensor and the
    clamp another step: a replay of the old graphs would train the blown pair)."""
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.train import faults
    from glint_word2vec_torch.train.trainer import Trainer

    vocab, enc = problem or _toy_problem(geom)
    cfg = Word2VecConfig(
        vector_size=geom["d"], min_count=1, pairs_per_batch=geom["b"],
        num_iterations=2, window=2, steps_per_dispatch=2, heartbeat_every_steps=2,
        prefetch_chunks=0, subsample_ratio=0.0, norm_watch="recover",
        nonfinite_policy="halt", negative_pool=16)
    trainer = Trainer(cfg, vocab, device=device)
    cuda = trainer.device.type == "cuda"
    twins_before: set = set()
    twins_after: set = set()
    orig_key = trainer._graph_key

    def graph_key(with_metrics):
        (twins_after if trainer.restore_captures else twins_before).add(
            bool(with_metrics))
        return orig_key(with_metrics)

    trainer._graph_key = graph_key
    form_before = trainer._step_form()
    error = None
    faults.configure(scale_params_at_step=8)
    try:
        trainer.fit(enc)
    except Exception as e:  # noqa: BLE001 — reported, not raised (audit style)
        error = f"{type(e).__name__}: {e}"[:500]
    finally:
        faults.reset()
        del trainer._graph_key
    engaged = float(trainer._stabilizers.max_row_norm)
    result = {
        "error": error,
        "recoveries": int(trainer.recoveries_performed),
        "watchdog_fires": int(trainer.norm_watchdog.fires),
        "restores": len(trainer.restore_captures),
        "step_form_before": form_before,
        "step_form_after": trainer._step_form(),
        "engaged_max_row_norm": engaged,
    }
    ok = bool(error is None and result["recoveries"] == 1 and result["restores"] == 1
              and engaged == cfg.norm_watch_threshold)
    if cuda:
        before = trainer.restore_captures[0] if trainer.restore_captures else 0
        result.update(captures_before=int(before),
                      expected_before=len(twins_before),
                      recaptures=int(trainer.graph_captures - before),
                      expected_recaptures=len(twins_after))
        ok = bool(ok and before == len(twins_before)
                  and result["recaptures"] == len(twins_after) >= 1)
    else:
        result.update(captures_before=None, recaptures=None)
    result["ok"] = ok
    return result


def audit(geom: dict, device, variants=None, recover: bool = True) -> dict:
    out = {"geometry": geom, "variants": {}}
    problems: dict = {}
    for v in variants or VARIANTS:
        log(f"stepaudit: auditing {v} on {device} ...")
        res = audit_variant(v, geom, device, problems=problems)
        out["variants"][v] = res
        t = res["transfers"]
        log(f"  {v:18s} in_place={res['in_place']['ok']} transfers={t['ok']} "
            f"dtype={res['dtype']['ok']} recompile="
            f"{None if res['recompile'] is None else res['recompile']['ok']} "
            f"declared syncs/chunk={t['declared_syncs_per_chunk']} "
            f"({res['chunks']} chunks)")
    ok = all(r["ok"] for r in out["variants"].values())
    if recover:
        log("stepaudit: auditing the norm_watch='recover' recapture ...")
        rr = out["recover_rebuild"] = audit_recover_rebuild(
            geom, device, problems.get(geom["sentences"]))
        log(f"  recover_rebuild    recoveries={rr['recoveries']} "
            f"recaptures={rr['recaptures']} ok={rr['ok']}")
        ok = ok and rr["ok"]
    out["ok"] = bool(ok)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glint_word2vec_torch.stepaudit",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny geometry")
    ap.add_argument("--device", default="cuda",
                    help="where the fits run (default the card; 'cpu' runs the plain "
                         "versions, and (d) reports null)")
    ap.add_argument("--only", default="",
                    help="comma-separated variant subset; skips the recovery audit")
    ap.add_argument("--json-out", default="", help="also write the result here")
    args = ap.parse_args(argv)

    from glint_word2vec_torch.device import resolve_device

    device = resolve_device(args.device)
    geom = smoke_geometry(device.type) if args.smoke else full_geometry(device.type)
    only = None
    if args.only:
        only = tuple(s.strip() for s in args.only.split(",") if s.strip())
        bad = [v for v in only if v not in VARIANTS]
        if bad:
            ap.error(f"unknown variant(s) {bad}; known: {VARIANTS}")
    t0 = time.perf_counter()
    result = audit(geom, device, variants=only, recover=only is None)
    result["device"] = str(device)
    if device.type == "cuda":
        result["card"] = torch.cuda.get_device_name(device)
    result["seconds"] = round(time.perf_counter() - t0, 1)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
