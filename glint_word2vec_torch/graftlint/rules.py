"""The port's repo-invariant rules: each JAX rule of ``tools/graftlint/rules.py`` carried
over to its torch counterpart (none is dropped). The catalogue, with the twins, is in
README.md's port section.

| id | invariant | JAX rule | the port's form |
|----|-----------|----------|-----------------|
| R1 | no ad-hoc thread pools in library code | same | the JAX allowlist at the port's paths, plus ``Word2VecModel.load`` |
| R2 | seeded randomness only in the library | stdlib ``random``, unseeded ``np.random`` | the same, and every torch draw without ``generator=`` |
| R3 | no host sync where the program is captured | inside ``jit``/``shard_map`` | inside what a CUDA graph captures: ``Trainer._chunk_body`` and its reach across modules, the plain versions' CPU-only and float64-only branches pruned |
| R4 | prefix accumulation carries ≥f32/int evidence | ``.astype`` markers | ``dtype=``, ``.to(torch.float32/...)``, ``.double()``/``.long()``/``.float()``, an integer or boolean source |
| R5 | data-plane reads go through ``retry_io`` | same | same, under ``glint_word2vec_torch/data/`` |
| R6 | the trainer places host data on the device only by staging | ``device_put`` outside ``_stage_to_device`` | ``.cuda()``, ``torch.tensor/as_tensor(..., device=)`` and ``.to(...)`` of a host tensor outside ``_stage``/``_device_arrays`` |
| R7 | contract tools print exactly one JSON line | the JAX tools | the port's tools; ``chip_smoke.py`` is exempt: its contract is its LAST line after a log, which its own ``main`` prints once |
| R8 | every knob pair refused at dispatch is refused in config | ``__post_init__`` vs ``_build_step``/``__init__`` | ``__post_init__`` and the validators it calls vs every ``Trainer`` method; the knob registry of ``glint_word2vec_torch/graftcheck`` |
| R9-R11 | lock order, handler safety, shared mutables | ``glint_word2vec_tpu/lockcheck.py`` | ``glint_word2vec_torch/lockcheck.py`` (concurrency.py) |

Library rules apply to :func:`.engine.in_library` paths, R7 to the tool scope, as the
JAX rules apply to ``glint_word2vec_tpu/`` and ``tools/``. ``SCOPE`` holds the tool-scope
literal (:data:`.engine.TOOL_SCOPE`) to the tree.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from glint_word2vec_torch.graftlint.engine import (
    LIB, TOOL_SCOPE, Finding, ModuleContext, in_library)


def _name_of(func: ast.AST) -> str:
    """Dotted text of a call's func node: Name → 'x', Attribute → 'a.b.c'."""
    parts: List[str] = []
    cur = func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return ".".join(reversed(parts))


def _walk_names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


# ---------------------------------------------------------------------------------------
# R1 — determinism contract: no ad-hoc thread pools / threads in library code. The
# blessed owners are the JAX package's, at the port's paths, each with the JAX entry's
# reason, and one of the port's own.
# ---------------------------------------------------------------------------------------
class R1ThreadPools:
    id = "R1"
    _POOLS = {"ThreadPoolExecutor", "ProcessPoolExecutor", "Pool"}
    ALLOW = {
        (LIB + "data/pipeline.py", "ordered_pool_map"),
        (LIB + "train/trainer.py", "_threaded_iter.__init__"),
        (LIB + "train/trainer.py", "_one_ahead_iter.__init__"),
        # the status endpoint's serving thread: READ-only, it renders snapshots of
        # trainer state and never produces or orders training data
        (LIB + "obs/statusd.py", "StatusServer.start"),
        # the serving tier's two owners: the micro-batcher worker orders
        # request/response PAIRING only, the hot-reload watcher stats a file and
        # invokes the swap callback; both READ-only on params
        (LIB + "serve/batcher.py", "BatchingScheduler.start"),
        (LIB + "serve/reload.py", "CheckpointWatcher.start"),
        # the fleet's two owners: each SubprocessReplica's stdout reader pairs wire
        # responses to tickets by id, the router's one prober/orchestrator thread
        # probes, trips breakers, restarts and reloads; neither touches training data
        (LIB + "serve/fleet.py", "SubprocessReplica.start"),
        (LIB + "serve/fleet.py", "FleetRouter.__init__"),
        # the peer-liveness beacon writer: one daemon thread per sharded-fit process
        # touching a liveness file; touches no training data, orders nothing
        (LIB + "train/supervisor.py", "BeaconBoard.start"),
        # the port's own: the one worker that builds the vocabulary's word index while
        # the matrices are read (READ-only on the checkpoint, joined before load
        # returns; nothing is ordered by it)
        (LIB + "models/word2vec.py", "Word2VecModel.load"),
    }

    def applies(self, path: str) -> bool:
        return in_library(path)

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _name_of(node.func)
            is_pool = name.rsplit(".", 1)[-1] in self._POOLS
            is_thread = name in ("threading.Thread", "Thread")
            if not (is_pool or is_thread):
                continue
            qn = ctx.qualname(node)
            if any(ctx.path == p and (qn == q or qn.endswith("." + q))
                   for p, q in self.ALLOW):
                continue
            kind = "thread pool" if is_pool else "thread"
            out.append(Finding(
                rule=self.id, path=ctx.path, line=node.lineno, col=node.col_offset,
                message=f"ad-hoc {kind} creation ({name}) in library code — route "
                        f"through pipeline.ordered_pool_map (the ordered-merge "
                        f"determinism contract) or allowlist a documented owner"))
        return out


# ---------------------------------------------------------------------------------------
# R2 — PRNG discipline: the library draws randomness from the counter-hash PRNG
# (ops/prng.py), a seeded np.random.Generator, or a torch.Generator passed explicitly.
# Stdlib `random`, unseeded np.random module calls and torch's global generator make
# streams depend on process state.
# ---------------------------------------------------------------------------------------
class R2Prng:
    id = "R2"
    _NP_OK = {"default_rng", "SeedSequence", "Generator", "BitGenerator", "PCG64",
              "Philox"}
    _TORCH_FNS = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
                  "randint_like", "normal", "bernoulli", "multinomial", "poisson"}
    _TORCH_METHODS = {"normal_", "uniform_", "bernoulli_", "exponential_", "random_",
                      "cauchy_", "log_normal_", "geometric_", "bernoulli", "multinomial"}

    def applies(self, path: str) -> bool:
        return in_library(path)

    def _torch_draw(self, node: ast.Call) -> Optional[str]:
        name = _name_of(node.func)
        tail = name.rsplit(".", 1)[-1]
        if name.startswith("torch.") and name.count(".") == 1 and tail in self._TORCH_FNS:
            return name
        if isinstance(node.func, ast.Attribute) and tail in self._TORCH_METHODS \
                and not name.startswith(("np.", "numpy.", "torch.")):
            return f".{tail}()"
        return None

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            msg = None
            if isinstance(node, ast.Import):
                if any(a.name == "random" for a in node.names):
                    msg = ("stdlib `random` import in library code — use the "
                           "counter-hash PRNG (ops/prng.py), a seeded "
                           "np.random.Generator or an explicit torch.Generator")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "random":
                    msg = "stdlib `random` import in library code — seeded draws only"
            elif isinstance(node, ast.Call):
                name = _name_of(node.func)
                draw = self._torch_draw(node)
                if (name.startswith(("np.random.", "numpy.random."))
                        and name.rsplit(".", 1)[-1] not in self._NP_OK):
                    msg = (f"unseeded module-level numpy RNG ({name}) — draw from an "
                           f"explicit np.random.default_rng(seed) Generator or the "
                           f"counter-hash PRNG")
                elif draw is not None and not _has_kw(node, "generator"):
                    msg = (f"torch draw ({draw}) without generator= reads torch's "
                           f"global generator — pass an explicit seeded "
                           f"torch.Generator (or use the counter-hash PRNG)")
            if msg:
                out.append(Finding(rule=self.id, path=ctx.path, line=node.lineno,
                                   col=node.col_offset, message=msg))
        return out


# ---------------------------------------------------------------------------------------
# R3 — capture discipline, the twin of the JAX tracer rule. The JAX rule forbids host
# syncs inside jit/shard_map, where they crash at trace time or fold host state into
# the program. The port's counterpart is the code a CUDA graph captures: a host sync
# there (a device read, a blocking copy, a synchronize) fails the capture or, replayed,
# runs at capture time only; the CPU tests never capture, so such a fault shows first on
# the card. The roots are what Trainer._run_chunk replays (ChunkGraphs.run); the walk
# follows calls AND functions used as values (the steps and the scatter are passed
# around) across modules, and prunes the arms a captured body cannot take: a tensor
# not on the card (`not x.is_cuda`, `device.type != "cuda"`) and float64 parameters
# (the trainer places f32 or bf16 only), which keeps the plain versions out.
# ---------------------------------------------------------------------------------------
_CAPTURE_ROOTS = (
    (LIB + "train/trainer.py", "Trainer._chunk_body"),
    (LIB + "train/trainer.py", "Trainer._flush_hot"),
    (LIB + "ops/sgns.py", "sgns_step_core"),
    (LIB + "ops/sgns.py", "sgns_step_shared_scatter_"),
    (LIB + "ops/sgns.py", "cbow_step_core"),
    (LIB + "ops/sgns.py", "cbow_step_shared_core"),
    (LIB + "ops/cbow_banded.py", "cbow_step_banded_core"),
    (LIB + "ops/fused_sgns.py", "fused_sgns_shared_step"),
    (LIB + "ops/sgns_shard.py", "make_sharded_sgns_step"),
    (LIB + "ops/sgns_shard.py", "make_sharded_per_pair_step"),
    (LIB + "ops/sgns_shard.py", "make_sharded_cbow_step"),
    (LIB + "ops/sgns_shard.py", "make_sharded_banded_step"),
    (LIB + "ops/scatter.py", "scatter_add_rows_"),
)
# the functions that begin a capture, and the graph holder whose run() replays a body
_CAPTURE_SITES = ((LIB + "train/graphs.py", "ChunkGraphs._capture"),)
_GRAPH_HOLDER = "ChunkGraphs"
_CAPTURE_CALLS = {"capture_begin", "torch.cuda.graph", "make_graphed_callables"}
_DEPTH = 16

_DTYPES = {"float16", "float32", "float64", "bfloat16", "half", "float", "double"}
_STATIC_ATTRS = {"shape", "ndim", "dtype"}
_STATIC_CALLS = {"len", "numel", "dim", "size"}


def _dtype_attr(node: ast.AST) -> Optional[str]:
    name = _name_of(node) if isinstance(node, ast.Attribute) else ""
    if name.startswith("torch.") and name.rsplit(".", 1)[-1] in _DTYPES:
        tail = name.rsplit(".", 1)[-1]
        return {"double": "float64", "float": "float32", "half": "float16"}.get(tail, tail)
    return None


def truth_under_capture(test: ast.AST) -> Optional[bool]:
    """The value a condition has in code a CUDA graph captures, where it is decided by
    that alone: True/False, or None if the capture does not decide it. Captured code
    runs on tensors on the card, in float32 or bfloat16."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        t = truth_under_capture(test.operand)
        return None if t is None else not t
    if isinstance(test, ast.BoolOp):
        vals = [truth_under_capture(v) for v in test.values]
        if isinstance(test.op, ast.And):
            return False if False in vals else (True if all(vals) else None)
        return True if True in vals else (False if all(v is False for v in vals)
                                          else None)
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        return True
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    left, op, right = test.left, test.ops[0], test.comparators[0]
    eq = isinstance(op, (ast.Eq, ast.Is))
    ne = isinstance(op, (ast.NotEq, ast.IsNot))
    if (isinstance(left, ast.Attribute) and left.attr == "type"
            and isinstance(right, ast.Constant) and isinstance(right.value, str)):
        on_card = right.value == "cuda"
        return on_card if eq else (not on_card if ne else None)
    if "float64" in (_dtype_attr(left), _dtype_attr(right)):
        return False if eq else (True if ne else None)
    if isinstance(op, (ast.In, ast.NotIn)) and isinstance(right, (ast.Tuple, ast.List)):
        kinds = [_dtype_attr(e) for e in right.elts]
        if kinds and None not in kinds and "float64" not in kinds \
                and "float32" in kinds and "bfloat16" in kinds:
            return isinstance(op, ast.In)
    return None


_HOST_ANNOTATIONS = {"int", "float", "bool", "str"}
_HOST_FNS = {"int", "float", "bool"}


def host_params(node: ast.AST) -> Set[str]:
    """The parameters of a def annotated as a Python scalar (int, float, bool, str)."""
    args = getattr(node, "args", None)
    if args is None:
        return set()
    return {a.arg for a in args.args + args.kwonlyargs
            if a.annotation is not None
            and ast.unparse(a.annotation) in _HOST_ANNOTATIONS}


def host_fields(cls: Optional[ast.ClassDef]) -> Set[str]:
    """The class-body fields of ``cls`` annotated as a Python scalar (a dataclass's or a
    NamedTuple's host numbers)."""
    if cls is None:
        return set()
    return {s.target.id for s in cls.body if isinstance(s, ast.AnnAssign)
            and isinstance(s.target, ast.Name)
            and ast.unparse(s.annotation) in _HOST_ANNOTATIONS}


def is_host(node: ast.AST, names: Set[str], fields: Set[str] = frozenset()) -> bool:
    """True for an expression of host values only, whose conversion reads nothing from
    the device: constants, module constants, sizes and shapes, dtypes, ``names`` (host
    scalars in scope), ``self.<fields>``, and comparisons, arithmetic and numpy or
    conversion calls of those."""
    def rec(e: ast.AST) -> bool:
        if isinstance(e, ast.Constant):
            return True
        if isinstance(e, ast.Name):
            return e.id in names or e.id.isupper()
        if isinstance(e, ast.Attribute):
            return (e.attr in _STATIC_ATTRS or _dtype_attr(e) is not None
                    or _name_of(e).startswith(("np.", "numpy."))
                    or (isinstance(e.value, ast.Name) and e.value.id == "self"
                        and e.attr in fields))
        if isinstance(e, ast.Subscript):
            return rec(e.value)
        if isinstance(e, ast.Compare):  # a string or a dtype compared: a host bool
            ops = [e.left] + e.comparators
            return any((isinstance(o, ast.Constant) and isinstance(o.value, str))
                       or _dtype_attr(o) is not None for o in ops) or all(
                rec(o) for o in ops)
        if isinstance(e, ast.BinOp):
            return rec(e.left) and rec(e.right)
        if isinstance(e, ast.BoolOp):
            return all(rec(v) for v in e.values)
        if isinstance(e, ast.UnaryOp):
            return rec(e.operand)
        if isinstance(e, ast.IfExp):
            return rec(e.body) and rec(e.orelse)
        if isinstance(e, ast.Call):
            name = _name_of(e.func)
            if name.rsplit(".", 1)[-1] in _STATIC_CALLS:
                return True
            builtin = isinstance(e.func, ast.Name) and name in _HOST_FNS
            return (builtin or name.startswith(("np.", "numpy.")) or rec(e.func)) and all(
                rec(a) for a in e.args)
        return False
    return rec(node)


def _narrowed(test: ast.AST) -> Tuple[Set[str], Set[str]]:
    """Names a condition proves to be host values: (in its body, in its else). Only
    ``isinstance(x, torch.Tensor)`` narrows: its else (or its negation's body)."""
    neg = isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
    core = test.operand if neg else test
    if not (isinstance(core, ast.Call) and _name_of(core.func) == "isinstance"
            and len(core.args) == 2 and isinstance(core.args[0], ast.Name)
            and ast.unparse(core.args[1]) == "torch.Tensor"):
        return set(), set()
    host = {core.args[0].id}
    return (host, set()) if neg else (set(), host)


def _exits(stmts: List[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise))


def host_sync(call: ast.Call, names: Set[str] = frozenset(),
              fields: Set[str] = frozenset()) -> Optional[str]:
    """What makes ``call`` a host sync (or a host-side read the graph would bake in), or
    None. ``names``/``fields``: the host scalars in scope (see :func:`is_host`)."""
    name = _name_of(call.func)
    tail = name.rsplit(".", 1)[-1]
    method = isinstance(call.func, ast.Attribute)
    if name in ("float", "int", "bool") and call.args and not is_host(
            call.args[0], names, fields):
        return f"{name}() reads a device value on the host"
    if method and tail in ("item", "cpu", "tolist", "numpy") and not name.startswith(
            ("np.", "numpy.")):
        return f".{tail}() copies a device value to the host"
    if tail in ("nonzero", "argwhere") and (method or name == tail):
        return f"{name}() sizes its output from device data (a host sync)"
    if tail in ("unique", "unique_consecutive") and not name.startswith(("np.", "numpy.")):
        return f"{name}() sizes its output from device data (a host sync)"
    if tail == "synchronize":
        return f"{name}() blocks the host on the device"
    if name in ("np.asarray", "numpy.asarray", "np.array", "numpy.array"):
        return f"{name}() copies to the host"
    if name.startswith("time.") or name == "perf_counter":
        return f"{name}() reads the host clock once, at capture"
    return None


class R3CaptureDiscipline:
    id = "R3"
    repo_rule = True

    def __init__(self, roots=_CAPTURE_ROOTS, sites=_CAPTURE_SITES):
        self.roots = roots
        self.sites = sites

    def _root_fns(self, index, findings: List[Finding]):
        fns = []
        for path, qual in self.roots:
            cls, _, name = qual.rpartition(".")
            fn = index.fns.get((path, cls or None, name))
            if fn is None:
                findings.append(Finding(
                    rule=self.id, path=path, line=0, col=0,
                    message=f"stale capture root: no def {qual!r} in {path} — R3 "
                            f"would walk nothing from it; update the root list"))
            else:
                fns.append(fn)
        return fns

    def reach(self, index, findings: Optional[List[Finding]] = None):
        """{function key: (Fn, chain of labels from its root)} for every function the
        captured bodies can run, and the host syncs found in them as findings."""
        findings = [] if findings is None else findings
        reached: Dict[tuple, Tuple[object, List[str]]] = {}
        frontier = []
        for fn in self._root_fns(index, findings):
            if fn.key not in reached:
                reached[fn.key] = (fn, [fn.label])
                frontier.append(fn)
        seen: Set[Tuple[str, int, str]] = set()
        while frontier:
            fn = frontier.pop(0)
            chain = reached[fn.key][1]
            entry = index.classes.get(fn.cls) if fn.cls else None
            fields = host_fields(entry[1] if entry else None)

            def expr(node: ast.AST, names: Set[str]) -> None:
                if isinstance(node, ast.IfExp):
                    t = truth_under_capture(node.test)
                    expr(node.test, names)
                    if t is not False:
                        expr(node.body, names)
                    if t is not True:
                        expr(node.orelse, names)
                    return
                if isinstance(node, ast.Lambda):
                    expr(node.body, set())
                    return
                if isinstance(node, ast.Call):
                    what = host_sync(node, names, fields)
                    if what and (fn.path, node.lineno, what) not in seen:
                        seen.add((fn.path, node.lineno, what))
                        findings.append(Finding(
                            rule=self.id, path=fn.path, line=node.lineno,
                            col=node.col_offset,
                            message=f"host sync in code a CUDA graph captures: {what} "
                                    f"(reached via {' -> '.join(chain)})"))
                if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                        node.ctx, ast.Load):
                    # a call target or a function used as a value (a step, a scatter)
                    callee = index.resolve_ref(node, fn)
                    if callee is not None and callee.key not in reached \
                            and len(chain) < _DEPTH:
                        reached[callee.key] = (callee, chain + [callee.label])
                        frontier.append(callee)
                for child in ast.iter_child_nodes(node):
                    expr(child, names)

            def block(stmts: List[ast.stmt], names: Set[str]) -> None:
                names = set(names)
                for stmt in stmts:
                    if isinstance(stmt, ast.If):
                        t = truth_under_capture(stmt.test)
                        in_body, in_else = _narrowed(stmt.test)
                        expr(stmt.test, names)
                        if t is not False:
                            block(stmt.body, names | in_body)
                        if t is not True:
                            block(stmt.orelse, names | in_else)
                        if t is not False and _exits(stmt.body) and not stmt.orelse:
                            names |= in_else  # past an early exit: the else holds
                    elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        block(stmt.body, host_params(stmt))
                    elif isinstance(stmt, ast.ClassDef):
                        block(stmt.body, set())
                    else:
                        for field, value in ast.iter_fields(stmt):
                            if isinstance(value, list) and value and isinstance(
                                    value[0], ast.stmt):
                                block(value, names)
                            elif isinstance(value, list):
                                for v in value:
                                    if isinstance(v, ast.excepthandler):
                                        block(v.body, names)
                                    elif isinstance(v, ast.AST):
                                        expr(v, names)
                            elif isinstance(value, ast.AST):
                                expr(value, names)
                        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                                and isinstance(stmt.targets[0], ast.Name):
                            tgt = stmt.targets[0].id
                            if is_host(stmt.value, names, fields):
                                names.add(tgt)
                            else:
                                names.discard(tgt)

            if isinstance(fn.node, ast.Lambda):
                expr(fn.node.body, set())
            else:
                block(fn.node.body, host_params(fn.node))
        return reached, findings

    def _sites(self, index) -> List[Finding]:
        """Every capture is begun at a declared site, and every body the graph holder
        replays calls only declared roots: a new capture path must name its roots."""
        out: List[Finding] = []
        declared = {(p, q) for p, q in self.sites}
        roots = {(p, q) for p, q in self.roots}
        for path, (tree, _) in index.files.items():
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                name = _name_of(node.func)
                capture = name in _CAPTURE_CALLS or name.rsplit(".", 1)[-1] in \
                    _CAPTURE_CALLS
                run = (isinstance(node.func, ast.Attribute) and node.func.attr == "run"
                       and len(node.args) >= 2)
                if not (capture or run):
                    continue
                fn = index.enclosing_fn(path, node)
                qual = None if fn is None else (
                    f"{fn.cls}.{fn.name}" if fn.cls else fn.name)
                if capture and (path, qual) not in declared:
                    out.append(Finding(
                        rule=self.id, path=path, line=node.lineno, col=0,
                        message=f"CUDA graph capture ({name}) outside the declared "
                                f"capture sites — declare the site and the roots its "
                                f"body runs in graftlint's R3"))
                if not run or fn is None:
                    continue
                holder = node.func.value
                htype = None
                if isinstance(holder, ast.Attribute) and isinstance(
                        holder.value, ast.Name) and holder.value.id == "self" and fn.cls:
                    htype = index.attr_types.get((fn.cls, holder.attr))
                if htype != _GRAPH_HOLDER:
                    continue
                body = node.args[1]
                calls = ([c for c in ast.walk(body.body) if isinstance(c, ast.Call)]
                         if isinstance(body, ast.Lambda) else [])
                targets = [index.resolve_ref(c.func, fn) for c in calls] or [
                    index.resolve_ref(body, fn)]
                for t in targets:
                    tq = None if t is None else (
                        t.path, f"{t.cls}.{t.name}" if t.cls else t.name)
                    if tq not in roots:
                        out.append(Finding(
                            rule=self.id, path=fn.path, line=node.lineno, col=0,
                            message=f"a body replayed by {_GRAPH_HOLDER}.run calls "
                                    f"{'an unresolved function' if t is None else t.label}"
                                    f", which is not a declared capture root — add it "
                                    f"to R3's roots"))
        return out

    def check_repo(self, root: str, index=None) -> List[Finding]:
        from glint_word2vec_torch.graftlint.concurrency import TreeIndex, suppressible
        index = index or TreeIndex(root)
        _, findings = self.reach(index)
        return suppressible(index, findings + self._sites(index))


# ---------------------------------------------------------------------------------------
# R4 — dtype discipline for prefix accumulation: a cumsum chain fed from bf16 params
# cancels away the very interval it computes (ops/cbow_banded.py). Every prefix
# accumulation on tensors must carry STATIC evidence of a ≥f32 or integer dtype: a
# dtype= keyword, a cast to a wide type in its input's def-use chain, or an integer or
# boolean source (a comparison, arange, argsort...).
# ---------------------------------------------------------------------------------------
class R4PrefixDtype:
    id = "R4"
    _TARGET_TAILS = {"cumsum", "cumsum_rows", "cumprod", "cummax", "cummin",
                     "logcumsumexp", "segment_sum"}
    _HOST_PREFIXES = ("np.", "numpy.")  # host numpy accumulates in f64/int
    _MARKERS = ("float32", "float64", "int32", "int64", "torch.long", "torch.double",
                "torch.int", ".long()", ".double()", ".float()", ".int()",
                "promote_types")
    _INT_SOURCES = {"arange", "argsort", "argmax", "argmin", "bincount", "searchsorted",
                    "randint", "nonzero"}

    def applies(self, path: str) -> bool:
        return in_library(path)

    def _has_marker(self, node: ast.AST, assigns: Dict[str, ast.AST],
                    depth: int = 0) -> bool:
        if depth > 4:
            return False
        if isinstance(node, (ast.Compare, ast.BoolOp)) or (
                isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not)):
            return True  # a boolean tensor: cumsum accumulates it in int64
        if isinstance(node, ast.Call) and _name_of(node.func).rsplit(
                ".", 1)[-1] in self._INT_SOURCES:
            return True
        if any(m in ast.unparse(node) for m in self._MARKERS):
            return True
        for name in _walk_names(node):
            rhs = assigns.get(name)
            if rhs is not None and self._has_marker(
                    rhs, {k: v for k, v in assigns.items() if k != name}, depth + 1):
                return True
        return False

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        modules = {a.asname or a.name.split(".")[0] for node in ast.walk(ctx.tree)
                   if isinstance(node, (ast.Import, ast.ImportFrom)) for a in node.names}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _name_of(node.func)
            if name.rsplit(".", 1)[-1] not in self._TARGET_TAILS \
                    or name.startswith(self._HOST_PREFIXES) or _has_kw(node, "dtype"):
                continue
            fn = ctx.enclosing_function(node)
            assigns: Dict[str, ast.AST] = {}
            if fn is not None and not isinstance(fn, ast.Lambda):
                for stmt in ast.walk(fn):
                    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                            and isinstance(stmt.targets[0], ast.Name):
                        assigns[stmt.targets[0].id] = stmt.value
            # torch.cumsum(x, ...) / cumsum_rows(x) read their first argument, the
            # method form x.cumsum(...) its receiver
            method = isinstance(node.func, ast.Attribute) and not (
                isinstance(node.func.value, ast.Name) and node.func.value.id in modules)
            source = node.func.value if method else (node.args[0] if node.args else None)
            if source is None or not self._has_marker(source, assigns):
                out.append(Finding(
                    rule=self.id, path=ctx.path, line=node.lineno, col=node.col_offset,
                    message=f"prefix accumulation ({name}) without static ≥f32/int "
                            f"dtype evidence on its input — a bf16 prefix cancels the "
                            f"interval (ops/cbow_banded.py); pass dtype=, cast the "
                            f"input (.to(torch.float32), .double(), .long()) or "
                            f"suppress with the reasoning"))
        return out


def _retry_protected(ctx: ModuleContext, node: ast.AST) -> bool:
    """True if ``node`` is lexically inside (a) the argument subtree of a retry_io(...)
    call, or (b) a def/lambda whose NAME is passed to retry_io(...) in this module."""
    retry_calls = [n for n in ast.walk(ctx.tree) if isinstance(n, ast.Call)
                   and _name_of(n.func).rsplit(".", 1)[-1] == "retry_io"]
    retried_names: Set[str] = set()
    for call in retry_calls:
        for arg in call.args:
            if isinstance(arg, ast.Name):
                retried_names.add(arg.id)
            if any(sub is node for sub in ast.walk(arg)):
                return True
    cur = node
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                cur.name in retried_names:
            return True
        cur = ctx.parents.get(cur)
    return False


# ---------------------------------------------------------------------------------------
# R5 — robust ingest: data-plane READS (open/np.memmap/np.fromfile in data/) go through
# train.faults.retry_io, so a transient FS hiccup retries with backoff instead of
# killing a long run. Writes are exempt: the one-shot encode passes restart from
# scratch instead (a blind re-run would silently truncate).
# ---------------------------------------------------------------------------------------
class R5RetryIO:
    id = "R5"

    def applies(self, path: str) -> bool:
        return path.startswith(LIB + "data/")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _name_of(node.func)
            if name == "open":
                mode = "r"
                if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
                    mode = str(node.args[1].value)
                for kw in node.keywords:
                    if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                        mode = str(kw.value.value)
                if not mode.startswith("r"):
                    continue  # write passes restart from scratch by design
            elif name.rsplit(".", 1)[-1] not in ("memmap", "fromfile"):
                continue
            if _retry_protected(ctx, node):
                continue
            out.append(Finding(
                rule=self.id, path=ctx.path, line=node.lineno, col=node.col_offset,
                message=f"bare data-plane read ({name}) not routed through retry_io — "
                        f"transient FS errors kill long runs; wrap the open/mmap in "
                        f"retry_io(...)"))
        return out


# ---------------------------------------------------------------------------------------
# R6 — staging discipline: the trainer places host data on the device ONLY through its
# staging path (_stage on the producer thread, _device_arrays on the consumer:
# pinned memory, non-blocking copies, the "stage" sync site the transfer audit reads)
# and parallel/distributed.put_global on a mesh. Anything else in the trainer is a
# blocking copy the audit sees only on the paths it drives.
# ---------------------------------------------------------------------------------------
class R6StagingDiscipline:
    id = "R6"
    _ALLOW_FNS = {"_stage", "_device_arrays"}
    _HOST_CTORS = {"torch.from_numpy", "torch.as_tensor", "torch.tensor"}

    def applies(self, path: str) -> bool:
        return path == LIB + "train/trainer.py"

    @staticmethod
    def _device_kw(call: ast.Call) -> bool:
        return any(kw.arg == "device" and not (
            isinstance(kw.value, ast.Constant) and kw.value.value in (None, "cpu"))
            for kw in call.keywords)

    def _host_root(self, node: ast.AST) -> bool:
        """True if a ``.to(...)`` receiver is a tensor made from host data: a
        ``torch.from_numpy`` / ``as_tensor`` / ``tensor`` call, possibly through
        ``.pin_memory()`` and similar method chains."""
        while isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if _name_of(node.func) in self._HOST_CTORS:
                return True
            node = node.func.value
        return isinstance(node, ast.Call) and _name_of(node.func) in self._HOST_CTORS

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _name_of(node.func)
            bad = None
            if isinstance(node.func, ast.Attribute) and node.func.attr == "cuda":
                bad = ".cuda()"
            elif name in ("torch.as_tensor", "torch.tensor") and self._device_kw(node):
                bad = f"{name}(..., device=)"
            elif isinstance(node.func, ast.Attribute) and node.func.attr == "to" \
                    and self._host_root(node.func.value) and (
                        node.args or self._device_kw(node)):
                bad = ".to(device) of a host tensor"
            if bad is None:
                continue
            qn = ctx.qualname(node)
            if any(qn == a or qn.endswith("." + a) for a in self._ALLOW_FNS):
                continue
            out.append(Finding(
                rule=self.id, path=ctx.path, line=node.lineno, col=node.col_offset,
                message=f"raw host-to-device placement in the trainer ({bad}) — go "
                        f"through the staging path (_stage / _device_arrays, or "
                        f"distributed.put_global on a mesh), which copies from pinned "
                        f"memory without blocking at the declared 'stage' sync site"))
        return out


# ---------------------------------------------------------------------------------------
# R7 — the exactly-one-JSON-line stdout contract of the port's JSON-contract tools: one
# machine-readable line on stdout, everything human on stderr. chip_smoke.py is not
# held to it: its stdout is a log whose LAST line is the contract (its main prints it
# once, after the kernels' line).
# ---------------------------------------------------------------------------------------
class R7JsonStdout:
    id = "R7"
    CONTRACT_MODULES = {LIB + m for m in (
        "chaos_run.py", "continual_run.py", "fleet_run.py", "obs_collect.py",
        "racecheck.py", "run_report.py", "servebench.py", "stepaudit.py",
        "telemetry_run.py", "train_run.py", "graftcheck/__main__.py")}

    def applies(self, path: str) -> bool:
        return path in self.CONTRACT_MODULES

    @staticmethod
    def _is_json_print(node: ast.Call) -> bool:
        return (len(node.args) == 1 and isinstance(node.args[0], ast.Call)
                and _name_of(node.args[0].func).endswith("json.dumps"))

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        json_prints_per_fn: Dict[str, int] = {}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and _name_of(node.func) == "print"):
                continue
            if any(kw.arg == "file" for kw in node.keywords):
                continue  # stderr-routed
            if self._is_json_print(node):
                qn = ctx.qualname(node)
                json_prints_per_fn[qn] = json_prints_per_fn.get(qn, 0) + 1
                if json_prints_per_fn[qn] > 1:
                    out.append(Finding(
                        rule=self.id, path=ctx.path, line=node.lineno,
                        col=node.col_offset,
                        message=f"second print(json.dumps(...)) in {qn} — the stdout "
                                f"contract is exactly ONE JSON line"))
                continue
            out.append(Finding(
                rule=self.id, path=ctx.path, line=node.lineno, col=node.col_offset,
                message="bare print() to stdout in a JSON-contract tool — route human "
                        "output to stderr (file=sys.stderr); stdout carries exactly "
                        "one JSON line"))
        return out


# ---------------------------------------------------------------------------------------
# R8 — refusal-matrix parity (repo rule): every knob combination the trainer refuses
# (any Trainer method) must also be refused by the config's construction-time
# validation (__post_init__ and the validators it calls), so an unsupported config
# fails before any card time. Conditions that test runtime state as well are exempt.
# The cross-reference: the port's graftcheck knob registry enumerates every config
# field, so the executing checker cannot under-cover the surface this rule parses.
# ---------------------------------------------------------------------------------------
class R8RefusalParity:
    id = "R8"
    repo_rule = True

    _CONFIG = LIB + "config.py"
    _TRAINER = LIB + "train/trainer.py"
    _GRAFTCHECK_REGISTRY = LIB + "graftcheck/registry.py"
    _PURE_MODULES = ("np", "numpy", "torch")

    def _knobs_in(self, test: ast.AST, selves: Set[str],
                  fields: Set[str]) -> Optional[Set[str]]:
        """Config-field names referenced in a condition; None if the condition also
        references non-config runtime state."""
        knobs: Set[str] = set()
        pure = True
        for node in ast.walk(test):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
                if node.value.id in selves:
                    if node.attr in fields:
                        knobs.add(node.attr)
                    else:
                        pure = False
                elif node.value.id not in self._PURE_MODULES:
                    pure = False
            elif isinstance(node, ast.Call) or (
                    isinstance(node, ast.Name)
                    and node.id not in selves | set(self._PURE_MODULES)):
                pure = False  # a call or a local: runtime state
        return knobs if pure and knobs else None

    def _raise_matrix(self, fns, fields: Set[str], parents: Dict[ast.AST, ast.AST]):
        """set of frozensets: the knob set guarding each pure-config raise (union of
        every enclosing `if` condition's knobs). ``fns``: (def, names of self)."""
        out = set()
        for fn, selves in fns:
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Raise) and node.exc is not None
                        and "ValueError" in ast.unparse(node.exc)):
                    continue
                knobs: Set[str] = set()
                pure = True
                cur = parents.get(node)
                while cur is not None and cur is not fn:
                    if isinstance(cur, ast.If):
                        k = self._knobs_in(cur.test, selves, fields)
                        if k is None:
                            pure = False
                            break
                        knobs |= k
                    cur = parents.get(cur)
                if pure and knobs:
                    out.add(frozenset(knobs))
        return out

    @staticmethod
    def _parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
        p = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                p[child] = node
        return p

    def check_repo(self, root: str, index=None) -> List[Finding]:
        try:
            with open(os.path.join(root, *self._CONFIG.split("/")), "r",
                      encoding="utf-8") as f:
                cfg_tree = ast.parse(f.read())
            with open(os.path.join(root, *self._TRAINER.split("/")), "r",
                      encoding="utf-8") as f:
                tr_tree = ast.parse(f.read())
        except (OSError, SyntaxError) as e:
            return [Finding(rule=self.id, path=self._CONFIG, line=0, col=0,
                            message=f"cannot parse matrix sources: {e}")]

        # the config dataclass's fields (InitVar and ClassVar are not fields) = the
        # knob universe; the validation is __post_init__ plus the module functions it
        # calls with self (the port keeps the reference's checks in validators)
        fields: Set[str] = set()
        post = None
        for node in ast.walk(cfg_tree):
            if isinstance(node, ast.ClassDef) and node.name == "Word2VecConfig":
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and isinstance(
                            stmt.target, ast.Name) and not any(
                            m in ast.unparse(stmt.annotation)
                            for m in ("InitVar", "ClassVar")):
                        fields.add(stmt.target.id)
                    elif isinstance(stmt, ast.FunctionDef) and \
                            stmt.name == "__post_init__":
                        post = stmt
        if not fields:
            return [Finding(rule=self.id, path=self._CONFIG, line=0, col=0,
                            message="Word2VecConfig fields not found")]
        cfg_fns = [(post, {"self"})] if post is not None else []
        helpers = {n.name: n for n in cfg_tree.body if isinstance(n, ast.FunctionDef)}
        for call in (ast.walk(post) if post is not None else []):
            if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                    and call.func.id in helpers and call.args
                    and isinstance(call.args[0], ast.Name) and call.args[0].id == "self"):
                h = helpers[call.func.id]
                if h.args.args:
                    cfg_fns.append((h, {h.args.args[0].arg}))
        tr_fns = [(fn, {"cfg", "config", "self"}) for cls in ast.walk(tr_tree)
                  if isinstance(cls, ast.ClassDef) and cls.name == "Trainer"
                  for fn in ast.walk(cls) if isinstance(fn, ast.FunctionDef)]

        cfg_matrix = self._raise_matrix(cfg_fns, fields, self._parents(cfg_tree))
        disp_matrix = self._raise_matrix(tr_fns, fields, self._parents(tr_tree))
        findings: List[Finding] = []
        for combo in sorted(disp_matrix, key=sorted):
            if len(combo) < 2:
                continue  # single-knob range checks live in config by design
            # covered only by a MULTI-knob config raise over a subset of these knobs: a
            # single-knob range check says nothing about the combination
            if not any(len(c) >= 2 and c <= combo for c in cfg_matrix):
                findings.append(Finding(
                    rule=self.id, path=self._TRAINER, line=0, col=0,
                    message=f"knob combination refused at trainer dispatch but not in "
                            f"the config's construction-time validation: "
                            f"{sorted(combo)} — add the refusal to config.py "
                            f"(graftcheck executes the empirical twin of this check)"))
        findings.extend(self._check_graftcheck_registry(root, fields))
        return findings

    def _check_graftcheck_registry(self, root: str, fields: Set[str]) -> List[Finding]:
        """Every config field has a knob entry in the port's graftcheck registry (pure
        AST: literal ``_K("name", ...)`` entries); skipped where the graftcheck package
        is absent (the fixture mini-repos)."""
        if not os.path.isdir(os.path.join(root, *(LIB + "graftcheck").split("/"))):
            return []
        try:
            with open(os.path.join(root, *self._GRAFTCHECK_REGISTRY.split("/")), "r",
                      encoding="utf-8") as f:
                reg_tree = ast.parse(f.read())
        except (OSError, SyntaxError) as e:
            return [Finding(rule=self.id, path=self._GRAFTCHECK_REGISTRY, line=0, col=0,
                            message=f"cannot parse the graftcheck knob registry: {e}")]
        declared = {str(node.args[0].value) for node in ast.walk(reg_tree)
                    if isinstance(node, ast.Call)
                    and _name_of(node.func) in ("_K", "Knob")
                    and node.args and isinstance(node.args[0], ast.Constant)}
        out = [Finding(rule=self.id, path=self._GRAFTCHECK_REGISTRY, line=0, col=0,
                       message=f"config field {name!r} has no knob entry in the "
                               f"graftcheck registry — the executing lattice "
                               f"under-covers the refusal surface; declare its domain")
               for name in sorted(fields - declared)]
        out += [Finding(rule=self.id, path=self._GRAFTCHECK_REGISTRY, line=0, col=0,
                        message=f"graftcheck registry knob {name!r} does not exist on "
                                f"Word2VecConfig — drop the stale entry")
                for name in sorted(declared - fields)]
        return out


# ---------------------------------------------------------------------------------------
# SCOPE — the tool-scope literal stays true: every entry names a file (or a package
# directory) in the tree, so a renamed tool cannot silently fall under the library rules
# or out of R7.
# ---------------------------------------------------------------------------------------
class ToolScopeStaleness:
    id = "SCOPE"
    repo_rule = True

    def check_repo(self, root: str, index=None) -> List[Finding]:
        out: List[Finding] = []
        for entry in TOOL_SCOPE:
            p = os.path.join(root, *entry.rstrip("/").split("/"))
            ok = os.path.isdir(p) if entry.endswith("/") else os.path.isfile(p)
            if not ok:
                out.append(Finding(
                    rule=self.id, path=entry, line=0, col=0,
                    message=f"stale tool-scope entry {entry!r}: nothing there — drop "
                            f"or update engine.TOOL_SCOPE"))
        for mod in sorted(R7JsonStdout.CONTRACT_MODULES):
            if not os.path.isfile(os.path.join(root, *mod.split("/"))):
                out.append(Finding(
                    rule=self.id, path=mod, line=0, col=0,
                    message=f"stale R7 contract module {mod!r}: no such file"))
        return out


from glint_word2vec_torch.graftlint.concurrency import CONCURRENCY_RULES  # noqa: E402
# (the lock rules live in their own module, imported at the bottom so it can use
# _name_of from here)

ALL_RULES = [R1ThreadPools(), R2Prng(), R3CaptureDiscipline(), R4PrefixDtype(),
             R5RetryIO(), R6StagingDiscipline(), R7JsonStdout(), R8RefusalParity(),
             ToolScopeStaleness()] + CONCURRENCY_RULES
