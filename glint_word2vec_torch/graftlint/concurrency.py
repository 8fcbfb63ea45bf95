"""The lock-discipline rules R9-R11 and R1's staleness gate over the port, ported from
``tools/graftlint/concurrency.py`` and bound to :mod:`glint_word2vec_torch.lockcheck`'s
table; and :class:`TreeIndex`, the whole-tree index the repo rules share.

- **R9 lock-order**: every lock is constructed through ``glint_word2vec_torch.lockcheck``
  with a registered rank (``LOCK_TABLE``, parsed here as a pure literal). The
  cross-module acquisition graph is built from ``with``/``.acquire()`` sites resolved
  through ``self.`` attributes plus a bounded call closure; any edge that does not
  strictly increase rank, any cycle, and any reentrant acquisition of a non-reentrant
  kind is a finding. Registry drift (unregistered construction, a raw
  ``threading.Lock()`` in scanned code, stale or moved entries) fails the same rule.
- **R10 signal-handler safety**: the call closure of every installed signal handler may
  not acquire a non-reentrant lock. The walk propagates literal boolean keyword
  arguments one call deep (pruning ``if param:`` bodies): the dump path's
  ``include_stats=False`` is such a guard.
- **R11 shared-mutable discipline** (per-file, library scope): in a thread-owning
  class, every whole-collection access of a shared deque/list/dict attribute holds the
  same lock, or lives in a documented snapshot helper.
- **R1 staleness**: an R1 allowlist entry whose (path, qualname) no longer resolves to
  a def is a finding.

R9 and R10 resolve calls exactly as the JAX rules do (same-module names, ``self.``
methods, typed ``self.`` attributes and locals, class constructors), so the two tools
agree on the JAX fixtures and ``racecheck``'s static cross-check reads the same graph.
:meth:`TreeIndex.resolve_ref` adds what R3's capture walk needs on top: imported names
and modules, module-level instances (``COLLECTIVES``) and class attributes.

Repo-rule findings honour the standard suppression syntax: the engine applies
directives to per-file rules only, so these rules re-apply them per flagged file.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from glint_word2vec_torch.graftlint.engine import (
    LIB, Finding, apply_suppressions, in_library, iter_source_files)
from glint_word2vec_torch.graftlint.rules import _name_of

_LOCKCHECK = LIB + "lockcheck.py"
_FACTORIES = {"make_lock": "lock", "make_rlock": "rlock",
              "make_condition": "condition"}
_PRIMITIVES = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}
_CLOSURE_DEPTH = 10


def _is_primitive_ctor(call: ast.Call) -> Optional[str]:
    """'lock'/'rlock'/'condition' for a raw threading primitive construction
    (``threading.Lock()`` or a bare ``Lock()``)."""
    name = _name_of(call.func)
    tail = name.rsplit(".", 1)[-1]
    if tail in _PRIMITIVES and name in (tail, "threading." + tail):
        return _PRIMITIVES[tail]
    return None


def _factory_call(call: ast.Call) -> Optional[Tuple[str, Optional[str]]]:
    """(kind, registered name or None) for lockcheck factory calls."""
    tail = _name_of(call.func).rsplit(".", 1)[-1]
    if tail not in _FACTORIES:
        return None
    name = None
    if call.args and isinstance(call.args[0], ast.Constant) and isinstance(
            call.args[0].value, str):
        name = call.args[0].value
    return _FACTORIES[tail], name


def _parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def qualname_exists(tree: ast.Module, qual: str) -> bool:
    """True if ``qual`` (``Class.method``, ``func``, ``func.inner``) names a def."""
    parents = _parent_map(tree)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        parts = [node.name]
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                parts.append(cur.name)
            cur = parents.get(cur)
        if ".".join(reversed(parts)) == qual:
            return True
    return False


class Fn:
    """One function/method with everything the closure walks need."""

    __slots__ = ("node", "path", "cls", "name", "params")

    def __init__(self, node: ast.AST, path: str, cls: Optional[str],
                 name: str) -> None:
        self.node = node
        self.path = path
        self.cls = cls
        self.name = name
        args = getattr(node, "args", None)
        self.params = ({a.arg for a in args.args} | {a.arg for a in args.kwonlyargs}
                       if args is not None else set())

    @property
    def key(self) -> Tuple[str, Optional[str], str]:
        return (self.path, self.cls, self.name)

    @property
    def label(self) -> str:
        return f"{self.path}:{(self.cls + '.') if self.cls else ''}{self.name}"


class TreeIndex:
    """Whole-tree index: the lock registry, every construction site, per-class lock and
    typed attributes, the function map the closure walks resolve calls through, and
    each module's imports and module-level instances (for :meth:`resolve_ref`)."""

    def __init__(self, root: str, contexts=None):
        self.root = root
        self.registry: Dict[str, dict] = {}
        self.registry_err: Optional[str] = None
        self.files: Dict[str, Tuple[ast.Module, List[str]]] = {}
        # ClassName -> (path, ClassDef); name collisions -> None (ambiguous)
        self.classes: Dict[str, Optional[Tuple[str, ast.ClassDef]]] = {}
        self.fns: Dict[Tuple[str, Optional[str], str], Fn] = {}
        self.attr_locks: Dict[Tuple[str, str], str] = {}   # (cls, attr) -> lock
        self.mod_locks: Dict[Tuple[str, str], str] = {}    # (path, var) -> lock
        self.attr_types: Dict[Tuple[str, str], str] = {}   # (cls, attr) -> Cls
        # (path, qualname, lockname, kind, lineno)
        self.construct_sites: List[Tuple[str, str, Optional[str], str, int]] = []
        self.raw_sites: List[Tuple[str, str, str, int]] = []
        # path -> local name -> (module path, attribute or None for the module)
        self.imports: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = {}
        self.mod_vars: Dict[Tuple[str, str], str] = {}     # (path, var) -> Cls
        self._scope_types: Dict[tuple, Dict[str, str]] = {}
        self.parents: Dict[str, Dict[ast.AST, ast.AST]] = {}
        self._load(contexts)

    # -- loading -----------------------------------------------------------------------

    def _load(self, contexts) -> None:
        """Parse the scanned files, or take the engine's parsed ``contexts`` (path ->
        ModuleContext) as they are."""
        if contexts is not None:
            for rel, ctx in contexts.items():
                self.files[rel] = (ctx.tree, ctx.lines)
                self.parents[rel] = ctx.parents
        else:
            for abspath in iter_source_files(self.root):
                rel = os.path.relpath(abspath, self.root).replace(os.sep, "/")
                try:
                    with open(abspath, "r", encoding="utf-8") as f:
                        text = f.read()
                    tree = ast.parse(text)
                except (OSError, SyntaxError):
                    continue  # the engine reports AST findings; nothing here
                self.files[rel] = (tree, text.splitlines())
        lc = self.files.get(_LOCKCHECK)
        if lc is None:
            self.registry_err = f"{_LOCKCHECK} not found — no lock registry"
        else:
            self._parse_registry(lc[0])
        for rel, (tree, _) in self.files.items():
            self._index_module(rel, tree)
        # second pass: typed attributes and imports need the full class and file maps
        for rel, (tree, _) in self.files.items():
            self._index_attr_types(rel, tree)
            self._index_imports(rel, tree)

    def enclosing_fn(self, path: str, node: ast.AST) -> Optional[Fn]:
        """The indexed def whose body holds ``node`` in module ``path``."""
        parents = self.parents[path]
        cur = parents.get(node)
        while cur is not None and not isinstance(cur, (ast.FunctionDef,
                                                       ast.AsyncFunctionDef)):
            cur = parents.get(cur)
        if cur is None:
            return None
        owner = parents.get(cur)
        while owner is not None and not isinstance(owner, ast.ClassDef):
            owner = parents.get(owner)
        fn = self.fns.get((path, owner.name if owner else None, cur.name))
        return fn if fn is not None and fn.node is cur else None

    def _parse_registry(self, tree: ast.Module) -> None:
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "LOCK_TABLE"):
                try:
                    table = ast.literal_eval(node.value)
                except ValueError:
                    self.registry_err = (
                        "LOCK_TABLE is not a pure literal — entries built by code are "
                        "invisible to the drift gate")
                    return
                self.registry = dict(table)
                return
        self.registry_err = "LOCK_TABLE not found in lockcheck.py"

    def _index_module(self, rel: str, tree: ast.Module) -> None:
        parents = self.parents.get(rel)
        if parents is None:
            parents = self.parents[rel] = _parent_map(tree)

        def qualname(node: ast.AST) -> str:
            parts: List[str] = []
            cur = parents.get(node)
            while cur is not None:
                if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.ClassDef)):
                    parts.append(cur.name)
                cur = parents.get(cur)
            return ".".join(reversed(parts)) or "<module>"

        def enclosing_class(node: ast.AST) -> Optional[str]:
            cur = parents.get(node)
            while cur is not None:
                if isinstance(cur, ast.ClassDef):
                    return cur.name
                cur = parents.get(cur)  # a def nested in a method belongs to the class
            return None

        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and parents.get(node) is tree:
                self.classes[node.name] = (
                    None if node.name in self.classes else (rel, node))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = Fn(node, rel, enclosing_class(node), node.name)
                self.fns.setdefault(fn.key, fn)
            elif isinstance(node, ast.Call):
                fac = _factory_call(node)
                kind_raw = _is_primitive_ctor(node)
                if fac is not None:
                    kind, lname = fac
                    self.construct_sites.append(
                        (rel, qualname(node), lname, kind, node.lineno))
                    tgt = self._assign_target(parents.get(node), node)
                    if tgt is not None and lname is not None:
                        mode, attr = tgt
                        if mode == "self":
                            cls = enclosing_class(node)
                            if cls:
                                self.attr_locks[(cls, attr)] = lname
                        else:
                            self.mod_locks[(rel, attr)] = lname
                        # locals are resolved lexically in resolve_lock
                elif kind_raw is not None and rel != _LOCKCHECK:
                    self.raw_sites.append((rel, qualname(node), kind_raw, node.lineno))

    @staticmethod
    def _assign_target(parent: Optional[ast.AST], call: ast.Call):
        """('self', attr) / ('module', name) for single-target ``X = <call>``
        assignments (annotated or not)."""
        if isinstance(parent, ast.AnnAssign) and parent.value is call:
            t = parent.target
        elif (isinstance(parent, ast.Assign) and parent.value is call
                and len(parent.targets) == 1):
            t = parent.targets[0]
        else:
            return None
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                and t.value.id == "self":
            return ("self", t.attr)
        if isinstance(t, ast.Name):
            return ("module", t.id)
        return None

    def _class_of_call(self, value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Call):
            tail = _name_of(value.func).rsplit(".", 1)[-1]
            if self.classes.get(tail) is not None:
                return tail
        return None

    def _index_attr_types(self, rel: str, tree: ast.Module) -> None:
        for cls_entry in list(self.classes.values()):
            if cls_entry is None or cls_entry[0] != rel:
                continue
            cnode = cls_entry[1]
            for node in ast.walk(cnode):
                if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Attribute)
                        and isinstance(node.targets[0].value, ast.Name)
                        and node.targets[0].value.id == "self"):
                    continue
                tcls = self._class_of_call(node.value)
                if tcls is not None:
                    self.attr_types[(cnode.name, node.targets[0].attr)] = tcls
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                tcls = self._class_of_call(node.value)
                if tcls is not None:
                    self.mod_vars[(rel, node.targets[0].id)] = tcls

    def _module_file(self, dotted: str) -> Optional[str]:
        base = dotted.replace(".", "/")
        for cand in (base + ".py", base + "/__init__.py"):
            if cand in self.files:
                return cand
        return None

    def _index_imports(self, rel: str, tree: ast.Module) -> None:
        """Every import of the module, wherever it sits (the port imports lazily inside
        functions too), as local name -> (module file, attribute or None)."""
        out: Dict[str, Tuple[str, Optional[str]]] = {}
        pkg = rel.split("/")[:-1]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    path = self._module_file(a.name)
                    if path is not None and a.asname:
                        out[a.asname] = (path, None)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg[:len(pkg) - (node.level - 1)] if node.level > 1 else pkg
                    dotted = ".".join(base + ([node.module] if node.module else []))
                else:
                    dotted = node.module or ""
                for a in node.names:
                    local = a.asname or a.name
                    sub = self._module_file(f"{dotted}.{a.name}")
                    if sub is not None:
                        out[local] = (sub, None)
                        continue
                    path = self._module_file(dotted)
                    if path is not None:
                        out[local] = (path, a.name)
        self.imports[rel] = out

    # -- lock/call resolution (the JAX rules' forms) -----------------------------------

    def resolve_lock(self, expr: ast.AST, fn: Fn) -> Optional[str]:
        """Lock name for a with/acquire context expression, or None."""
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id == "self" and fn.cls:
            return self.attr_locks.get((fn.cls, expr.attr))
        if isinstance(expr, ast.Name):
            got = self.mod_locks.get((fn.path, expr.id))
            if got is not None:
                return got
            for node in ast.walk(fn.node):  # a local `x = make_lock("...")`
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == expr.id
                        and isinstance(node.value, ast.Call)):
                    fac = _factory_call(node.value)
                    if fac is not None and fac[1] is not None:
                        return fac[1]
        return None

    def _method(self, cls: Optional[str], name: str) -> Optional[Fn]:
        entry = self.classes.get(cls) if cls else None
        return self.fns.get((entry[0], cls, name)) if entry else None

    def resolve_call(self, call: ast.Call, fn: Fn) -> Optional[Fn]:
        """Callee for the call forms the JAX lock rules understand."""
        f = call.func
        if isinstance(f, ast.Name):
            callee = self.fns.get((fn.path, None, f.id))
            if callee is not None:
                return callee
            if self.classes.get(f.id) is not None:
                return self._method(f.id, "__init__")
            return self.fns.get((fn.path, fn.cls, f.id))  # a nested def
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name) and base.id == "self" and fn.cls:
                return self.fns.get((fn.path, fn.cls, f.attr))
            if isinstance(base, ast.Attribute) and isinstance(
                    base.value, ast.Name) and base.value.id == "self" and fn.cls:
                return self._method(self.attr_types.get((fn.cls, base.attr)), f.attr)
            if isinstance(base, ast.Name):
                return self._method(self._local_type(base.id, fn), f.attr)
        return None

    def _assign_types(self, scope: ast.AST, chained: bool) -> Dict[str, str]:
        """name -> class for the ``name = Cls(...)`` assignments in ``scope`` (the first
        in walk order; ``chained``: ``a = b[k] = Cls(...)`` too), once a scope."""
        got = self._scope_types.get((id(scope), chained))
        if got is None:
            got = {}
            for node in ast.walk(scope):
                if not isinstance(node, ast.Assign) or (
                        len(node.targets) != 1 and not chained):
                    continue
                tcls = self._class_of_call(node.value)
                for t in node.targets:
                    if tcls is not None and isinstance(t, ast.Name) and t.id not in got:
                        got[t.id] = tcls
            self._scope_types[(id(scope), chained)] = got
        return got

    def _local_type(self, name: str, fn: Fn, chained: bool = False) -> Optional[str]:
        # the function's own assignments first, then the whole module: a nested def (a
        # signal handler inside main()) closes over its enclosing function's locals
        got = self._assign_types(fn.node, chained).get(name)
        entry = self.files.get(fn.path)
        if got is None and entry is not None:
            got = self._assign_types(entry[0], chained).get(name)
        return got

    # -- references across modules (R3) ------------------------------------------------

    def _import(self, path: str, name: str) -> Optional[Tuple[str, Optional[str]]]:
        return self.imports.get(path, {}).get(name)

    def _var_type(self, path: str, name: str) -> Optional[str]:
        """The class of a module-level instance ``name`` seen from ``path`` (defined
        there or imported there)."""
        got = self.mod_vars.get((path, name))
        if got is not None:
            return got
        imp = self._import(path, name)
        if imp is not None and imp[1] is not None:
            return self.mod_vars.get((imp[0], imp[1]))
        return None

    def _module_def(self, path: str, name: str) -> Optional[Fn]:
        """A top-level def or a class's constructor named ``name`` in module ``path``."""
        got = self.fns.get((path, None, name))
        if got is not None:
            return got
        entry = self.classes.get(name)
        if entry is not None and entry[0] == path:
            return self._method(name, "__init__")
        return None

    def resolve_ref(self, expr: ast.AST, fn: Fn) -> Optional[Fn]:
        """The def that a call target, or a function used as a value, names: the JAX
        forms of :meth:`resolve_call`, plus imported functions and classes, functions of
        imported modules (``mod.f``), methods of module-level instances
        (``COLLECTIVES.all_reduce``) and of classes (``Cls.m``), and properties read
        through ``self``."""
        if isinstance(expr, ast.Name):
            got = (self.fns.get((fn.path, None, expr.id))
                   or self.fns.get((fn.path, fn.cls, expr.id)))
            if got is not None:
                return got
            if self.classes.get(expr.id) is not None:
                return self._method(expr.id, "__init__")
            imp = self._import(fn.path, expr.id)
            if imp is not None and imp[1] is not None:
                return self._module_def(*imp)
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        base = expr.value
        if isinstance(base, ast.Name):
            if base.id == "self" and fn.cls:
                return self.fns.get((fn.path, fn.cls, expr.attr))
            imp = self._import(fn.path, base.id)
            if imp is not None and imp[1] is None:
                return self._module_def(imp[0], expr.attr)
            if self.classes.get(base.id) is not None:
                return self._method(base.id, expr.attr)
            cls = (self._var_type(fn.path, base.id)
                   or self._local_type(base.id, fn, chained=True))
            return self._method(cls, expr.attr)
        if isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name):
            if base.value.id == "self" and fn.cls:
                return self._method(self.attr_types.get((fn.cls, base.attr)), expr.attr)
            imp = self._import(fn.path, base.value.id)
            if imp is not None and imp[1] is None:
                return self._method(self.mod_vars.get((imp[0], base.attr)), expr.attr)
        return None

    # -- the bounded closure (R9, R10) -------------------------------------------------

    def closure_locks(self, fn: Fn, consts: Dict[str, bool] = None,
                      _depth: int = 0, _stack: Optional[Set] = None,
                      _memo: Optional[Dict] = None) -> Dict[str, List[str]]:
        """lock name -> call chain (labels) for every lock this function can acquire,
        walking same-tree callees up to _CLOSURE_DEPTH deep. ``consts`` prunes
        ``if param:`` branches for literal boolean keyword arguments (one level)."""
        consts = consts or {}
        memo = _memo if _memo is not None else {}
        key = (fn.key, frozenset(consts.items()))
        if key in memo:
            return memo[key]
        stack = _stack if _stack is not None else set()
        if fn.key in stack or _depth > _CLOSURE_DEPTH:
            return {}
        stack = stack | {fn.key}
        out: Dict[str, List[str]] = {}

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.If):
                test = node.test
                skip_body = skip_else = False
                if isinstance(test, ast.Name) and test.id in consts:
                    skip_body = not consts[test.id]
                    skip_else = consts[test.id]
                elif (isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
                        and isinstance(test.operand, ast.Name)
                        and test.operand.id in consts):
                    skip_body = consts[test.operand.id]
                    skip_else = not consts[test.operand.id]
                if not skip_body:
                    for child in node.body:
                        visit(child)
                if not skip_else:
                    for child in node.orelse:
                        visit(child)
                return
            if isinstance(node, ast.With):
                for item in node.items:
                    lname = self.resolve_lock(item.context_expr, fn)
                    if lname is not None:
                        out.setdefault(lname, [fn.label])
            if isinstance(node, ast.Call):
                if _name_of(node.func).endswith(".acquire"):
                    lname = self.resolve_lock(node.func.value, fn)
                    if lname is not None:
                        out.setdefault(lname, [fn.label])
                callee = self.resolve_call(node, fn)
                if callee is not None:
                    sub_consts = {
                        kw.arg: bool(kw.value.value) for kw in node.keywords
                        if kw.arg and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, bool) and kw.arg in callee.params}
                    sub = self.closure_locks(callee, sub_consts, _depth + 1, stack, memo)
                    for lname, chain in sub.items():
                        out.setdefault(lname, [fn.label] + chain)
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                          ast.Lambda)):
                    visit(child)

        for stmt in getattr(fn.node, "body", []):
            visit(stmt)
        memo[key] = out
        return out


def suppressible(index: TreeIndex, findings: List[Finding]) -> List[Finding]:
    """Repo-rule findings honour the standard suppression syntax: group by path and
    re-apply the engine's directive parser with that file's lines."""
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    out: List[Finding] = []
    for path, fs in by_path.items():
        entry = index.files.get(path)
        out.extend(fs if entry is None else apply_suppressions(entry[1], fs))
    return out


# ---------------------------------------------------------------------------------------
# R9 — lock-order discipline + the registry drift gate. Locks are acquired in strictly
# increasing rank order (lockcheck.LOCK_TABLE); the graph is built from with/acquire
# sites plus the bounded call closure, so a cross-module nesting is an edge even though
# no single function shows both locks.
# ---------------------------------------------------------------------------------------
class R9LockOrder:
    id = "R9"
    repo_rule = True

    def check_repo(self, root: str, index: Optional[TreeIndex] = None) -> List[Finding]:
        index = index or TreeIndex(root)
        if index.registry_err:
            return [Finding(rule=self.id, path=_LOCKCHECK, line=0, col=0,
                            message=index.registry_err)]
        findings = self._drift(index) + self._graph(index)
        return suppressible(index, findings)

    def _drift(self, index: TreeIndex) -> List[Finding]:
        out: List[Finding] = []
        seen: Dict[str, Tuple[str, str, str]] = {}
        for path, qn, lname, kind, lineno in index.construct_sites:
            if lname is None:
                out.append(Finding(
                    rule=self.id, path=path, line=lineno, col=0,
                    message="lockcheck factory call without a literal lock name — the "
                            "registry drift gate needs the string at the construction "
                            "site"))
                continue
            entry = index.registry.get(lname)
            if entry is None:
                out.append(Finding(
                    rule=self.id, path=path, line=lineno, col=0,
                    message=f"lock {lname!r} constructed here but not registered in "
                            f"lockcheck.LOCK_TABLE — register an owner and a rank"))
                continue
            seen[lname] = (path, qn, kind)
            if entry.get("kind") != kind:
                out.append(Finding(
                    rule=self.id, path=path, line=lineno, col=0,
                    message=f"lock {lname!r} registered as kind {entry.get('kind')!r} "
                            f"but constructed as {kind!r}"))
            want_site = str(entry.get("site", ""))
            have_site = f"{path}:{qn}"
            if want_site and want_site != have_site:
                out.append(Finding(
                    rule=self.id, path=path, line=lineno, col=0,
                    message=f"lock {lname!r} registered at {want_site!r} but "
                            f"constructed at {have_site!r} — update the registry's "
                            f"site in the same change"))
        for lname, entry in sorted(index.registry.items()):
            if lname not in seen:
                out.append(Finding(
                    rule=self.id, path=_LOCKCHECK, line=0, col=0,
                    message=f"stale registry entry {lname!r} ({entry.get('site')}) — "
                            f"no construction site in the tree; drop it or fix the "
                            f"site"))
        for path, qn, kind, lineno in index.raw_sites:
            out.append(Finding(
                rule=self.id, path=path, line=lineno, col=0,
                message=f"raw threading.{kind.capitalize()}() construction in {qn} — "
                        f"route through glint_word2vec_torch.lockcheck (make_{kind}) "
                        f"so the lock carries a registered owner and rank"))
        return out

    def edges(self, index: TreeIndex) -> Dict[Tuple[str, str], Tuple[str, int, str]]:
        """The static acquisition graph: (outer, inner) -> (path, line, via) of the
        first inner acquisition seen."""
        edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        memo: Dict = {}

        def record(outer: str, inner: str, path: str, line: int, via: str) -> None:
            edges.setdefault((outer, inner), (path, line, via))

        for fn in index.fns.values():
            self._walk_fn(index, fn, [], record, memo)
        return edges

    def _graph(self, index: TreeIndex) -> List[Finding]:
        edges = self.edges(index)
        out: List[Finding] = []
        ranks = {n: e.get("rank", 0) for n, e in index.registry.items()}
        kinds = {n: e.get("kind", "lock") for n, e in index.registry.items()}
        for (outer, inner), (path, line, via) in sorted(edges.items()):
            if outer == inner:
                if kinds.get(inner) != "rlock":
                    out.append(Finding(
                        rule=self.id, path=path, line=line, col=0,
                        message=f"reentrant acquisition of non-reentrant lock "
                                f"{inner!r} ({via}) — self-deadlock; make it an rlock "
                                f"or restructure"))
                continue
            if ranks.get(inner, 0) <= ranks.get(outer, 0):
                out.append(Finding(
                    rule=self.id, path=path, line=line, col=0,
                    message=f"lock-order inversion: {inner!r} (rank {ranks.get(inner)}) "
                            f"acquired while holding {outer!r} (rank "
                            f"{ranks.get(outer)}) via {via} — ranks must strictly "
                            f"increase (lockcheck.LOCK_TABLE); reorder the "
                            f"acquisitions or re-rank with the reasoning"))
        # with strictly increasing ranks every cycle holds an inversion, but the cycle
        # is reported too, so a re-ranking "fix" that leaves a loop is still caught
        out.extend(self._cycles(edges))
        return out

    def _walk_fn(self, index: TreeIndex, fn: Fn, held: List[str], record,
                 memo: Dict) -> None:
        def visit(node: ast.AST, held: List[str]) -> None:
            if isinstance(node, ast.With):
                acquired: List[str] = []
                for item in node.items:
                    lname = index.resolve_lock(item.context_expr, fn)
                    if lname is not None:
                        if held:
                            record(held[-1], lname, fn.path, node.lineno, fn.label)
                        acquired.append(lname)
                for child in node.body:
                    visit(child, held + acquired)
                return
            if isinstance(node, ast.Call) and held:
                callee = index.resolve_call(node, fn)
                if callee is not None:
                    sub_consts = {
                        kw.arg: bool(kw.value.value) for kw in node.keywords
                        if kw.arg and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, bool) and kw.arg in callee.params}
                    for lname, chain in index.closure_locks(
                            callee, sub_consts, 1, None, memo).items():
                        record(held[-1], lname, fn.path, node.lineno,
                               " -> ".join([fn.label] + chain))
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                          ast.Lambda)):
                    visit(child, held)

        for stmt in getattr(fn.node, "body", []):
            visit(stmt, held)

    @staticmethod
    def _cycles(edges: Dict) -> List[Finding]:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            if a != b:
                graph.setdefault(a, set()).add(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in set(graph) | {b for bs in graph.values() for b in bs}}

        def dfs(n: str, path: List[str]) -> Optional[List[str]]:
            color[n] = GRAY
            for m in sorted(graph.get(n, ())):
                if color[m] == GRAY:
                    return path[path.index(m):] + [m] if m in path else [n, m]
                if color[m] == WHITE:
                    cyc = dfs(m, path + [m])
                    if cyc:
                        return cyc
            color[n] = BLACK
            return None

        for n in sorted(color):
            if color[n] == WHITE:
                cyc = dfs(n, [n])
                if cyc:
                    epath, eline, _ = edges[(cyc[0], cyc[1])]
                    return [Finding(rule="R9", path=epath, line=eline, col=0,
                                    message=f"lock-acquisition cycle: "
                                            f"{' -> '.join(cyc)} — potential deadlock")]
        return []


# ---------------------------------------------------------------------------------------
# R10 — signal-handler safety. A handler runs on the main thread at an arbitrary point,
# inside a critical section too; if its call closure can block on a non-reentrant lock
# that a normal path holds, the process deadlocks exactly when the dump matters most.
# ---------------------------------------------------------------------------------------
class R10HandlerSafety:
    id = "R10"
    repo_rule = True

    def check_repo(self, root: str, index: Optional[TreeIndex] = None) -> List[Finding]:
        index = index or TreeIndex(root)
        if index.registry_err:
            return []  # R9 reports the registry problem once
        findings: List[Finding] = []
        memo: Dict = {}
        kinds = {n: e.get("kind", "lock") for n, e in index.registry.items()}
        for path in sorted(index.files):
            for fn in [f for f in index.fns.values() if f.path == path]:
                for node in ast.walk(fn.node):
                    if not (isinstance(node, ast.Call)
                            and _name_of(node.func) in ("signal.signal", "signal")
                            and len(node.args) == 2):
                        continue
                    handler = self._resolve_handler(index, fn, node.args[1])
                    if handler is None:
                        continue
                    closure = index.closure_locks(handler, None, 0, None, memo)
                    for lname, chain in sorted(closure.items()):
                        if kinds.get(lname) == "rlock":
                            continue
                        findings.append(Finding(
                            rule=self.id, path=path, line=node.lineno, col=0,
                            message=f"signal handler "
                                    f"{handler.label.split(':')[-1]!r} can acquire "
                                    f"non-reentrant lock {lname!r} (via "
                                    f"{' -> '.join(chain)}) — if the signal lands "
                                    f"while the interrupted thread holds it, the "
                                    f"handler deadlocks; make the lock reentrant or "
                                    f"keep it off the handler path"))
        return suppressible(index, findings)

    @staticmethod
    def _resolve_handler(index: TreeIndex, fn: Fn, expr: ast.AST) -> Optional[Fn]:
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id == "self" and fn.cls:
            return index.fns.get((fn.path, fn.cls, expr.attr))
        if isinstance(expr, ast.Name):
            return (index.fns.get((fn.path, fn.cls, expr.id))
                    or index.fns.get((fn.path, None, expr.id)))
        return None


# ---------------------------------------------------------------------------------------
# R11 — shared-mutable discipline (per-file, library scope). In a class that owns a
# thread, a deque/list/dict attribute mutated anywhere must have every whole-collection
# access (append/pop/iterate/sorted/list) under ONE lock attribute, or live in a
# documented snapshot helper. A lock-free append plus a locked sorted() still races.
# ---------------------------------------------------------------------------------------
class R11SharedMutable:
    id = "R11"
    _CTORS = {"deque", "list", "dict", "OrderedDict", "defaultdict"}
    _MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
                 "pop", "popleft", "remove", "clear", "update", "setdefault"}
    _READERS = {"sorted", "list", "tuple", "max", "min", "sum", "set"}

    def applies(self, path: str) -> bool:
        return in_library(path)

    def check(self, ctx) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node))
        return out

    def _check_class(self, ctx, cls: ast.ClassDef) -> List[Finding]:
        if not self._owns_thread(cls):
            return []
        shared = self._shared_collections(cls)
        if not shared:
            return []
        locks = self._lock_attrs(cls)
        findings: List[Finding] = []
        for attr in sorted(shared):
            sites = self._access_sites(ctx, cls, attr, locks)
            guards = {g for _, _, g, helper in sites if not helper}
            for lineno, what, guard, helper in sites:
                if helper:
                    continue
                if guard is None:
                    findings.append(Finding(
                        rule=self.id, path=ctx.path, line=lineno, col=0,
                        message=f"{what} of shared collection 'self.{attr}' in "
                                f"thread-owning class {cls.name} outside any lock — "
                                f"another thread mutating it concurrently corrupts "
                                f"state or raises; hold the owning lock or go through "
                                f"a documented snapshot helper"))
                elif len(guards - {None}) > 1:
                    findings.append(Finding(
                        rule=self.id, path=ctx.path, line=lineno, col=0,
                        message=f"'self.{attr}' in {cls.name} is guarded by different "
                                f"locks at different sites "
                                f"({sorted(g for g in guards if g)}) — one "
                                f"collection, one lock"))
        return findings

    @staticmethod
    def _owns_thread(cls: ast.ClassDef) -> bool:
        return any(isinstance(node, ast.Call)
                   and _name_of(node.func) in ("threading.Thread", "Thread")
                   for node in ast.walk(cls))

    @staticmethod
    def _self_attr_assign(node: ast.AST):
        """(attr, value) for ``self.x = v`` / ``self.x: T = v`` assignments."""
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            t = node.target
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
        else:
            return None
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                and t.value.id == "self":
            return (t.attr, node.value)
        return None

    def _shared_collections(self, cls: ast.ClassDef) -> Set[str]:
        assigned: Set[str] = set()
        for node in ast.walk(cls):
            pair = self._self_attr_assign(node)
            if pair is not None:
                attr, v = pair
                if (isinstance(v, (ast.List, ast.Dict, ast.Set))
                        or (isinstance(v, ast.Call)
                            and _name_of(v.func).rsplit(".", 1)[-1] in self._CTORS)):
                    assigned.add(attr)
        mutated: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self._MUTATORS:
                base = node.func.value
                if isinstance(base, ast.Attribute) and isinstance(
                        base.value, ast.Name) and base.value.id == "self":
                    mutated.add(base.attr)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in tgts:
                    if isinstance(t, ast.Subscript) and isinstance(
                            t.value, ast.Attribute) and isinstance(
                            t.value.value, ast.Name) and t.value.value.id == "self":
                        mutated.add(t.value.attr)
        return assigned & mutated

    def _lock_attrs(self, cls: ast.ClassDef) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(cls):
            pair = self._self_attr_assign(node)
            if pair is not None and isinstance(pair[1], ast.Call):
                if (_factory_call(pair[1]) is not None
                        or _is_primitive_ctor(pair[1]) is not None):
                    out.add(pair[0])
        return out

    def _access_sites(self, ctx, cls: ast.ClassDef, attr: str, locks: Set[str]):
        """(lineno, description, guarding lock attr or None, in_helper)."""
        sites = []
        for method in [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            # the documented-snapshot escape: the method NAME says snapshot and a
            # docstring exists to say why it is safe
            helper = "snapshot" in method.name and bool(ast.get_docstring(method))

            def guard_of(node: ast.AST) -> Optional[str]:
                cur = ctx.parents.get(node)
                while cur is not None and cur is not method:
                    if isinstance(cur, ast.With):
                        for item in cur.items:
                            e = item.context_expr
                            if isinstance(e, ast.Attribute) and isinstance(
                                    e.value, ast.Name) and e.value.id == "self" \
                                    and e.attr in locks:
                                return e.attr
                    cur = ctx.parents.get(cur)
                return None

            def is_attr(node: ast.AST) -> bool:
                return (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self" and node.attr == attr)

            for node in ast.walk(method):
                what = None
                if isinstance(node, ast.Call):
                    f = node.func
                    if isinstance(f, ast.Attribute) and is_attr(f.value) \
                            and f.attr in self._MUTATORS:
                        what = f"mutation (.{f.attr})"
                    elif isinstance(f, ast.Name) and f.id in self._READERS and node.args:
                        a = node.args[0]
                        if is_attr(a) or (
                                isinstance(a, ast.Call)
                                and isinstance(a.func, ast.Attribute)
                                and a.func.attr in ("values", "items", "keys")
                                and is_attr(a.func.value)):
                            what = f"whole-collection read ({f.id}(...))"
                elif isinstance(node, ast.For) and is_attr(node.iter):
                    what = "iteration"
                elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                                       ast.DictComp)):
                    if any(is_attr(gen.iter) for gen in node.generators):
                        what = "iteration (comprehension)"
                elif (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Subscript)
                        and is_attr(node.targets[0].value)):
                    what = "mutation (subscript assignment)"
                if what is not None:
                    sites.append((node.lineno, what, guard_of(node), helper))
        return sites


# ---------------------------------------------------------------------------------------
# R1 staleness (repo rule, same id as the per-file R1): an allowlist entry blessing a
# thread owner that no longer exists would silently cover whatever def next takes the
# name.
# ---------------------------------------------------------------------------------------
class R1Staleness:
    id = "R1"
    repo_rule = True

    def __init__(self, allowlist=None):
        if allowlist is None:
            from glint_word2vec_torch.graftlint.rules import R1ThreadPools
            allowlist = R1ThreadPools.ALLOW
        self._allow = allowlist

    def check_repo(self, root: str, index: Optional[TreeIndex] = None) -> List[Finding]:
        findings: List[Finding] = []
        trees: Dict[str, Optional[ast.Module]] = {}
        for path, qual in sorted(self._allow):
            if path not in trees:
                try:
                    with open(os.path.join(root, *path.split("/")), "r",
                              encoding="utf-8") as f:
                        trees[path] = ast.parse(f.read())
                except (OSError, SyntaxError):
                    trees[path] = None
            tree = trees[path]
            if tree is None:
                findings.append(Finding(
                    rule=self.id, path=path, line=0, col=0,
                    message=f"stale R1 allowlist entry: {path!r} cannot be "
                            f"parsed/found, but ({path!r}, {qual!r}) still blesses a "
                            f"thread owner there"))
            elif not qualname_exists(tree, qual):
                findings.append(Finding(
                    rule=self.id, path=path, line=0, col=0,
                    message=f"stale R1 allowlist entry: no def {qual!r} in {path} — "
                            f"the blessing would silently cover whatever next takes "
                            f"the name; drop or update the allowlist entry"))
        return findings


CONCURRENCY_RULES = [R9LockOrder(), R10HandlerSafety(), R11SharedMutable(),
                     R1Staleness()]
