"""Checker 11: lock-order analysis (SA011), the rule of
``spfft_tpu/analysis/locks.py`` over the port's package code.

The port holds two dozen ``threading.Lock/RLock/Condition`` objects across
serve, sched, verify, tuning, obs, faults and the IR's CUDA-graph captures.
This checker builds the *static acquisition graph* over the whole package
and enforces two rules:

* **No cycles.** An edge ``A -> B`` is recorded wherever code that holds
  ``A`` may acquire ``B`` — directly (a nested ``with``), through a call to
  a function whose (transitively computed) lock effects include ``B``, or
  through a typed-error construction (``GenericError.__init__`` emits a
  flight-recorder event, i.e. takes the trace lock). A cycle in the graph
  is a potential deadlock; a self-edge on a non-reentrant lock is a
  guaranteed one.
* **Nothing slow under a lock.** A lock held across ``time.sleep``, a
  ``.join()``/``.result()``/foreign ``.wait()``, or one of the port's slow
  calls serializes every other path through that lock behind an unbounded
  wait. The port's slow calls take the place of the JAX package's
  ``jax``/``jnp`` dispatch: a device synchronization
  (``torch.cuda.synchronize``, an event's ``.synchronize()``, and the
  implicit ones of ``.item()``, ``.cpu()`` and ``.numpy()``), a CUDA-graph
  capture (``torch.cuda.graph``, which synchronizes the device and empties
  the allocator's cache) and a kernel build (``_build.build_*``, an
  ``nvcc`` or ``g++`` run). ``Condition.wait`` on the *held* condition is
  exempt — it releases while waiting.

Resolution is intentionally conservative and name-based (documented
limitations): module-level locks, ``self.<attr>`` locks assigned in the
defining file, and local variables bound to a fresh ``threading.Lock()``
are tracked; dynamically stored locks (dict-held latches) and locks
reached through unresolvable receivers are not. Same-package calls resolve
through one level of ``__init__`` re-exports.

Modeled acquisition shapes beyond the nested ``with``:

* ``stack.enter_context(lock)`` — an ``ExitStack`` chain acquires in call
  order and holds until the stack unwinds, so each ``enter_context`` of a
  resolvable lock extends the held set for the remaining statements of the
  enclosing body (edges + self-deadlock checks identical to ``with``).
* ``Condition.wait`` — the wait *releases the condition's own lock* while
  blocked (exempt when the condition is the only thing held), but any
  OTHER held lock stays held across the unbounded wait and is flagged.
  The implicit re-acquire on wakeup re-establishes the edges the original
  acquisition already recorded, so no separate edge is emitted for it.

The same walk feeds two consumers: :func:`check_lock_order` (the SA011
findings) and :func:`static_graph` — the JSON-plain lock/edge export the
runtime lockdep validator (:mod:`.lockdep`) cross-checks its observed
acquisition graph against.
"""
from __future__ import annotations

import ast

from .core import PACKAGE_DIRS, Tree, checker

LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}
REENTRANT = ("rlock",)


def _ctor_kind(node):
    """'lock'/'rlock'/'condition' when ``node`` is (or contains) a
    ``threading.X()`` constructor call."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            name = None
            if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
                if fn.value.id == "threading":
                    name = fn.attr
            elif isinstance(fn, ast.Name):
                name = fn.id
            if name in LOCK_CTORS:
                return LOCK_CTORS[name]
    return None


def _root_name(node):
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _module_rel(tree, parts):
    """Module path parts -> existing file relpath (module or package)."""
    rel = "/".join(parts) + ".py"
    if tree.exists(rel):
        return rel
    rel = "/".join(parts) + "/__init__.py"
    if tree.exists(rel):
        return rel
    return None


class _Module:
    """Per-file facts: locks, imports, functions, classes."""

    def __init__(self, rel, node):
        self.rel = rel
        self.node = node
        self.module_locks: dict = {}   # name -> (lock_id, kind)
        self.attr_locks: dict = {}     # attr -> (lock_id, kind)  (self.X)
        self.lock_lines: dict = {}     # lock_id -> definition lineno
        self.mod_alias: dict = {}      # alias -> module rel
        self.obj_alias: dict = {}      # alias -> (module rel, attr)
        self.functions: dict = {}      # qual -> ast node ("f" / "C.m")
        self.classes: dict = {}        # class name -> ClassDef
        self.instance_of: dict = {}    # module-global name -> [class names]


class LockIndex:
    """Whole-package lock/function/import index + transitive lock effects."""

    def __init__(self, tree: Tree):
        self.tree = tree
        self.modules: dict = {}
        for rel in tree.py_files(PACKAGE_DIRS):
            try:
                node = tree.parse(rel)
            except SyntaxError:
                continue
            self.modules[rel] = self._scan(rel, node)
        self._effects: dict = {}  # (rel, qual) -> frozenset(lock ids)
        self._busy: set = set()

    # ---- per-file scan -------------------------------------------------------

    def _scan(self, rel, node):
        m = _Module(rel, node)
        pkg_parts = rel.split("/")[:-1]
        if rel.endswith("/__init__.py"):
            own_parts = rel.split("/")[:-1]
        else:
            own_parts = rel.split("/")[:-1]
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                kind = _ctor_kind(stmt.value)
                classes = [
                    s.func.id
                    for s in ast.walk(stmt.value)
                    if isinstance(s, ast.Call) and isinstance(s.func, ast.Name)
                ]
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        if kind:
                            m.module_locks[t.id] = (f"{rel}::{t.id}", kind)
                            m.lock_lines[f"{rel}::{t.id}"] = stmt.lineno
                        if classes:
                            m.instance_of[t.id] = classes
        # imports anywhere in the file (the lazy function-scope import is a
        # deliberate pattern here; alias collisions across scopes are rare
        # enough that a flat map stays honest)
        for stmt in ast.walk(node):
            if not isinstance(stmt, ast.ImportFrom):
                continue
            base = own_parts[: len(own_parts) - (stmt.level - 1)] if (
                stmt.level
            ) else []
            if stmt.level and stmt.module:
                base = base + stmt.module.split(".")
            elif not stmt.level and stmt.module:
                base = stmt.module.split(".")
            if base[:1] and base[0] != pkg_parts[0] and stmt.level == 0:
                continue  # external import
            for a in stmt.names:
                if a.name == "*":
                    continue
                alias = a.asname or a.name
                sub = _module_rel(self.tree, base + [a.name])
                if sub:
                    m.mod_alias.setdefault(alias, sub)
                else:
                    mod = _module_rel(self.tree, base)
                    if mod:
                        m.obj_alias.setdefault(alias, (mod, a.name))
        for cls in [s for s in node.body if isinstance(s, ast.ClassDef)]:
            m.classes[cls.name] = cls
            for sub in ast.walk(cls):
                if isinstance(sub, ast.Assign):
                    kind = _ctor_kind(sub.value)
                    if not kind:
                        continue
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            m.attr_locks[t.attr] = (
                                f"{rel}::{cls.name}.{t.attr}", kind,
                            )
                            m.lock_lines[f"{rel}::{cls.name}.{t.attr}"] = (
                                sub.lineno
                            )
            for meth in cls.body:
                if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    m.functions[f"{cls.name}.{meth.name}"] = meth
        for fn in node.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                m.functions[fn.name] = fn
        return m

    # ---- name resolution -----------------------------------------------------

    def resolve_export(self, rel, attr, depth=0):
        """(rel, qual) of ``attr`` looked up in module ``rel``, chasing
        one-level ``__init__`` re-exports and submodules."""
        if depth > 3 or rel not in self.modules:
            return None
        m = self.modules[rel]
        for qual in (attr, ):
            if qual in m.functions:
                return (rel, qual)
        if attr in m.classes:
            # constructor effects: the class's own __init__, else the
            # nearest same-file base's (errors.py's taxonomy pattern)
            seen = set()
            name = attr
            while name in m.classes and name not in seen:
                seen.add(name)
                if f"{name}.__init__" in m.functions:
                    return (rel, f"{name}.__init__")
                bases = [
                    b.id for b in m.classes[name].bases
                    if isinstance(b, ast.Name)
                ]
                name = bases[0] if bases else ""
            return None
        if attr in m.mod_alias:
            return ("__module__", m.mod_alias[attr])
        if attr in m.obj_alias:
            mod, a = m.obj_alias[attr]
            return self.resolve_export(mod, a, depth + 1)
        sub = _module_rel(self.tree, rel.rsplit("/", 1)[0].split("/") + [attr]) \
            if rel.endswith("/__init__.py") else None
        if sub:
            return ("__module__", sub)
        return None

    def resolve_call(self, m: _Module, class_name, call):
        """(rel, qual) of a call's callee, or None."""
        fn = call.func
        if isinstance(fn, ast.Name):
            if fn.id in m.functions:
                return (m.rel, fn.id)
            if class_name and f"{class_name}.{fn.id}" in m.functions:
                return (m.rel, f"{class_name}.{fn.id}")
            if fn.id in m.obj_alias:
                mod, attr = m.obj_alias[fn.id]
                got = self.resolve_export(mod, attr)
                return got if got and got[0] != "__module__" else None
            if fn.id in m.classes:
                return self.resolve_export(m.rel, fn.id)
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        recv = fn.value
        if isinstance(recv, ast.Name):
            if recv.id == "self":
                if class_name and f"{class_name}.{fn.attr}" in m.functions:
                    return (m.rel, f"{class_name}.{fn.attr}")
                for qual in m.functions:
                    if qual.endswith(f".{fn.attr}"):
                        return (m.rel, qual)
                return None
            if recv.id in m.mod_alias:
                got = self.resolve_export(m.mod_alias[recv.id], fn.attr)
                return got if got and got[0] != "__module__" else None
            if recv.id in m.instance_of:
                for cls in m.instance_of[recv.id]:
                    if f"{cls}.{fn.attr}" in m.functions:
                        return (m.rel, f"{cls}.{fn.attr}")
            return None
        if isinstance(recv, ast.Attribute):
            # dotted module receiver, e.g. obs.trace.event
            root = _root_name(recv)
            if root and root in m.mod_alias:
                got = self.resolve_export(m.mod_alias[root], recv.attr)
                if got and got[0] == "__module__":
                    got = self.resolve_export(got[1], fn.attr)
                    return got if got and got[0] != "__module__" else None
        return None

    def resolve_lock(self, m: _Module, class_name, local_locks, expr):
        """(lock_id, kind) of a with-item/receiver expression, or None."""
        if isinstance(expr, ast.Name):
            if expr.id in local_locks:
                return local_locks[expr.id]
            return m.module_locks.get(expr.id)
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            return m.attr_locks.get(expr.attr)
        return None

    # ---- transitive lock effects --------------------------------------------

    def effects(self, key) -> frozenset:
        """Locks ``key = (rel, qual)`` may acquire, transitively."""
        if key in self._effects:
            return self._effects[key]
        if key in self._busy:
            return frozenset()  # recursion cycle: partial is fine (fixpoint)
        rel, qual = key
        m = self.modules.get(rel)
        if m is None or qual not in m.functions:
            self._effects[key] = frozenset()
            return self._effects[key]
        self._busy.add(key)
        class_name = qual.split(".")[0] if "." in qual else None
        fn_node = m.functions[qual]
        local_locks = self._local_locks(m.rel, qual, fn_node)
        out = set()
        for node in ast.walk(fn_node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    got = self.resolve_lock(
                        m, class_name, local_locks, item.context_expr
                    )
                    if got:
                        out.add(got[0])
            elif isinstance(node, ast.Call):
                got = _enter_context_lock(
                    self, m, class_name, local_locks, node
                )
                if got:
                    out.add(got[0])
                callee = self.resolve_call(m, class_name, node)
                if callee:
                    out |= self.effects(callee)
        self._busy.discard(key)
        self._effects[key] = frozenset(out)
        return self._effects[key]

    @staticmethod
    def _local_locks(rel, qual, fn_node) -> dict:
        out = {}
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign):
                kind = _ctor_kind(node.value)
                if not kind:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = (f"{rel}::{qual}.{t.id}", kind)
        return out


BLOCKING_RECEIVER_ATTRS = ("join", "result")
# the implicit device synchronizations of a tensor read on the host
HOST_READ_ATTRS = ("item", "cpu", "numpy")


def _enter_context_lock(index, m, class_name, local_locks, call):
    """``(lock_id, kind)`` when ``call`` is ``<stack>.enter_context(<lock>)``
    on a resolvable lock — the ExitStack acquisition shape."""
    fn = call.func
    if not (
        isinstance(fn, ast.Attribute)
        and fn.attr == "enter_context"
        and call.args
    ):
        return None
    return index.resolve_lock(m, class_name, local_locks, call.args[0])


def _blocking_desc(index, m, class_name, local_locks, held, call):
    """A human description when ``call`` blocks while locks are held."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        root = _root_name(fn)
        if fn.attr == "sleep" and root == "time":
            return "time.sleep(...)"
        if fn.attr == "synchronize":
            return f"a device synchronization (.{fn.attr}())"
        if fn.attr in HOST_READ_ATTRS and not call.args and not call.keywords:
            return f".{fn.attr}() (a device synchronization)"
        if fn.attr == "graph" and root == "torch":
            return "a CUDA-graph capture (torch.cuda.graph)"
        if root == "_build" and fn.attr.startswith("build"):
            return f"_build.{fn.attr}(...) (a kernel build: an nvcc or g++ run)"
        if fn.attr in BLOCKING_RECEIVER_ATTRS:
            return f".{fn.attr}()"
        if fn.attr == "wait":
            got = index.resolve_lock(m, class_name, local_locks, fn.value)
            if got and got[0] in held:
                # Condition.wait releases the condition's OWN lock while
                # blocked — exempt only when that is the whole held set; any
                # other lock stays held across the unbounded wait
                if all(h == got[0] for h in held):
                    return None
                return (
                    ".wait() (Condition.wait releases only its own lock; "
                    "the other held lock stays held across the wait)"
                )
            return ".wait()"
    elif isinstance(fn, ast.Name) and fn.id == "fence":
        return "fence() (a completion wait)"
    return None


def _stmt_lists(stmt):
    for field in ("body", "orelse", "finalbody"):
        sub = getattr(stmt, field, None)
        if sub:
            yield sub
    for h in getattr(stmt, "handlers", []) or []:
        yield h.body


def _calls_here(stmt):
    """Calls in a statement, not descending into nested defs/lambdas or
    nested statement bodies (those are walked by the caller)."""
    skip: set = set()
    for sub_list in _stmt_lists(stmt):
        for s in sub_list:
            for n in ast.walk(s):
                skip.add(id(n))
    for node in ast.walk(stmt):
        if id(node) in skip:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            for n in ast.walk(node):
                skip.add(id(n))
            continue
        if isinstance(node, ast.Call):
            yield node


def find_cycles(graph: dict) -> list:
    """Non-trivial strongly connected components of ``{node: {succ, ...}}``,
    each a sorted node list — iterative Tarjan (recursion-free; the graphs
    are tiny but deep recursion limits are not worth trusting). Shared by
    the static checker and the runtime lockdep report."""
    idx: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]

    def strongconnect(v):
        work = [(v, iter(sorted(graph.get(v, ()))))]
        idx[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in idx:
                    idx[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], idx[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[node])
            if low[node] == idx[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for v in sorted(graph):
        if v not in idx:
            strongconnect(v)
    return sorted(sccs)


def collect(tree: Tree, make_finding) -> dict:
    """The SA011 walk over the whole package: acquisition edges, lock kinds
    and definition sites, plus the non-cycle findings (``make_finding(file,
    line, message)`` constructs them). One walk, two consumers — the static
    checker and :func:`static_graph` (the lockdep cross-check's model)."""
    findings: list = []
    index = LockIndex(tree)
    kinds: dict = {}
    sites: dict = {}
    for m in index.modules.values():
        for lock_id, kind in list(m.module_locks.values()) + list(
            m.attr_locks.values()
        ):
            kinds[lock_id] = kind
            sites[lock_id] = (m.rel, m.lock_lines.get(lock_id, 0))
    edges: dict = {}  # (A, B) -> (rel, line)

    def note_edge(a, b, rel, line):
        edges.setdefault((a, b), (rel, line))

    def acquire(lock_id, kind, held, rel, line):
        for h in held:
            note_edge(h, lock_id, rel, line)
        if lock_id in held and kind not in REENTRANT:
            findings.append(
                make_finding(
                    rel, line,
                    f"non-reentrant lock {lock_id} re-acquired while "
                    "already held (guaranteed self-deadlock)",
                )
            )

    def walk(m, class_name, qual, local_locks, stmts, held):
        held = list(held)
        for stmt in stmts:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                newly = []
                for item in stmt.items:
                    got = index.resolve_lock(
                        m, class_name, local_locks, item.context_expr
                    )
                    if got:
                        lock_id, kind = got
                        acquire(lock_id, kind, held + newly, m.rel, stmt.lineno)
                        newly.append(lock_id)
                    elif isinstance(item.context_expr, ast.Call):
                        # a with on a call (context manager): treat like a
                        # call for lock effects, and for what it blocks on
                        # (torch.cuda.graph is entered as a with item)
                        _note_blocking(
                            m, class_name, local_locks, held + newly,
                            item.context_expr,
                        )
                        _note_call_effects(
                            m, class_name, item.context_expr, held
                        )
                walk(m, class_name, qual, local_locks, stmt.body, held + newly)
                continue
            if held:
                for call in _calls_here(stmt):
                    _note_blocking(
                        m, class_name, local_locks, held, call
                    )
                    _note_call_effects(m, class_name, call, held)
            for sub in _stmt_lists(stmt):
                walk(m, class_name, qual, local_locks, sub, held)
            # an ExitStack acquisition holds for the REST of this body:
            # record its edges and extend the held set for what follows
            for call in _calls_here(stmt):
                got = _enter_context_lock(
                    index, m, class_name, local_locks, call
                )
                if got:
                    acquire(got[0], got[1], held, m.rel, call.lineno)
                    held.append(got[0])

    def _note_blocking(m, class_name, local_locks, held, call):
        if not held:
            return
        desc = _blocking_desc(index, m, class_name, local_locks, held, call)
        if desc:
            findings.append(
                make_finding(
                    m.rel, call.lineno,
                    f"lock {held[-1]} held across {desc} — "
                    "move the blocking call outside the lock",
                )
            )

    def _note_call_effects(m, class_name, call, held):
        callee = index.resolve_call(m, class_name, call)
        if not callee:
            return
        for lock_id in index.effects(callee):
            for h in held:
                note_edge(h, lock_id, m.rel, call.lineno)
                if h == lock_id and kinds.get(lock_id) not in REENTRANT:
                    findings.append(
                        make_finding(
                            m.rel, call.lineno,
                            f"call may re-acquire held non-reentrant lock "
                            f"{lock_id} (self-deadlock through "
                            f"{callee[0]}::{callee[1]})",
                        )
                    )

    for m in index.modules.values():
        for qual, fn_node in m.functions.items():
            class_name = qual.split(".")[0] if "." in qual else None
            local_locks = index._local_locks(m.rel, qual, fn_node)
            walk(m, class_name, qual, local_locks, fn_node.body, [])

    return {
        "findings": findings,
        "edges": edges,
        "kinds": kinds,
        "sites": sites,
    }


def static_graph(tree: Tree) -> dict:
    """JSON-plain export of the static acquisition model — the baseline the
    runtime lockdep validator (:mod:`.lockdep`) cross-checks against:
    ``locks`` keyed by lock id with kind + definition site (the runtime
    wrapper joins on ``file:line``), ``edges`` as ``[from, to]`` pairs."""
    data = collect(tree, lambda file, line, message: None)
    return {
        "locks": {
            lock_id: {
                "kind": data["kinds"].get(lock_id, "lock"),
                "file": rel,
                "line": line,
            }
            for lock_id, (rel, line) in sorted(data["sites"].items())
        },
        "edges": sorted([a, b] for (a, b) in data["edges"]),
    }


@checker(
    "lock-order",
    code="SA011",
    doc="Builds the static lock-acquisition graph over every "
    "threading.Lock/RLock/Condition in the package (nested `with` blocks, "
    "ExitStack.enter_context chains, transitive call effects, typed-error "
    "constructions) and flags cycles, re-acquisition of a held "
    "non-reentrant lock, and locks held across blocking calls (time.sleep, "
    ".join/.result/foreign .wait, Condition.wait with another lock still "
    "held, device synchronizations: torch.cuda.synchronize, .synchronize(), "
    ".item(), .cpu(), .numpy(); CUDA-graph capture: torch.cuda.graph; "
    "kernel builds: _build.build_*). Name-based and conservative: "
    "dynamically stored locks are not tracked. The runtime lockdep layer "
    "(SPFFT_TPU_LOCKDEP) validates this model against observed "
    "acquisitions.",
)
def check_lock_order(tree: Tree):
    data = collect(tree, check_lock_order.finding)
    findings = list(data["findings"])
    edges = data["edges"]

    # ---- cycle detection over the acquisition graph -------------------------
    graph: dict = {}
    for (a, b), _loc in edges.items():
        if a != b:
            graph.setdefault(a, set()).add(b)

    for comp in find_cycles(graph):
        example = None
        for (a, b), loc in sorted(edges.items()):
            if a in comp and b in comp and a != b:
                example = loc
                break
        rel, line = example if example else (comp[0].split("::")[0], 0)
        findings.append(
            check_lock_order.finding(
                rel, line,
                "lock-order cycle (potential deadlock): "
                + " <-> ".join(comp),
            )
        )
    return findings
