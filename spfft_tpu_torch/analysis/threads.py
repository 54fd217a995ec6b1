"""Checker 17: thread-lifecycle discipline (SA017), the rule of
``spfft_tpu/analysis/threads.py`` over the port's package code.

The package starts worker threads (the serve dispatch loop, the scheduler's
runners, the fence and trial deadline workers, the RPC server). Two failure
shapes this checker closes off before they ship:

* **A non-daemon thread nobody joins.** Process shutdown hangs on it, and
  a test suite that created one leaks it into every later test. Every
  ``threading.Thread(...)`` the package constructs must either be
  ``daemon=True`` at construction (or via a ``t.daemon = True`` assignment
  on the same binding) or be ``.join()``-ed somewhere in the same file.
* **An unbounded wait.** ``Condition.wait()`` / ``Event.wait()`` /
  ``Queue.get()`` / ``Thread.join()`` without a timeout parks a thread
  forever when the notify/put/exit it expects never comes — the
  no-deadlock serving contract requires every park to be bounded. Waits
  and gets are checked on bindings this file can resolve to a
  ``threading.Condition/Event`` / ``queue.Queue`` construction;
  ``.join()`` with zero arguments is flagged unconditionally (string and
  path joins always carry an argument).

Resolution is name-based within one file (module globals, ``self.<attr>``
assignments, locals), conservative like the lock checker: dynamically
stored primitives are not tracked. The runtime lockdep layer observes
what this checker cannot.
"""
from __future__ import annotations

import ast

from .core import PACKAGE_DIRS, Tree, checker

THREAD_CTOR = "Thread"
WAITABLE_CTORS = {"Condition": "Condition", "Event": "Event"}
QUEUE_CTORS = ("Queue", "LifoQueue", "PriorityQueue", "SimpleQueue")


def _binding_key(target):
    """A comparable key for a Name / ``self.<attr>`` assignment target."""
    if isinstance(target, ast.Name):
        return target.id
    if (
        isinstance(target, ast.Attribute)
        and isinstance(target.value, ast.Name)
        and target.value.id == "self"
    ):
        return f"self.{target.attr}"
    return None


def _receiver_key(expr):
    """The binding key of a call receiver (``worker.join`` /
    ``self._worker.join``)."""
    return _binding_key(expr)


def _ctor_name(call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _has_timeout(call) -> bool:
    """Whether a wait/join call carries a timeout argument (the single
    positional IS the timeout for both)."""
    if call.args:
        return True
    return any(kw.arg == "timeout" for kw in call.keywords)


def _get_unbounded(call) -> bool:
    """Whether a ``Queue.get`` call provably parks forever: no timeout
    (second positional or keyword) and blocking not literally False —
    ``get(block=True)`` / ``get(True)`` / bare ``get()`` all park; a
    non-literal ``block`` expression is skipped (conservative)."""
    if len(call.args) >= 2 or any(kw.arg == "timeout" for kw in call.keywords):
        return False
    block = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "block":
            block = kw.value
    if block is None:
        return True  # bare get(): blocking, unbounded
    if isinstance(block, ast.Constant):
        return block.value is not False  # get(False)/get_nowait shape is fine
    return False  # dynamic block= expression: cannot judge statically


def _daemon_true(call) -> bool:
    return any(
        kw.arg == "daemon"
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is True
        for kw in call.keywords
    )


@checker(
    "thread-lifecycle",
    code="SA017",
    doc="Every threading.Thread the package constructs is daemon=True (or "
    "daemon-assigned on the same binding) or joined in the same file — a "
    "non-daemon thread nobody joins hangs shutdown; and every park is "
    "bounded: Condition.wait/Event.wait/Queue.get on resolvable bindings "
    "and every zero-argument .join() must carry a timeout. Name-based "
    "within one file, conservative; dynamically stored primitives are not "
    "tracked.",
)
def check_thread_lifecycle(tree: Tree):
    findings = []
    for rel in tree.py_files(PACKAGE_DIRS):
        try:
            mod = tree.parse(rel)
        except SyntaxError:
            continue
        threads: dict = {}     # binding key -> (lineno, daemon)
        waitables: dict = {}   # binding key -> ctor kind
        queues: set = set()
        joined: set = set()
        unbound_threads: list = []  # (lineno, call) never assigned
        # pass 1: collect every construction — ast.walk order is breadth-
        # first, so a `t.daemon = True` at outer level can precede a
        # nested construction; binding collection must complete first
        for node in ast.walk(mod):
            if not (
                isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
            ):
                continue
            ctor = _ctor_name(node.value)
            keys = [
                k for k in map(_binding_key, node.targets) if k is not None
            ]
            if ctor == THREAD_CTOR and keys:
                for k in keys:
                    threads[k] = (node.lineno, _daemon_true(node.value))
            elif ctor in WAITABLE_CTORS and keys:
                for k in keys:
                    waitables[k] = ctor
            elif ctor in QUEUE_CTORS and keys:
                queues.update(keys)
        # pass 2: daemon assignments, joins, waits, gets, unbound starts
        for node in ast.walk(mod):
            if isinstance(node, ast.Assign):
                v = node.value
                # t.daemon = True after construction
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and t.attr == "daemon"
                        and isinstance(v, ast.Constant)
                        and v.value is True
                    ):
                        key = _binding_key(t.value)
                        if key in threads:
                            threads[key] = (threads[key][0], True)
            elif isinstance(node, ast.Call):
                fn = node.func
                if not isinstance(fn, ast.Attribute):
                    continue
                recv = _receiver_key(fn.value)
                if fn.attr == "join":
                    if recv is not None:
                        joined.add(recv)
                    if not _has_timeout(node):
                        findings.append(
                            check_thread_lifecycle.finding(
                                rel, node.lineno,
                                ".join() without a timeout parks the caller "
                                "forever if the thread never exits — pass a "
                                "timeout and handle the survivor",
                            )
                        )
                elif fn.attr == "wait" and recv in waitables:
                    if not _has_timeout(node):
                        findings.append(
                            check_thread_lifecycle.finding(
                                rel, node.lineno,
                                f"{waitables[recv]}.wait() without a timeout "
                                "is an unbounded park — every wait must be "
                                "bounded (the no-deadlock contract)",
                            )
                        )
                elif fn.attr == "get" and recv in queues:
                    if _get_unbounded(node):
                        findings.append(
                            check_thread_lifecycle.finding(
                                rel, node.lineno,
                                "blocking Queue.get() without a timeout is "
                                "an unbounded park — pass timeout= (or use "
                                "get_nowait and back off)",
                            )
                        )
                elif (
                    fn.attr == "start"
                    and isinstance(fn.value, ast.Call)
                    and _ctor_name(fn.value) == THREAD_CTOR
                ):
                    # threading.Thread(...).start() — never bound, cannot be
                    # joined: daemon=True is the only acceptable shape
                    if not _daemon_true(fn.value):
                        unbound_threads.append(node.lineno)
        for key, (lineno, daemon) in sorted(threads.items()):
            if not daemon and key not in joined:
                findings.append(
                    check_thread_lifecycle.finding(
                        rel, lineno,
                        f"thread {key!r} is neither daemon=True nor joined "
                        "in this file — a leaked non-daemon thread hangs "
                        "process shutdown",
                    )
                )
        for lineno in unbound_threads:
            findings.append(
                check_thread_lifecycle.finding(
                    rel, lineno,
                    "unbound Thread(...).start() without daemon=True can "
                    "never be joined — mark it daemon or bind and join it",
                )
            )
    return findings
