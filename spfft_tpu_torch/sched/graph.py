"""Task graphs over split-phase transform executions.

The port of ``spfft_tpu/sched/graph.py``. A :class:`TaskGraph`'s nodes are
single transform executions (the ``multi_transform`` dispatch and finalize
halves with their host staging); its edges are the two dependency kinds the
runtime has:

- **data dependencies**: ``after=[...]``, and ``input_from=<task id>`` when a
  task's payload is an upstream result;
- **retained-buffer constraints**: tasks naming the same transform *object*
  run in submission order, since a plan's retained space is per object (the
  rule that makes ``multi_transform_*`` refuse a plan twice is an edge here).

A node carries a ``transform`` (a pinned plan) or a ``spec`` dict (geometry
only; the placement pass gives it a device and a plan from the pool).
Unknown and duplicate ids, dangling dependencies and cycles raise
:class:`~spfft_tpu_torch.errors.InvalidParameterError` before anything runs.
"""
from __future__ import annotations

import numpy as np

from ..errors import InvalidParameterError
from ..tuning.wisdom import sparsity_signature
from ..types import ScalingType
from .placement import SPEC_KEYS, spec_digest

DIRECTIONS = ("backward", "forward")

_obj_id = id  # the builtin; the ``id=`` task-id keyword shadows it


class Task:
    """One transform execution of a :class:`TaskGraph` (module docstring)."""

    __slots__ = (
        "id", "direction", "payload", "scaling", "deps", "input_from",
        "transform", "spec", "digest", "deadline", "batch",
        # execution state (the executor's)
        "plan", "pending", "ready", "result", "error", "outcome", "attempts",
        "host_moves", "dispatched_at", "finished_at",
    )

    def __init__(self, id, direction, *, payload=None, scaling=ScalingType.NONE, deps=(),
                 input_from=None, transform=None, spec=None, deadline=None, batch=False,
                 digest=None):
        if direction not in DIRECTIONS:
            raise InvalidParameterError(
                f"task {id!r}: unknown direction {direction!r} (expected one of {DIRECTIONS})")
        if (transform is None) == (spec is None):
            raise InvalidParameterError(
                f"task {id!r}: exactly one of transform= (pinned plan) or spec= (placed "
                "through the plan pool) is required")
        if spec is not None and direction == "forward" and payload is None \
                and input_from is None:
            raise InvalidParameterError(
                f"task {id!r}: a spec'd forward task needs an explicit payload or "
                "input_from= — pool-resolved plans are shared per (geometry, device), so "
                "their retained space buffers are not task-addressable")
        # a batch task: the payload is a list of requests run as one batched
        # dispatch (one task, one finalize, one ladder); needs a pinned plan
        self.batch = bool(batch)
        if self.batch:
            if transform is None:
                raise InvalidParameterError(f"task {id!r}: a batch task needs a pinned transform=")
            if not isinstance(payload, (list, tuple)) or not payload:
                raise InvalidParameterError(
                    f"task {id!r}: a batch task needs a non-empty list payload (one entry "
                    "per request)")
            payload = list(payload)
        self.id = str(id)
        self.direction = direction
        self.payload = payload
        self.scaling = ScalingType(scaling)
        self.deps = tuple(str(d) for d in deps)
        self.input_from = None if input_from is None else str(input_from)
        self.transform = transform
        self.spec = dict(spec) if spec is not None else None
        self.digest = digest  # the spec's identity (placement.spec_digest)
        # an absolute time.monotonic() deadline, or None: an expired task is
        # never dispatched (typed DeadlineExceededError)
        self.deadline = None if deadline is None else float(deadline)
        self.plan = transform
        self.pending = None
        self.ready = None  # the CUDA event recorded after the dispatch, or None
        self.result = None
        self.error = None
        self.outcome = None  # one of executor.OUTCOMES once resolved
        self.attempts = 0
        self.host_moves = 0
        self.dispatched_at = None
        self.finished_at = None

    def describe(self) -> dict:
        """The task's identity and outcome, JSON-plain."""
        return {
            "id": self.id,
            "direction": self.direction,
            "batch": len(self.payload) if self.batch else None,
            "deps": list(self.deps),
            "outcome": self.outcome,
            "attempts": self.attempts,
            "error": None if self.error is None else type(self.error).__name__,
        }


class TaskGraph:
    """Ordered :class:`Task` nodes with dependency edges."""

    def __init__(self):
        self._tasks: dict = {}
        self._last_user: dict = {}  # id(transform) -> its last task's id
        self._auto_id = 0
        # id(indices) -> (indices, sparsity signature): each indices array
        # that specs share is hashed once; the reference keeps the id valid
        self._sticks: dict = {}

    def add(self, direction, *, id=None, payload=None, scaling=ScalingType.NONE, after=(),
            input_from=None, transform=None, spec=None, deadline=None, batch=False) -> str:
        """Add one task; returns its id (``t<n>`` when not given). ``after``
        lists upstream ids; ``input_from`` names one whose result becomes the
        payload (and joins the dependencies). Tasks sharing a ``transform``
        object run in submission order."""
        if id is not None:
            tid = str(id)
        else:
            while f"t{self._auto_id}" in self._tasks:  # never a caller's id
                self._auto_id += 1
            tid = f"t{self._auto_id}"
            self._auto_id += 1
        if tid in self._tasks:
            raise InvalidParameterError(f"duplicate task id {tid!r}")
        deps = [str(a) for a in after]
        if input_from is not None and str(input_from) not in deps:
            deps.append(str(input_from))
        if transform is not None:
            prev = self._last_user.get(_obj_id(transform))
            if prev is not None and prev not in deps:
                deps.append(prev)  # the retained-buffer edge
        for d in deps:
            if d not in self._tasks:
                raise InvalidParameterError(
                    f"task {tid!r} depends on unknown task {d!r} (dependencies must be "
                    "added first)")
        self._tasks[tid] = Task(
            tid, direction, payload=payload, scaling=scaling, deps=deps, input_from=input_from,
            transform=transform, spec=spec, deadline=deadline, batch=batch,
            digest=None if spec is None else self._spec_digest(spec))
        if transform is not None:
            # recorded only for a task that exists: a refused add leaves no
            # edge behind (the graph holds each recorded transform, so its
            # id() is not reused by another object)
            self._last_user[_obj_id(transform)] = tid
        return tid

    def _spec_digest(self, spec: dict) -> str:
        """:func:`~.placement.spec_digest` of ``spec``, its indices hashed
        once for every spec of this graph that shares the array."""
        if "indices" not in spec:
            raise InvalidParameterError(f"task spec is missing 'indices' (required: {SPEC_KEYS})")
        indices = spec["indices"]
        held = self._sticks.get(_obj_id(indices))
        if held is None:
            held = self._sticks[_obj_id(indices)] = (
                indices, sparsity_signature(np.asarray(indices)))
        return spec_digest(spec, held[1])

    def __len__(self) -> int:
        return len(self._tasks)

    def __iter__(self):
        return iter(self._tasks.values())

    def task(self, tid: str) -> Task:
        try:
            return self._tasks[str(tid)]
        except KeyError:
            raise InvalidParameterError(f"unknown task id {tid!r}") from None

    def order(self) -> list:
        """Topological order, submission order among ready peers (Kahn's
        algorithm); a cycle raises."""
        indeg = {t.id: len(t.deps) for t in self._tasks.values()}
        children: dict = {t.id: [] for t in self._tasks.values()}
        for t in self._tasks.values():
            for d in t.deps:
                children[d].append(t.id)
        ready = [tid for tid, n in indeg.items() if n == 0]
        out = []
        while ready:
            tid = ready.pop(0)
            out.append(tid)
            for c in children[tid]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(out) != len(self._tasks):
            stuck = sorted(tid for tid, n in indeg.items() if n > 0)
            raise InvalidParameterError(f"task graph has a dependency cycle through {stuck}")
        return [self._tasks[tid] for tid in out]

    def depth(self) -> int:
        """The longest dependency chain (1 for a flat batch, 0 empty): the
        ``sched_graph_depth`` gauge."""
        depth: dict = {}
        for task in self.order():
            depth[task.id] = 1 + max((depth[d] for d in task.deps), default=0)
        return max(depth.values(), default=0)

    def describe(self) -> dict:
        """Size, depth and each task's outcome, JSON-plain."""
        return {"tasks": len(self._tasks), "depth": self.depth(),
                "nodes": [t.describe() for t in self._tasks.values()]}
