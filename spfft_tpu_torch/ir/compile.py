"""Run stage graphs: fused (one program per direction), staged, and batched.

* **Fused** (the default, ``SPFFT_TPU_FUSE=1`` / ``fuse=True``): :func:`compose`
  folds a graph into one function. On a CUDA plan that function is captured
  in one ``torch.cuda.CUDAGraph`` per ``(direction, scaling)`` at its first
  call, as ``jax.jit`` compiles at the first call in the JAX package: one
  eager run on a side stream (it fills cuFFT's plan cache and the allocator),
  then the capture over static input buffers, in one memory pool that the
  plan's graphs share. Each call copies the caller's tensors into the static
  inputs, replays, and hands out a copy of the static outputs, so that a
  later call never overwrites a result the caller holds. On a CPU plan the
  composed function runs in one eager call and nothing is captured.
* **Staged** (``SPFFT_TPU_FUSE=0`` / ``fuse=False``): one eager call per node,
  the reference that the fused program is held against.
* **Batched** (``SPFFT_TPU_BATCH_FUSE``, fused plans only): B requests of one
  plan in one program per direction: on the card one graph per
  ``(direction, scaling, B)`` that holds the B per-request compositions over
  slices of stacked static inputs, so that a batch costs one replay.

The degradation rungs of the JAX package (``spfft_tpu/ir/compile.py``),
each recorded on the plan card's ``degradations`` and in
``degradations_total`` (:mod:`spfft_tpu_torch.faults`):

* ``ir_lower_failed`` (fault site ``ir.lower``, or a lowering or validation
  that fails): the engine runs its **legacy** path, its stage bodies called
  in its builder's node order with no graph (a mesh engine's exchanges on
  the same route as its nodes: a gather, or pack, collective and unpack);
* ``fuse_compile_failed`` (fault site ``ir.compile`` when the plan is built,
  or a fused program whose first call fails with a runtime error, such as a
  CUDA-graph capture that the CUDA runtime refuses): the staged path, from
  then on, for every direction;
* ``batch_fuse_failed`` (fault site ``ir.batch``, or a batched program's
  first call failing): the plan's batch axis is off and its callers loop.

The kernels' own typed failures (``GPUSupportError``, ``GPULaunchError``)
take no rung: they raise. A replay that fails raises
:class:`~spfft_tpu_torch.errors.GPUError`.

**Over a process group** a mesh plan runs fused too, as the JAX package's
``shard_map`` program does: on the card each direction's CUDA graph holds
NCCL's kernels beside K1 and K2. It stays staged only where a graph cannot
hold the collective: a CUDA plan whose group's backend is not NCCL (gloo
runs its collectives on CUDA tensors through the host); ``describe()``
names that backend (``"staged_because"``) and ``fuse=True`` there raises.
The invariant over a group: on every call, each process issues the same
collectives in the same order, whatever path it takes. :func:`schedule`
is deterministic from the graph, so the fused, staged and legacy paths
issue one order, once a call. A program's first call over a group runs in
step (:meth:`EngineIr._run_in_step`): the composed body once, eagerly (it
issues the call's collectives, creates NCCL's communicator and is the
call's result), then the capture, which executes nothing, then one
all-reduce that counts the processes that cannot replay (a capture that
failed, a plan on another path). If any cannot, every process takes the
rung and runs staged from then on, so that no process replays a captured
collective against another's eager one. A batched program agrees first on
``ir.batch``. The eager run itself takes no rung over a group: running the
call again would re-issue collectives the other processes have passed, so
its failure raises :class:`~spfft_tpu_torch.errors.MPIError`, and the
other processes' collectives fail at the group's timeout.

:data:`dispatches` counts program calls by ``(mode, direction)``: staged adds
one per node (added once per call), fused one per direction, batched one per
batch and direction; the metrics registry's ``ir_dispatches_total{mode,
direction}`` counts the same. On the staged path each node runs under
``timing.trace_annotation(<its stage label>)``, so a ``torch.profiler``
trace names each stage's device time; with no profiler running that is the
shared no-op scope. A CUDA program's call after its capture is timed in
three ``timing.scoped`` scopes: "copy in" (the caller's tensors into the
static inputs), "replay" (``graph.replay()``) and "copy out" (``finish``:
the clone, or the batch's stack); a CPU plan's eager call has none. Every
count, scope and span sits outside the captured region: host code inside a
capture runs once at capture and never at a replay.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import threading
import weakref

import torch

from .. import faults, knobs, obs, timing
from ..errors import GPUError, InvalidParameterError, MPIError
from ..types import ScalingType

FUSE_ENV = "SPFFT_TPU_FUSE"
BATCH_FUSE_ENV = "SPFFT_TPU_BATCH_FUSE"
# the keys of ``describe()`` (Transform.describe()["ir"]), as in the JAX package
IR_KEYS = ("fused", "path", "requested", "stages", "donation")
# the keys of ``describe_batch()`` (the card's ``batch`` section); the plan
# card's BATCH_SECTION_KEYS mirrors it (the SA009 checker pins the two equal)
BATCH_KEYS = ("enabled", "requested", "sizes", "failed")

# Program calls, keyed by (mode, direction); mode is "staged", "fused" or "batched".
dispatches: collections.Counter = collections.Counter()


def resolve_fuse(fuse=None):
    """``(fused, source)``: an explicit ``fuse=`` wins, else ``SPFFT_TPU_FUSE``
    (default fused); ``source`` is ``"kwarg"``, ``"env"`` or ``"default"``."""
    if fuse is not None:
        if not isinstance(fuse, (bool, int)) or fuse not in (0, 1):
            raise InvalidParameterError(f"fuse= must be a bool (or 0/1), got {fuse!r}")
        return bool(fuse), "kwarg"
    raw = knobs.raw(FUSE_ENV)
    if raw is None or raw == "":
        return True, "default"
    if raw not in ("0", "1"):
        raise InvalidParameterError(f"{FUSE_ENV} must be 0 or 1, got {raw!r}")
    return raw == "1", "env"


def resolve_batch_fuse():
    """``(enabled, source)`` of ``SPFFT_TPU_BATCH_FUSE`` (default on), read at
    call time so that it flips without rebuilding plans."""
    raw = knobs.raw(BATCH_FUSE_ENV)
    if raw is None or raw == "":
        return True, "default"
    if raw not in ("0", "1"):
        raise InvalidParameterError(f"{BATCH_FUSE_ENV} must be 0 or 1, got {raw!r}")
    return raw == "1", "env"


def _bind(graph, args) -> dict:
    names = graph.inputs
    if len(args) != len(names):
        raise InvalidParameterError(
            f"ir[{graph.direction}]: expected {len(names)} inputs ({names}), got {len(args)}"
        )
    return dict(zip(names, args))


def _run_node(env, node):
    out = node.fn(*[env[e] for e in node.inputs])
    if len(node.outputs) == 1:
        env[node.outputs[0]] = out
    else:
        env.update(zip(node.outputs, out))


def _results(graph, env):
    outs = tuple(env[e] for e in graph.outputs)
    return outs[0] if len(outs) == 1 else outs


# ---- the stream schedule of the OVERLAPPED exchange ---------------------------------
# What the JAX package gets from XLA's asynchronous collectives, written out:
# on a CUDA plan every node of these stages runs on a side stream of the
# plan's device, so that a chunk's exchange (K2 gathers without a process
# group, NCCL's kernel with one) runs while the compute stream runs the
# neighbour chunks' DFT stages (K1).

OVERLAPPED_STAGES = ("exchange overlapped", "exchange A overlapped", "exchange B overlapped")


def schedule(graph) -> list:
    """The nodes in issue order: a topological order that, among the ready
    nodes, issues an overlapped exchange first, then a node that feeds one,
    then the rest, each in the graph's order. A chunk's exchange is so
    queued on the side stream as soon as its producer is, ahead of the
    compute stages it can hide behind. A graph with no overlapped node keeps
    :meth:`~.graph.StageGraph.toposort`'s order."""
    nodes = graph.toposort()
    if not any(n.stage in OVERLAPPED_STAGES for n in nodes):
        return nodes
    feeds = {e for n in nodes if n.stage in OVERLAPPED_STAGES for e in n.inputs}
    rank = {n.name: (0 if n.stage in OVERLAPPED_STAGES else
                     1 if any(e in feeds for e in n.outputs) else 2, i)
            for i, n in enumerate(nodes)}
    ready, remaining, order = set(graph.inputs), list(nodes), []
    while remaining:
        node = min((n for n in remaining if all(e in ready for e in n.inputs)),
                   key=lambda n: rank[n.name])
        order.append(node)
        ready.update(node.outputs)
        remaining.remove(node)
    return order


class _Streams:
    """One call's two streams: the caller's current (compute) stream and
    the plan's side stream. A side node waits on the events its inputs'
    producers recorded on the compute stream (a graph input: on everything
    the compute stream has queued); a compute node waits on the event its
    side-stream producer recorded. :meth:`join` makes the compute stream
    wait on the side stream at the end of the call, and every edge of the
    call is held until then (the caching allocator then cannot hand a
    tensor that one stream still reads to the other). Inside a CUDA-graph
    capture the first wait forks the side stream into the capture and the
    join brings it back, so the graph holds parallel branches."""

    def __init__(self, side, marked):
        self.compute = torch.cuda.current_stream(side.device)
        self.side = side
        self.marked = marked  # the compute nodes whose outputs a side node reads
        self.events = {}  # edge -> the event recorded after its producer
        self.on_side = set()  # edges produced on the side stream
        self.used = False

    def run(self, env, node):
        if node.stage in OVERLAPPED_STAGES:
            waited = set()
            for e in node.inputs:
                if e in self.on_side:
                    continue  # the side stream's own order
                ev = self.events.get(e)
                if ev is None:
                    self.side.wait_stream(self.compute)
                elif id(ev) not in waited:
                    self.side.wait_event(ev)
                    waited.add(id(ev))
            self.used = True
            with torch.cuda.stream(self.side):
                _run_node(env, node)
            ev = torch.cuda.Event()
            ev.record(self.side)
            for e in node.outputs:
                self.events[e] = ev
                self.on_side.add(e)
            return
        for ev in {id(self.events[e]): self.events[e] for e in node.inputs
                   if e in self.on_side}.values():
            self.compute.wait_event(ev)
        _run_node(env, node)
        if node.name in self.marked:
            ev = torch.cuda.Event()
            ev.record(self.compute)
            for e in node.outputs:
                self.events[e] = ev

    def join(self):
        if self.used:
            self.compute.wait_stream(self.side)


def _runner(graph, side):
    """A function giving each call's ``(run(env, node), join())``: plain in
    order, or the stream schedule where ``side`` (a callable giving the
    plan's side stream, None on the CPU) is given and the graph has
    overlapped nodes."""
    if side is None or not any(n.stage in OVERLAPPED_STAGES for n in graph.nodes):
        return lambda: (_run_node, lambda: None)
    side_inputs = {e for n in graph.nodes if n.stage in OVERLAPPED_STAGES for e in n.inputs}
    marked = {n.name for n in graph.nodes if n.stage not in OVERLAPPED_STAGES
              and any(e in side_inputs for e in n.outputs)}

    def streams():
        s = _Streams(side(), marked)
        return s.run, s.join

    return streams


def compose(graph, side=None):
    """The graph as one function: ``fn(*args)`` binds ``args`` to the input
    edges in order, runs the nodes in :func:`schedule`'s order (the
    overlapped exchanges on the side stream that ``side()`` gives, on a
    CUDA plan) and returns the output edges (a bare value for one output,
    else a tuple). ``fn.stage`` names the node that ran last, for error
    reports."""
    order, runner = schedule(graph), _runner(graph, side)

    def fn(*args):
        env = _bind(graph, args)
        run, join = runner()
        for node in order:
            fn.stage = node.stage
            run(env, node)
        join()
        return _results(graph, env)

    fn.stage = None
    return fn


class StagedProgram:
    """The per-node reference executor: each node is its own eager call
    (the overlapped exchanges on the side stream ``side()``, as fused)."""

    def __init__(self, graph, side=None):
        self.graph = graph
        self.order, self.runner = schedule(graph), _runner(graph, side)

    def __call__(self, *args):
        env = _bind(self.graph, args)
        run, join = self.runner()
        for node in self.order:
            with timing.trace_annotation(node.stage):
                run(env, node)
        join()
        direction, n = self.graph.direction, len(self.order)
        dispatches["staged", direction] += n
        obs.counter("ir_dispatches_total", mode="staged", direction=direction).inc(n)
        return _results(self.graph, env)


def _stack(items):
    """Per-request results -> the stacked ``(B, ...)`` results (new tensors)."""
    if isinstance(items[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*items))
    return torch.stack(items)


# One CUDA-graph capture at a time in the process (see _Program._capture).
# A capture may hold a collective (a plan over an NCCL group): every
# process of the group captures in step, and a capture executes nothing
# (no communication waits on a peer under the lock), so holding it there
# cannot deadlock.
_CAPTURE_LOCK = threading.Lock()


# The programs whose CUDA graph holds a collective. NCCL's communicator
# cannot be destroyed while a graph holds its kernels (destroy_process_group
# then waits forever), so release_collective_graphs drops them first.
_COLLECTIVE_GRAPHS: weakref.WeakSet = weakref.WeakSet()


def release_collective_graphs() -> int:
    """Drop the CUDA graph of every program that captured a collective
    (:func:`~spfft_tpu_torch.parallel.mesh.shutdown_distributed` calls it
    before it destroys the process group); such a program's later calls
    raise :class:`MPIError`. Returns how many graphs were dropped."""
    released = 0
    for prog in list(_COLLECTIVE_GRAPHS):
        released += prog._captured is not None
        prog._captured, prog._released = None, True
    _COLLECTIVE_GRAPHS.clear()
    return released


class _Program:
    """One program: ``body`` in one eager call on a CPU plan; on a CUDA plan
    one CUDA graph of ``body``, captured at the first call. ``finish`` turns
    the body's outputs into the caller's results (new tensors).
    ``collective``: the body issues collectives (a plan over a group)."""

    def __init__(self, body, finish, device, pool, what, stage, collective=False):
        self.body, self.finish, self.device, self.pool = body, finish, device, pool
        self.what, self.stage = what, stage  # for error reports
        self.collective = collective
        self._captured = None  # (CUDAGraph, static inputs, static outputs)
        self._released = False  # release_collective_graphs dropped its graph

    def __call__(self, *args):
        if self._released:
            raise MPIError(f"{self.what}: its process group was shut down")
        if self.device.type != "cuda":
            return self.eager(*args)
        if self._captured is None:
            self._capture(args)
        graph, static_in, static_out = self._captured
        # the replay's host scopes, after the capture and outside it
        with timing.scoped("copy in"):
            for buf, a in zip(static_in, args):
                if (buf is None) != (a is None) or (buf is not None and buf.shape != a.shape):
                    raise InvalidParameterError(
                        f"{self.what}: inputs differ from those the graph was captured on"
                    )
                if buf is not None:
                    buf.copy_(a)
        with timing.scoped("replay"):
            try:
                graph.replay()
            except RuntimeError as e:
                raise GPUError(f"{self.what}: CUDA graph replay failed: {e}") from e
        with timing.scoped("copy out"):
            return self.finish(static_out)

    def eager(self, *args):
        """The body in one eager call on the caller's stream (a CPU plan's
        every call; over a process group, a program's first call)."""
        return self.finish(self.body(*args))

    def _capture(self, args, warm=True) -> None:
        """Static inputs holding ``args``, one eager run on a side stream
        (cuFFT plans, the allocator, the kernels' libraries; ``warm=False``
        where an eager call of the body has just run, as over a process
        group, where that call also created NCCL's communicator), then the
        capture into the plan's pool. Nothing on a CPU plan.

        The capture is ``thread_local``: other threads may go on allocating,
        building plans and copying results to the host while it runs (a
        serving dispatcher captures a new batch size while its callers read
        their results; ProcessGroupNCCL's watchdog queries its events),
        which the default ``global`` mode refuses and which would invalidate
        the capture. Captures of the process take turns
        (:data:`_CAPTURE_LOCK`): ``torch.cuda.graph`` synchronizes the device
        and empties the allocator's cache before it captures, which must not
        meet another thread's capture. A collective captured here (NCCL's
        kernels, on NCCL's stream, which the collective forks from the
        capturing stream and its wait joins back) runs at each replay with
        the split sizes fixed when the plan was built."""
        if self.device.type != "cuda":
            return
        self._captured = capture(self.body, args, self.device, self.pool, warm=warm,
                                 where=lambda: f"{self.what}: CUDA graph capture failed at "
                                               f"stage {self.stage()!r}")
        if self.collective:
            _COLLECTIVE_GRAPHS.add(self)


def capture(body, args, device, pool, *, warm=True, where=None, graph=None,
            around=contextlib.nullcontext):
    """``(graph, static inputs, static outputs)``: ``body`` captured over
    static inputs holding ``args`` into the memory pool ``pool``, after one
    eager run on a side stream unless ``warm`` is False (see
    :meth:`_Program._capture`). ``graph`` is the ``torch.cuda.CUDAGraph`` to
    capture into (a new one by default); ``around()`` is entered around the
    captured call alone (the compiled-program statistics' recorder,
    :mod:`spfft_tpu_torch.obs.hlo`). A failure keeps its class and gets the
    note ``where()``."""
    with _CAPTURE_LOCK, torch.cuda.device(device):
        static_in = [None if a is None else a.to(device).clone(
            memory_format=torch.contiguous_format) for a in args]
        current = torch.cuda.current_stream(device)
        try:
            if warm:
                side = torch.cuda.Stream(device)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    body(*static_in)
                current.wait_stream(side)
            graph = torch.cuda.CUDAGraph() if graph is None else graph
            # held across the capture on purpose: captures take turns
            with no_collection(), torch.cuda.graph(graph, pool=pool,  # noqa: SA011
                                                   capture_error_mode="thread_local"):
                with around():
                    static_out = body(*static_in)
        except Exception as e:  # the class is kept: EngineIr decides the rung
            # a capture that fails inside torch.cuda.graph leaves its
            # stream current: the caller's comes back
            torch.cuda.set_stream(current)
            if where is not None:
                e.add_note(where())
            raise
    return graph, static_in, static_out


@contextlib.contextmanager
def no_collection():
    """Python's cyclic garbage collector held off for a CUDA-graph capture. A
    plan that was dropped is cyclic garbage (its engine and its programs refer
    to each other); a collection during a capture would destroy its graphs,
    which the CUDA runtime refuses while a stream captures, and the refusal
    invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _clone(out):
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


class EngineIr:
    """One engine's graphs and programs, and the routing and counting of its
    ``backward_pair``/``forward_pair`` and batched entries. Built by
    :func:`init_engine_ir`."""

    def __init__(self, graphs, *, path, requested, device, staged_because=None, sink=None,
                 engine=None, group=None):
        self.graphs = graphs  # {"backward": g, "forward": {ScalingType: g}}; None: legacy
        self.path = path  # "fused" | "staged" | "legacy"
        self.requested = requested
        self.staged_because = staged_because
        self.device = torch.device(device)
        # the process group of the exchange's collectives (None: no group);
        # a program's first call over it runs in step (_run_in_step)
        self._group = group
        self._agreed = set()  # program keys whose first call ran in step
        # the plan's live degradations list, kept from the scope the engine
        # was built in, so that a rung taken at a first dispatch lands on it
        self._sink = sink
        self._engine = engine  # the legacy path's stage bodies
        # the memory pool of this plan's CUDA graphs: every result is copied
        # out of it right after its replay, on the same stream, so a graph
        # may reuse what another one freed
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        # the side stream of the OVERLAPPED exchange (made at its first use)
        self._side = None
        self.side = self._side_stream if self.device.type == "cuda" else None
        self._programs = {}  # (direction, scaling or None, B or None) -> program
        self._compiled = set()  # keys of the programs whose first call succeeded
        self._batch_keys = set()  # (direction, scaling) whose batched build passed ir.batch
        self._batch_failed = False
        self._batch_sizes = set()  # distinct batch sizes dispatched (the card)
        if path == "staged":
            self._install_staged()

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _install_staged(self) -> None:
        self._programs = {("backward", None, None): StagedProgram(self.graphs["backward"],
                                                                  self.side)}
        for s, g in self.graphs["forward"].items():
            self._programs["forward", s, None] = StagedProgram(g, self.side)

    @property
    def fused(self) -> bool:
        return self.path == "fused"

    def _record(self, event: str, exc) -> None:
        """A rung taken after construction: recorded, and placed on the
        plan's own list (the sink kept at construction)."""
        entry = faults.record_degradation(event, faults.summarize(exc))
        if self._sink is not None and (not self._sink or self._sink[-1] is not entry):
            self._sink.append(entry)

    def _degrade_to_staged(self, exc) -> None:
        """``fuse_compile_failed`` at a first dispatch: the staged path from
        now on, for every direction (the plan card re-reads the live list)."""
        self._record("fuse_compile_failed", exc)
        self.path = "staged"
        self._install_staged()

    def _graph(self, direction, scaling):
        return self.graphs["backward"] if direction == "backward" else self.graphs["forward"][scaling]

    def body(self, direction, scaling=None):
        """A fresh function of one direction's program, as its fused program
        runs it: :func:`compose` of the direction's graph, or on the legacy
        path the engine's stage bodies in order. The plan's own programs and
        their graphs are untouched (the compiled-program statistics,
        :mod:`spfft_tpu_torch.obs.hlo`)."""
        if self.graphs is None:
            e = self._engine
            if direction == "backward":
                return e._legacy_backward
            return lambda *args: e._legacy_forward(ScalingType(scaling), *args)
        return compose(self._graph(direction, scaling), self.side)

    def _program(self, direction, scaling, batch=None):
        key = (direction, scaling, batch)
        prog = self._programs.get(key)
        if prog is None:
            graph = self._graph(direction, scaling)
            fn = compose(graph, self.side)
            what = f"ir[{direction}{'' if scaling is None else ', ' + scaling.name}" + (
                "]" if batch is None else f", batch {batch}]")
            if batch is None:
                body, finish = fn, (_clone if self.device.type == "cuda" else (lambda out: out))
            else:
                body, finish = _batched(graph, fn, batch), _stack
            prog = _Program(body, finish, self.device, self._pool, what, lambda: fn.stage,
                            collective=self._group is not None)
            self._programs[key] = prog
        return prog

    def _run(self, direction, scaling, args):
        if self._group is not None and (direction, scaling, None) not in self._agreed:
            return self._run_in_step(direction, scaling, args)
        return self._dispatch(direction, scaling, args)

    def _dispatch(self, direction, scaling, args):
        if self.path == "legacy":
            e = self._engine
            out = (e._legacy_backward(*args) if direction == "backward"
                   else e._legacy_forward(scaling, *args))
        else:
            key = (direction, scaling, None)
            prog = self._program(direction, scaling)
            if self.path != "fused" or key in self._compiled:
                out = prog(*args)
            else:
                try:
                    out = prog(*args)
                except faults.ENGINE_BUILD_ERRORS as e:
                    self._degrade_to_staged(e)
                    return self._run(direction, scaling, args)
                self._compiled.add(key)
            if self.path == "staged":  # staged counts per node itself
                return out
        dispatches[self.path, direction] += 1
        obs.counter("ir_dispatches_total", mode=self.path, direction=direction).inc()
        return out

    def _agree(self, behind: bool, what: str) -> int:
        """The processes of the group for which ``behind`` holds, counted in
        one all-reduce; a failed all-reduce is an :class:`MPIError`."""
        from ..verify.checks import group_scalar

        try:
            return int(group_scalar(behind, self._group, self.device))
        except (RuntimeError, ValueError) as e:
            raise MPIError(f"{what}: the group's agreement failed: {e}") from e

    def _first_call(self, prog, key, what: str, args):
        """A fused program's first call over a group: its body, eagerly (the
        call's collectives; its result), the capture, then the agreement.
        Returns the result, and the failure that the caller's rung records
        where any process cannot replay (None: every one can). The eager run
        takes no rung (module docstring): its failure raises
        :class:`MPIError`."""
        try:
            out = prog.eager(*args)
        except faults.ENGINE_BUILD_ERRORS as e:
            raise MPIError(f"{what}: the first call over the process group failed on this "
                           f"process, which cannot run it again in step: {e}") from e
        mine = None
        try:
            prog._capture(args, warm=False)
        except faults.ENGINE_BUILD_ERRORS as e:
            mine = e
        behind = self._agree(mine is not None, what)
        self._agreed.add(key)
        if not behind:
            self._compiled.add(key)
            return out, None
        return out, mine if mine is not None else MPIError(
            f"{what}: {behind} process(es) of the group cannot replay its graph")

    def _run_in_step(self, direction, scaling, args):
        """The first call of ``(direction, scaling)`` over a process group,
        on every path: the call once (fused: :meth:`_first_call`; staged and
        legacy: as always), then one all-reduce counting the processes that
        will not replay its graph. If any will not, every fused process takes
        ``fuse_compile_failed`` and runs staged from then on."""
        what = f"ir[{direction}{'' if scaling is None else ', ' + scaling.name}]"
        if self.path != "fused":
            out = self._dispatch(direction, scaling, args)
            self._agree(True, what)
            self._agreed.add((direction, scaling, None))
            return out
        out, failed = self._first_call(self._program(direction, scaling),
                                       (direction, scaling, None), what, args)
        dispatches["fused", direction] += 1
        obs.counter("ir_dispatches_total", mode="fused", direction=direction).inc()
        if failed is not None:
            self._degrade_to_staged(failed)
        return out

    def run_backward(self, *args):
        return self._run("backward", None, args)

    def run_forward(self, scaling, *args):
        return self._run("forward", ScalingType(scaling), args)

    # ---- batched programs (SPFFT_TPU_BATCH_FUSE) ----------------------------------

    def batch_available(self) -> bool:
        """The knob is on, the plan runs fused (the staged and legacy paths
        have no batch axis, so their callers loop) and no batched program
        has taken the ``batch_fuse_failed`` rung."""
        enabled, _ = resolve_batch_fuse()
        return (enabled and self.path == "fused" and not self._batch_failed
                and bool(self.graphs["backward"].batch_inputs))

    def _batch_degrade(self, exc) -> None:
        """``batch_fuse_failed``: the batch axis is off for this plan; its
        callers loop, and the plan stays healthy."""
        self._record("batch_fuse_failed", exc)
        self._batch_failed = True
        for key in [k for k in self._programs if k[2] is not None]:
            del self._programs[key]

    def _run_batch(self, direction, scaling, args):
        """Stacked ``(B, ...)`` per-request inputs in, stacked results out, as
        one program; None when batching is unavailable or its rung was taken
        here (the caller loops)."""
        if not self.batch_available():
            return None
        batch = int(args[0].shape[0])
        key = (direction, scaling, batch)
        if self._group is not None and key not in self._agreed:
            return self._run_batch_in_step(direction, scaling, batch, args)
        if (direction, scaling) not in self._batch_keys:
            try:  # the fault site of this layer refusing to build
                faults.site("ir.batch")
            except faults.ENGINE_BUILD_ERRORS as e:
                self._batch_degrade(e)
                return None
            self._batch_keys.add((direction, scaling))
        prog = self._program(direction, scaling, batch)
        if key in self._compiled:
            out = prog(*args)
        else:
            try:
                out = prog(*args)
            except faults.ENGINE_BUILD_ERRORS as e:
                self._batch_degrade(e)
                return None
            self._compiled.add(key)
        self._batch_sizes.add(batch)
        dispatches["batched", direction] += 1
        obs.counter("ir_dispatches_total", mode="batched", direction=direction).inc()
        return out

    def _run_batch_in_step(self, direction, scaling, batch, args):
        """A batched program's first call over a process group: the
        processes agree on ``ir.batch`` before the batch issues a
        collective (a process that loops would interleave its calls' own
        all-reduces differently), then run it as :meth:`_run_in_step`; a
        capture that fails anywhere turns every process's batch axis off."""
        what = f"ir[{direction}, batch {batch}]"
        mine = None
        if (direction, scaling) not in self._batch_keys:
            try:
                faults.site("ir.batch")
            except faults.ENGINE_BUILD_ERRORS as e:
                mine = e
            behind = self._agree(mine is not None, what)
            if behind:
                self._batch_degrade(mine if mine is not None else MPIError(
                    f"{what}: {behind} process(es) of the group refused the batched program"))
                return None
            self._batch_keys.add((direction, scaling))
        out, failed = self._first_call(self._program(direction, scaling, batch),
                                       (direction, scaling, batch), what, args)
        if failed is not None:
            self._batch_degrade(failed)
        self._batch_sizes.add(batch)
        dispatches["batched", direction] += 1
        obs.counter("ir_dispatches_total", mode="batched", direction=direction).inc()
        return out

    def run_backward_batch(self, *args):
        return self._run_batch("backward", None, args)

    def run_forward_batch(self, scaling, *args):
        return self._run_batch("forward", ScalingType(scaling), args)

    # ---- describe -------------------------------------------------------------------

    def describe_batch(self) -> dict:
        """The plan card's ``batch`` section: whether the batched path is
        live, where the knob came from, the distinct batch sizes dispatched
        so far, and whether the axis took the ``batch_fuse_failed`` rung."""
        _, requested = resolve_batch_fuse()
        return dict(zip(BATCH_KEYS, (self.batch_available(), requested,
                                     sorted(self._batch_sizes), self._batch_failed)))

    def describe(self) -> dict:
        """The ``ir`` section (:data:`IR_KEYS`): path, where the choice came
        from, the stage lists per direction (None on the legacy path) and the
        donation map."""
        card = {
            "fused": self.fused,
            "path": self.path,
            "requested": self.requested,
            "stages": None if self.graphs is None else {
                "backward": self.graphs["backward"].stage_list(),
                "forward": self.graphs["forward"][ScalingType.NONE].stage_list(),
            },
            # Donation is not ported: PyTorch has no input donation, and the
            # fused program's static input buffers are what it saved.
            "donation": {"backward": [], "forward": []},
        }
        if self.staged_because:
            card["staged_because"] = self.staged_because
        return card


def _batched(graph, fn, batch: int):
    """The body of a batched program: ``fn`` once per request, on slices of
    the stacked ``batch_inputs``; the other inputs are shared."""
    idx = [i for i, name in enumerate(graph.inputs) if name in graph.batch_inputs]

    def body(*args):
        if any(args[i] is not None and args[i].shape[0] != batch for i in idx):
            raise InvalidParameterError(f"ir[{graph.direction}]: batch of {batch} expected")
        items = []
        for b in range(batch):
            item = list(args)
            for i in idx:
                if item[i] is not None:
                    item[i] = item[i][b]
            items.append(fn(*item))
        return items

    return body


def capture_refusal(engine):
    """Why ``engine``'s exchange cannot run inside a CUDA graph, or None: a
    CUDA plan over a process group whose backend is not NCCL (gloo runs its
    collectives on CUDA tensors through the host, outside any stream)."""
    if not getattr(engine, "collective", False) or torch.device(engine.device).type != "cuda":
        return None
    from ..parallel.mesh import _ask_group

    backend = str(_ask_group("get_backend", engine.mesh.group))
    if backend == "nccl":
        return None
    return (f"the exchange runs over a {backend} process group, whose collectives a CUDA "
            "graph cannot hold (NCCL's can)")


def init_engine_ir(engine, fuse=None) -> EngineIr:
    """Lower ``engine``, validate its graphs and choose its path: fused
    unless ``fuse=False`` or ``SPFFT_TPU_FUSE=0``, over a process group too;
    staged where :func:`capture_refusal` names a reason (``fuse=True``
    there raises). The rungs (module docstring) record on the plan being
    built, through the ambient :func:`spfft_tpu_torch.faults.collecting`
    sink."""
    from .lower import lower_engine

    fused, requested = resolve_fuse(fuse)
    because = capture_refusal(engine)
    if because is not None:
        if fused and requested == "kwarg":
            raise InvalidParameterError(f"fuse=True: {because} (it runs staged)")
        fused = False
    group = engine.mesh.group if getattr(engine, "collective", False) else None
    sink = faults.current_sink()
    # the IR's own refusals (validation, no lowering) are rungs too
    rung_errors = faults.ENGINE_BUILD_ERRORS + (InvalidParameterError,)
    try:
        faults.site("ir.lower")
        graphs = lower_engine(engine)
        graphs["backward"].validate()
        for g in graphs["forward"].values():
            g.validate()
    except rung_errors as e:
        faults.record_degradation("ir_lower_failed", faults.summarize(e))
        return EngineIr(None, path="legacy", requested=requested, device=engine.device,
                        engine=engine, group=group)
    path = "staged"
    if fused:
        try:
            faults.site("ir.compile")
            path = "fused"
        except rung_errors as e:
            faults.record_degradation("fuse_compile_failed", faults.summarize(e))
    ir = EngineIr(graphs, path=path, requested=requested, device=engine.device,
                  staged_because=because, sink=sink, group=group)
    obs.trace.event("decision", what="fuse", choice=ir.path)
    return ir
