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
:class:`~spfft_tpu_torch.errors.GPUError`. A mesh plan whose exchange is a
``torch.distributed`` collective (NCCL under graph capture is later work)
runs staged, says so in ``describe()`` (``"staged_because"``), and raises
on ``fuse=True``.

:data:`dispatches` counts program calls by ``(mode, direction)``: staged adds
one per node (added once per call), fused one per direction, batched one per
batch and direction; the metrics registry's ``ir_dispatches_total{mode,
direction}`` counts the same. On the staged path each node runs under
``timing.trace_annotation(<its stage label>)``, so a ``torch.profiler``
trace names each stage's device time; with no profiler running that is the
shared no-op scope. Every count, scope and span sits
outside the captured region: host code inside a capture runs once at capture
and never at a replay.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import threading

import torch

from .. import faults, knobs, obs, timing
from ..errors import GPUError, InvalidParameterError
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


def compose(graph):
    """The graph as one function: ``fn(*args)`` binds ``args`` to the input
    edges in order, runs the nodes in topological order and returns the
    output edges (a bare value for one output, else a tuple).
    ``fn.stage`` names the node that ran last, for error reports."""
    order = graph.toposort()

    def fn(*args):
        env = _bind(graph, args)
        for node in order:
            fn.stage = node.stage
            _run_node(env, node)
        return _results(graph, env)

    fn.stage = None
    return fn


class StagedProgram:
    """The per-node reference executor: each node is its own eager call."""

    def __init__(self, graph):
        self.graph = graph
        self.order = graph.toposort()

    def __call__(self, *args):
        env = _bind(self.graph, args)
        for node in self.order:
            with timing.trace_annotation(node.stage):
                _run_node(env, node)
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
_CAPTURE_LOCK = threading.Lock()


class _Program:
    """One program: ``body`` in one eager call on a CPU plan; on a CUDA plan
    one CUDA graph of ``body``, captured at the first call. ``finish`` turns
    the body's outputs into the caller's results (new tensors)."""

    def __init__(self, body, finish, device, pool, what, stage):
        self.body, self.finish, self.device, self.pool = body, finish, device, pool
        self.what, self.stage = what, stage  # for error reports
        self._captured = None  # (CUDAGraph, static inputs, static outputs)

    def __call__(self, *args):
        if self.device.type != "cuda":
            return self.finish(self.body(*args))
        if self._captured is None:
            self._capture(args)
        graph, static_in, static_out = self._captured
        for buf, a in zip(static_in, args):
            if (buf is None) != (a is None) or (buf is not None and buf.shape != a.shape):
                raise InvalidParameterError(
                    f"{self.what}: inputs differ from those the graph was captured on"
                )
            if buf is not None:
                buf.copy_(a)
        try:
            graph.replay()
        except RuntimeError as e:
            raise GPUError(f"{self.what}: CUDA graph replay failed: {e}") from e
        return self.finish(static_out)

    def _capture(self, args) -> None:
        """Static inputs holding ``args``, one eager run on a side stream
        (cuFFT plans, the allocator, the kernels' libraries), then the
        capture into the plan's pool.

        The capture is ``thread_local``: other threads may go on allocating,
        building plans and copying results to the host while it runs (a
        serving dispatcher captures a new batch size while its callers read
        their results), which the default ``global`` mode refuses and which
        would invalidate the capture. Captures of the process take turns
        (:data:`_CAPTURE_LOCK`): ``torch.cuda.graph`` synchronizes the device
        and empties the allocator's cache before it captures, which must not
        meet another thread's capture."""
        with _CAPTURE_LOCK, torch.cuda.device(self.device):
            static_in = [None if a is None else a.to(self.device).clone(
                memory_format=torch.contiguous_format) for a in args]
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            try:
                with torch.cuda.stream(side):
                    self.body(*static_in)
                current.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                # held across the capture on purpose: captures take turns
                with no_collection(), torch.cuda.graph(graph, pool=self.pool,  # noqa: SA011
                                                       capture_error_mode="thread_local"):
                    static_out = self.body(*static_in)
            except Exception as e:  # the class is kept: EngineIr decides the rung
                # a capture that fails inside torch.cuda.graph leaves its
                # stream current: the caller's comes back
                torch.cuda.set_stream(current)
                e.add_note(f"{self.what}: CUDA graph capture failed at stage {self.stage()!r}")
                raise
        self._captured = (graph, static_in, static_out)


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
                 engine=None):
        self.graphs = graphs  # {"backward": g, "forward": {ScalingType: g}}; None: legacy
        self.path = path  # "fused" | "staged" | "legacy"
        self.requested = requested
        self.staged_because = staged_because
        self.device = torch.device(device)
        # the plan's live degradations list, kept from the scope the engine
        # was built in, so that a rung taken at a first dispatch lands on it
        self._sink = sink
        self._engine = engine  # the legacy path's stage bodies
        # the memory pool of this plan's CUDA graphs: every result is copied
        # out of it right after its replay, on the same stream, so a graph
        # may reuse what another one freed
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self._programs = {}  # (direction, scaling or None, B or None) -> program
        self._compiled = set()  # keys of the programs whose first call succeeded
        self._batch_keys = set()  # (direction, scaling) whose batched build passed ir.batch
        self._batch_failed = False
        self._batch_sizes = set()  # distinct batch sizes dispatched (the card)
        if path == "staged":
            self._install_staged()

    def _install_staged(self) -> None:
        self._programs = {("backward", None, None): StagedProgram(self.graphs["backward"])}
        for s, g in self.graphs["forward"].items():
            self._programs["forward", s, None] = StagedProgram(g)

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

    def _program(self, direction, scaling, batch=None):
        key = (direction, scaling, batch)
        prog = self._programs.get(key)
        if prog is None:
            graph = self._graph(direction, scaling)
            fn = compose(graph)
            what = f"ir[{direction}{'' if scaling is None else ', ' + scaling.name}" + (
                "]" if batch is None else f", batch {batch}]")
            if batch is None:
                body, finish = fn, (_clone if self.device.type == "cuda" else (lambda out: out))
            else:
                body, finish = _batched(graph, fn, batch), _stack
            prog = _Program(body, finish, self.device, self._pool, what, lambda: fn.stage)
            self._programs[key] = prog
        return prog

    def _run(self, direction, scaling, args):
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


COLLECTIVE_STAGED = ("the exchange is a torch.distributed collective, which this port "
                     "does not capture into a CUDA graph")


def init_engine_ir(engine, fuse=None) -> EngineIr:
    """Lower ``engine``, validate its graphs and choose its path: fused
    unless ``fuse=False`` or ``SPFFT_TPU_FUSE=0``, and staged for a mesh
    engine whose exchange is a collective (``fuse=True`` there raises). The
    rungs (module docstring) record on the plan being built, through the
    ambient :func:`spfft_tpu_torch.faults.collecting` sink."""
    from .lower import lower_engine

    fused, requested = resolve_fuse(fuse)
    because = None
    if getattr(engine, "collective", False):
        if fused and requested == "kwarg":
            raise InvalidParameterError(f"fuse=True: {COLLECTIVE_STAGED} (it runs staged)")
        fused, because = False, COLLECTIVE_STAGED
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
                        engine=engine)
    path = "staged"
    if fused:
        try:
            faults.site("ir.compile")
            path = "fused"
        except rung_errors as e:
            faults.record_degradation("fuse_compile_failed", faults.summarize(e))
    ir = EngineIr(graphs, path=path, requested=requested, device=engine.device,
                  staged_because=because, sink=sink)
    obs.trace.event("decision", what="fuse", choice=ir.path)
    return ir
