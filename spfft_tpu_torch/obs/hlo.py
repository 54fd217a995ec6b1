"""Compiled-program statistics: the op-class counts of a plan's backward
program, the element-granular gather/scatter detector, and what its
compilation cost. The port of ``spfft_tpu/obs/hlo.py``, under its names.

**What "compiled" means in the port.** In the JAX package a plan's compiled
program is its backward pipeline lowered to StableHLO and compiled by XLA.
In the port it is the program :mod:`spfft_tpu_torch.ir.compile` runs: the
function that ``compose`` builds from the backward stage graph, captured on a
CUDA plan into one CUDA graph. Its text is two records:

* **The op record** (:func:`recording`): one call of the program body under
  a ``TorchDispatchMode`` that keeps every aten (and ``c10d``) op with its
  operand and index shapes. The port's own kernels are counted at their
  entry points, as the classes :data:`K1` (``ops/complex_matmul.py``),
  :data:`K2` (``ops/row_gather.py``) and :data:`FFT` (``ops/line_fft.py``),
  with what runs inside them muted: so a CPU plan, whose wrappers run the
  plain versions, records the same classes as the plan on the card, as
  StableHLO is the same on every backend. :func:`hlo_op_class_counts` and
  :func:`element_granular_ops` read it.
* **The CUDA graph** (a CUDA plan): a fresh capture of the body into the
  plan's memory pool, with the CUDA runtime's DOT dump of the graph, whose
  nodes :func:`graph_node_counts` counts by kind and by kernel (K1's, K2's,
  the line FFT's, NCCL's and PyTorch's own). The plan's cached graphs are
  not touched.

The detector is the library home of the guard of
``tests/test_torch_rowgranular.py``, the twin of the JAX package's
``tests/test_pencil2_rowgranular.py``: on the TPU an element scatter made a
pencil plan about 230x slower while every CPU oracle test stayed green. In
the port the same regression would be an element-wise ``index_put_`` or
``gather`` where K2's row gather runs. Decompress and compress
(``ops/compression.py``) are one element ``index_copy_`` and one
``index_select`` on the flat stick table, which the rule counts where the
table holds more than :data:`METADATA_ELEMS` slots: on the H100 they
measured faster than row-granular copy plans of the same maps.

**Over a process group** the program issues collectives, so every process
of the group calls :func:`compiled_stats` (``report(include_compiled=True)``)
together, as it calls the plan. The processes agree twice on the group's
store, with no collective: before anything runs (a process whose fault
site refused counts as refusing) and after the capture (a process whose
capture failed). Unless every process is there and ready, every one raises
:class:`~spfft_tpu_torch.verify.checks.GroupFailure`, which the plan card
records as ``hlo_stats_unavailable``; a process that reports alone gives up
after :data:`AGREE_SECONDS` and issues nothing on the group, and the
group's next joint report agrees as if it had not (:func:`_agree`).
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os
import re
import tempfile
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Metadata lookups (branch tables, shard geometry) legitimately gather single
# elements out of tiny operands; data arrays are far larger.
METADATA_ELEMS = 4096
# The op classes of the port's kernels, counted at their wrappers' entry.
K1 = "k1"
K2 = "k2"
FFT = "fft"
# How long a process waits for the rest of its group to report with it.
AGREE_SECONDS = 60.0

# aten gather/scatter ops (without a trailing "_"): their data operand is
# their first argument, the source of a gather and the target of a scatter
_PER_DIM = ("index_select", "index_add", "index_copy")  # (self, dim, index, ...)
_PER_INDICES = ("index", "index_put", "_index_put_impl")  # (self, indices, ...)
_ELEMENTWISE = ("take", "gather", "scatter", "scatter_add", "scatter_reduce")
GATHER_SCATTER = _PER_DIM + _PER_INDICES + _ELEMENTWISE

_local = threading.local()


class Record:
    """What one call of a program dispatched: ``ops``, one ``(op, operand,
    detail)`` row each. ``operand`` is the data operand's type
    (``"16385xf32"``) for a gather or scatter class op, and ``detail`` its
    elements per index row; both are None elsewhere."""

    def __init__(self):
        self.ops = []
        self._muted = 0

    @contextlib.contextmanager
    def muted(self):
        """The ops of a kernel's wrapper are its own: none is recorded."""
        self._muted += 1
        try:
            yield
        finally:
            self._muted -= 1

    def kernel(self, op: str, operand) -> None:
        """One launch of the port's kernel ``op`` on the tensor ``operand``."""
        self.ops.append((op, _type_str(operand), None))


def _type_str(t) -> str:
    dt = str(t.dtype).removeprefix("torch.")
    short = {"float32": "f32", "float64": "f64", "complex64": "c64", "complex128": "c128",
             "int32": "i32", "int64": "i64", "bool": "i1"}.get(dt, dt)
    return "x".join([*(str(d) for d in t.shape), short])


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _per_index(base: str, args) -> int:
    """Elements one index row moves in a gather/scatter class op."""
    src = args[0]
    if base in _PER_DIM:
        dim = int(args[1]) % max(src.dim(), 1)
        return _numel(src.shape) // max(int(src.shape[dim]), 1) if src.dim() else 1
    if base in _PER_INDICES:
        # a dim an index covers is one element a row; a None index's dim and
        # the dims after the last index ride along as a slice
        pos, rest = 0, 1
        for idx in args[1]:
            if idx is None:
                rest *= int(src.shape[pos])
                pos += 1
            else:
                pos += idx.dim() if idx.dtype in (torch.bool, torch.uint8) else 1
        return rest * _numel(src.shape[pos:])
    return 1


class _Mode(TorchDispatchMode):
    """The dispatch mode that fills a :class:`Record`."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # no torch._dynamo around __torch_dispatch__: nothing here is compiled,
        # and its first import costs seconds
        return False

    def __init__(self, record):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rec = self.record
        if rec._muted:
            return out
        packet = func.overloadpacket
        name = packet.__name__
        ns = getattr(func, "namespace", "aten")
        op = name if ns == "aten" else f"{ns}.{name}"
        base = name.rstrip("_")
        if ns == "aten" and base in GATHER_SCATTER and args and torch.is_tensor(args[0]):
            rec.ops.append((op, _type_str(args[0]), _per_index(base, args)))
        else:
            rec.ops.append((op, None, None))
        return out


def recorder():
    """The :class:`Record` this thread is filling, or None."""
    return getattr(_local, "record", None)


@contextlib.contextmanager
def recording():
    """Record every op this thread dispatches inside the block; yields the
    :class:`Record`."""
    rec, prev = Record(), recorder()
    _local.record = rec
    try:
        with _Mode(rec):
            yield rec
    finally:
        _local.record = prev


def kernel_entry(fn):
    """The decorator of a kernel's wrapper: under :func:`recording`, the
    wrapper's own ops are muted (the wrapper records its class with
    :func:`kernel_ran`). Outside a recording it costs one lookup."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        rec = recorder()
        if rec is None:
            return fn(*args, **kwargs)
        with rec.muted():
            return fn(*args, **kwargs)

    return entry


def kernel_ran(op: str, operand) -> None:
    """One run of the port's kernel ``op`` on ``operand``, recorded under
    :func:`recording`: a wrapper calls it where it counts a launch, and on
    the CPU where its plain version stands in for one."""
    rec = recorder()
    if rec is not None:
        rec.kernel(op, operand)


def element_granular_ops(record, metadata_elems: int = METADATA_ELEMS):
    """``(op, operand, detail)`` rows for every gather/scatter class op in
    ``record`` that moves one element per index row out of or into an
    operand of more than ``metadata_elems`` elements (``detail``: 1, the
    elements per index row)."""
    bad = []
    for op, operand, per_index in record.ops:
        if operand is None or per_index != 1:
            continue
        if _numel(int(d) for d in operand.split("x")[:-1]) > metadata_elems:
            bad.append((op, operand, per_index))
    return bad


def hlo_op_class_counts(record) -> dict:
    """``{op_class: count}`` over a record, most frequent first: what the
    program spends its ops on (K1 and K2 launches, copies, collectives)."""
    counts: dict = {}
    for op, _, _ in record.ops:
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])))


# ---- the CUDA graph's nodes ----------------------------------------------------------

_NODE_RE = re.compile(r'label="\{([A-Z_]+)')
_KERNEL_RE = re.compile(r'label="\{KERNEL\s*\n\| \{ID \| \d+ \(topoId: \d+\) \| ([^\n\\]+)')
# kernel classes by a part of the (mangled) name: the source file of K1's, K2's
# and the line FFT's CUDA kernels, NCCL's device kernels; every other kernel
# is PyTorch's
KERNEL_CLASSES = ((K1, "complex_matmul"), (K2, "row_gather"), (FFT, "line_fft"),
                  ("nccl", "nccl"))


def graph_node_counts(dot: str) -> dict:
    """``{"total", "kinds", "kernels"}`` of a CUDA graph's DOT dump
    (``cudaGraphDebugDotPrint``): its nodes by kind (``kernel``, ``memcpy``,
    ``memset``, ``event_record``, ``wait_event``, ``empty``, ...), and its
    kernel nodes by class: :data:`K1`, :data:`K2`, :data:`FFT`, ``nccl`` and
    ``torch``."""
    kinds: dict = {}
    for kind in _NODE_RE.findall(dot):
        kinds[kind.lower()] = kinds.get(kind.lower(), 0) + 1
    kernels = {cls: 0 for cls, _ in KERNEL_CLASSES} | {"torch": 0}
    for name in _KERNEL_RE.findall(dot):
        low = name.lower()
        cls = next((c for c, part in KERNEL_CLASSES if part in low), "torch")
        kernels[cls] += 1
    return {"total": sum(kinds.values()), "kinds": dict(sorted(kinds.items())),
            "kernels": kernels}


# ---- agreement over a process group ----------------------------------------------------

def _agree(group, ready: bool, what: str) -> None:
    """One round of agreement on the group's store (module docstring):
    returns where every process of ``group`` is there and ready, else
    raises :class:`GroupFailure` on every process that took part.

    The round's number lives in the store, so every process joins the
    current one whatever it did alone before: the process that decides a
    round (the last to arrive, or one whose deadline passed) moves the
    number on before it writes the round's state, so a process that reads
    the state finds the next number there."""
    import torch.distributed as dist

    from ..verify.checks import GroupFailure

    try:
        ranks = dist.get_process_group_ranks(group)
        store = dist.distributed_c10d._get_default_store()
    except (RuntimeError, ValueError) as e:
        raise GroupFailure(f"{what}: the group's store is unavailable: {e}") from e
    base = "spfft_tpu_torch/hlo/" + ",".join(map(str, ranks))
    n = _text(store.compare_set(f"{base}/round", "", "1"))
    prefix = f"{base}/{n}"

    def decide(state: str) -> str:
        store.compare_set(f"{base}/round", n, str(int(n) + 1))
        return _text(store.compare_set(f"{prefix}/state", "", state))

    if not ready:
        store.set(f"{prefix}/refused", "1")
    if store.add(f"{prefix}/arrived", 1) == len(ranks):
        decide("refused" if store.check([f"{prefix}/refused"]) else "go")
    try:
        store.wait([f"{prefix}/state"], datetime.timedelta(seconds=AGREE_SECONDS))
    except RuntimeError:
        pass  # the deadline: the round is abandoned unless another process decided it
    state = decide("abandoned")
    if state != "go":
        raise GroupFailure(f"{what}: the group did not agree ({state}): every process of "
                           "a plan over a group reports it together")


def _text(value) -> str:
    return value.decode() if isinstance(value, bytes) else str(value)


# ---- the statistics ------------------------------------------------------------------


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def backward_inputs(transform):
    """Zeros of the shapes and dtypes of the backward program's inputs."""
    ex = transform._exec
    graphs = ex._ir.graphs
    if graphs is None:  # the legacy path: the lowering's metadata
        from ..ir.lower import lower_engine

        graphs = lower_engine(ex)
    g = graphs["backward"]
    return [torch.zeros(g.meta[name].shape, dtype=ex.torch_dtype, device=ex.device)
            for name in g.inputs]


def record_program(transform, direction: str = "backward", scaling=None):
    """The :class:`Record` of one eager call of the plan's ``direction``
    program on zero inputs (the forward program's: the backward program's
    outputs), and the call's outputs. Over a process group every process
    calls it together."""
    ir = transform._exec._ir
    args = backward_inputs(transform)
    if direction != "backward":
        from ..types import ScalingType

        scaling = ScalingType.NONE if scaling is None else scaling
        out = ir.body("backward")(*args)
        args = _flat(out) + ([None] if not isinstance(out, (tuple, list)) else [])
    body = ir.body(direction, scaling)
    with recording() as rec:
        out = body(*args)
    return rec, out


def compiled_stats(transform) -> dict:
    """Record (and on a CUDA plan, capture) the plan's backward program and
    report its statistics: the counterpart of the JAX package's
    ``compiled_stats(ex.lowered_backward())``.

    ``compile_seconds`` is the capture's and the instantiation's wall time
    on a CUDA plan, else the time of the recorded call; ``hlo_op_classes``
    and ``element_granular_ops`` come from the record; ``memory_analysis``
    holds ``argument_size_in_bytes`` and ``output_size_in_bytes`` (the
    static buffers), and on a CUDA plan ``temp_size_in_bytes``, the bytes the
    capture allocated in the plan's pool beside its outputs (every
    allocation, freed or not: a bound of the peak). A CUDA plan
    adds ``graph_nodes`` (:func:`graph_node_counts`). A CUDA plan that runs
    staged because its group's collectives cannot be captured is recorded
    as a CPU plan is, with no graph.

    Fault site ``hlo.stats`` fires before anything is read: the statistics
    are an optional layer of the plan card, so a failure here degrades
    ``report(include_compiled=True)`` (``obs.plancard`` owns that catch).
    """
    from .. import faults

    ex = transform._exec
    ir = ex._ir
    group = ir._group
    refusal = None
    try:
        faults.site("hlo.stats")
    except (RuntimeError, OSError) as e:
        if group is None:
            raise
        refusal = e
    if group is not None:
        _agree(group, refusal is None, "compiled_stats")
    if refusal is not None:
        raise refusal
    args = backward_inputs(transform)
    body = ir.body("backward")
    if ex.device.type != "cuda" or ir.staged_because:
        t0 = time.perf_counter()
        with recording() as rec:
            out = body(*args)
        stats = _stats(rec, time.perf_counter() - t0)
        stats["memory_analysis"] = {"argument_size_in_bytes": _nbytes(args),
                                    "output_size_in_bytes": _nbytes(_flat(out))}
        return stats
    return _captured_stats(ir, body, args, group)


def _stats(rec, seconds) -> dict:
    return {"compile_seconds": seconds, "hlo_op_classes": hlo_op_class_counts(rec),
            "element_granular_ops": len(element_granular_ops(rec))}


def _captured_stats(ir, body, args, group) -> dict:
    """A CUDA plan's fresh capture of ``body`` into its pool, recorded and
    dumped; over a group the processes agree on the capture before any
    replays it (none does: the graph is dropped)."""
    from ..ir.compile import capture

    device = ir.device
    rec_box = []

    @contextlib.contextmanager
    def around():
        with recording() as rec:
            rec_box.append(rec)
            yield

    failure, graph = None, None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "backward.dot")
        try:
            # one eager call first (the kernels' libraries, cuFFT's plans), so
            # that compile_seconds is the capture's and instantiation's alone
            body(*args)
            torch.cuda.synchronize(device)
            # keep_graph: the cudaGraph_t outlives instantiation, for the dump
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = torch.cuda.memory_stats(device).get("allocated_bytes.all.allocated", 0)
            t0 = time.perf_counter()
            graph, static_in, static_out = capture(body, args, device, ir._pool, warm=False,
                                                   graph=graph, around=around)
            graph.instantiate()
            seconds = time.perf_counter() - t0
            allocated = torch.cuda.memory_stats(device).get("allocated_bytes.all.allocated", 0)
            _dot_print(graph.raw_cuda_graph(), path)
            with open(path) as f:
                dot = f.read()
        except (RuntimeError, OSError) as e:
            failure = e
        finally:
            if graph is not None:
                graph.reset()  # the stats graph never outlives the call
        if group is not None:
            _agree(group, failure is None, "compiled_stats capture")
        if failure is not None:
            raise failure
    out = _flat(static_out)
    stats = _stats(rec_box[0], seconds)
    stats["memory_analysis"] = {
        "argument_size_in_bytes": _nbytes(static_in),
        "output_size_in_bytes": _nbytes(out),
        "temp_size_in_bytes": max(0, allocated - before - _nbytes(static_in) - _nbytes(out)),
    }
    stats["graph_nodes"] = graph_node_counts(dot)
    return stats


def _dot_print(raw_graph: int, path: str) -> None:
    """The CUDA runtime's DOT dump of a graph (``cudaGraphDebugDotPrint``,
    verbose), through the runtime library the process has loaded; not
    ``CUDAGraph.debug_dump``, whose debug mode is process-wide and keeps every
    later graph's ``cudaGraph_t`` alive."""
    import ctypes

    major = int(str(torch.version.cuda).split(".")[0])
    runtime = ctypes.CDLL(f"libcudart.so.{major}")
    fn = runtime.cudaGraphDebugDotPrint
    fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]
    fn.restype = ctypes.c_int
    err = fn(ctypes.c_void_p(raw_graph), path.encode(), 1)  # cudaGraphDebugDotFlagsVerbose
    if err:  # the card records it as hlo_stats_unavailable, as a failed write
        raise OSError(f"cudaGraphDebugDotPrint failed: cudaError {err}")  # noqa: SA010

