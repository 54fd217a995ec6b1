"""Stage-graph IR: the typed pipeline description the engines lower to.

A :class:`StageGraph` describes one *direction* of a transform pipeline
(backward: decompress -> ... -> space; forward: space -> ... -> compress) as a
DAG of stage nodes joined by named edges. Nodes carry a canonical stage label
from :data:`NODES` and a ``fn`` that computes the node's outputs from its
input edges. Edges carry dtype and shape metadata (:class:`EdgeMeta`), so a
graph is validated before it runs: an unknown stage label, a dangling edge
(consumed but never produced), an edge produced twice, a dtype mismatch
across an edge, or a cycle raise :class:`~spfft_tpu_torch.errors.InvalidParameterError`
when the plan is made.

The graph is a scheduling representation, not a tensor IR: stage bodies stay
ordinary PyTorch callables (closures over engine constants).
:mod:`spfft_tpu_torch.ir.compile` runs a graph as one program per direction
(one CUDA-graph replay on the card) or node by node.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..errors import InvalidParameterError

# The canonical node vocabulary, the same literal as the JAX package's
# (spfft_tpu/ir/graph.py NODES); the exchange labels belong to the mesh
# engines ("A"/"B" to the pencil engines, the "overlapped" ones to the
# OVERLAPPED exchange's chunk collectives).
NODES = (
    "compression",
    "stick symmetry",
    "plane symmetry",
    "z transform",
    "y transform",
    "y transform sparse",
    "y transform blocked",
    "x transform",
    "expand",
    "pack",
    "exchange",
    "unpack",
    "pack A",
    "exchange A",
    "unpack A",
    "pack B",
    "exchange B",
    "unpack B",
    "exchange overlapped",
    "exchange A overlapped",
    "exchange B overlapped",
)


@dataclass(frozen=True)
class EdgeMeta:
    """Metadata of one edge: a numpy-comparable ``dtype`` (None: unchecked)
    and a ``shape`` (None: unknown)."""

    dtype: object = None
    shape: tuple | None = None


@dataclass(frozen=True)
class Node:
    """One pipeline stage: a canonical label, a body, and the edges it
    consumes and produces. ``name`` is unique per graph; ``fn(*inputs)``
    returns the single output when ``len(outputs) == 1``, else a sequence of
    ``len(outputs)`` values."""

    name: str
    stage: str
    fn: object
    inputs: tuple
    outputs: tuple


@dataclass
class StageGraph:
    """A validated, topologically orderable pipeline DAG for one direction."""

    direction: str  # "backward" | "forward"
    nodes: list = field(default_factory=list)
    inputs: list = field(default_factory=list)  # ordered input edge names
    outputs: list = field(default_factory=list)  # ordered output edge names
    meta: dict = field(default_factory=dict)  # edge name -> EdgeMeta
    # The input edges that carry per-request data (values, space): a batched
    # program runs the graph once per request on these, while every other
    # input is shared by the batch. Empty: the graph cannot batch.
    batch_inputs: tuple = ()
    # consumer dtype expectations: (edge, dtype) -> consumer node name
    expect: dict = field(default_factory=dict)

    def add_input(self, name: str, *, dtype=None, shape=None) -> None:
        """Declare a graph input edge (a caller-supplied value)."""
        if name in self.meta:
            raise InvalidParameterError(f"ir: duplicate edge {name!r}")
        self.inputs.append(name)
        self.meta[name] = EdgeMeta(dtype, None if shape is None else tuple(shape))

    def add(self, stage: str, fn, inputs, outputs, *, name: str | None = None,
            out_meta: dict | None = None) -> None:
        """Append a stage node. ``out_meta`` maps produced edge names to
        :class:`EdgeMeta` (missing entries are untyped edges)."""
        if stage not in NODES:
            raise InvalidParameterError(
                f"ir: unknown stage {stage!r}: not in the canonical node vocabulary "
                "(spfft_tpu_torch/ir/graph.py NODES)"
            )
        name = name or stage
        if any(n.name == name for n in self.nodes):
            raise InvalidParameterError(f"ir: duplicate node name {name!r}")
        inputs, outputs = tuple(inputs), tuple(outputs)
        for e in outputs:
            if e in self.meta:
                raise InvalidParameterError(f"ir: edge {e!r} produced more than once (node {name!r})")
            m = (out_meta or {}).get(e)
            self.meta[e] = m if m is not None else EdgeMeta()
        self.nodes.append(Node(name, stage, fn, inputs, outputs))

    def remove(self, name: str) -> None:
        """Drop node ``name`` and the edges it produced (a graph rewrite:
        the OVERLAPPED exchange's, :mod:`spfft_tpu_torch.ir.lower`)."""
        node = next((n for n in self.nodes if n.name == name), None)
        if node is None:
            raise InvalidParameterError(f"ir: no node {name!r} to remove")
        self.nodes.remove(node)
        for e in node.outputs:
            self.meta.pop(e, None)

    def set_outputs(self, names) -> None:
        self.outputs = list(names)

    def expect_dtype(self, node_name: str, edge: str, dtype) -> None:
        """Record that ``node_name`` expects ``edge`` to carry ``dtype``,
        checked against the producer's metadata in :meth:`validate`."""
        self.expect[(edge, dtype)] = node_name

    # ---- validation ------------------------------------------------------------

    def validate(self) -> None:
        """Raise :class:`InvalidParameterError` on the first structural defect."""
        produced = set(self.inputs)
        for node in self.nodes:
            produced.update(node.outputs)
        for node in self.nodes:
            for e in node.inputs:
                if e not in produced:
                    raise InvalidParameterError(
                        f"ir[{self.direction}]: dangling edge {e!r} consumed by node "
                        f"{node.name!r} but produced by no node or graph input"
                    )
        for e in self.outputs:
            if e not in produced:
                raise InvalidParameterError(
                    f"ir[{self.direction}]: graph output {e!r} is produced by no node"
                )
        for (edge, want), consumer in self.expect.items():
            m = self.meta.get(edge)
            if m is None or m.dtype is None or want is None:
                continue
            if np.dtype(m.dtype) != np.dtype(want):
                raise InvalidParameterError(
                    f"ir[{self.direction}]: dtype mismatch at edge {edge!r}: produced "
                    f"{np.dtype(m.dtype)} but {consumer!r} expects {np.dtype(want)}"
                )
        self.toposort()  # raises on cycles

    def toposort(self) -> list:
        """Nodes in dependency order; raises on cycles."""
        ready = set(self.inputs)
        remaining = list(self.nodes)
        order = []
        while remaining:
            progressed = False
            for node in list(remaining):
                if all(e in ready for e in node.inputs):
                    order.append(node)
                    ready.update(node.outputs)
                    remaining.remove(node)
                    progressed = True
            if not progressed:
                names = [n.name for n in remaining]
                raise InvalidParameterError(
                    f"ir[{self.direction}]: cycle or unsatisfiable dependency among nodes {names}"
                )
        return order

    # ---- introspection ---------------------------------------------------------

    def stage_list(self) -> list:
        """Stage labels in topological order (``describe()["ir"]["stages"]``)."""
        return [n.stage for n in self.toposort()]
