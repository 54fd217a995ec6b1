"""The ``DistributedTransform`` public API object: a transform over P shards.

The port of the JAX package's ``spfft_tpu/distributed.py`` (the reference's
MPI transforms, include/spfft/grid.hpp:89-141,
include/spfft/transform.hpp:102-131): the 1-D slab decomposition over
:func:`~spfft_tpu_torch.parallel.mesh.make_fft_mesh`, and the 2-D pencil
decomposition over :func:`~spfft_tpu_torch.parallel.mesh.make_fft_mesh2`
(engines ``"pencil2"`` and ``"pencil2-mxu"``, :mod:`.parallel.pencil2`),
where shard ``s`` holds the ``(local_z_length(s), local_y_length(s), X)``
block of space. Per-shard quantities are lists indexed by the global shard
id. The shards of a process sit stacked on its device:

* one process, no process group: ``backward`` takes the P value lists and
  returns the global ``(Z, Y, X)`` space tensor; the exchange is a gather on
  the device and each direction runs fused (one CUDA graph on the card);
* processes joined by a group: each process passes its own shards' values
  (None for the others') and gets its shards' slabs (pencil blocks) back;
  the exchange is ``torch.distributed.all_to_all_single`` and the plan runs
  staged.

``forward`` returns the per-shard packed values (None for another
process's). Results are tensors on the plan's device.

Observability as the local ``Transform`` and the JAX package's plan: a
``plan`` operation with ``decision`` events (engine, exchange), ``execute``
operations with the timing scopes and the completion fence, and
``exchange_wire_bytes_total`` per dispatch; the plan card is :meth:`report`.
``guard=`` and ``verify=`` as on the local ``Transform``; an ``mxu`` engine
that fails to build falls back to ``torch.fft`` over the same mesh and
discipline (``pencil2-mxu`` to ``pencil2``), and an exchange that fails to
build (fault site ``exchange.build``) raises :class:`MPIError`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import faults, obs, timing, tuning
from .errors import InvalidParameterError, MPIError
from .grid import Grid
from .ops.fft import resolve_precision
from .parallel.execution import DistributedExecution
from .parallel.execution_mxu import MxuDistributedExecution
from .parallel.mesh import fft_mesh_size, is_pencil2_mesh
from .parallel.pencil2 import Pencil2Execution
from .parallel.pencil2_mxu import MxuPencil2Execution
from .parallel.policy import (discipline_volumes, resolve_default_for_plan,
                              resolve_overlap_chunks, resolve_policy)
from .parameters import (DistributedParameters, distribute_triplets,
                         make_distributed_parameters)
from .sync import fence
from .transform import (_Observed, _resolve_batch_count, _validate_data_location,
                        reference_parts, storage_triplets_from)
from .types import (ExchangeType, ExecType, IndexFormat, ProcessingUnit, ScalingType,
                    TransformType, wire_scalar_bytes)


class DistributedTransform(_Observed):
    """A sparse 3-D FFT plan sharded over a :class:`~.parallel.mesh.ShardMesh`.

    ``indices``: a list of per-shard triplet arrays (every shard's, on every
    process: the plan needs the global stick tables), or one global triplet
    array, distributed by whole z-sticks with balanced value counts
    (:func:`~spfft_tpu_torch.parameters.distribute_triplets`; on a pencil
    mesh column by column, ``layout=(P1, P2)``).
    ``engine``: ``"mxu"`` (K1/K2), ``"xla"`` (``torch.fft``) or ``"auto"``
    (``"xla"`` on a CPU mesh, ``"mxu"`` on the card); on a pencil mesh the
    plan's engine is named ``"pencil2-mxu"`` or ``"pencil2"`` (which it also
    takes). ``exchange_type``
    DEFAULT resolves through :mod:`~spfft_tpu_torch.parallel.policy` on a slab
    mesh, inside the engine on a pencil mesh (the JAX package's cost model).
    ``local_z_lengths`` cut the slabs of a slab mesh; a pencil mesh splits
    z and y evenly.
    ``overlap`` takes only 1: the OVERLAPPED exchange is not ported and
    raises. ``policy="tuned"`` (None reads ``SPFFT_TPU_POLICY``) resolves a
    DEFAULT exchange by measurement on a slab or pencil mesh
    (:mod:`spfft_tpu_torch.tuning`; the model over more than one process),
    its record in ``report()["tuning"]``.
    A process group that fails while the exchange is built raises
    :class:`MPIError`; no engine takes its place. ``guard`` and ``verify``
    as on :class:`~spfft_tpu_torch.transform.Transform`. Over a process
    group every process verifies the global transform from its own shards:
    the checks' sums meet in one all-reduce a call, and the reference rung
    gathers what it needs, so every process of the group must make the same
    verified calls. Guard's input check meets the group's in one all-reduce
    a call, so a bad input on one process raises on every process.
    """

    def __init__(self, processing_unit, transform_type, dim_x, dim_y, dim_z, indices, *,
                 mesh=None, local_z_lengths=None,
                 exchange_type: ExchangeType = ExchangeType.DEFAULT,
                 index_format: IndexFormat = IndexFormat.TRIPLETS, grid: Grid | None = None,
                 dtype=None, engine: str = "auto", precision: str = "highest",
                 policy: str | None = None, overlap: int | None = None,
                 guard: bool | None = None, verify=None, fuse=None):
        if IndexFormat(index_format) != IndexFormat.TRIPLETS:
            raise InvalidParameterError("only SPFFT_INDEX_TRIPLETS is supported")
        if mesh is None and grid is not None:
            mesh = grid.mesh
        if mesh is None:
            raise InvalidParameterError("a distributed transform needs a mesh (make_fft_mesh)")
        num_shards = fft_mesh_size(mesh)
        if isinstance(indices, (list, tuple)):
            per_shard = [np.asarray(t).reshape(-1, 3) for t in indices]
        elif is_pencil2_mesh(mesh):
            per_shard = distribute_triplets(np.asarray(indices), num_shards, int(dim_y),
                                            layout=mesh.shape, dim_x=int(dim_x))
        else:
            per_shard = distribute_triplets(np.asarray(indices), num_shards, int(dim_y))
        params = make_distributed_parameters(TransformType(transform_type), dim_x, dim_y, dim_z,
                                             per_shard, local_z_lengths)
        self._setup(processing_unit, params, mesh, grid, exchange_type, dtype, engine,
                    precision, policy, overlap, fuse, guard, verify)

    @classmethod
    def from_parameters(cls, processing_unit, params: DistributedParameters, *, mesh,
                        exchange_type=ExchangeType.DEFAULT, grid: Grid | None = None,
                        dtype=None, engine: str = "auto", precision: str = "highest",
                        policy=None, overlap=None, fuse=None, guard=None,
                        verify=None) -> "DistributedTransform":
        """A plan from already built parameters, e.g. carried over from the
        JAX package by :func:`~spfft_tpu_torch.parameters.from_jax_distributed_params`."""
        self = cls.__new__(cls)
        self._setup(processing_unit, params, mesh, grid, exchange_type, dtype, engine,
                    precision, policy, overlap, fuse, guard, verify)
        return self

    def _setup(self, processing_unit, params, mesh, grid, exchange_type, dtype, engine,
               precision, policy, overlap, fuse, guard=None, verify=None):
        self._processing_unit = ProcessingUnit(processing_unit)
        on_card = mesh.device.type == "cuda"
        if (self._processing_unit == ProcessingUnit.GPU) != on_card:
            raise InvalidParameterError(
                f"processing unit {self._processing_unit.name} does not match the mesh's "
                f"device {mesh.device}")
        self._params, self._mesh, self._grid = params, mesh, grid
        p = params
        exchange_type = ExchangeType(exchange_type)
        if grid is not None:
            if p.dim_x > grid.max_dim_x or p.dim_y > grid.max_dim_y or p.dim_z > grid.max_dim_z:
                raise InvalidParameterError("transform dimensions exceed grid maxima")
            if p.max_num_sticks > grid.max_num_local_z_columns:
                raise InvalidParameterError("more z-columns than grid maximum")
            if p.max_local_z_length > grid.max_local_z_length:
                raise InvalidParameterError("local z length exceeds grid maximum")
            if exchange_type == ExchangeType.DEFAULT:
                exchange_type = grid.exchange_type
        self._real_dtype = np.dtype(np.float64 if dtype is None else dtype)
        if self._real_dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise InvalidParameterError("dtype must be float32 or float64")
        self._policy = resolve_policy(policy)
        self._tuning = None  # the tuned decision's record (tuning._record)
        resolve_overlap_chunks(overlap)
        self._requested_exchange = exchange_type
        self._precision = resolve_precision(precision)
        self._guard = faults.guard_enabled(guard)
        self._degradations: list = []  # the rungs taken (the plan card's degradations)
        self._run_id = obs.trace.new_run_id()
        pencil = is_pencil2_mesh(mesh)
        with obs.trace.operation("plan", run_id=self._run_id, kind="distributed"):
            if exchange_type == ExchangeType.DEFAULT and self._policy == "tuned":
                # trial plans name their discipline and take the model
                # policy, so tuning cannot recurse
                def trial(cand):
                    return DistributedTransform.from_parameters(
                        self._processing_unit, p, mesh=mesh,
                        exchange_type=ExchangeType[cand["exchange_type"]],
                        dtype=self._real_dtype, engine=engine, precision=self._precision,
                        policy="default", fuse=fuse, guard=False, verify=False)

                with faults.collecting(self._degradations):
                    exchange_type, self._tuning = tuning.tuned_exchange(
                        p, mesh, self._real_dtype, engine, self._precision, pencil, trial)
            if exchange_type == ExchangeType.DEFAULT and not pencil:
                exchange_type = resolve_default_for_plan(p)
            if engine == "auto":  # the JAX package's rule (spfft_tpu/distributed.py:208-209)
                engine = "xla" if mesh.device.type == "cpu" else "mxu"
            if pencil and engine in ("pencil2", "pencil2-mxu"):  # a plan's own name
                engine = "mxu" if engine == "pencil2-mxu" else "xla"
            if engine not in ("xla", "mxu"):
                raise InvalidParameterError(f"unknown engine {engine!r}")
            name = {("mxu", True): "pencil2-mxu", ("xla", True): "pencil2"}

            def build(which):
                """The engine ``which`` (a pencil engine resolves DEFAULT
                itself, with its x-group strategy); fault site
                ``engine.compile`` guards the mxu engines."""
                if which == "mxu":
                    faults.site("engine.compile")
                engine_class = {("mxu", False): MxuDistributedExecution,
                                ("xla", False): DistributedExecution,
                                ("mxu", True): MxuPencil2Execution,
                                ("xla", True): Pencil2Execution}[which, pencil]
                args = (self._precision,) if which == "mxu" else ()
                return engine_class(p, self._real_dtype, mesh, exchange_type, *args, fuse=fuse)

            # Ladder rung 1: an mxu engine that fails to build falls back to
            # torch.fft over the same mesh and discipline; a failure with no
            # rung below it (the torch.fft engine, the exchange: fault site
            # exchange.build) raises MPIError.
            with faults.collecting(self._degradations):
                try:
                    self._exec = build(engine)
                except faults.ENGINE_BUILD_ERRORS as e:
                    if engine != "mxu":
                        raise MPIError(f"distributed engine construction failed: {e}") from e
                    faults.engine_fallback(name.get(("mxu", pencil), "mxu"),
                                           name.get(("xla", pencil), "xla"), faults.summarize(e))
                    engine = "xla"
                    try:
                        self._exec = build("xla")
                    except faults.ENGINE_BUILD_ERRORS as e2:
                        raise MPIError(f"distributed engine construction failed: {e2}") from e2
            self._engine = name.get((engine, pencil), engine)
            if self._tuning is not None:
                self._tuning = tuning.with_k1_form(self._tuning, self._exec)
            obs.trace.event("decision", what="engine", choice=self._engine, policy=self._policy)
            obs.trace.event("decision", what="exchange", choice=self.exchange_type.name,
                            overlap=self.overlap_chunks)
        self._exec_mode = ExecType.SYNCHRONOUS
        self._space_data = None  # native: (re, im) for C2C, re for R2C
        # a plan constant, counted on every call: summed here once
        self._wire_bytes = self.exchange_wire_bytes()
        # over a process group (one process included) the checks reduce
        # their sums over the group (_check_shards)
        self._init_verify(verify)

    # ---- transforms -----------------------------------------------------------------

    def backward(self, values, output_location: ProcessingUnit | None = None):
        """Per-shard packed values (a list over all P shards, None for another
        process's) -> the global ``(Z, Y, X)`` space tensor, or, across
        processes, this process's per-shard slabs (None for the others')."""
        if output_location is not None:
            _validate_data_location(output_location)
        with self._execute("backward"):
            self._guard_input(values, "backward")
            if self._verifier is not None:
                return self._verifier.backward(values)
            return self._backward_attempt(values)

    def forward(self, space=None, scaling: ScalingType = ScalingType.NONE,
                input_location: ProcessingUnit | None = None):
        """A global ``(Z, Y, X)`` space (or per-shard slabs; None: the
        retained space of the last backward) -> per-shard packed values."""
        if input_location is not None:
            _validate_data_location(input_location)
        with self._execute("forward"):
            self._guard_input(space, "forward")
            if self._verifier is not None:
                return self._verifier.forward(space, scaling)
            return self._forward_attempt(space, scaling)

    def _backward_attempt(self, values):
        """One whole backward: the unit the verify supervisor runs again."""
        out = self._dispatch_backward(values)
        self._wait(out, "backward")
        with timing.scoped("output staging"):
            result = self._exec.unpad_space(out)
        if self._guard:
            self._guard_space(result)
        return result

    def _forward_attempt(self, space, scaling):
        """One whole forward: the supervisor's unit of :meth:`forward`."""
        pair = self._dispatch_forward(space, scaling)
        self._wait(pair, "forward")
        with timing.scoped("output staging"):
            result = self._exec.unpad_values(pair)
        if self._guard:
            faults.check_array(result, check="forward output", platform=self._platform)
        return result

    def _guard_input(self, data, direction: str) -> None:
        """Guard's check of a call's input. Over a process group the
        processes agree before the exchange: each one's verdict meets the
        others' in one all-reduce, and a bad input on any of them raises the
        same typed error on every one."""
        if not self._guard or self._mesh.group is None:
            return super()._guard_input(data, direction)
        mine = None
        try:
            super()._guard_input(data, direction)
        except faults.execution_error(self._platform) as e:
            mine = e
        from .verify.checks import group_scalar

        failed = int(group_scalar(mine is not None, self._mesh.group, self.device))
        if mine is not None:
            raise mine
        if failed:
            raise faults.execution_error(self._platform)(
                f"guard [{direction} input]: failed on {failed} other process(es) of the group")

    def _guard_space(self, result) -> None:
        """Guard's check of a backward result: the global slab's values and
        shape; per-shard slabs (across processes) their values."""
        faults.check_array(result, check="backward output", platform=self._platform,
                           shape=None if isinstance(result, (list, tuple))
                           else (self.dim_z, self.dim_y, self.dim_x))

    # split phases (multi_transform)
    def _dispatch_backward(self, values):
        with timing.scoped("input staging"):
            pair = self._exec.pad_values(values)
        self._record_wire_bytes()
        with self._dispatching("backward"):
            out = self._exec.backward_pair(*pair)
            out = faults.site("engine.execute", payload=out)
        self._space_data = out
        return out

    def _finalize_backward(self, out):
        self._wait(out)
        return self._exec.unpad_space(out)

    def _dispatch_forward(self, space, scaling):
        if space is None:
            if self._space_data is None:
                raise InvalidParameterError(
                    "no space domain data: run backward first or pass an array")
        else:
            with timing.scoped("input staging"):
                self._retain_space(space)
        self._record_wire_bytes()
        with self._dispatching("forward"):
            pair = self._exec.forward_pair(*self._parts(self._space_data),
                                           ScalingType(scaling))
            return faults.site("engine.execute", payload=pair)

    def _finalize_forward(self, pair):
        self._wait(pair)
        return self._exec.unpad_values(pair)

    def _record_wire_bytes(self) -> None:
        """Count one exchange's wire bytes into ``exchange_wire_bytes_total``
        (a no-op with metrics off)."""
        obs.counter("exchange_wire_bytes_total", engine=self._engine).inc(self._wire_bytes)

    def _retain_space(self, space) -> None:
        """Stage a space as the retained native data (also the supervisor's:
        a verified recovery replaces a failed result)."""
        re, im = self._exec.pad_space(space)
        self._space_data = re if self._is_r2c else (re, im)

    def _parts(self, data):
        return (data, None) if self._is_r2c else data

    # ---- device-side entry points, in the stacked native layout ----------------------

    def backward_pair(self, values_re, values_im):
        """Stacked ``(P_local, V_max)`` (re, im) values -> the native space
        (:attr:`space_domain_layout`), retained for :meth:`forward_pair`."""
        put = lambda v: torch.as_tensor(v, dtype=self._exec.torch_dtype,
                                        device=self.device).reshape(self._exec.num_local, -1)
        self._space_data = self._exec.backward_pair(put(values_re), put(values_im))
        return self._space_data

    def forward_pair(self, scaling: ScalingType = ScalingType.NONE):
        """Forward over the retained native space: the stacked value pair."""
        if self._space_data is None:
            raise InvalidParameterError("no space domain data: run backward first")
        return self._exec.forward_pair(*self._parts(self._space_data), ScalingType(scaling))

    # ---- batches of one plan ----------------------------------------------------------

    def backward_batch(self, values_batch, *, fallback: bool = True, count: int | None = None):
        """B backwards as one program per direction (one CUDA-graph replay on
        the card); a loop of :meth:`backward` where batching is unavailable
        (the knob off, a staged plan), or None with ``fallback=False``."""
        values_batch = list(values_batch)
        if not values_batch:
            return []
        count = _resolve_batch_count(count, len(values_batch))
        if self._verifier is None and self._exec._ir.batch_available():
            with self._execute("backward", count):
                for v in values_batch[:count]:
                    self._guard_input(v, "backward")
                with timing.scoped("input staging"):
                    pairs = [self._exec.pad_values(v) for v in values_batch]
                    re = torch.stack([p[0] for p in pairs])
                    im = torch.stack([p[1] for p in pairs])
                with self._dispatching("backward"):
                    out = self._exec.backward_pair_batch(re, im)
                    if out is not None:
                        out = faults.site("engine.execute", payload=out)
                if out is not None:  # None: the batch_fuse_failed rung, so loop
                    self._wait(out, "backward")
                    with timing.scoped("output staging"):
                        pick = ((lambda b: out[b]) if self._is_r2c
                                else (lambda b: (out[0][b], out[1][b])))
                        results = [self._exec.unpad_space(pick(b)) for b in range(count)]
                    if self._guard:
                        for result in results:
                            self._guard_space(result)
                    return results
        # the loop, each request under its supervisor if verified
        return [self.backward(v) for v in values_batch[:count]] if fallback else None

    def forward_batch(self, spaces, scaling: ScalingType = ScalingType.NONE, *,
                      fallback: bool = True, count: int | None = None):
        """B spaces -> B per-shard value lists, as :meth:`backward_batch`."""
        spaces = list(spaces)
        if not spaces:
            return []
        count = _resolve_batch_count(count, len(spaces))
        if self._verifier is None and self._exec._ir.batch_available():
            with self._execute("forward", count):
                for s in spaces[:count]:
                    self._guard_input(s, "forward")
                with timing.scoped("input staging"):
                    natives = [self._exec.pad_space(s) for s in spaces]
                    re = torch.stack([n[0] for n in natives])
                    im = None if self._is_r2c else torch.stack([n[1] for n in natives])
                with self._dispatching("forward"):
                    out = self._exec.forward_pair_batch(re, im, ScalingType(scaling))
                    if out is not None:
                        out = faults.site("engine.execute", payload=out)
                if out is not None:  # None: the batch_fuse_failed rung, so loop
                    self._wait(out, "forward")
                    with timing.scoped("output staging"):
                        results = [self._exec.unpad_values((out[0][b], out[1][b]))
                                   for b in range(count)]
                    if self._guard:
                        for result in results:
                            faults.check_array(result, check="forward output",
                                               platform=self._platform)
                    return results
        return [self.forward(s, scaling) for s in spaces[:count]] if fallback else None

    # ---- retained data ----------------------------------------------------------------

    def space_domain_data(self, processing_unit: ProcessingUnit | None = None):
        """The most recent space-domain result: for GPU the retained native
        tensors (:attr:`space_domain_layout`); else on the host, the global
        ``(Z, Y, X)`` numpy array, or across processes this process's
        per-shard slabs (None for the others')."""
        if self._space_data is None:
            raise InvalidParameterError("no space domain data available yet")
        if processing_unit is not None and _validate_data_location(
                processing_unit) == ProcessingUnit.GPU:
            return self._space_data
        native = self._parts(self._space_data)
        obs.counter("staged_bytes_total", direction="device_to_host").inc(
            sum(t.numel() * t.element_size() for t in native if t is not None))
        out = self._exec.unpad_space(self._space_data)
        if isinstance(out, list):
            return [None if s is None else s.cpu().numpy() for s in out]
        return out.cpu().numpy()

    def space_domain_data_local(self, shard: int):
        """Shard ``shard``'s ``(local_z_length, Y, X)`` slab of the most
        recent result, on a pencil mesh its ``(local_z_length,
        local_y_length, X)`` block, on the host (the reference's per-rank
        pointer); the shard must be this process's."""
        if self._space_data is None:
            raise InvalidParameterError("no space domain data available yet")
        local = list(self._mesh.local_shards)
        if shard not in local:
            raise InvalidParameterError(f"shard {shard} is not this process's ({local})")
        if self._pencil:
            return self._exec.local_block(self._space_data, shard).cpu().numpy()
        full = self._space_data if self._is_r2c else torch.complex(*self._space_data)
        slab = full[:, :, local.index(shard), :self.local_z_length(shard)].permute(2, 0, 1)
        return slab.cpu().numpy()

    # ---- verification hooks (spfft_tpu_torch.verify) --------------------------------

    def _verify_triplets(self) -> np.ndarray:
        """Every shard's storage-order rows, concatenated in shard order:
        aligned with the per-shard values concatenated."""
        p = self._params
        return np.concatenate([
            storage_triplets_from(p.value_indices[r, :int(p.num_values_per_shard[r])],
                                  p.stick_x_all[r], p.stick_y_all[r], p.dim_z)
            for r in range(p.num_shards)], axis=0)

    def _reference_engine(self):
        """The supervisor's reference rung: a local ``torch.fft`` engine over
        the global geometry on the plan's device, with no exchange."""
        if self._reference_exec is None:
            from .execution import LocalExecution
            from .parameters import make_local_parameters

            p = self._params
            params = make_local_parameters(p.transform_type, p.dim_x, p.dim_y, p.dim_z,
                                           self._verify_triplets())
            self._reference_exec = LocalExecution(params, self._real_dtype, self.device)
        return self._reference_exec

    def _reference_backward(self, values):
        """Per-shard values, concatenated -> the global ``(Z, Y, X)`` space;
        over a process group every shard's values are gathered first and
        this process keeps its own blocks, as :meth:`backward` returns them."""
        from .execution import from_pair
        from .verify.supervisor import flat_values

        if self._mesh.group is not None:
            values = self._gathered_values(values)
        ref = self._reference_engine()
        out = fence(ref.backward_pair(*ref.values_pair(flat_values(values))))
        out = out if self._is_r2c else from_pair(out)
        return out if self._mesh.group is None else self._own_blocks(out)

    def _reference_forward(self, space, scaling):
        """A global ``(Z, Y, X)`` space on the device (over a process group
        the global space or this process's blocks: its blocks are gathered
        first) -> the per-shard values."""
        from .execution import from_pair

        if self._mesh.group is not None:
            space = self._gathered_space(space)
        ref = self._reference_engine()
        flat = from_pair(fence(ref.forward_pair(*reference_parts(space, self._is_r2c),
                                                ScalingType(scaling))))
        values = list(torch.split(flat, [int(n) for n in self._params.num_values_per_shard]))
        if self._mesh.group is None:
            return values
        local = set(self._mesh.local_shards)
        return [v if r in local else None for r, v in enumerate(values)]

    # ---- verification over a process group ---------------------------------------------

    def _check_shards(self):
        """This process's part of the plan for the checks
        (:class:`~.verify.checks.Shards`), None without a process group."""
        if self._mesh.group is None:
            return None
        from .verify.checks import Shards

        p = self._params
        first = self._mesh.local_shards[0]
        return Shards(self._mesh.group, (p.dim_z, p.dim_y, p.dim_x),
                      int(p.num_values_per_shard.sum()),
                      int(p.num_values_per_shard[:first].sum()), self.device)

    def _local_values(self, values):
        """This process's shards' values of a per-shard list, concatenated."""
        from .verify.supervisor import flat_values

        return flat_values([values[r] for r in self._mesh.local_shards])

    def _holds_every_shard(self) -> bool:
        return len(self._mesh.local_shards) == self.num_shards

    def _shard_blocks(self, space) -> list:
        """A space as a per-shard list of this process's blocks (None for
        the others'): a per-shard list as it is, a global ``(Z, Y, X)``
        tensor cut at each of this process's shards' offsets."""
        if isinstance(space, (list, tuple)):
            return list(space)
        out = [None] * self.num_shards
        for r in self._mesh.local_shards:
            z0, y0 = self.local_z_offset(r), self.local_y_offset(r)
            out[r] = space[z0:z0 + self.local_z_length(r), y0:y0 + self.local_y_length(r)]
        return out

    def _local_blocks(self, space) -> list:
        """``(block, z0, y0)`` for this process's part of a space (a global
        tensor or a per-shard list): the global ``(Z, Y, X)`` tensor where
        it holds every shard, else each of its shards' blocks at its
        offset."""
        if not isinstance(space, (list, tuple)) and self._holds_every_shard():
            return [(space, 0, 0)]
        blocks = self._shard_blocks(space)
        return [(blocks[r], self.local_z_offset(r), self.local_y_offset(r))
                for r in self._mesh.local_shards]

    def _own_blocks(self, full):
        """A global ``(Z, Y, X)`` result -> what :meth:`backward` returns on
        this process: the global tensor where it holds every shard, else
        its shards' blocks (None for the others')."""
        if self._holds_every_shard():
            return full
        return [None if b is None else b.contiguous() for b in self._shard_blocks(full)]

    def _all_gather(self, t):
        """``t`` from every process of the group, stacked in rank order on
        the plan's device (NCCL gathers on the card, gloo on the CPU)."""
        import torch.distributed as dist

        group = self._mesh.group
        src = t.to(self.device if dist.get_backend(group) == "nccl" else "cpu")
        parts = [torch.empty_like(src) for _ in range(self._mesh.world)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts).to(self.device)

    def _gathered_values(self, values):
        """Every shard's values from every process: each sends its shards'
        ``(re, im)`` padded to the longest shard, in the plan's dtype."""
        from .verify.supervisor import flat_values

        counts = [int(n) for n in self._params.num_values_per_shard]
        local = list(self._mesh.local_shards)
        buf = torch.zeros((len(local), max(counts), 2), dtype=self._exec.torch_dtype,
                          device=self.device)
        for j, r in enumerate(local):
            v = flat_values([values[r]]).to(self.device)
            buf[j, :counts[r], 0] = v.real if v.is_complex() else v
            if v.is_complex():
                buf[j, :counts[r], 1] = v.imag
        every = self._all_gather(buf)
        return [torch.complex(every[r, :n, 0], every[r, :n, 1]) for r, n in enumerate(counts)]

    def _gathered_space(self, space):
        """The global ``(Z, Y, X)`` space from every process's blocks (each
        sends its shards' blocks, flattened and padded to the largest)."""
        if not isinstance(space, (list, tuple)):
            if self._holds_every_shard():  # a group of one: nothing to gather
                return space
            space = self._shard_blocks(space)
        shape = lambda r: (self.local_z_length(r), self.local_y_length(r), self.dim_x)
        size = max(int(np.prod(shape(r))) for r in range(self.num_shards))
        planes = 1 if self._is_r2c else 2
        local = list(self._mesh.local_shards)
        buf = torch.zeros((len(local), size, planes), dtype=self._exec.torch_dtype,
                          device=self.device)
        for j, r in enumerate(local):
            blk = space[r].reshape(-1)
            n = blk.numel()
            buf[j, :n, 0] = blk.real if blk.is_complex() else blk
            if planes == 2 and blk.is_complex():
                buf[j, :n, 1] = blk.imag
        every = self._all_gather(buf)
        complex_dtype = torch.complex128 if every.dtype == torch.float64 else torch.complex64
        full = torch.zeros((self.dim_z, self.dim_y, self.dim_x),
                           dtype=every.dtype if self._is_r2c else complex_dtype,
                           device=self.device)
        for r in range(self.num_shards):
            lz, ly, _ = shape(r)
            z0, y0 = self.local_z_offset(r), self.local_y_offset(r)
            n = lz * ly * self.dim_x
            blk = every[r, :n, 0] if self._is_r2c else torch.complex(every[r, :n, 0],
                                                                     every[r, :n, 1])
            full[z0:z0 + lz, y0:y0 + ly] = blk.reshape(shape(r))
        return full

    def _device_space(self, space):
        """The space on the plan's device: the caller's (a tensor there is
        not copied) or, for None, the retained one; a global ``(Z, Y, X)``
        tensor, or over a process group a per-shard list of this process's
        blocks (None for the others')."""
        p = self._params
        if space is None:
            if self._space_data is None:
                raise InvalidParameterError(
                    "no space domain data: run backward first or pass an array")
            return self._exec.unpad_space(self._space_data)
        if isinstance(space, (list, tuple)) and self._mesh.group is not None:
            local = set(self._mesh.local_shards)
            return [self._exec._tensor(s) if r in local and s is not None else None
                    for r, s in enumerate(space)]
        t = space.to(self.device) if torch.is_tensor(space) else torch.as_tensor(
            np.asarray(space), device=self.device)
        if t.numel() != p.total_size:
            raise InvalidParameterError(
                f"expected {p.total_size} space-domain elements, got {t.numel()}")
        return t.reshape(p.dim_z, p.dim_y, p.dim_x)

    @property
    def space_domain_layout(self) -> str:
        """Axis order of the native space: ``"yxz"``, on both engines: the
        stacked ``(Y, X, P_local, L_max)`` slabs, on a pencil mesh the
        stacked ``(P_local, Ly, X, Lz)`` blocks."""
        return self._exec.NATIVE_LAYOUT

    def clone(self) -> "DistributedTransform":
        """An independent plan with the same shards, mesh, engine, exchange,
        precision and fusion as this one resolved them."""
        c = DistributedTransform.from_parameters(
            self._processing_unit, self._params, mesh=self._mesh,
            exchange_type=self.exchange_type, grid=self._grid, dtype=self._real_dtype,
            engine=self._engine, precision=self._precision, policy=self._policy,
            fuse=self.fused, guard=self._guard, verify=self._verify_mode)
        c._exec._ir.requested = self._exec._ir.requested
        c._requested_exchange = self._requested_exchange
        return c

    @property
    def fused(self) -> bool:
        """True if each direction runs as one program (on the card one
        CUDA-graph replay); False on the staged path, which a plan whose
        exchange is a collective always takes (``describe()["ir"]``)."""
        return self._exec._ir.fused

    # ---- the plan card ----------------------------------------------------------------

    def describe(self) -> dict:
        """The engine's plan decisions, the exchange (discipline, wire bytes,
        rounds, transport, and for a DEFAULT request the wire bytes of the
        disciplines it was chosen from) and the ``ir`` section."""
        p = self._params
        exchange = {
            "type": self.exchange_type.name, "requested": self._requested_exchange.name,
            "wire_bytes": self.exchange_wire_bytes(), "rounds": self.exchange_rounds(),
            "transport": self._exec.exchange_transport(), "overlap_chunks": 1,
        }
        if self._pencil:
            tables = self._exec.geometry.policy_tables
            if tables is not None:  # the cost model ran: what it weighed
                exchange["policy"] = {a["discipline"]: {"wire_bytes": a["wire_bytes"]}
                                      for a in tables[True]["alternatives"]}
        elif self._requested_exchange == ExchangeType.DEFAULT:
            width = 2 * wire_scalar_bytes(ExchangeType.BUFFERED, self._real_dtype)
            exchange["policy"] = {d.name: {"wire_bytes": v * width} for d, v in
                                  discipline_volumes(p.num_sticks_per_shard,
                                                     p.local_z_lengths).items()}
        return {"engine": self._engine, "num_shards": p.num_shards,
                "local_shards": list(self._mesh.local_shards), **self._exec.describe(),
                "exchange": exchange, "ir": self._exec._ir.describe()}

    def report(self, *, include_compiled: bool = False) -> dict:
        """The plan card (:mod:`spfft_tpu_torch.obs.plancard`), schema
        ``spfft_tpu.obs.plan_card/1``: the local card's keys, the shards,
        mesh and decomposition, the exchange and the DEFAULT policy's
        alternatives. ``include_compiled=True`` raises: there is no HLO."""
        return obs.plan_card(self, include_compiled=include_compiled)

    # ---- accessors ----------------------------------------------------------------------

    @property
    def _is_r2c(self) -> bool:
        return self._params.transform_type == TransformType.R2C

    @property
    def _pencil(self) -> bool:
        return self._engine.startswith("pencil2")

    @property
    def transform_type(self) -> TransformType:
        return self._params.transform_type

    @property
    def dim_x(self) -> int:
        return self._params.dim_x

    @property
    def dim_y(self) -> int:
        return self._params.dim_y

    @property
    def dim_z(self) -> int:
        return self._params.dim_z

    @property
    def num_shards(self) -> int:
        return self._params.num_shards

    @property
    def mesh(self):
        return self._mesh

    # The per-shard space layout: a pencil engine holds its own z x y split
    # (the params' slab split does not describe it).

    def local_z_length(self, shard: int) -> int:
        if self._pencil:
            return self._exec.local_z_length(shard)
        return int(self._params.local_z_lengths[shard])

    def local_z_offset(self, shard: int) -> int:
        if self._pencil:
            return self._exec.local_z_offset(shard)
        return int(self._params.z_offsets[shard])

    def local_y_length(self, shard: int) -> int:
        """``dim_y`` on a slab mesh; the shard's y-slab length on a pencil mesh."""
        return self._exec.local_y_length(shard) if self._pencil else self.dim_y

    def local_y_offset(self, shard: int) -> int:
        return self._exec.local_y_offset(shard) if self._pencil else 0

    def local_slice_size(self, shard: int) -> int:
        return self.dim_x * self.local_y_length(shard) * self.local_z_length(shard)

    def num_local_elements(self, shard: int) -> int:
        return int(self._params.num_values_per_shard[shard])

    @property
    def num_global_elements(self) -> int:
        return int(self._params.num_values_per_shard.sum())

    @property
    def global_size(self) -> int:
        return self._params.total_size

    @property
    def processing_unit(self) -> ProcessingUnit:
        return self._processing_unit

    @property
    def device(self) -> torch.device:
        return self._mesh.device

    @property
    def exchange_type(self) -> ExchangeType:
        """The discipline the plan runs (DEFAULT resolved)."""
        return self._exec.exchange_type

    @property
    def overlap_chunks(self) -> int:
        return 1

    def exchange_wire_bytes(self) -> int:
        """Off-shard bytes of one exchange direction, over the mesh (the JAX
        package's accounting; pair it with :meth:`exchange_rounds`)."""
        return self._exec.exchange_wire_bytes()

    def exchange_rounds(self) -> int:
        """Collective rounds per direction: 1 for every discipline here (2 on
        a pencil mesh, exchanges A and B), where the JAX package's COMPACT
        chain (and its UNBUFFERED fallback off the TPU) takes P-1:
        ``all_to_all_single`` takes uneven split sizes."""
        return self._exec.exchange_rounds()

    @property
    def engine(self) -> str:
        return self._engine

    @property
    def precision(self) -> str:
        return self._precision

    @property
    def policy(self) -> str:
        return self._policy

    @property
    def dtype(self) -> np.dtype:
        return self._real_dtype

    @property
    def grid(self) -> Grid | None:
        return self._grid

    @property
    def params(self) -> DistributedParameters:
        return self._params

    def execution_mode(self) -> ExecType:
        return self._exec_mode

    def set_execution_mode(self, mode: ExecType) -> None:
        """ASYNCHRONOUS returns once the kernels are enqueued; :meth:`synchronize` waits."""
        self._exec_mode = ExecType(mode)
