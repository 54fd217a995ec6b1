"""The ``Transform`` public API object.

A shape-specialised sparse 3-D FFT plan with the reference's surface
(reference: include/spfft/transform.hpp:56-318) and the JAX package's
signature. ``backward(values)`` maps packed complex values (triplet order) to
the space domain, ``(dim_z, dim_y, dim_x)``, complex for C2C and real for R2C;
``forward(space, scaling)`` maps back. Results are tensors on the plan's
``torch.device``: the CUDA card for ``ProcessingUnit.GPU``, the CPU for HOST.
The device-side entry points (``backward_pair``, ``forward_pair``,
``space_domain_data(ProcessingUnit.GPU)``) keep the engine's native layout,
:attr:`Transform.space_domain_layout`.

Observability, as in the JAX package (:mod:`spfft_tpu_torch.obs`): plan
construction is a ``plan`` operation of the flight recorder with an
"Execution init" timing scope; each host-facing call is an ``execute``
operation under the plan's run ID, timed in the scopes "backward"/"forward",
"input staging", "dispatch", "wait" (the completion :func:`~.sync.fence`)
and "output staging", and counted in ``transforms_total``. The plan card is
:meth:`Transform.report`.

Faults and verification, as in the JAX package (:mod:`spfft_tpu_torch.faults`,
:mod:`spfft_tpu_torch.verify`): ``guard=`` (``SPFFT_TPU_GUARD``) checks each
call's input and result on the device; ``verify=`` (``SPFFT_TPU_VERIFY``)
runs each call under the recovery supervisor; an ``mxu`` engine that fails
to build (fault site ``engine.compile``) falls back to ``torch.fft``;
dispatch, wait and ``synchronize`` failures raise typed errors; the fault
site ``engine.execute`` sits on each dispatch's result. Every rung lands in
the plan card's ``degradations``.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from . import faults, obs, timing, tuning
from .errors import FFTWError, InvalidParameterError
from .execution import LocalExecution, from_pair
from .execution_mxu import MxuLocalExecution
from .grid import Grid, device_for_processing_unit
from .ops.fft import resolve_precision
from .parallel.policy import resolve_policy
from .parameters import LocalParameters, make_local_parameters
from .sync import fence, wait
from .types import ExecType, IndexFormat, ProcessingUnit, ScalingType, TransformType


class _Observed:
    """The hooks of a plan's host-facing calls, shared by :class:`Transform`
    and :class:`~.distributed.DistributedTransform` and placed as the JAX
    package places them. The plan holds ``_engine``, ``_run_id``,
    ``_exec_mode``, ``_space_data``, ``_guard``, ``_verifier``,
    ``_degradations`` and ``device``."""

    @property
    def _platform(self) -> str:
        """``"gpu"`` on the card, ``"cpu"`` on the CPU (the JAX package's
        ``device.platform``, which picks the typed execution error)."""
        return "gpu" if self.device.type == "cuda" else str(self.device.type)

    def _init_verify(self, verify) -> None:
        """The verification supervisor (explicit ``verify=`` wins, else
        ``SPFFT_TPU_VERIFY``); off, the calls pay one falsy check."""
        from .verify import Supervisor, resolve_mode

        self._verify_mode = resolve_mode(verify)
        self._verifier = None
        self._reference_exec = None
        if self._verify_mode != "off":
            self._verifier = Supervisor(self, self._verify_mode)

    @contextmanager
    def _execute(self, direction: str, count: int = 1):
        """One call of ``count`` transforms: counted in ``transforms_total``,
        an ``execute`` operation under the plan's run ID, timed in the
        direction's scope."""
        obs.counter("transforms_total", direction=direction, engine=self._engine).inc(count)
        with obs.trace.operation("execute", run_id=self._run_id, direction=direction), \
                timing.scoped(direction):
            yield

    @contextmanager
    def _dispatching(self, direction: str):
        """The "dispatch" scope of one call, observed in ``dispatch_seconds``,
        with its failures turned into the platform's typed error."""
        with timing.scoped("dispatch"), obs.phase_timer("dispatch_seconds", direction=direction), \
                faults.typed_execution(self._platform, f"{direction} dispatch"):
            yield

    def _wait(self, out, direction: str | None = None) -> None:
        """SYNCHRONOUS mode: wait for ``out``. A host-facing call names its
        ``direction``: the fence, in the "wait" scope, observed in
        ``wait_seconds``, its failures typed. A split-phase finalize names
        none: the bare :func:`~.sync.wait`, as the JAX package waits in its
        host fetch."""
        if self._exec_mode != ExecType.SYNCHRONOUS:
            return
        if direction is None:
            wait(out)
            return
        with timing.scoped("wait"), obs.phase_timer("wait_seconds", direction=direction), \
                faults.typed_execution(self._platform, f"{direction} wait"):
            fence(out)

    def _guard_input(self, data, direction: str) -> None:
        if self._guard and data is not None:
            faults.check_array(data, check=f"{direction} input", platform=self._platform)

    def synchronize(self) -> None:
        """Wait for the plan's enqueued work: its retained data, and all
        that its device's current stream holds (an ASYNCHRONOUS batch
        retains nothing). A failure raises the platform's typed error."""
        with faults.typed_execution(self._platform, "synchronize"):
            fence(self._space_data, self.device)


class Transform(_Observed):
    """A sparse 3-D FFT plan on one device.

    ``engine``: ``"mxu"``, the matrix-product engine (every DFT stage a K1
    launch; its y stage runs one of three plans, chosen as the JAX engine
    chooses: dense, per-slot sparse (C2C) or blocked sparse), ``"xla"``, the
    ``torch.fft`` engine (cuFFT on the card), or ``"auto"``, which is
    ``"xla"`` on a CPU plan and ``"mxu"`` on the card, the JAX package's rule.

    ``precision`` (any case) is the JAX package's matrix-product precision.
    In float32 on the card: ``"highest"`` FP32-accurate 3xTF32, ``"high"``
    bf16x3 (about 1e-5 relative on a 256^3 transform), ``"default"`` one
    bf16 pass (about 4e-3).
    Float64 plans accept the name and ignore it, as do CPU plans, whose plain
    products are exact float32 or float64, and the ``"xla"`` engine.

    ``fuse``: each direction runs as one program (on the card one CUDA-graph
    replay) when true, node by node when false; None reads
    ``SPFFT_TPU_FUSE`` (default fused).

    ``guard``: checks of each call's input and result (finite values on the
    device, shape, dtype, device), raising typed errors; None reads
    ``SPFFT_TPU_GUARD``. ``verify``: ``"on"``/``True``, ``"strict"`` or
    ``"off"``/``False``, the ABFT checks and recovery supervisor
    (:mod:`spfft_tpu_torch.verify`); None reads ``SPFFT_TPU_VERIFY``.

    ``policy``: ``"tuned"`` resolves ``engine="auto"`` by measurement
    (:mod:`spfft_tpu_torch.tuning`: a wisdom hit, else trials of the local
    candidates on this plan, else the static rule), ``"default"`` by the
    static rule; None reads ``SPFFT_TPU_POLICY``. The decision's record is
    ``report()["tuning"]``.
    """

    def __init__(
        self,
        processing_unit,
        transform_type,
        dim_x,
        dim_y,
        dim_z,
        num_local_elements=None,
        indices=None,
        *,
        local_z_length=None,
        index_format: IndexFormat = IndexFormat.TRIPLETS,
        grid: Grid | None = None,
        dtype=None,
        engine: str = "auto",
        precision: str = "highest",
        device=None,
        policy: str | None = None,
        guard: bool | None = None,
        verify=None,
        fuse=None,
    ):
        if IndexFormat(index_format) != IndexFormat.TRIPLETS:
            raise InvalidParameterError("only SPFFT_INDEX_TRIPLETS is supported")
        if indices is None:
            raise InvalidParameterError("index triplets are required")
        indices = np.asarray(indices)
        if num_local_elements is not None:
            flat = indices.reshape(-1)
            if flat.size < 3 * num_local_elements:
                raise InvalidParameterError("fewer indices than num_local_elements")
            indices = flat[: 3 * int(num_local_elements)]
        # A local plan spans the full z-extent; 0 means unspecified.
        if local_z_length is not None:
            local_z_length = int(local_z_length)
            if local_z_length < 0:
                raise InvalidParameterError("local_z_length must be non-negative")
            if local_z_length not in (0, int(dim_z)):
                raise InvalidParameterError(
                    f"a local transform spans the full z-extent: local_z_length "
                    f"must be dim_z ({int(dim_z)}), got {local_z_length}"
                )
            local_z_length = local_z_length or None
        params = make_local_parameters(
            TransformType(transform_type), dim_x, dim_y, dim_z, indices
        )
        self._setup(processing_unit, params, grid, dtype, engine, precision, device, fuse,
                    policy, local_z_length, guard, verify)

    @classmethod
    def from_parameters(
        cls, processing_unit, params: LocalParameters, *, grid: Grid | None = None,
        dtype=None, engine: str = "auto", precision: str = "highest", device=None, fuse=None,
        policy: str | None = None, guard: bool | None = None, verify=None,
    ) -> "Transform":
        """A plan from already built parameters, e.g. carried over from the
        JAX package by :func:`~spfft_tpu_torch.parameters.from_jax_params`."""
        self = cls.__new__(cls)
        self._setup(processing_unit, params, grid, dtype, engine, precision, device, fuse,
                    policy, None, guard, verify)
        return self

    def _setup(self, processing_unit, params, grid, dtype, engine, precision, device, fuse,
               policy=None, local_z_length=None, guard=None, verify=None):
        """``local_z_length``: the caller's explicit one (None if unspecified),
        checked against the grid's maximum as the JAX package checks it."""
        self._processing_unit = ProcessingUnit(processing_unit)
        self._params = params
        self._grid = grid
        if grid is not None:
            # capacity validation, parity with src/spfft/transform_internal.cpp:45-137
            if (
                params.dim_x > grid.max_dim_x
                or params.dim_y > grid.max_dim_y
                or params.dim_z > grid.max_dim_z
            ):
                raise InvalidParameterError("transform dimensions exceed grid maxima")
            if local_z_length is not None and local_z_length > grid.max_local_z_length:
                raise InvalidParameterError("local z length exceeds grid maximum")
            if params.num_sticks > grid.max_num_local_z_columns:
                raise InvalidParameterError("more z-columns than grid maximum")
            if not (self._processing_unit & grid.processing_unit):
                raise InvalidParameterError("transform processing unit not covered by grid")
            if device is None and (grid.device.type == "cpu") == (
                self._processing_unit == ProcessingUnit.HOST
            ):
                device = grid.device
        self._real_dtype = np.dtype(np.float64 if dtype is None else dtype)
        if self._real_dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise InvalidParameterError("dtype must be float32 or float64")
        self._precision = resolve_precision(precision)
        self._policy = resolve_policy(policy)
        self._tuning = None  # the tuned decision's record (tuning._record)
        if engine not in ("auto", "mxu", "xla"):
            raise InvalidParameterError(f"unknown engine {engine!r}")
        self._device = device_for_processing_unit(self._processing_unit, device)
        self._guard = faults.guard_enabled(guard)
        self._degradations: list = []  # the rungs taken (the plan card's degradations)
        # Run ID (obs.trace): the key that joins this plan's card, metrics and
        # flight-recorder events; the "plan" operation keeps it active while
        # the engine is built.
        self._run_id = obs.trace.new_run_id()
        with obs.trace.operation("plan", run_id=self._run_id, kind="local"):
            engine_env = {}  # a tuned candidate's knob overrides
            if engine == "auto" and self._policy == "tuned":
                # trial plans name their engine and take the model policy,
                # so tuning cannot recurse
                def build(cand):
                    with tuning.env_overrides(cand.get("env") or {}):
                        return Transform.from_parameters(
                            self._processing_unit, params, dtype=self._real_dtype,
                            engine=cand["engine"], precision=self._precision,
                            device=self._device, fuse=fuse, policy="default", guard=False,
                            verify=False)

                with faults.collecting(self._degradations):
                    choice, self._tuning = tuning.tuned_local(
                        params, self._device, self._real_dtype, self._precision, build,
                        fuse=fuse)
                engine, engine_env = choice["engine"], dict(choice.get("env") or {})
            if engine == "auto":  # the JAX package's rule (spfft_tpu/transform.py:207-208)
                engine = "xla" if self._device.type == "cpu" else "mxu"
            # the reference's plan-creation scope (src/execution/execution_host.cpp:56).
            # Ladder rung 1: an mxu engine that fails to build (fault site
            # engine.compile) falls back to torch.fft; the kernels' typed
            # errors raise. A torch.fft engine has no rung below it.
            with timing.scoped("Execution init"), faults.collecting(self._degradations), \
                    tuning.env_overrides(engine_env):
                if engine == "mxu":
                    try:
                        faults.site("engine.compile")
                        self._exec = MxuLocalExecution(params, self._real_dtype, self._device,
                                                       self._precision, fuse=fuse)
                    except faults.ENGINE_BUILD_ERRORS as e:
                        faults.engine_fallback("mxu", "xla", faults.summarize(e))
                        engine = "xla"
                if engine == "xla":
                    try:
                        self._exec = LocalExecution(params, self._real_dtype, self._device,
                                                    fuse=fuse)
                    except faults.ENGINE_BUILD_ERRORS as e:
                        raise FFTWError(f"local engine construction failed: {e}") from e
            obs.trace.event("decision", what="engine", choice=engine, policy=self._policy)
        self._engine = engine
        if self._tuning is not None:
            self._tuning = tuning.with_k1_form(self._tuning, self._exec)
        self._exec_mode = ExecType.SYNCHRONOUS
        self._space_data = None  # native layout: (re, im) for C2C, re for R2C
        self._init_verify(verify)

    # ---- transforms -----------------------------------------------------------

    def backward(self, values, output_location: ProcessingUnit | None = None):
        """Frequency -> space. Returns the ``(dim_z, dim_y, dim_x)`` space-domain
        tensor on the plan's device (complex for C2C, real for R2C).

        Reference: include/spfft/transform.hpp:286-298. The result is also
        retained for :meth:`space_domain_data` and input-less :meth:`forward`.
        """
        if output_location is not None:
            _validate_data_location(output_location)
        with self._execute("backward"):
            self._guard_input(values, "backward")
            if self._verifier is not None:
                return self._verifier.backward(values)
            return self._backward_attempt(values)

    def forward(
        self,
        space=None,
        scaling: ScalingType = ScalingType.NONE,
        input_location: ProcessingUnit | None = None,
    ):
        """Space -> frequency. Returns the packed ``(num_local_elements,)``
        complex values on the plan's device.

        Reference: include/spfft/transform.hpp:259-283. ``space=None`` reads the
        retained space-domain data of the last :meth:`backward`.
        """
        if input_location is not None:
            _validate_data_location(input_location)
        with self._execute("forward"):
            self._guard_input(space, "forward")
            if self._verifier is not None:
                return self._verifier.forward(space, scaling)
            return self._forward_attempt(space, scaling)

    def _backward_attempt(self, values):
        """One whole backward (dispatch, wait, output staging, guard's
        checks): the unit the verify supervisor runs again."""
        out = self._dispatch_backward(values)
        self._wait(out, "backward")
        with timing.scoped("output staging"):
            result = self._public_space(out)
        if self._guard:
            self._guard_space(out, result)
        return result

    def _forward_attempt(self, space, scaling):
        """One whole forward: the supervisor's unit of :meth:`forward`."""
        pair = self._dispatch_forward(space, scaling)
        self._wait(pair, "forward")
        with timing.scoped("output staging"):
            result = from_pair(pair)
        if self._guard:
            self._guard_values(pair, result)
        return result

    def _guard_space(self, out, result) -> None:
        """Guard's checks of a backward: ``out``'s device (None: not
        checked) and the result's values, shape and dtype."""
        plat = self._platform
        if out is not None:
            faults.check_device(out, self._device, check="backward output", platform=plat)
        faults.check_array(result, check="backward output", platform=plat,
                           shape=(self.dim_z, self.dim_y, self.dim_x),
                           dtype=self._real_dtype if self._is_r2c else _complex(self._real_dtype))

    def _guard_values(self, pair, result) -> None:
        """Guard's checks of a forward, as :meth:`_guard_space`."""
        plat = self._platform
        if pair is not None:
            faults.check_device(pair, self._device, check="forward output", platform=plat)
        faults.check_array(result, check="forward output", platform=plat,
                           shape=(self.num_local_elements,), dtype=_complex(self._real_dtype))

    # ---- split phases (multi_transform) ---------------------------------------------

    def _dispatch_backward(self, values):
        """Stage the values and enqueue the backward pipeline; returns the
        native result without waiting, and retains it."""
        with timing.scoped("input staging"):
            re, im = self._exec.values_pair(self._checked_values(values))
        with self._dispatching("backward"):
            out = self._exec.backward_pair(re, im)
            out = faults.site("engine.execute", payload=out)
        self._space_data = out
        return out

    def _finalize_backward(self, out):
        """Wait (SYNCHRONOUS mode) and return the public ``(Z, Y, X)`` view."""
        self._wait(out)
        return self._public_space(out)

    def _dispatch_forward(self, space, scaling):
        """Stage the space (or take the retained one) and enqueue the forward
        pipeline; returns the (re, im) values without waiting."""
        if space is None:
            if self._space_data is None:
                raise InvalidParameterError(
                    "no space domain data: run backward first or pass an array"
                )
        else:
            with timing.scoped("input staging"):
                self._retain_space(space)
        with self._dispatching("forward"):
            pair = self._exec.forward_pair(*self._space_parts(self._space_data),
                                           ScalingType(scaling))
            return faults.site("engine.execute", payload=pair)

    def _finalize_forward(self, pair):
        self._wait(pair)
        return from_pair(pair)

    def _checked_values(self, values):
        n = self._params.num_values
        size = values.numel() if torch.is_tensor(values) else np.asarray(values).size
        if size != n:
            raise InvalidParameterError(f"expected {n} frequency values, got {size}")
        return values

    def _space_parts(self, data):
        """Retained native data -> the engine's ``(space_re, space_im)``."""
        return (data, None) if self._is_r2c else data

    # ---- device-side entry points, in the native layout -----------------------------

    def backward_pair(self, values_re, values_im):
        """(re, im) values in, space out in the engine's native layout
        (:attr:`space_domain_layout`): the (re, im) pair for C2C, the real
        tensor for R2C. The result is retained for :meth:`forward_pair`.
        An ``execute`` operation, timed in "backward", "input staging" and
        "dispatch", as :meth:`backward` is; it waits for nothing."""
        with self._execute("backward"):
            with timing.scoped("input staging"):
                put = lambda v: torch.as_tensor(v, dtype=self._exec.torch_dtype,
                                                device=self._device).reshape(-1)
                re, im = put(values_re), put(values_im)
                self._checked_values(re)
                self._checked_values(im)
            with timing.scoped("dispatch"):
                self._space_data = self._exec.backward_pair(re, im)
            return self._space_data

    def forward_pair(self, scaling: ScalingType = ScalingType.NONE):
        """Forward over the retained native space; returns the (re, im) values.
        Observed as :meth:`backward_pair` is, in "forward"."""
        with self._execute("forward"):
            with timing.scoped("input staging"):
                if self._space_data is None:
                    raise InvalidParameterError("no space domain data: run backward first")
            with timing.scoped("dispatch"):
                return self._exec.forward_pair(*self._space_parts(self._space_data),
                                               ScalingType(scaling))

    # ---- batches of one plan (SPFFT_TPU_BATCH_FUSE) -----------------------------------

    def backward_batch(self, values_batch, *, fallback: bool = True, count: int | None = None):
        """B backward transforms of this plan as one program per direction
        (on the card one CUDA-graph replay for the batch); returns the B
        ``(Z, Y, X)`` results. Where batching is unavailable (the knob off,
        or a staged plan) the batch runs as a loop of :meth:`backward`
        dispatches, or with ``fallback=False`` returns None. ``count`` marks
        the first N entries as the real requests of a padded batch: only those
        are returned (and looped). The batched program leaves the retained
        space untouched."""
        values_batch = list(values_batch)
        count = _resolve_batch_count(count, len(values_batch))
        if not values_batch:
            return []
        if self._verifier is not None:  # each request under its supervisor
            return [self.backward(v) for v in values_batch[:count]]
        with self._execute("backward", count):
            for v in values_batch[:count]:
                self._guard_input(v, "backward")
            pending = self._dispatch_backward_batch(values_batch, fallback=fallback,
                                                    count=count)
            if pending is None:
                return None
            self._wait(pending, "backward")
            with timing.scoped("output staging"):
                results = self._finalize_backward_batch(pending)[:count]
            if self._guard:
                if "batched" in pending:
                    faults.check_device(pending["batched"], self._device,
                                        check="backward output", platform=self._platform)
                for result in results:
                    self._guard_space(None, result)
            return results

    def forward_batch(self, spaces, scaling: ScalingType = ScalingType.NONE, *,
                      fallback: bool = True, count: int | None = None):
        """B ``(Z, Y, X)`` spaces -> B packed value tensors, as
        :meth:`backward_batch` (one ``scaling`` for the batch)."""
        spaces = list(spaces)
        count = _resolve_batch_count(count, len(spaces))
        if not spaces:
            return []
        if self._verifier is not None:
            return [self.forward(s, scaling) for s in spaces[:count]]
        with self._execute("forward", count):
            for s in spaces[:count]:
                self._guard_input(s, "forward")
            pending = self._dispatch_forward_batch(spaces, scaling, fallback=fallback,
                                                   count=count)
            if pending is None:
                return None
            self._wait(pending, "forward")
            with timing.scoped("output staging"):
                results = self._finalize_forward_batch(pending)[:count]
            if self._guard:
                for result in results:
                    self._guard_values(None, result)
            return results

    def _dispatch_backward_batch(self, values_batch, *, fallback=True, count=None):
        """``{"batched": stacked native}`` after one batched dispatch, else
        ``{"loop": [...]}`` of per-request dispatches, or None."""
        count = _resolve_batch_count(count, len(values_batch))
        rows = [self._checked_values(v) for v in values_batch]
        if self._exec._ir.batch_available():
            with timing.scoped("input staging"):
                pairs = [self._exec.values_pair(v) for v in rows]
                re = torch.stack([p[0] for p in pairs])
                im = torch.stack([p[1] for p in pairs])
            with self._dispatching("backward"):
                out = self._exec.backward_pair_batch(re, im)
                if out is not None:  # None: the batch_fuse_failed rung, so loop
                    return {"batched": faults.site("engine.execute", payload=out)}
        if not fallback:
            return None
        return {"loop": [self._dispatch_backward(v) for v in rows[:count]]}

    def _finalize_backward_batch(self, pending):
        if "loop" in pending:
            return [self._public_space(out) for out in pending["loop"]]
        out = pending["batched"]
        batch = out.shape[0] if self._is_r2c else out[0].shape[0]
        pick = lambda b: out[b] if self._is_r2c else (out[0][b], out[1][b])
        return [self._public_space(pick(b)) for b in range(batch)]

    def _dispatch_forward_batch(self, spaces, scaling, *, fallback=True, count=None):
        count = _resolve_batch_count(count, len(spaces))
        if self._exec._ir.batch_available():
            with timing.scoped("input staging"):
                natives = [self._native_space(s) for s in spaces]
                if self._is_r2c:
                    re, im = torch.stack(natives), None
                else:
                    re, im = (torch.stack([n[i] for n in natives]) for i in (0, 1))
            with self._dispatching("forward"):
                out = self._exec.forward_pair_batch(re, im, ScalingType(scaling))
                if out is not None:  # None: the batch_fuse_failed rung, so loop
                    return {"batched": faults.site("engine.execute", payload=out)}
        if not fallback:
            return None
        pairs = []
        for space in spaces[:count]:  # the retained space stays untouched
            with timing.scoped("input staging"):
                native = self._native_space(space)
            with self._dispatching("forward"):
                pair = self._exec.forward_pair(*self._space_parts(native), ScalingType(scaling))
                pairs.append(faults.site("engine.execute", payload=pair))
        return {"loop": pairs}

    def _finalize_forward_batch(self, pending):
        if "loop" in pending:
            return [from_pair(p) for p in pending["loop"]]
        values = from_pair(pending["batched"])
        return [values[b] for b in range(values.shape[0])]

    # ---- layouts --------------------------------------------------------------------

    def _device_space(self, space):
        """A public ``(Z, Y, X)`` array or tensor (None: the retained space)
        -> a ``(Z, Y, X)`` tensor on the plan's device, in the caller's dtype
        (no copy for a tensor already there)."""
        p = self._params
        if space is None:
            if self._space_data is None:
                raise InvalidParameterError(
                    "no space domain data: run backward first or pass an array")
            return self._public_space(self._space_data)
        if torch.is_tensor(space):
            t = space.to(self._device)
        else:
            t = torch.tensor(np.asarray(space), device=self._device)
            # the bytes the plan's dtype stages, as the JAX package counts them
            obs.counter("staged_bytes_total", direction="host_to_device").inc(
                (1 if self._is_r2c else 2) * t.numel() * self._real_dtype.itemsize)
        if t.numel() != p.total_size:
            raise InvalidParameterError(
                f"expected {p.total_size} space-domain elements, got {t.numel()}"
            )
        return t.reshape(p.dim_z, p.dim_y, p.dim_x)

    def _retain_space(self, space) -> None:
        """Stage a public space as the retained native data (also the
        supervisor's: a verified recovery replaces a failed result)."""
        self._space_data = self._native_space(space)

    def _native_space(self, space):
        """A public ``(Z, Y, X)`` array or tensor -> native data on the device
        (a copy: the caller's array may change or be read-only)."""
        t = self._device_space(space)
        if self.space_domain_layout == "yxz":
            t = t.permute(1, 2, 0)
        dt = self._exec.torch_dtype
        if self._is_r2c:
            return (t.real if t.is_complex() else t).to(dt).contiguous()
        if t.is_complex():
            return t.real.to(dt).contiguous(), t.imag.to(dt).contiguous()
        re = t.to(dt).contiguous()
        return re, torch.zeros_like(re)

    def _public_space(self, data):
        """Native data -> the public ``(Z, Y, X)`` tensor (complex for C2C)."""
        arr = data if self._is_r2c else from_pair(data)
        return arr.permute(2, 0, 1) if self.space_domain_layout == "yxz" else arr

    # ---- verification hooks (spfft_tpu_torch.verify) --------------------------------

    def _verify_triplets(self) -> np.ndarray:
        """Storage-order index rows aligned with the packed values."""
        return storage_triplets(self._params)

    def _reference_engine(self) -> LocalExecution:
        """The supervisor's reference rung, built at its first use: a fresh
        ``torch.fft`` engine (cuFFT on the card) on the plan's own device,
        on no path that the primary engine's dispatch shares."""
        if self._reference_exec is None:
            self._reference_exec = LocalExecution(self._params, self._real_dtype, self._device)
        return self._reference_exec

    def _reference_backward(self, values):
        """Values -> the ``(Z, Y, X)`` space through the reference engine."""
        ref = self._reference_engine()
        out = fence(ref.backward_pair(*ref.values_pair(values)))
        return out if self._is_r2c else from_pair(out)

    def _reference_forward(self, space, scaling):
        """A ``(Z, Y, X)`` space on the device -> packed values through the
        reference engine."""
        ref = self._reference_engine()
        return from_pair(fence(ref.forward_pair(*reference_parts(space, self._is_r2c),
                                                ScalingType(scaling))))

    @property
    def space_domain_layout(self) -> str:
        """Axis order of the device-side space data (``backward_pair``'s
        result, ``space_domain_data(ProcessingUnit.GPU)``): ``"zyx"`` on the
        ``"xla"`` engine, ``"yxz"`` on the ``"mxu"`` engine."""
        return self._exec.NATIVE_LAYOUT

    def space_domain_data(self, processing_unit: ProcessingUnit | None = None):
        """The most recent space-domain result (reference: transform.hpp:245):
        a numpy ``(Z, Y, X)`` array for HOST (the default); for GPU the
        retained tensor data on the plan's device in the native layout
        (:attr:`space_domain_layout`): the (re, im) pair for C2C, the real
        tensor for R2C."""
        if self._space_data is None:
            raise InvalidParameterError("no space domain data available yet")
        if processing_unit is not None and _validate_data_location(
            processing_unit
        ) == ProcessingUnit.GPU:
            return self._space_data
        obs.counter("staged_bytes_total", direction="device_to_host").inc(
            (1 if self._is_r2c else 2) * self._params.total_size * self._real_dtype.itemsize)
        return self._public_space(self._space_data).cpu().numpy()

    def clone(self) -> "Transform":
        """An independent transform with the same layout, engine, precision
        and fusion as this one resolved them (reference: transform.hpp:133)."""
        c = Transform.from_parameters(
            self._processing_unit, self._params, grid=self._grid,
            dtype=self._real_dtype, engine=self._engine, precision=self._precision,
            device=self._device, fuse=self.fused, guard=self._guard, verify=self._verify_mode,
        )
        # the clone's fusion is this plan's decision, with where it came from
        c._exec._ir.requested = self._exec._ir.requested
        return c

    @property
    def fused(self) -> bool:
        """True if each direction runs as one program (one CUDA-graph replay
        on the card), False on the staged per-node path."""
        return self._exec._ir.fused

    # ---- accessors, parity with include/spfft/transform.hpp:147-245 -----------

    @property
    def _is_r2c(self) -> bool:
        return self._params.transform_type == TransformType.R2C

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
    def local_z_length(self) -> int:
        return self._params.dim_z

    @property
    def local_z_offset(self) -> int:
        return 0

    @property
    def local_slice_size(self) -> int:
        return self.dim_x * self.dim_y * self.local_z_length

    @property
    def num_local_elements(self) -> int:
        return self._params.num_values

    @property
    def num_global_elements(self) -> int:
        return self._params.num_values

    @property
    def global_size(self) -> int:
        return self._params.total_size

    @property
    def processing_unit(self) -> ProcessingUnit:
        return self._processing_unit

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def device_id(self) -> int:
        return self._device.index or 0

    @property
    def num_threads(self) -> int:
        return 1

    @property
    def dtype(self) -> np.dtype:
        return self._real_dtype

    @property
    def num_x_active(self) -> int:
        """Active x rows of the unique-x compaction (padded to ``SPFFT_TPU_XPAD``, 8);
        ``dim_x_freq`` on the ``"xla"`` engine, whose grid spans every x."""
        return self._exec.num_x_active

    @property
    def engine(self) -> str:
        return self._engine

    @property
    def precision(self) -> str:
        """The matrix-product precision: ``"highest"``, ``"high"`` or ``"default"``."""
        return self._precision

    def describe(self) -> dict:
        """The engine's plan decisions (``"mxu"``: precision, active x rows,
        the y plan) and the ``ir`` section: fused or staged, where that came
        from, and the stage lists."""
        return {**self._exec.describe(), "ir": self._exec._ir.describe()}

    @property
    def grid(self) -> Grid | None:
        return self._grid

    @property
    def params(self) -> LocalParameters:
        return self._params

    def execution_mode(self) -> ExecType:
        return self._exec_mode

    def set_execution_mode(self, mode: ExecType) -> None:
        """Reference: include/spfft/transform.hpp:225. ASYNCHRONOUS returns once
        the kernels are enqueued; :meth:`synchronize` waits."""
        self._exec_mode = ExecType(mode)

    def report(self, *, include_compiled: bool = False) -> dict:
        """The plan card (:mod:`spfft_tpu_torch.obs.plancard`): this plan's
        decisions under schema ``spfft_tpu.obs.plan_card/1``.
        ``include_compiled=True`` adds the ``compiled`` section: the backward
        program's statistics (:mod:`spfft_tpu_torch.obs.hlo`)."""
        return obs.plan_card(self, include_compiled=include_compiled)


def _resolve_batch_count(count, size: int) -> int:
    """The real-request count of a (possibly padded) batch: the whole batch
    by default; an explicit count addresses a non-empty prefix."""
    if count is None:
        return size
    count = int(count)
    if not 0 < count <= size:
        raise InvalidParameterError(f"batch count= must be in [1, {size}], got {count}")
    return count


def reference_parts(space, r2c: bool) -> tuple:
    """A ``(Z, Y, X)`` space, real or complex -> the ``torch.fft`` engine's
    forward inputs ``(space_re, space_im)`` (``space_im`` None for R2C)."""
    if r2c:
        return (space.real if space.is_complex() else space), None
    if space.is_complex():
        return space.real, space.imag
    return space, torch.zeros_like(space)


def _complex(real_dtype) -> np.dtype:
    return np.dtype(np.complex64 if np.dtype(real_dtype) == np.float32 else np.complex128)


def storage_triplets(p: LocalParameters) -> np.ndarray:
    """A plan's storage-order index triplets, in the packed values' order:
    the value -> slot map (``stick * dim_z + z``) decoded."""
    return storage_triplets_from(p.value_indices, p.stick_x, p.stick_y, p.dim_z)


def storage_triplets_from(value_indices, stick_x, stick_y, dim_z) -> np.ndarray:
    """Decode a value -> slot map (``stick * dim_z + z``) to ``(x, y, z)`` rows."""
    vi = np.asarray(value_indices, dtype=np.int64)
    stick_of_value = vi // dim_z
    x = np.asarray(stick_x, dtype=np.int64)[stick_of_value]
    y = np.asarray(stick_y, dtype=np.int64)[stick_of_value]
    return np.stack([x, y, vi % dim_z], axis=1).astype(np.int32)


def _validate_data_location(pu) -> ProcessingUnit:
    """A data location is exactly HOST or GPU."""
    try:
        pu = ProcessingUnit(pu)
    except ValueError as e:
        raise InvalidParameterError(f"invalid processing unit: {pu!r}") from e
    if pu not in (ProcessingUnit.HOST, ProcessingUnit.GPU):
        raise InvalidParameterError(f"invalid data location: {pu!r}")
    return pu


class TransformFloat(Transform):
    """Single-precision transform, the reference's parity alias
    (include/spfft/transform_float.hpp): ``dtype=float32``."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("dtype", np.float32)
        super().__init__(*args, **kwargs)
