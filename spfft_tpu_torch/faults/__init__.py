"""spfft_tpu_torch.faults: fault injection, guard mode, the degradation ladder.

The port of ``spfft_tpu/faults/``, with the JAX package's exports:

1. **Injection plane** (:mod:`.plane`): named fault sites (:data:`SITES`),
   armed by ``SPFFT_TPU_FAULTS="site=kind[:rate]"`` or :func:`inject`,
   deterministic under ``SPFFT_TPU_FAULTS_SEED``, one falsy-dict check when
   disarmed.
2. **Guard mode** (:mod:`.guard`): ``SPFFT_TPU_GUARD=1`` / ``guard=``:
   non-finite scans on the device and shape, dtype and device checks around
   each host-facing transform, raising typed errors.
3. **Degradation ladder** (:mod:`.ladder`): an ``mxu`` engine that fails to
   build falls back to ``torch.fft``, the IR's rungs, typed execution
   errors; each rung on the plan card's ``degradations`` and in the metrics.

The invariant the tests hold: with a site armed, a transform raises a typed
error or returns a right result through a recorded rung, never a silent
wrong one.
"""
from .plane import (  # noqa: F401
    FAULTS_DELAY_ENV,
    FAULTS_ENV,
    FAULTS_SEED_ENV,
    KINDS,
    SITES,
    InjectedFault,
    arm,
    armed,
    disarm,
    inject,
    parse_spec,
    reseed,
    site,
)
from .guard import (  # noqa: F401
    GUARD_ENV,
    check_array,
    check_device,
    execution_error,
    guard_enabled,
)
from .ladder import (  # noqa: F401
    ENGINE_BUILD_ERRORS,
    backoff_s,
    collecting,
    current_sink,
    engine_fallback,
    record_degradation,
    summarize,
    typed_execution,
)
