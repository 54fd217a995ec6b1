"""spfft_tpu_torch.verify: self-verifying transforms (ABFT) with recovery.

The port of ``spfft_tpu/verify/``, with its exports:

1. **Checks** (:mod:`.checks`): Parseval, DC consistency and a random probe,
   armed by ``SPFFT_TPU_VERIFY=1|strict`` or ``verify=`` on a
   ``Transform``, ``DistributedTransform`` or ``Grid.create_transform``; on
   the card the sums over the result run on the device.
2. **Supervisor** (:mod:`.supervisor`): retry, demote to the ``torch.fft``
   reference engine, or raise typed
   :class:`~spfft_tpu_torch.errors.VerificationError`, every rung recorded.
3. **Circuit breaker** (:mod:`.breaker`): an engine with K consecutive
   verified failures is skipped for the process until a half-open probe
   heals it.

With verification armed a transform returns a result consistent with the
reference or raises ``VerificationError``. Disarmed (the default), a plan
pays one falsy attribute check per call.
"""
from . import breaker  # noqa: F401
from .checks import (  # noqa: F401
    CHECK_FNS,
    CHECKS,
    VERIFY_ENV,
    VERIFY_RTOL_ENV,
    VERIFY_SEED_ENV,
    Geometry,
    applicable_checks,
    resolve_mode,
    resolve_rtol,
    run_checks,
)
from .supervisor import (  # noqa: F401
    DEFAULT_BACKOFF_S,
    DEFAULT_RETRIES,
    RETRYABLE_ERRORS,
    VERIFY_BACKOFF_ENV,
    VERIFY_JITTER_SEED_ENV,
    VERIFY_RETRIES_ENV,
    Supervisor,
    jitter_rng,
    resolve_backoff_s,
    resolve_retries,
)
