"""Independent transforms executed together, every dispatch before any wait.

Parity with the reference's ``multi_transform_{forward,backward}``
(reference: include/spfft/multi_transform.hpp:48-95) and the JAX package's
``spfft_tpu/multi_transform.py``: every transform is staged and enqueued
first (PyTorch's launches are asynchronous, so the card runs transform i while
the host stages i+1), then the results are waited on, in order. The
split-phase halves (``dispatch_*`` / ``finalize_*``) are public for callers
that work between the two.

Plans own their buffers, so transforms of one Grid may share a batch, and
local and distributed transforms mix (a distributed member takes and gives
per-shard lists, as its own ``backward``/``forward``); the same transform
object twice is rejected, since its retained space-domain data is per object.
Each batch is timed as in the JAX package: "multi backward" (or "multi
forward") over "dispatch all" and "finalize all".
"""
from __future__ import annotations

from . import timing
from .errors import InvalidParameterError
from .types import ScalingType


def _check_batch(transforms, inputs, name):
    if len(transforms) != len(inputs):
        raise InvalidParameterError(
            f"{name}: got {len(transforms)} transforms but {len(inputs)} inputs"
        )
    if len(set(map(id, transforms))) != len(transforms):
        raise InvalidParameterError(
            f"{name}: the same transform object appears more than once in the batch"
        )


def _broadcast_scaling(scaling_types, n):
    if scaling_types is None:
        return [ScalingType.NONE] * n
    try:
        if isinstance(scaling_types, (int, ScalingType)):
            return [ScalingType(scaling_types)] * n
        scaling_types = [ScalingType(s) for s in scaling_types]
    except (ValueError, TypeError) as e:
        raise InvalidParameterError(f"invalid scaling type: {e}") from e
    if len(scaling_types) != n:
        raise InvalidParameterError(
            f"got {n} transforms but {len(scaling_types)} scaling types"
        )
    return scaling_types


def dispatch_backward(transforms, values_list):
    """Stage and enqueue every backward without waiting; returns the pending
    native results (finish with :func:`finalize_backward`)."""
    transforms, values_list = list(transforms), list(values_list)
    _check_batch(transforms, values_list, "dispatch_backward")
    return [t._dispatch_backward(v) for t, v in zip(transforms, values_list)]


def finalize_backward(transforms, pending):
    """Wait for a :func:`dispatch_backward` batch; the ``(Z, Y, X)`` results in order."""
    return [t._finalize_backward(o) for t, o in zip(transforms, pending)]


def dispatch_forward(transforms, spaces_list, scalings):
    """Split-phase forward dispatch; ``scalings`` is one :class:`ScalingType`
    per transform."""
    transforms, spaces_list = list(transforms), list(spaces_list)
    scalings = list(scalings)
    _check_batch(transforms, spaces_list, "dispatch_forward")
    if len(scalings) != len(transforms):
        raise InvalidParameterError(
            f"dispatch_forward: got {len(transforms)} transforms but "
            f"{len(scalings)} scaling types"
        )
    return [t._dispatch_forward(s, sc) for t, s, sc in zip(transforms, spaces_list, scalings)]


def finalize_forward(transforms, pending):
    """Wait for a :func:`dispatch_forward` batch; the packed values in order."""
    return [t._finalize_forward(p) for t, p in zip(transforms, pending)]


def multi_transform_backward(transforms, values_list):
    """Independent backward transforms, all dispatched before any wait.
    ``values_list[i]`` is the packed input of ``transforms[i]``; returns the
    space-domain results in order (reference: multi_transform.hpp:72-95)."""
    transforms, values_list = list(transforms), list(values_list)
    with timing.scoped("multi backward"):
        with timing.scoped("dispatch all"):
            pending = dispatch_backward(transforms, values_list)
        with timing.scoped("finalize all"):
            return finalize_backward(transforms, pending)


def multi_transform_forward(transforms, spaces_list=None, scaling_types=None):
    """Independent forward transforms, all dispatched before any wait.
    ``spaces_list[i]`` is the space input of ``transforms[i]`` (None: its
    retained space, e.g. right after a backward); ``scaling_types`` one
    scaling for all or one per transform (reference: multi_transform.hpp:48-70)."""
    transforms = list(transforms)
    spaces_list = [None] * len(transforms) if spaces_list is None else list(spaces_list)
    scalings = _broadcast_scaling(scaling_types, len(transforms))
    with timing.scoped("multi forward"):
        with timing.scoped("dispatch all"):
            pending = dispatch_forward(transforms, spaces_list, scalings)
        with timing.scoped("finalize all"):
            return finalize_forward(transforms, pending)
