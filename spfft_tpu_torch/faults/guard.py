"""Guard mode: checks before and after each host-facing transform.

The port of ``spfft_tpu/faults/guard.py``. ``SPFFT_TPU_GUARD=1`` (or
``guard=True`` on a plan) turns on:

- a **non-finite scan** of the input before staging and of the result after
  the wait: a NaN or Inf raises the platform's typed execution error
  (:class:`~spfft_tpu_torch.errors.HostExecutionError` on a CPU plan,
  :class:`~spfft_tpu_torch.errors.GPUFFTError` on the card);
- the **shape and dtype** of the result against the plan's contract;
- the **device** of the result against the plan's device.

The scan runs where the tensor lives, never a copy of the tensor to the
host: one sum over every tensor of a call (per device and dtype; a NaN or
Inf anywhere makes it non-finite) and one host transfer. A sum that is not
finite is confirmed tensor by tensor by an exact count (an overflow of
finite values is no failure), which also gives the message its count of
non-finite values. Numpy inputs are scanned on the host, without a copy.
Every check counts ``guard_checks_total{check}``, every failure
``guard_failures_total{check}`` before it raises, and each verdict lands as
a ``guard`` flight-recorder event. Guard mode changes nothing that runs on
the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import knobs, obs
from ..errors import GPUFFTError, HostExecutionError

GUARD_ENV = "SPFFT_TPU_GUARD"


def guard_enabled(explicit: bool | None = None) -> bool:
    """An explicit ``guard=`` wins, else ``SPFFT_TPU_GUARD`` (default off)."""
    if explicit is not None:
        return bool(explicit)
    return knobs.get_bool(GUARD_ENV)


def execution_error(platform: str):
    """The typed error of an execution failure on ``platform``:
    :class:`HostExecutionError` for ``"cpu"``, else :class:`GPUFFTError`."""
    return HostExecutionError if str(platform) == "cpu" else GPUFFTError


def _fail(check: str, platform: str, message: str):
    obs.counter("guard_failures_total", check=check).inc()
    obs.trace.event("guard", check=check, verdict="fail", message=message)
    raise execution_error(platform)(f"guard [{check}]: {message}")


def _as_tensor(a):
    """A tensor over ``a``'s data: itself, or a numpy array's buffer (no
    copy where torch can share it)."""
    if torch.is_tensor(a):
        return a
    a = np.asarray(a)
    try:
        return torch.from_numpy(a)
    except TypeError:  # a dtype torch lacks: copied
        return torch.as_tensor(a.astype(np.complex128 if np.iscomplexobj(a) else np.float64))


def _np_dtype(t) -> np.dtype:
    """A tensor's dtype under numpy's name (the messages are the JAX package's)."""
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _memory_order(t):
    """``t``'s elements as one vector in memory order: a view for any dense
    layout (the mxu engine's ``(Z, Y, X)`` results are permuted views)."""
    return t.permute(sorted(range(t.dim()), key=lambda a: -t.stride(a))).reshape(-1)


def _maybe_finite(tensors) -> list:
    """Per tensor: True when all its values are finite, False when they may
    not be, None for no float data. One sum per device and dtype over the
    tensors together (a NaN or Inf anywhere makes it non-finite), so a call
    costs a few kernels and one host transfer per group, whatever the
    number of shards."""
    flags, groups = [None] * len(tensors), {}
    for i, t in enumerate(tensors):
        if t is not None and (t.is_floating_point() or t.is_complex()):
            groups.setdefault((t.device, t.dtype), []).append(i)
    for idx in groups.values():
        parts = [tensors[i] for i in idx]
        total = parts[0].sum() if len(parts) == 1 else torch.cat(
            [_memory_order(t) for t in parts]).sum()
        ok = bool(torch.isfinite(total))
        for i in idx:
            flags[i] = ok
    return flags


def check_array(arr, *, check: str, platform: str, shape=None, dtype=None):
    """Check one array (tensor or numpy) or each of a per-shard list:
    finite values, and optionally the exact shape and dtype. Raises the
    platform's typed error on the first violation; returns ``arr``."""
    obs.counter("guard_checks_total", check=check).inc()
    arrays = arr if isinstance(arr, (list, tuple)) else (arr,)
    tensors = [None if a is None else _as_tensor(a) for a in arrays]  # None: another process's
    finite = _maybe_finite(tensors)
    for i, t in enumerate(tensors):
        if t is None:
            continue
        tag = f"{check}[{i}]" if len(arrays) > 1 else check
        if shape is not None and tuple(t.shape) != tuple(shape):
            _fail(check, platform, f"{tag} shape {tuple(t.shape)} != expected {tuple(shape)}")
        if dtype is not None and _np_dtype(t) != np.dtype(dtype):
            _fail(check, platform,
                  f"{tag} dtype {_np_dtype(t)} != expected {np.dtype(dtype)}")
        if finite[i] is False:
            bad = int(t.numel() - int(torch.isfinite(t).sum()))
            if bad:  # else finite values whose sum overflowed
                _fail(check, platform, f"{tag}: {bad} non-finite value(s) of {t.numel()}")
    obs.trace.event("guard", check=check, verdict="ok")
    return arr


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            yield from _leaves(leaf)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            yield from _leaves(leaf)


def check_device(tree, device, *, check: str, platform: str):
    """Check that every tensor in ``tree`` lies on the plan's ``device``."""
    obs.counter("guard_checks_total", check=check).inc()
    device = torch.device(device)
    for leaf in _leaves(tree):
        if leaf.device != device:
            _fail(check, platform,
                  f"result on {[str(leaf.device)]} but the plan is bound to {device}")
    obs.trace.event("guard", check=check, verdict="ok")
    return tree
