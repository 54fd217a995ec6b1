"""The program's own ranges in the traced stretch, and the reductions of
them that per-layer metrics of the copies and of the host's path are to
read: the device time of the IR runtime's copy-in and copy-out a pair, and
the host's time a pair in the entry points, the copies and the replay.

``spfft_tpu_torch.timing.scoped`` draws each of its scopes as a
``torch.profiler`` range named ``spfft:<label>`` while a profiler runs, on
the host's timeline and on the same clock as the device's activities. On
the pair path a call is ``spfft:backward`` or ``spfft:forward``, with
``input staging`` and ``dispatch`` inside; inside the dispatch of a fused
plan the IR runtime's ``copy in`` (the caller's tensors into the CUDA
graph's static inputs), ``replay`` (``graph.replay()``) and ``copy out``
(the clone of its static outputs). A device activity belongs to a range
where the host made its runtime call (its ``cudaMemcpyAsync``, its launch)
inside it, matched by the call's correlation id as the harness's ``V(r)``
multiply is (:func:`perfbench.trace._launches_inside`).

Each reduction takes the stretch's ``Profile`` and the trace's whole event
list, which ``Profile`` does not keep: no per-layer metric reads them yet,
since a reader is handed the ``Profile`` alone. Every reduction returns None
where the stretch holds no range of the program (a program that draws none,
such as one older than these ranges). Times are µs; the reductions give ms a
pair.
"""
from __future__ import annotations

from perfbench.trace import _launches_inside, union

PREFIX = "spfft:"  # timing.RANGE_PREFIX of the program
CALLS = ("backward", "forward")
COPY_IN, REPLAY, COPY_OUT = "copy in", "replay", "copy out"
RUNTIME = (COPY_IN, REPLAY, COPY_OUT)


def ranges(profile, events, *labels) -> list:
    """The program's host ranges named ``spfft:<label>`` for ``labels`` that
    start inside the stretch."""
    names = {PREFIX + label for label in labels}
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") in names and profile.start <= float(e["ts"]) < profile.end]


def _spans(events) -> list:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)


def _per_pair_ms(profile, us):
    return us / 1e3 / profile.pairs if profile.pairs else None


def device_ms(profile, events, label: str) -> float | None:
    """Device time a pair of the activities (kernels, copies, memsets) whose
    runtime call the host made inside a ``label`` range."""
    if profile is None:
        return None
    found = ranges(profile, events, label)
    if not found:
        return None
    launched = _launches_inside(events, found)
    us = sum(float(e["dur"]) for e in profile.device_ops
             if e.get("args", {}).get("correlation") in launched)
    return _per_pair_ms(profile, us)


def host_ms(profile, events, *labels) -> float | None:
    """The host's time a pair inside the ranges of ``labels`` (each label's
    ranges are disjoint: one scope of the calling thread at a time)."""
    if profile is None:
        return None
    found = ranges(profile, events, *labels)
    if not found:
        return None
    return _per_pair_ms(profile, sum(float(e["dur"]) for e in found))


def entry_ms(profile, events) -> float | None:
    """The host's time a pair inside the calls (``backward``, ``forward``)
    that is in none of the IR runtime's ranges inside them: the entry
    points' own path (checks, staging, the engine's and the IR's dispatch)."""
    if profile is None:
        return None
    calls = _spans(ranges(profile, events, *CALLS))
    if not calls:
        return None
    inner = [(max(a, c0), min(b, c1)) for a, b in _spans(ranges(profile, events, *RUNTIME))
             for c0, c1 in calls if a < c1 and b > c0]
    return _per_pair_ms(profile, union(calls) - union(inner))


def merged(spans) -> list:
    """``(start, end)`` intervals merged into disjoint ones, in order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap(first: list, second: list) -> float:
    """Length of the intersection of two unions of intervals."""
    total, j = 0.0, 0
    second = merged(second)
    for a, b in merged(first):
        while j < len(second) and second[j][1] <= a:
            j += 1
        k = j
        while k < len(second) and second[k][0] < b:
            total += max(0.0, min(b, second[k][1]) - max(a, second[k][0]))
            k += 1
    return total


def idle_in_calls_pct(profile, events) -> float | None:
    """The device's idle time while the host is inside a call (``backward``,
    ``forward``), as a share of the stretch."""
    if profile is None or profile.window_us <= 0:
        return None
    calls = _spans(ranges(profile, events, *CALLS))
    if not calls:
        return None
    return 100.0 * overlap(profile.idle_gaps(), calls) / profile.window_us
