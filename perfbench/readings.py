"""The arithmetic the metric readers share (``metrics/<name>.py``).

Each returns None where it finds nothing to read: no traced stretch, no
kernel of the family, no span. Per-pair device times are the activities'
summed durations over the pairs of the traced stretch.
"""
from __future__ import annotations

import statistics

# NVLink 4 on the H100 SXM: 18 links of 25 GB/s each way, 450 GB/s a
# direction (NVIDIA's data sheet: 900 GB/s in both directions together)
NVLINK_BYTES_PER_S = 450e9


def per_pair_ms(profile, us_of) -> float | None:
    """``us_of(profile)`` µs of the stretch, per pair, in ms."""
    if profile is None or not profile.pairs or not profile.device_ops:
        return None
    us = us_of(profile)
    return us / 1e3 / profile.pairs if us > 0 else None


def family_ms(profile, family: str) -> float | None:
    return per_pair_ms(profile, lambda p: p.family_us(family))


def idle_pct(profile) -> float | None:
    """The share of the stretch in which no activity ran on the device."""
    if profile is None or not profile.device_ops or profile.window_us <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_us() / profile.window_us)


def host_call_ms(window: dict) -> float | None:
    """The host's time inside ``backward_pair`` + ``forward_pair``, per pair."""
    spans = window.get("host_call_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None


def latency_ms(window: dict, quantile: int) -> float | None:
    """The ``quantile``-th percentile of the window's pair latencies
    (Python's ``statistics.quantiles``, exclusive method, in 100 steps)."""
    lat = window.get("latency_ms") or []
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100)[quantile - 1]
