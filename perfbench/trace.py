"""The traced stretch: ``torch.profiler`` over a run of pairs, and the
reduction of its Chrome trace to what the per-layer metrics read.

The stretch is ``profile_pairs`` pairs (whole blocks) that follow the timed
window in the same sweep, after one untraced warm-up block of the
profiler's schedule. The harness marks it with ranges of its own
(``perfbench.stretch``; ``perfbench.backward_pair``, ``.potential``,
``.forward_pair`` and ``.fence`` around the calls), which the trace holds on
the host's timeline, on the same clock as the device's activities. A kernel
whose launch the host made inside ``perfbench.potential`` (matched by the
launch's correlation id) is the harness's own multiply by ``V(r)``: it is
device work of the pair, but of no layer of the program.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "perfbench.stretch"
POTENTIAL = "perfbench.potential"
HARNESS = "harness"  # the family of the harness's own kernels


def union(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = re.sub(r"^void\s+", "", name)
    cut = min((i for i in (name.find("<", 1), name.find("(", 1)) if i > 0), default=len(name))
    return name[:cut][:96]


class Profile:
    """The device activities and the harness's ranges of one traced stretch
    of ``pairs`` pairs; times in µs."""

    def __init__(self, events: list, pairs: int, families: dict):
        self.pairs = pairs
        self.families = {f: [re.compile(p) for p in pats] for f, pats in families.items()}
        ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith("perfbench.")]
        stretch = [e for e in ranges if e["name"] == STRETCH]
        if stretch:
            self.start = float(stretch[0]["ts"])
            self.end = self.start + float(stretch[0]["dur"])
        else:
            self.start, self.end = math.inf, -math.inf
        inside = lambda e: self.start <= float(e["ts"]) < self.end
        self.device_ops = [e for e in events if e.get("ph") == "X"
                           and e.get("cat") in DEVICE_CATS and inside(e)]
        self.host_ranges = [e for e in ranges if e["name"] != STRETCH and inside(e)]
        self.harness_launches = _launches_inside(
            events, [e for e in ranges if e["name"] == POTENTIAL])

    # ---- what the metrics read ------------------------------------------------------

    @property
    def window_us(self) -> float:
        return max(self.end - self.start, 0.0)

    def _spans(self, ops):
        return [(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), self.end)) for e in ops]

    def busy_us(self) -> float:
        return union(self._spans(self.device_ops))

    def family(self, e) -> str | None:
        if e["cat"] != "kernel":
            return None
        if e.get("args", {}).get("correlation") in self.harness_launches:
            return HARNESS
        for name, patterns in self.families.items():
            if any(p.search(e["name"]) for p in patterns):
                return name
        return None

    def family_us(self, family: str) -> float:
        return sum(float(e["dur"]) for e in self.device_ops if self.family(e) == family)

    def count(self, family: str) -> int:
        return sum(1 for e in self.device_ops if self.family(e) == family)

    def copy_us(self) -> float:
        return sum(float(e["dur"]) for e in self.device_ops if e["cat"] == "gpu_memcpy")

    def other_us(self) -> float:
        """Kernels of no family, and memsets."""
        return sum(float(e["dur"]) for e in self.device_ops
                   if e["cat"] != "gpu_memcpy" and self.family(e) is None)

    def idle_gaps(self) -> list:
        """The device's idle intervals ``(start, end)`` inside the stretch."""
        gaps, reach = [], self.start
        for start, end in sorted(self._spans(self.device_ops)):
            if start > reach:
                gaps.append((reach, start))
            reach = max(reach, end)
        if self.end > reach:
            gaps.append((reach, self.end))
        return gaps

    # ---- the breakdown ----------------------------------------------------------------

    def device_ops_s(self, top: int = 10) -> list:
        """``[name, seconds]`` of the device operations that took most time."""
        by = {}
        for e in self.device_ops:
            key = short_name(e["name"]) if e["cat"] == "kernel" else e["name"]
            if self.family(e) == HARNESS:
                key = f"{HARNESS}: {key}"
            by[key] = by.get(key, 0.0) + float(e["dur"]) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_by_host_s(self, top: int = 10) -> list:
        """``[what the host was doing, seconds]``: the device's idle time
        summed by the harness's range the host was in when each gap began."""
        ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                        for e in self.host_ranges)
        by = {}
        for start, end in self.idle_gaps():
            label = "between calls"
            for r0, r1, name in ranges:
                if r0 <= start < r1:
                    label = name.removeprefix("perfbench.")
                elif r0 > start:
                    break
            by[label] = by.get(label, 0.0) + (end - start) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def _launches_inside(events: list, ranges: list) -> set:
    """Correlation ids of the runtime calls (kernel launches) the host made
    inside any of ``ranges``."""
    spans = sorted((float(r["ts"]), float(r["ts"]) + float(r["dur"])) for r in ranges)
    starts = [a for a, _ in spans]
    found = set()
    for e in events:
        if e.get("cat") != "cuda_runtime" or "correlation" not in e.get("args", {}):
            continue
        i = bisect.bisect_right(starts, float(e["ts"])) - 1
        if i >= 0 and float(e["ts"]) < spans[i][1]:
            found.add(e["args"]["correlation"])
    return found


def warm() -> None:
    """One tiny profiled op: the profiler's own first-use cost, in set-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile_stretch(sweep, pairs: int, families: dict) -> Profile:
    """``pairs`` pairs (whole blocks) of ``sweep`` under the profiler."""
    events, pairs = record_stretch(sweep, pairs)
    return Profile(events, pairs, families)


def record_stretch(sweep, pairs: int) -> tuple[list, int]:
    """The Chrome trace's events of ``pairs`` pairs (whole blocks) of
    ``sweep``, and the number of pairs traced."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    blocks = max(1, -(-pairs // sweep.fence_every))
    sweep.annotate = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            sweep.block()
            prof.step()
            with record_function(STRETCH):
                for _ in range(blocks):
                    sweep.block()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
    finally:
        sweep.annotate = False
    return events, blocks * sweep.fence_every
