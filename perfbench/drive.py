"""The one traffic generator: a closed-loop sweep over the resident bands.

A traffic file (``traffic/<name>.json``) sets its parameters:

- ``fence_every``: pairs dispatched between two fences (the host runs that
  far ahead of the card). At 1 the caller waits on every pair, and every
  pair is timed from its ``backward_pair`` call to the device's completion
  of its ``forward_pair``;
- ``profile_pairs``: the length of the profiled stretch of a traced run.

Each pair is what a plane-wave code does to one band when it applies its
Hamiltonian's local part: the port's ``backward_pair(re, im)``, the returned
space multiplied in place by the potential ``V(r)`` (the harness's own
multiply), then ``forward_pair(ScalingType.FULL)`` over that space. The
forward's values are kept as the band's result, and the space for the
bands the check samples. Bands are taken in order, round and round.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import torch

import spfft_tpu_torch as sp

KEYS = {"about", "fence_every", "profile_pairs"}
SCALING = sp.ScalingType.FULL


def space_parts(space) -> tuple:
    """The tensors of a native space: (re, im) for C2C, the real one for R2C."""
    return (space,) if torch.is_tensor(space) else tuple(space)


class Sweep:
    def __init__(self, plan, values, traffic: dict, potential, sampled, device):
        unknown = set(traffic) - KEYS
        if unknown:
            raise ValueError(f"the sweep does not know the traffic's {sorted(unknown)}")
        self.plan, self.values, self.potential = plan, values, potential
        self.sampled = set(sampled)
        self.device = torch.device(device)
        self.bands = values.shape[0]
        self.results = [None] * self.bands
        self.kept = {}  # sampled band -> its latest space, V applied
        self.next = 0
        self.done = 0  # pairs dispatched
        self.fence_every = int(traffic["fence_every"])
        self.latency_ms: list = []
        self.host_call_s: list = []
        self.spans = False  # record host_call_s
        self.annotate = False  # profiler ranges around the calls
        self._events = (tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                        if self.device.type == "cuda" else None)

    def fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _range(self, name):
        return torch.profiler.record_function(name) if self.annotate else nullcontext()

    def pair(self):
        b = self.next
        self.next = (b + 1) % self.bands
        self.done += 1
        plan, v = self.plan, self.values[b]
        t0 = time.perf_counter() if self.spans else 0.0
        with self._range("perfbench.backward_pair"):
            space = plan.backward_pair(v[0], v[1])
        t1 = time.perf_counter() if self.spans else 0.0
        with self._range("perfbench.potential"):
            for part in space_parts(space):
                part.mul_(self.potential)
        t2 = time.perf_counter() if self.spans else 0.0
        with self._range("perfbench.forward_pair"):
            self.results[b] = plan.forward_pair(SCALING)
        if self.spans:
            self.host_call_s.append(t1 - t0 + time.perf_counter() - t2)
        if b in self.sampled:
            self.kept[b] = space

    def block(self):
        """``fence_every`` pairs, then the fence; at 1, the pair's latency."""
        if self.fence_every == 1:
            self._mark()
            self.pair()
            self.latency_ms.append(self._since_mark())
            return
        for _ in range(self.fence_every):
            self.pair()
        with self._range("perfbench.fence"):
            self.fence()

    def _mark(self):
        if self._events:
            self._events[0].record()
        else:
            self._t = time.perf_counter()

    def _since_mark(self) -> float:
        """ms from :meth:`_mark` to the completion of the work since, after
        the fence: on the card by CUDA events (the device's clock, from the
        call's enqueue to the forward's last kernel), elsewhere by the
        host's clock."""
        if not self._events:
            return 1e3 * (time.perf_counter() - self._t)
        self._events[1].record()
        with self._range("perfbench.fence"):
            self.fence()
        return self._events[0].elapsed_time(self._events[1])

    def sweep(self):
        """Every band once (the warm-up)."""
        for _ in range(-(-self.bands // self.fence_every)):
            self.block()

    def window(self, seconds: float) -> dict:
        """Whole blocks until ``seconds`` have passed, from the first
        dispatch to the last fence; the latencies and host spans are this
        window's."""
        self.latency_ms, self.host_call_s = [], []
        pairs, t0 = 0, time.perf_counter()
        while True:
            self.block()
            pairs += self.fence_every
            elapsed = time.perf_counter() - t0
            if self.over(elapsed, seconds):
                return {"pairs": pairs, "seconds": elapsed}

    def over(self, elapsed: float, seconds: float) -> bool:
        """Whether the window closes after the block just fenced (the
        ranks of a group agree on it: :class:`perfbench.ranks.RankSweep`)."""
        return elapsed >= seconds
