"""Profiling counters (crazyflie-perf-compatible semantics).

Host-side equivalent of Common/Common/Time/perf_counter.{hpp,cpp}: three
counter kinds — COUNT (event counts), ELAPSED (begin/end timing with
min/max/mean), INTERVAL (time between successive events) — kept in a
global registry with a print-all dump. Device-side profiling goes through
torch.profiler; these counters time the host loop (bridge ticks, plan calls,
device round-trips).

A copy of `agrifly_tpu/utils/perf.py` (tests/test_torch_host_copies.py
holds the two equal).
"""

from __future__ import annotations

import time
from typing import Dict

PC_COUNT = 0
PC_ELAPSED = 1
PC_INTERVAL = 2

_registry: Dict[str, "PerfCounter"] = {}


class PerfCounter:
    def __init__(self, kind, name):
        self.kind = kind
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._t0 = None
        self._last = None

    # COUNT
    def bump(self, n=1):
        self.count += n

    # ELAPSED
    def begin(self):
        self._t0 = time.perf_counter()

    def end(self):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._accumulate(dt)
        self._t0 = None

    # INTERVAL
    def event(self):
        t = time.perf_counter()
        if self._last is not None:
            self._accumulate(t - self._last)
        self._last = t

    def _accumulate(self, dt):
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    def summary(self):
        if self.kind == PC_COUNT:
            return f"{self.name}: count={self.count}"
        return (
            f"{self.name}: n={self.count} mean={self.mean * 1e3:.3f}ms "
            f"min={self.min * 1e3 if self.count else 0:.3f}ms "
            f"max={self.max * 1e3:.3f}ms total={self.total:.3f}s"
        )


def alloc(kind, name) -> PerfCounter:
    if name not in _registry:
        _registry[name] = PerfCounter(kind, name)
    return _registry[name]


def print_all():
    for name in sorted(_registry):
        print(_registry[name].summary())


def reset_all():
    _registry.clear()


class timed:
    """Context manager: with perf.timed('plan'): ..."""

    def __init__(self, name):
        self.counter = alloc(PC_ELAPSED, name)

    def __enter__(self):
        self.counter.begin()
        return self.counter

    def __exit__(self, *exc):
        self.counter.end()
