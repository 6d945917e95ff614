"""Wall-clock and device timing utilities.

Replaces CBenchmark (reference: src/General/CBenchmark.cpp:46-119) and adds
what the reference lacked (SURVEY.md section 5): per-phase timers, a device
profiler hook (jax.profiler traces viewable in TensorBoard/XProf), and a
mass-balance audit trail.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Benchmark:
    """Named accumulating wall-clock timers."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._start = time.monotonic()

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def report(self) -> str:
        lines = [f"total wall: {self.elapsed:.2f}s"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"  {name:<24s} {self.totals[name]:9.3f}s "
                         f"x{self.counts[name]}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device profile (works on GPU and CPU backends):

        with device_trace('/tmp/prof'):
            sim.run_to(60.0)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class MassBalanceAudit:
    """Tracks domain volume over time; the papers' <1% budget check
    (BASELINE.md accuracy anchors) as a runtime observable."""

    def __init__(self, sim):
        self.sim = sim
        self.records = []

    def sample(self):
        self.records.append((self.sim.t, self.sim.volume()))
        return self.records[-1]

    def drift(self) -> float:
        """Relative volume change between first and last samples."""
        if len(self.records) < 2:
            return 0.0
        v0 = self.records[0][1]
        v1 = self.records[-1][1]
        return (v1 - v0) / max(abs(v0), 1e-30)
