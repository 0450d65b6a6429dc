"""Aggregating wall-clock profiler + jax.profiler hooks.

Replaces the reference's `ca::Profiler` (dependency/tictoc_profiler/
include/tictoc_profiler/profiler.hpp:54-84): named tictoc sections into a
global registry with aggregated stats, plus helpers for device-accurate
timing (block on small fetches) and XLA traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class _Entry:
    total: float = 0.0
    count: int = 0
    min_t: float = float("inf")
    max_t: float = 0.0

    def add(self, dt: float) -> None:
        self.total += dt
        self.count += 1
        self.min_t = min(self.min_t, dt)
        self.max_t = max(self.max_t, dt)


@dataclass
class Profiler:
    """tictoc(name) toggles a named timer; aggregated stats on report."""

    enabled: bool = True
    _open: dict = field(default_factory=dict)
    _agg: dict = field(default_factory=lambda: defaultdict(_Entry))

    def tictoc(self, name: str) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        if name in self._open:
            self._agg[name].add(now - self._open.pop(name))
        else:
            self._open[name] = now

    @contextlib.contextmanager
    def section(self, name: str):
        self.tictoc(name)
        try:
            yield
        finally:
            self.tictoc(name)

    def report(self) -> str:
        rows = sorted(
            self._agg.items(), key=lambda kv: kv[1].total / max(kv[1].count, 1), reverse=True
        )
        lines = [f"{'name':<40} {'calls':>6} {'avg ms':>9} {'min ms':>9} {'max ms':>9} {'total ms':>10}"]
        for name, e in rows:
            avg = e.total / max(e.count, 1)
            lines.append(
                f"{name:<40} {e.count:>6} {avg * 1e3:>9.2f} {e.min_t * 1e3:>9.2f} "
                f"{e.max_t * 1e3:>9.2f} {e.total * 1e3:>10.1f}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self._open.clear()
        self._agg.clear()


GLOBAL = Profiler()
tictoc = GLOBAL.tictoc
section = GLOBAL.section


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Capture a jax.profiler trace (TensorBoard format) for a code region."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
