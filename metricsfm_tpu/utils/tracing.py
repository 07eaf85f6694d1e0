"""Tracing / profiling instrumentation.

The reference has no tracing (SURVEY.md §5: std::cout lines + one chrono
timer).  This module adds the missing engineering: scoped wall-clock
timers with aggregated reports, and hooks into the JAX device profiler for
per-kernel device traces.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional


class Tracer:
    """Aggregating scoped timer: with tracer.span("match"): ..."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack = []

    @contextlib.contextmanager
    def span(self, name: str, block_jax: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_jax:
                try:
                    import jax
                    jax.effects_barrier()
                except Exception:
                    pass
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"{name:<32} {total:9.3f}s  x{self.counts[name]}"
                 for name, total in rows]
        return "\n".join(lines)

    def as_dict(self):
        return {k: {"total_s": v, "count": self.counts[k]}
                for k, v in self.totals.items()}

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)


GLOBAL_TRACER = Tracer()
span = GLOBAL_TRACER.span


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a JAX/XLA device profile (view with TensorBoard/xprof)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
