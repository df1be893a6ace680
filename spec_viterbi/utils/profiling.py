"""Profiling/tracing helpers.

The reference's only instrumentation is benchmark wall-clock timing plus
CUDA line info for nvprof (SURVEY.md §5). Equivalents here:

- :func:`trace` — a `jax.profiler` trace context writing TensorBoard-format
  traces (xplane) for per-kernel timing;
- :class:`StepTimer` — lightweight wall-clock step accounting with median /
  percentile summaries, matching the benchmark harness' semantics.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: ``with trace("/tmp/trace"): decode(...)``.

    View with TensorBoard's profile plugin or `xprof`.
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Wall-clock accumulator: ``with timer.step(): ...`` per iteration."""

    def __init__(self):
        self.times_ms: list[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times_ms.append((time.perf_counter() - t0) * 1e3)

    def summary(self) -> dict:
        if not self.times_ms:
            return {"count": 0}
        a = np.asarray(self.times_ms)
        return {
            "count": int(a.size),
            "median_ms": float(np.median(a)),
            "mean_ms": float(a.mean()),
            "p90_ms": float(np.percentile(a, 90)),
            "min_ms": float(a.min()),
            "max_ms": float(a.max()),
        }
