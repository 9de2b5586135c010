"""Profiling and timing helpers.

The reference sprinkles a manual steady_clock stopwatch and duplicated
``*_time`` method variants through the hot paths (helpers/timer.h:21-84,
ngd/NGD-GH-impl.h:66-127, GVI-GH-Cuda-impl.h:289-460).  On an accelerator the idiomatic
equivalents are a device-synchronized wall timer and ``jax.profiler`` traces
— no duplicated code paths.
"""

from __future__ import annotations

import contextlib
import time

import jax


class Timer:
    """Device-synchronized stopwatch (blocks on outstanding work)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def elapsed_ms(self, result=None) -> float:
        if result is not None:
            jax.block_until_ready(result)
        return (time.perf_counter() - self._t0) * 1e3


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/profile'):`` captures a jax.profiler trace viewable
    in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, repeats: int = 5, warmup: int = 1) -> float:
    """Best-of-N wall time (seconds) of a jitted callable, compile excluded."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
