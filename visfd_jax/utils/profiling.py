"""Profiling helpers.

The reference ships gprof/valgrind compiler configs
(``alternate_compiler_settings/for_debugging_and_profiling/``); the
equivalents here are XLA profiler traces and per-stage device timings.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Sequence, Tuple


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``jax.profiler`` trace (open with TensorBoard or
    Perfetto).  Usage::

        with device_trace("/tmp/trace"):
            out = step(x)
            out.block_until_ready()
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def stage_timings(
    stages: Sequence[Tuple[str, Callable[[], object]]],
    warmup: int = 1,
    iters: int = 3,
) -> Dict[str, float]:
    """Best-of-N wall timings for a list of (name, thunk) stages; each
    thunk must return a JAX value (blocked on via block_until_ready).
    The warmup runs absorb compilation."""
    import jax

    out: Dict[str, float] = {}
    for name, thunk in stages:
        for _ in range(warmup):
            jax.block_until_ready(thunk())
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(thunk())
            best = min(best, time.perf_counter() - t0)
        out[name] = best
    return out
