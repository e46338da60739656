"""Profiling / tracing / metrics.

The reference's observability is wall-clock prints around phases
(``Octree.java:195,272-290``), a per-frame time in the loop
(``Window.java:83,102-103``), node-type counters (``Octree.java:31-34``), and
GPU-cost *visualization* via the iteration-count heatmap (render mode 1).
All of those exist here (Application.frame_time_ms, Octree.node_counts,
shade.shade_heatmap); this module adds the structured pieces the reference
lacks: scoped timers with summaries, and a jax device-profiler hook.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_timings: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def timer(name: str, sync=None):
    """Scoped wall-clock timer.  Pass ``sync=jax.block_until_ready``-able
    output (or a callable) to include device time."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            import jax

            jax.block_until_ready(sync() if callable(sync) else sync)
        _timings[name].append(time.perf_counter() - t0)


def summary() -> dict[str, dict]:
    out = {}
    for name, ts in _timings.items():
        out[name] = {"count": len(ts), "total_s": sum(ts),
                     "mean_ms": 1000.0 * sum(ts) / len(ts),
                     "last_ms": 1000.0 * ts[-1]}
    return out


def reset() -> None:
    _timings.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace scope (open with TensorBoard / xprof).  A trace
    that cannot start or stop raises: a measurement must not silently
    come back without its trace."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
