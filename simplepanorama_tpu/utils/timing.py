"""Tracing/profiling: named accumulating timers + optional jax.profiler.

Capability mirror of util::Timer (/root/reference/src/system/_util.h:56-90)
— named start/stop pairs accumulating durations — plus what the reference
lacks: a stage context manager that can emit jax.profiler traces
(SPT_TRACE_DIR env) so device time is attributable per pipeline stage.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timer:
    """Named accumulating stopwatch (util::Timer semantics)."""

    def __init__(self) -> None:
        self._start: Dict[str, float] = {}
        self.durations: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def start(self, name: str) -> None:
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        t0 = self._start.pop(name, None)
        if t0 is None:
            return 0.0
        dt = time.perf_counter() - t0
        self.durations[name] += dt
        self.counts[name] += 1
        return dt

    def report(self) -> str:
        lines = [f"{k}: {v:.3f}s x{self.counts[k]}"
                 for k, v in sorted(self.durations.items(),
                                    key=lambda kv: -kv[1])]
        return "\n".join(lines)


_GLOBAL = Timer()


def global_timer() -> Timer:
    return _GLOBAL


def _sync_device() -> None:
    """Drain the default device's execution stream: block on a trivial
    program enqueued AFTER the stage's work (per-device program execution
    is FIFO, so this waits for everything already dispatched)."""
    import jax

    global _SYNC_FN
    if _SYNC_FN is None:
        import jax.numpy as jnp
        _SYNC_FN = jax.jit(lambda: jnp.zeros(()))
    jax.block_until_ready(_SYNC_FN())


_SYNC_FN = None


@contextlib.contextmanager
def stage(name: str, timer: Optional[Timer] = None) -> Iterator[None]:
    """Time a pipeline stage; emits a jax.profiler trace span when
    SPT_TRACE_DIR is set (start_trace on first use).

    With SPT_SYNC_STAGES set, the device stream is drained at each stage
    boundary so per-stage wall times attribute ASYNC device work to the
    stage that dispatched it instead of letting a later stage absorb it
    (bench.py uses this for the honest stage breakdown; it adds sync
    points, so throughput runs leave it off)."""
    t = timer or _GLOBAL
    trace_dir = os.environ.get("SPT_TRACE_DIR")
    ctx = contextlib.nullcontext()
    if trace_dir:
        import jax
        ctx = jax.profiler.TraceAnnotation(name)
    t.start(name)
    try:
        with ctx:
            yield
    finally:
        if os.environ.get("SPT_SYNC_STAGES"):
            _sync_device()
        t.stop(name)
