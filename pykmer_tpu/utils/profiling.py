"""Profiling hooks.

The reference's profiling story is `pypy -m cProfile` plus the Timer's bp/s
fields (README.md:255-259, tools.py:24-64). Device counterpart: wrap pipeline
sections in `jax.profiler` traces (viewable in TensorBoard/Perfetto) while
keeping the same durable Timer fields in `.kin.json`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a jax.profiler trace when ``log_dir`` (or PYKMER_TPU_TRACE_DIR)
    is set; no-op otherwise."""
    log_dir = log_dir or os.environ.get("PYKMER_TPU_TRACE_DIR")
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-span inside a device trace (TraceAnnotation)."""
    try:
        import jax

        ctx = jax.profiler.TraceAnnotation(name)
    except Exception:
        ctx = contextlib.nullcontext()
    with ctx:
        yield


class StageTimer:
    """Wall-clock per-stage accounting printed as an aligned table."""

    def __init__(self) -> None:
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def report(self) -> str:
        total = sum(dt for _, dt in self.stages) or 1e-9
        rows = [
            f"  {name:24s} {dt * 1e3:10.1f} ms {dt / total * 100.0:6.1f}%"
            for name, dt in self.stages
        ]
        return "\n".join(rows)
