"""Per-stage timers, throughput counters, and jax.profiler integration.

The reference has no tracing at all (SURVEY.md §5 -- only ad-hoc time.time()
deltas in one integration test); this module is the rebuild's first-class
observability layer:

  * ``StageTimer`` -- nested named stages with wall time and MB/s, logged
    through the package logger and queryable as a dict (the bench harness
    and the converter's verbose mode both use it).
  * ``device_trace`` -- context manager around ``jax.profiler.trace`` for
    capturing TensorBoard-viewable device traces of the encode pipeline.

Costs nothing when disabled: the default StageTimer is a no-op unless
explicitly enabled or the package logger is at DEBUG.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

logger = logging.getLogger("flac_raster_tpu.profiling")

__all__ = ["StageTimer", "device_trace", "timed_stage"]


@dataclass
class StageRecord:
    name: str
    seconds: float
    bytes: int = 0

    @property
    def mb_per_s(self) -> float:
        return self.bytes / 1e6 / self.seconds if self.seconds > 0 else 0.0


@dataclass
class StageTimer:
    """Collects (stage, seconds, MB/s) records.

    Usage::

        timer = StageTimer(enabled=True)
        with timer.stage("normalize", nbytes=data.nbytes):
            ...
        timer.report()   # logs one line per stage
    """

    enabled: bool = False
    records: list[StageRecord] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            rec = StageRecord(name, dt, nbytes)
            self.records.append(rec)
            if nbytes:
                logger.debug("%s: %.3fs (%.1f MB/s)", name, dt, rec.mb_per_s)
            else:
                logger.debug("%s: %.3fs", name, dt)

    def as_dict(self) -> dict[str, dict[str, float]]:
        return {
            r.name: {"seconds": r.seconds, "mb_per_s": r.mb_per_s}
            for r in self.records
        }

    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)

    def report(self, level: int = logging.INFO) -> None:
        for r in self.records:
            if r.bytes:
                logger.log(level, "%-20s %8.3fs %10.1f MB/s", r.name, r.seconds, r.mb_per_s)
            else:
                logger.log(level, "%-20s %8.3fs", r.name, r.seconds)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Capture a jax.profiler trace (TensorBoard format) when log_dir given."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
    logger.info("device trace written to %s", log_dir)


@contextlib.contextmanager
def timed_stage(name: str, nbytes: int = 0, level: int = logging.DEBUG):
    """Standalone one-shot stage timer (module-logger output)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if nbytes:
            logger.log(level, "%s: %.3fs (%.1f MB/s)", name, dt, nbytes / 1e6 / max(dt, 1e-9))
        else:
            logger.log(level, "%s: %.3fs", name, dt)
