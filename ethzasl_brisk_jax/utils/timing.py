"""Tagged timing registry with rolling-window statistics.

Mirrors the reference's ``brisk::timing`` subsystem
(``brisk/include/brisk/internal/timer.h:40-190``, ``brisk/src/timer.cc``):
a process-wide registry of named timers, each keeping a rolling window of
the last N samples with total/mean/min/max/variance and Hz, plus a
``print_timing()`` report. ``DebugTimer`` compiles away unless enabled
(the reference's ``ENABLE_BRISK_TIMING`` switch, ``timer.h:182-186``).

Timers can include device time: pass the result arrays (any pytree) as
``block_on`` and the timer stops after ``jax.block_until_ready`` on
them. ``annotate`` wraps ``jax.profiler.TraceAnnotation`` so tags line up
with XLA traces. Stage tags follow the reference's taxonomy
("0.x Detection ... / 1.x Extraction ...",
``scale-space-layer-inl.h:110,210,221,381``).
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

_WINDOW = 50  # Accumulator<double,double,50> (timer.h:135)

_ENABLED_DEBUG = os.environ.get("BRISK_TIMING", "0") not in ("0", "")


class _Accumulator:
    """Rolling-window accumulator (timer.h:60-133 semantics)."""

    def __init__(self, window: int = _WINDOW):
        self.window = deque(maxlen=window)
        self.total_samples = 0
        self.total_time = 0.0
        self.min_v = math.inf
        self.max_v = -math.inf

    def add(self, v: float) -> None:
        self.window.append(v)
        self.total_samples += 1
        self.total_time += v
        self.min_v = min(self.min_v, v)
        self.max_v = max(self.max_v, v)

    @property
    def rolling_mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    @property
    def rolling_std(self) -> float:
        n = len(self.window)
        if n < 2:
            return 0.0
        m = self.rolling_mean
        return math.sqrt(sum((x - m) ** 2 for x in self.window) / (n - 1))

    @property
    def mean(self) -> float:
        return self.total_time / max(self.total_samples, 1)


class Timing:
    """Singleton tag registry (timer.h:135-180)."""

    _lock = threading.Lock()
    _tags: dict[str, _Accumulator] = {}

    @classmethod
    def add(cls, tag: str, seconds: float) -> None:
        with cls._lock:
            cls._tags.setdefault(tag, _Accumulator()).add(seconds)

    @classmethod
    def get(cls, tag: str) -> Optional[_Accumulator]:
        return cls._tags.get(tag)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._tags.clear()

    @classmethod
    def print_timing(cls) -> str:
        """Formatted report (Timing::Print, timer.cc)."""
        lines = ["BRISK Timing", "-" * 78]
        with cls._lock:
            for tag in sorted(cls._tags):
                a = cls._tags[tag]
                hz = 1.0 / a.rolling_mean if a.rolling_mean > 0 else 0.0
                lines.append(
                    f"{tag:<48s} {a.total_samples:>6d}  "
                    f"mean {a.rolling_mean * 1e3:9.3f}ms  "
                    f"[{a.min_v * 1e3:8.3f}, {a.max_v * 1e3:8.3f}]  "
                    f"{hz:8.1f}Hz"
                )
        report = "\n".join(lines)
        return report


@contextmanager
def timer(tag: str, block_on=None):
    """Context timer; pass a jax array/pytree as ``block_on`` to include
    device execution time (waited for with ``jax.block_until_ready``)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block_on is not None:
            import jax

            jax.block_until_ready(block_on)
        Timing.add(tag, time.perf_counter() - t0)


@contextmanager
def debug_timer(tag: str, block_on=None):
    """No-op unless BRISK_TIMING is set (DebugTimer, timer.h:182)."""
    if not _ENABLED_DEBUG:
        yield
        return
    with timer(tag, block_on):
        yield


@contextmanager
def annotate(tag: str):
    """jax.profiler trace annotation so tags appear in XLA profiles."""
    import jax.profiler

    with jax.profiler.TraceAnnotation(tag):
        yield


class Timer:
    """Imperative start/stop timer (timing::Timer, timer.h:40-58)."""

    def __init__(self, tag: str, construct_stopped: bool = False):
        self.tag = tag
        self._t0 = None
        if not construct_stopped:
            self.start()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        Timing.add(self.tag, time.perf_counter() - self._t0)
        self._t0 = None

    def is_timing(self) -> bool:
        return self._t0 is not None
