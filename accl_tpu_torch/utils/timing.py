"""Benchmark timer (reference: driver/xrt/include/accl/timing.hpp).

Port of ``accl_tpu/utils/timing.py``.  One wall-clock timing primitive:
:class:`Timer` is the start/end object (and context manager), and
:func:`timed` is a thin context manager over it (also importable from
utils/profiling.py).  Both expose nanoseconds and microseconds
consistently (duration_ns / duration_us; durationUs is kept as the
reference-shaped alias).
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional


class Timer:
    """Wall-clock timer with the reference Timer's start/end/duration
    shape."""

    def __init__(self):
        self._start = 0.0
        self._end = 0.0
        self._running = False

    def start(self) -> None:
        self._start = time.perf_counter()
        self._running = True

    def end(self) -> None:
        self._end = time.perf_counter()
        self._running = False

    def _elapsed_s(self) -> float:
        end = time.perf_counter() if self._running else self._end
        return end - self._start

    def duration_us(self) -> float:
        return self._elapsed_s() * 1e6

    def duration_ns(self) -> float:
        return self._elapsed_s() * 1e9

    #: reference spelling (timing.hpp durationUs)
    durationUs = duration_us

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.end()


@contextlib.contextmanager
def timed(label: str, results: Optional[dict] = None) -> Iterator[Timer]:
    """Time a block with a :class:`Timer`; appends ns to results[label]
    if given (the profiling.timed shape — importable from either
    module, one implementation)."""
    t = Timer()
    t.start()
    try:
        yield t
    finally:
        t.end()
        if results is not None:
            results.setdefault(label, []).append(t.duration_ns())
