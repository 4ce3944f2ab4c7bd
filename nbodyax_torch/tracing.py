"""Spans and counters of a run, at the driver's part boundaries.

A ``Recorder`` belongs to one run (``driver.run_simulation`` makes one an
attempt and hands it to its runners and its bh probe). ``span(name)`` is a
context manager: the recorder keeps a stack of open spans, so each span
knows its parent, and sums each span's **self** seconds (its duration less
that of the spans opened inside it) by name. ``count(name, n)`` adds to a
counter. The sums and the counts are all it keeps.

When a ``torch.profiler`` records, each span is also a host-only profiler
range named ``nbodyax.<name>``: a plain CPU op among the profiler's host
events (``torch._C._profiler._RecordFunctionFast``), on the clock of the
device's events. ``torch.profiler.record_function`` is not used: its
ranges are user annotations, which the profiler copies onto the card's
timeline, where they would read as device activity. Tracing is on exactly
while a profiler records; with none, a span costs a ``perf_counter`` pair,
a dict add and one check of the profiler's state.
"""

from __future__ import annotations

import time

import torch

__all__ = ["Recorder", "PREFIX"]

PREFIX = "nbodyax."   # the profiler ranges' names: PREFIX + span name


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records on this thread."""
    return torch._C._autograd._profiler_enabled()


def _profiler_range(name: str):
    """An open host-only profiler range ``PREFIX + name``; close it with
    ``__exit__``."""
    r = torch._C._profiler._RecordFunctionFast(PREFIX + name)
    r.__enter__()
    return r


class _Span:
    __slots__ = ("rec", "name", "t0", "child", "range")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.range = _profiler_range(self.name) if _profiling() else None
        self.child = 0.0
        self.rec._open.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        rec = self.rec
        rec._open.pop()
        if rec._open:
            rec._open[-1].child += dt
        rec.seconds[self.name] = (rec.seconds.get(self.name, 0.0)
                                  + dt - self.child)
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


class Recorder:
    """One run's spans and counters: ``seconds`` (self seconds by span
    name) and ``counts`` (by counter name)."""

    def __init__(self):
        self.seconds: dict = {}
        self.counts: dict = {}
        self._open: list = []    # the open spans, innermost last

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n
