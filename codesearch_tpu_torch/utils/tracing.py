"""The port's own spans, kept in memory on the clock the torch profiler
stamps its events with (``time.time_ns``), so a span lines up with the
device's operations of the same profile without entering the profile.

``span(name, **counts)`` times a block, with counts beside it; ``count(name,
n)`` adds to a counter. Both record only while ``torch.profiler`` records
(``torch.autograd.profiler._is_profiler_enabled``) or inside
``recording()``. A span decides at entry: a profiler that starts or stops
while it is open leaves it as it began. A span that does not record costs a
flag check and hands back one shared object: no clock read, nothing kept.

A recorded span keeps its name, its start and end, its parent (the span
open on the same thread when it started) and a request id: a span with no
parent opens a new request and its children inherit it. Parents are kept
per thread (a ``contextvars`` variable), so requests served on threads do
not nest in each other. ``snapshot()`` gives the aggregates by name (count,
total and self seconds, self being the span's time less its children's,
and the summed counts) and the counters; ``spans()`` gives the raw spans,
the newest ``MAX_SPANS``.

``stage(name)`` is a span whose duration is measured whether it records or
not, on ``time.perf_counter``: the stage timings users read
(``SearchSession`` ``timings_ms``, ``IndexStats.elapsed_s``) come from it.

Nothing here adds a ``record_function`` range, an NVTX range or a device
synchronisation: the host waits on the device only where the program
already does (``utils.device.to_host``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import NamedTuple

from torch.autograd import profiler as _profiler

__all__ = ["MAX_SPANS", "SpanRecord", "count", "recording", "reset", "snapshot", "span",
           "spans", "stage"]

MAX_SPANS = 1 << 20          # raw spans kept; the oldest drop first


class SpanRecord(NamedTuple):
    id: int
    parent: int | None       # the enclosing span's id
    request: int
    name: str
    start_ns: int            # time.time_ns, the profiler's clock
    end_ns: int
    counts: dict


_forced = 0                  # depth of recording() blocks
_mu = threading.Lock()
_current: ContextVar = ContextVar("codesearch_span", default=None)
_ids = itertools.count(1)
_requests = itertools.count(1)
_raw: deque = deque(maxlen=MAX_SPANS)
_agg: dict[str, list] = {}   # name -> [count, total_ns, self_ns, counts]
_counters: dict[str, int] = {}


class _Off:
    """What a span that does not record hands back: false, and adds nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "request", "start_ns", "child_ns", "_token")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def __enter__(self):
        parent = _current.get()
        self.parent = parent
        self.id = next(_ids)
        self.request = parent.request if parent is not None else next(_requests)
        self.child_ns = 0
        self._token = _current.set(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _current.reset(self._token)
        dur = end - self.start_ns
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        rec = SpanRecord(self.id, parent.id if parent is not None else None, self.request,
                         self.name, self.start_ns, end, self.counts)
        with _mu:
            _raw.append(rec)
            agg = _agg.get(self.name)
            if agg is None:
                agg = _agg[self.name] = [0, 0, 0, {}]
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child_ns
            for k, v in self.counts.items():
                agg[3][k] = agg[3].get(k, 0) + v
        return False

    def __bool__(self):
        return True

    def add(self, **counts) -> None:
        """Adds to the span's counts (for counts known only at its end)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v


def span(name: str, **counts):
    """A context manager timing its block as the span ``name`` while
    recording; ``counts`` are summed by name in ``snapshot()``. It enters as
    a false object when not recording, so ``if sp: sp.add(...)`` computes
    late counts only when they are kept."""
    if _forced or _profiler._is_profiler_enabled:
        return _Span(name, counts)
    return _OFF


class _Stage:
    """A span whose duration is always measured (``seconds``, ``ms`` after
    the block, ``elapsed_ms()`` inside it)."""

    __slots__ = ("_span", "_t0", "seconds")

    def __init__(self, name: str):
        self._span = span(name)
        self.seconds = 0.0

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return self._span.__exit__(*exc)

    @property
    def ms(self) -> float:
        return self.seconds * 1e3

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


def stage(name: str) -> _Stage:
    return _Stage(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while recording."""
    if _forced or _profiler._is_profiler_enabled:
        with _mu:
            _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Records spans and counters inside the block, profiler or not."""
    global _forced
    with _mu:
        _forced += 1
    try:
        yield
    finally:
        with _mu:
            _forced -= 1


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s", "counts"}},
    "counters": {name: n}}`` over everything recorded since the last
    ``reset()``."""
    with _mu:
        return {
            "spans": {name: {"count": a[0], "total_s": a[1] / 1e9, "self_s": a[2] / 1e9,
                             "counts": dict(a[3])} for name, a in _agg.items()},
            "counters": dict(_counters),
        }


def spans() -> list[SpanRecord]:
    """The raw spans, oldest first, each when it ended."""
    with _mu:
        return list(_raw)


def reset() -> None:
    """Forgets every span and counter recorded so far."""
    with _mu:
        _raw.clear()
        _agg.clear()
        _counters.clear()
