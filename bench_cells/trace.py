"""The benchmark's own spans and the reduction of a profiler trace.

Spans are named ranges the benchmark wraps around its calls into the
program's layers (``torch.profiler.record_function``, so they sit in the
same trace as the device's operations) with host-clock totals beside them.
A ``Tracer`` that is off makes them no-ops, so the runs that report the
end-to-end metrics carry no tracing.

``reduce`` turns one profiled window into what the per-layer readers read:
the device's busy seconds (the union of its operations' intervals), each
kernel's device seconds by name in launch order, and the longest idle gaps
of the device labelled by the span that was open on the host.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function(name):
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t
                self.counts[name] += 1

    def wrap(self, name: str, fn):
        """``fn`` with every call inside the span ``name``."""
        if not self.enabled:
            return fn

        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        return wrapped

    @contextlib.contextmanager
    def window(self):
        """Profiles the block when tracing is on (CPU ops, the spans and the
        device's operations), or until ``stop()``."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        self.totals.clear()     # spans before the window (the warm-up) do not count
        self.counts.clear()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        try:
            yield
        finally:
            self.stop()

    def stop(self) -> None:
        """Ends the profiled window; the spans stop counting with it."""
        if self.enabled and self.prof is not None:
            self.prof.stop()
        self.enabled = False


def _union_s(intervals: list[tuple[int, int]]) -> float:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def _gaps(kernels, lo: int, hi: int) -> list[tuple[int, int, int]]:
    """(length, start, end) of each stretch of [lo, hi) with no kernel."""
    gaps, end = [], lo
    for s, e, _ in kernels:
        if e <= lo or s >= hi:
            continue
        if s > end:
            gaps.append((s - end, end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((hi - end, end, hi))
    return gaps


def reduce(prof, t0_ns: int | None = None, t1_ns: int | None = None, top: int = 10,
           intervals: list[tuple[int, int]] | None = None) -> dict:
    """Device busy seconds, kernels in launch order and by name, and the
    longest idle gaps with the innermost open span, from a profile. With
    ``intervals`` (``time.time_ns`` pairs) only the device's work and gaps
    inside them count, and ``window_s`` is their summed length."""
    from torch.autograd import DeviceType

    kernels, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), name)
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("bench."):     # the spans' mirror on the device
                kernels.append(span)
        elif name.startswith("bench."):
            spans.append(span)
    kernels.sort()
    if intervals is None:
        lo = t0_ns if t0_ns is not None else (kernels[0][0] if kernels else 0)
        hi = t1_ns if t1_ns is not None else (kernels[-1][1] if kernels else 0)
        intervals = [(lo, hi)]
    else:
        kernels = [k for k in kernels if any(a <= k[0] < b for a, b in intervals)]
    by_name: dict[str, float] = defaultdict(float)
    for s, e, n in kernels:
        by_name[n] += (e - s) / 1e9
    busy = _union_s([(s, e) for s, e, _ in kernels])
    gaps = [g for a, b in intervals for g in _gaps(kernels, a, b)]
    gaps.sort(reverse=True)
    spans.sort()
    starts = [s for s, _, _ in spans]
    labelled = defaultdict(float)
    for length, a, b in gaps:
        mid = (a + b) // 2
        inner = "outside any span"
        j = bisect.bisect_right(starts, mid)
        for i in range(j - 1, max(j - 64, 0) - 1, -1):
            if spans[i][1] >= mid:     # the latest-starting span holding it
                inner = spans[i][2]
                break
        labelled[inner] += length / 1e9
    return {
        "busy_s": busy,
        "window_s": sum(b - a for a, b in intervals) / 1e9,
        "kernels": [(n, (e - s) / 1e9) for s, e, n in kernels],
        "by_name": dict(by_name),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(labelled.items(), key=lambda kv: -kv[1])[:top],
    }
