"""Spans on the host's clock, and the reading of a torch.profiler trace.

`Spans` records named host intervals that the drivers put around calls
into the program's layers. `Profile` runs a stretch of work under
torch.profiler (CPU and CUDA activity), started and stopped inside a
running loop, and reduces its trace to what the metric readers take: each device operation's name and interval, the
union of device-busy time, and the host operation that was running in
each idle gap of the device.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager

import torch
from torch.autograd import DeviceType


class Spans:
    """Named host-clock intervals, kept in memory."""

    def __init__(self):
        self.items = defaultdict(list)  # name -> [(start_s, end_s)]

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items[name].append((t0, time.perf_counter()))

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def total(self, name: str, lo: float = float("-inf"),
              hi: float = float("inf")) -> float:
        """Seconds of `name` spans inside [lo, hi]."""
        return sum(max(0.0, min(e, hi) - max(s, lo))
                   for s, e in self.items.get(name, ()))


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


class TraceSummary:
    """A profiled stretch: `ops` [(name, start_us, end_us)] on the device,
    `window_s` its wall time, `busy_s` the union of the device's
    operations, `idle_by_host` {host op: idle seconds}."""

    def __init__(self, ops, window_s: float, host_ops):
        self.ops = ops
        self.window_s = window_s
        busy_us, gaps = _union([(s, e) for _, s, e in ops])
        self.busy_s = busy_us * 1e-6
        self.idle_by_host = defaultdict(float)
        host = sorted(host_ops, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for g0, g1 in gaps:
            # nested host ops: the innermost one running at the gap's
            # middle is the latest-started that has not ended
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid)
            name = "(no host op)"
            for h in reversed(host[max(0, i - 64):i]):
                if h[2] >= mid:
                    name = h[0]
                    break
            self.idle_by_host[name] += (g1 - g0) * 1e-6

    def device_seconds(self, match) -> float:
        """Seconds of device operations whose name `match` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n)) * 1e-6

    def count(self, match=lambda n: True) -> int:
        return sum(1 for n, _, _ in self.ops if match(n))

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for n, s, e in self.ops:
            by[n] += (e - s) * 1e-6
        return sorted(([n[:120], v] for n, v in by.items()),
                      key=lambda x: -x[1])[:k]

    def top_gaps(self, k: int = 10):
        return sorted(([n[:120], v] for n, v in self.idle_by_host.items()),
                      key=lambda x: -x[1])[:k]


class Profile:
    """torch.profiler (CPU and CUDA activity) over a stretch that starts
    and stops inside a running loop: `start`, then `stop`, which returns
    the stretch's TraceSummary. Both ends synchronise the card."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            self.acts.append(torch.profiler.ProfilerActivity.CUDA)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self.prof = torch.profiler.profile(activities=self.acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> TraceSummary:
        self._sync()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        ops, host = [], []
        for ev in self.prof.events():
            rng = (ev.name, ev.time_range.start, ev.time_range.end)
            if ev.device_type == DeviceType.CUDA:
                ops.append(rng)
            elif ev.device_type == DeviceType.CPU:
                host.append(rng)
        return TraceSummary(ops, window_s, host)


def profile(work) -> TraceSummary:
    """Run `work()` under torch.profiler and summarise its trace."""
    p = Profile()
    p.start()
    work()
    return p.stop()
