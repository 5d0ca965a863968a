"""The program's spans (manus_tpu_torch/utils/trace.py) joined with a
profiled stretch, and the per-layer readings they give.

`SpanJoin` puts the spans on the profiler's clock through a clock
anchor (kineto stamps its events in Unix-epoch nanoseconds, the spans
are perf_counter_ns) and gives each device operation, runtime call and
device idle gap the span it belongs to. `READINGS` are the seven
per-layer numbers that read the spans, each a function of a driver's
`layer` dict with four more keys: `spans` (the records), `span_join` (a
SpanJoin, or None), and `window_t0` / `window_t_end` (the window's ends
on the host's perf_counter, in seconds). The cells' drivers do not pass
these yet; `portbench/spans_run.py` runs a cell with them.
"""
from __future__ import annotations

import bisect
import statistics
import threading
from collections import defaultdict

from torch.autograd import DeviceType

from portbench.trace import Profile, _union

# the CUDA runtime calls that block the calling thread until the device
# has caught up
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize")
NO_SPAN = "(no span)"


class AnchoredProfile(Profile):
    """A Profile that also samples `anchor_fn()` (the program's
    clock_anchor) as its stretch starts, into `anchor`."""

    def __init__(self, anchor_fn):
        super().__init__()
        self.anchor_fn, self.anchor = anchor_fn, None

    def start(self):
        super().start()
        self.anchor = self.anchor_fn()


def _is_runtime_call(name: str) -> bool:
    return name.startswith(("cuda", "cuLaunch"))


class SpanJoin:
    """The program's spans joined with a profiled stretch's events.

    `events`: the stretch's torch.profiler events (`prof.events()`: name,
    device_type, time_range in us from `trace_start_ns`, id, which is the
    correlation id of a runtime call and of the device operation it
    launched, and device_resource_id, which for a host event is its
    thread). `spans`: the program's Span records; `anchor`: a
    (perf_counter_ns, time_ns) pair that puts them on the profiler's
    clock. `main_tid`: the native id of the thread that runs the loop;
    `idents`: {native id: threading.get_ident()} of the threads that
    opened spans (the profiler gives a runtime call that it links to no
    operator the low 32 bits of the ident, as a signed int, as its
    thread).

    A runtime call belongs to the innermost span open on its thread when
    it started; on a thread that opened no span (autograd's device
    thread, which works while the loop's thread waits in autograd.grad),
    to the innermost span open on the main thread. A device operation
    belongs to its runtime call's span (by correlation id); an idle gap
    of the device to the innermost span open on the main thread at the
    gap's middle. "Within" a span counts its descendants.
    """

    def __init__(self, events, trace_start_ns: int, spans, anchor,
                 main_tid: int, idents=None):
        off_us = (anchor[1] - anchor[0] - trace_start_ns) * 1e-3
        # id -> (name, tid, start_us, end_us, parent id)
        self.spans = {s.id: (s.name, s.tid, s.start_ns * 1e-3 + off_us,
                             s.end_ns * 1e-3 + off_us, s.parent)
                      for s in spans}
        alias = {}
        for tid, ident in (idents or {}).items():
            low = ident & 0xFFFFFFFF
            # as unsigned and as signed 32-bit, which the profiler gives
            alias[low] = alias[low - (low >> 31 << 32)] = tid
        by_thread = defaultdict(list)
        for sid, (_, tid, s0, _, _) in self.spans.items():
            by_thread[tid].append((s0, sid))
        self._starts = {}
        for tid, lst in by_thread.items():
            lst.sort()
            self._starts[tid] = ([s for s, _ in lst], [i for _, i in lst])
        self.calls = []  # (name, start_us, end_us, span id or None)
        # (span id, the outermost host operator it ran in) a blocking call
        self.blocking = []
        # {thread: runtime calls} of threads that opened no span
        self.unmapped = defaultdict(int)
        call_span, ops, host, blocking = {}, [], defaultdict(list), []
        for ev in events:
            t0, t1 = ev.time_range.start, ev.time_range.end
            if ev.device_type == DeviceType.CUDA:
                ops.append((ev.id, ev.name, t0, t1))
            elif ev.device_type != DeviceType.CPU:
                continue
            elif not _is_runtime_call(ev.name):
                host[ev.device_resource_id].append((t0, t1, ev.name))
            else:
                tid = alias.get(ev.device_resource_id, ev.device_resource_id)
                if tid not in self._starts:
                    self.unmapped[ev.device_resource_id] += 1
                    tid = main_tid
                sid = self.innermost(tid, t0)
                self.calls.append((ev.name, t0, t1, sid))
                call_span[ev.id] = sid
                if ev.name in BLOCKING:
                    blocking.append((sid, ev.device_resource_id, t0))
        for lst in host.values():
            lst.sort()
        for sid, rid, t0 in blocking:
            self.blocking.append((sid, _outermost(host.get(rid, ()), t0)))
        # (name, start_us, end_us, span id or None)
        self.ops = [(n, t0, t1, call_span.get(c)) for c, n, t0, t1 in ops]
        busy_us, gaps = _union([(t0, t1) for _, t0, t1, _ in self.ops])
        self.busy_s = busy_us * 1e-6
        self.gaps = [(g0, g1, self.innermost(main_tid, 0.5 * (g0 + g1)))
                     for g0, g1 in gaps]
        ends = [(t0, t1) for _, t0, t1, _ in self.ops + self.calls]
        self.t_first = min((t0 for t0, _ in ends), default=0.0)
        self.t_last = max((t1 for _, t1 in ends), default=0.0)

    def innermost(self, tid: int, t: float):
        """The id of the innermost span open on `tid` at `t` (us), or
        None. Spans on a thread nest, so it is the latest-started span
        before `t` or the first of its ancestors still open at `t`."""
        starts, ids = self._starts.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t)
        sid = ids[i - 1] if i else None
        while sid in self.spans:
            if self.spans[sid][3] >= t:
                return sid
            sid = self.spans[sid][4]
        return None

    def name(self, sid) -> str:
        return self.spans[sid][0] if sid in self.spans else NO_SPAN

    def _under(self, sid, ids) -> bool:
        """Whether span `sid` or one of its ancestors is in `ids`."""
        while sid in self.spans:
            if sid in ids:
                return True
            sid = self.spans[sid][4]
        return False

    def of_name(self, name: str, complete: bool = False) -> set:
        """The ids of the `name` spans; with `complete`, only those that
        lie wholly inside the stretch (its first event to its last)."""
        return {sid for sid, (n, _, s0, s1, _) in self.spans.items()
                if n == name and (not complete or (
                    s0 >= self.t_first and s1 <= self.t_last))}

    def device_s_within(self, ids) -> float:
        """Seconds of the union of the device operations launched within
        the spans `ids`."""
        busy_us, _ = _union([(t0, t1) for _, t0, t1, sid in self.ops
                             if self._under(sid, ids)])
        return busy_us * 1e-6

    def calls_within(self, ids, names=BLOCKING) -> int:
        """The runtime calls named in `names` made within the spans
        `ids`."""
        return sum(1 for call, _, _, sid in self.calls
                   if call in names and self._under(sid, ids))

    def idle_by_span(self) -> dict:
        """{span name: seconds of device idle gaps} over the stretch."""
        out = defaultdict(float)
        for g0, g1, sid in self.gaps:
            out[self.name(sid)] += (g1 - g0) * 1e-6
        return dict(out)

    def by_span(self) -> dict:
        """{span name: [host self seconds inside the stretch, device
        operations launched, their device seconds]}. A span's self time
        is its time minus what its children cover."""
        out = defaultdict(lambda: [0.0, 0, 0.0])
        lo, hi = self.t_first, self.t_last
        for name, _, s0, s1, parent in self.spans.values():
            d = (min(s1, hi) - max(s0, lo)) * 1e-6
            if d > 0:
                out[name][0] += d
                if parent in self.spans:
                    out[self.spans[parent][0]][0] -= d
        for _, t0, t1, sid in self.ops:
            row = out[self.name(sid)]
            row[1] += 1
            row[2] += (t1 - t0) * 1e-6
        return dict(out)

    def table(self, per: int = 1, what: str = "step") -> str:
        """The idle-by-span and per-span lines, each number over `per`
        (the traced steps or frames), and the runtime calls by name."""
        idle, rows = self.idle_by_span(), self.by_span()
        lines = [f"spans over the traced stretch, a {what} (of {per}): "
                 f"span, device idle ms, host self ms, launches, device ms"]
        for name in sorted(set(rows) | set(idle),
                           key=lambda n: -idle.get(n, 0.0)):
            host, n_ops, dev = rows.get(name, (0.0, 0, 0.0))
            lines.append("  %-20s %9.3f %9.3f %8.1f %9.3f" % (
                name, 1e3 * idle.get(name, 0.0) / per, 1e3 * host / per,
                n_ops / per, 1e3 * dev / per))
        by_name = defaultdict(int)
        for call, _, _, _ in self.calls:
            by_name[call] += 1
        lines.append("runtime calls: " + ", ".join(
            f"{n} {c}" for n, c in sorted(by_name.items(),
                                          key=lambda x: -x[1])))
        lines.append("runtime calls of threads that opened no span, given "
                     "to the main thread's: " + ", ".join(
                         f"thread {t} {n}" for t, n in self.unmapped.items()))
        owners = defaultdict(int)
        for sid, op in self.blocking:
            owners[f"{self.name(sid)} / {op}"] += 1
        lines.append(f"blocking calls ({', '.join(BLOCKING)}) a {what} by "
                     f"span / outermost operator: " + ", ".join(
                         "%s %.2f" % (k, n / per) for k, n in sorted(
                             owners.items(), key=lambda x: -x[1])))
        return "\n".join(lines)


def _outermost(ops, t: float) -> str:
    """The name of the outermost of `ops` ((start, end, name), sorted,
    nested) open at `t`, looking back over the 256 latest-started."""
    i = bisect.bisect_left(ops, (t, float("inf")))
    name = "(no operator)"
    for t0, t1, op in reversed(ops[max(0, i - 256):i]):
        if t1 >= t:
            name = op
    return name


def join_profile(profile: AnchoredProfile, spans, idents) -> SpanJoin:
    """The SpanJoin of a stopped AnchoredProfile's stretch, joined on the
    calling thread as the main one."""
    prof = profile.prof
    return SpanJoin(prof.events(),
                    prof.profiler.kineto_results.trace_start_ns(), spans,
                    profile.anchor, threading.get_native_id(), idents)


def _window(layer: dict):
    t0, t1 = layer.get("window_t0"), layer.get("window_t_end")
    if not layer.get("spans") or t0 is None or t1 is None or t1 <= t0:
        return None
    return t0, t1


def spans_in(layer: dict, names, by: str = "start") -> list:
    """(start_s, end_s) on the host's perf_counter of the spans named in
    `names` that started (by="start"), ended (by="end") or lay wholly
    (by="whole") in the window [window_t0, window_t_end)."""
    lo, hi = _window(layer) or (0.0, 0.0)
    out = []
    for s in layer.get("spans") or ():
        if s.name not in names:
            continue
        s0, s1 = s.start_ns * 1e-9, s.end_ns * 1e-9
        inside = {"start": lo <= s0 < hi, "end": lo <= s1 < hi,
                  "whole": lo <= s0 and s1 <= hi}[by]
        if inside:
            out.append((s0, s1))
    return out


def _share(layer: dict, names):
    """The time of the `names` spans that started in the window, up to
    its end, over the window's time (%); None when none started in it."""
    w = _window(layer)
    got = spans_in(layer, names)
    if w is None or not got:
        return None
    return 100.0 * sum(min(s1, w[1]) - s0 for s0, s1 in got) / (w[1] - w[0])


def _mean_ms(layer: dict, name: str, by: str):
    got = spans_in(layer, (name,), by)
    if _window(layer) is None or not got:
        return None
    return 1e3 * statistics.fmean(s1 - s0 for s0, s1 in got)


def batch_wait_share(layer: dict):
    """fit.batch_wait: the loop's wait on the prefetch queue, over the
    window (%)."""
    return _share(layer, ("fit.batch_wait",))


def prefetch_batch_ms(layer: dict):
    """prefetch.batch_ms: the prefetch thread's mean time to make a batch
    (prefetch.sample spans that ended in the window)."""
    return _mean_ms(layer, "prefetch.sample", "end")


def step_host_ms(layer: dict):
    """step.host_ms: the host's mean time in the train step as the loop
    calls it (fit.train_step spans wholly in the window), syncs
    included."""
    return _mean_ms(layer, "fit.train_step", "whole")


def step_host_syncs(layer: dict):
    """step.host_syncs: blocking runtime calls (BLOCKING) a step, within
    the fit.train_step spans that lie wholly in the traced stretch."""
    join = layer.get("span_join")
    if join is None:
        return None
    steps = join.of_name("fit.train_step", complete=True)
    if not steps:
        return None
    return join.calls_within(steps) / len(steps)


def event_share(layer: dict):
    """fit.event_share: densify events and opacity resets over the window
    (%); None when none fell in it."""
    return _share(layer, ("fit.densify", "fit.opacity_reset"))


def contacts_device_share(layer: dict):
    """contacts.device_share: the device time of the operations launched
    within composite.contacts, over the stretch's device busy time (%)."""
    join = layer.get("span_join")
    if join is None or join.busy_s <= 0:
        return None
    ids = join.of_name("composite.contacts")
    if not ids:
        return None
    return 100.0 * join.device_s_within(ids) / join.busy_s


def png_share(layer: dict):
    """frame.png_share: a frame's 8-bit cast and PNG over the window (%)."""
    return _share(layer, ("composite.png",))


# name: (unit, better, cell, the end-to-end metric it moves, reader)
READINGS = {
    "fit.batch_wait_share": ("%", "lower", "hand_lpips", "train_step_ms",
                             batch_wait_share),
    "prefetch.batch_ms": ("ms", "lower", "hand_lpips", "train_step_ms",
                          prefetch_batch_ms),
    "step.host_ms": ("ms", "lower", "hand_lpips", "train_step_ms",
                     step_host_ms),
    "step.host_syncs": ("syncs/step", "lower", "hand_lpips",
                        "train_step_ms", step_host_syncs),
    "fit.event_share": ("%", "lower", "hand_lpips", "train_step_ms",
                        event_share),
    "contacts.device_share": ("%", "lower", "composite_gt_eval",
                              "composite_frame_ms", contacts_device_share),
    "frame.png_share": ("%", "lower", "composite_gt_eval",
                        "composite_frame_ms", png_share),
}


def step_spread(layer: dict, root: str = "fit.step") -> dict:
    """{span name: (p10, median, p90) ms a `root` span} over the `root`
    spans wholly in the window: each root's time in the spans of that
    name beneath it (0 where it has none), and the time its children do
    not cover as "self"."""
    w = _window(layer)
    if w is None:
        return {}
    lo, hi = int(w[0] * 1e9), int(w[1] * 1e9)
    spans = {s.id: s for s in layer["spans"]}
    roots = {sid for sid, s in spans.items() if s.name == root
             and s.start_ns >= lo and s.end_ns <= hi}
    per = {sid: defaultdict(float) for sid in roots}
    for s in spans.values():
        top, child = s.parent, s.parent in roots
        while top in spans and top not in roots:
            top = spans[top].parent
        if top in roots:
            ms = (s.end_ns - s.start_ns) * 1e-6
            per[top][s.name] += ms
            if child:
                per[top]["self"] -= ms
    for sid in roots:
        per[sid]["self"] += (spans[sid].end_ns - spans[sid].start_ns) * 1e-6
    out = {}
    for name in sorted({n for d in per.values() for n in d}):
        vals = [d.get(name, 0.0) for d in per.values()]
        if len(vals) >= 2:
            q = statistics.quantiles(vals, n=10)
            out[name] = (q[0], statistics.median(vals), q[-1])
    return out
