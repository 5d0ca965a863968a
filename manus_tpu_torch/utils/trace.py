"""Spans on the host's clock: the port's span recorder.

The recorder is off by default; `enable()` turns it on and `disable()`
off. `span(name, **attrs)` is a context manager. Off, it returns one
shared no-op object: it reads no clock, allocates nothing and takes no
lock. On, it records a `Span` when the block closes (on an exception
too): its id, name, the thread's native id, start and end on
`time.perf_counter_ns()`, the id of the innermost span open on the same
thread when it opened (None for a root), and the attrs that tie the
spans of one step or frame together.

Records stay in memory, at most `CAP` spans and `CAP` counter readings;
those past the cap are dropped and counted (`dropped()`). `records()`,
`counters()` and `clear()` read and reset them.

The spans' clock is not the profiler's: torch.profiler (kineto) stamps
its events in Unix-epoch nanoseconds. `clock_anchor()` samples
(perf_counter_ns, time_ns) back to back, and a span's time on the
profiler's clock is its perf_counter_ns plus time_ns - perf_counter_ns
of an anchor. Nothing here enters the profiler's trace (no
record_function, no NVTX range), so a profiled stretch holds the same
device operations with the recorder on or off. `threads()` maps each
native thread id that opened a span to its `threading.get_ident()`,
which the profiler gives the CUDA runtime calls it links to no operator
(truncated to 32 bits).

`write_chrome_trace(path)` writes the spans as Chrome trace-event JSON,
which Perfetto (ui.perfetto.dev) and chrome://tracing open;
`python -m manus_tpu_torch.main --trace-out PATH ...` writes one for a
run. The spans the port opens:

  fit.step            Trainer.fit, one a loop iteration (root; step)
  fit.batch_wait      the wait for the next batch (seq: its number)
  fit.train_step      the train step, as the loop calls it
  step.forward        the loss (make_train_step,
                      make_composite_finetune_step)
  step.backward       autograd.grad and the mesh's reductions
  step.update         Adam, the mask prune and the densify statistics
  fit.densify         a densify event (step)
  fit.opacity_reset   an opacity reset (step)
  fit.log             the log_every block, with its host syncs
  prefetch.sample     PrefetchLoader's thread making a batch (seq: the
                      n-th batch put, which the loop's n-th wait receives)
  composite.finetune_step   run_composite's fine-tune, one a step (root;
                      step)
  composite.finetune_batch  its draw of a frame and view, get_batch and
                      the copies to the device
  composite.frame     run_composite, one a frame (root; frame)
  composite.contacts  make_composite_render's two contact searches
  composite.png       a frame's 8-bit cast and its PNG
  raster.project      render_gaussians: SH colours, the EWA projection
                      (one kernel on the card, csrc/project.cu; and a
                      sharded render's gather of the fields)
  raster.bin          binning: pairs, their sort, the tiles' segments
  raster.composite    the payload, the composite and the image

Counters: `count(name, *values)` records one reading, whose count is the
sum of the elements of `values` (0-d or larger tensors on any device, or
numbers). Off, it returns at once, as span() does. On, it keeps the
values as they are, with the thread and the clock: no operation is
launched and nothing is read back from the device, so a counted step
holds the same device operations as one that is not. `counters()` reads
them all back in one go, a host sync a device, when a stretch ends; the
Chrome trace export carries them as counter events ("ph": "C"). The
counters the port records:

  gaussians.live            live slots after a train step (make_train_step)
  raster.pairs_emitted      a view's (gaussian, tile) pairs before any
                            drop rule: kept plus dropped
  raster.pairs_kept         the pairs the view composites (TileBins'
                            tile_counts, summed)
  raster.pairs_dropped      the pairs binning dropped (TileBins'
                            overflow_count: the tile-per-gaussian and
                            multi-tile caps, the pair budget, the per-tile
                            cap); on a rank of a tile-sharded render the
                            kept pairs are its own tiles'
  raster.grad_rows          the rows a projection backward covers: a
                            launch of the kernel's (its autograd
                            Function) or the plain chain's backward
  composite.rows_trained    the slots the fine-tuned model places in the
                            scene, a fine-tune step
  densify.children_written  an event's children written into free slots:
                            clones + 2 x splits
  densify.children_dropped  the children of its candidates that found no
                            free slot (a split's two when either lacks one)
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from time import perf_counter_ns
from typing import NamedTuple, Optional

CAP = 1_000_000


class Span(NamedTuple):
    id: int
    name: str
    tid: int  # threading.get_native_id() of the thread that opened it
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]  # the id of the innermost span open on the thread
    attrs: dict


class Count(NamedTuple):
    name: str
    tid: int  # threading.get_native_id() of the recording thread
    t_ns: int  # time.perf_counter_ns()
    value: float  # the sum of the recorded values' elements


class _Noop:
    """What span() returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Open:
    """One span between its __enter__ and __exit__."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "stack", "tid",
                 "t0")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        local = self.rec._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.tid = threading.get_native_id()
            with self.rec._lock:
                self.rec._threads[local.tid] = threading.get_ident()
        self.stack, self.tid = stack, local.tid
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        self.t0 = perf_counter_ns()
        stack.append(self.id)
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        self.stack.pop()
        self.rec._add(Span(self.id, self.name, self.tid, self.t0, t1,
                           self.parent, self.attrs))
        return False


class Recorder:
    """Spans of every thread of the process, kept in memory up to `cap`."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._records = []
        self._counts = []
        self._threads = {}
        self._dropped = 0

    def span(self, name: str, /, **attrs):
        if not self.on:
            return NOOP
        return _Open(self, name, attrs)

    def count(self, name: str, /, *values):
        if not self.on:
            return
        rec = (name, threading.get_native_id(), perf_counter_ns(), values)
        with self._lock:
            if len(self._counts) < self.cap:
                self._counts.append(rec)
            else:
                self._dropped += 1

    def _add(self, span: Span):
        with self._lock:
            if len(self._records) < self.cap:
                self._records.append(span)
            else:
                self._dropped += 1

    def counters(self) -> list:
        """The counter readings as Count records, in the order recorded:
        each sum taken where its values live, then read back once per
        device."""
        with self._lock:
            recs = list(self._counts)
        if not recs:
            return []
        import torch

        sums, by_device = [0.0] * len(recs), {}
        for i, (_, _, _, values) in enumerate(recs):
            for v in values:
                if isinstance(v, torch.Tensor):
                    by_device.setdefault(v.device, ([], []))
                    by_device[v.device][0].append(i)
                    by_device[v.device][1].append(v.detach().sum(
                        dtype=torch.float64))
                else:
                    sums[i] += float(v)
        for idx, parts in by_device.values():
            for i, x in zip(idx, torch.stack(parts).tolist()):
                sums[i] += x
        return [Count(name, tid, t, total)
                for (name, tid, t, _), total in zip(recs, sums)]

    def records(self) -> list:
        with self._lock:
            return list(self._records)

    def dropped(self) -> int:
        return self._dropped

    def threads(self) -> dict:
        with self._lock:
            return dict(self._threads)

    def clear(self):
        with self._lock:
            self._records = []
            self._counts = []
            self._dropped = 0


_REC = Recorder()
span = _REC.span
count = _REC.count
counters = _REC.counters
records = _REC.records
dropped = _REC.dropped
threads = _REC.threads
clear = _REC.clear


def enable():
    _REC.on = True


def disable():
    _REC.on = False


def enabled() -> bool:
    return _REC.on


def clock_anchor() -> tuple:
    """(perf_counter_ns, time_ns), sampled back to back."""
    return perf_counter_ns(), time.time_ns()


def write_chrome_trace(path: str, anchor=None):
    """The recorder's spans as Chrome trace-event JSON: complete events
    ("ph": "X") in microseconds since the Unix epoch (through `anchor`, a
    clock_anchor(); a new one by default), one row a native thread id,
    each span's id, parent and attrs as its args; the counters as counter
    events ("ph": "C", the reading under the counter's name in args); and
    the count of spans and readings dropped."""
    perf0, epoch0 = anchor or clock_anchor()
    offset, pid = epoch0 - perf0, os.getpid()
    events = [dict(name=s.name, ph="X", ts=(s.start_ns + offset) / 1e3,
                   dur=(s.end_ns - s.start_ns) / 1e3, pid=pid, tid=s.tid,
                   args=dict(s.attrs, id=s.id, parent=s.parent))
              for s in records()]
    events += [dict(name=c.name, ph="C", ts=(c.t_ns + offset) / 1e3,
                    pid=pid, tid=c.tid, args={c.name: c.value})
               for c in counters()]
    with open(path, "w") as f:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms",
                       otherData=dict(dropped=dropped())), f, default=str)
