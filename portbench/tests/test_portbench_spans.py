"""The join of the program's spans with a profiled stretch, and the seven
readings of portbench/spans.py, on synthetic spans and a fake event
list; then spans_run on both cells, shrunk, on the CPU."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import spans as sp
from portbench.tests.conftest import tiny

MAIN, WORKER, AUTOGRAD = 101, 202, 303
IDENT = {MAIN: 0x7F0000001111, WORKER: 0x7F4096FFD6C0}
# the spans' clock is 1,000 us behind the profiler's trace start, in ns
ANCHOR = (0, 1_000_000 + 5_000_000)
T0 = 5_000_000  # the trace's start, on the profiler's clock


def span(id, name, tid, s_us, e_us, parent=None, **attrs):
    """A Span whose times are given in us on the profiler's clock."""
    return sp_span(id, name, tid, int(s_us * 1e3) - 1_000_000,
                   int(e_us * 1e3) - 1_000_000, parent, attrs)


def sp_span(*fields):
    from manus_tpu_torch.utils.trace import Span

    return Span(*fields)


def ev(name, kind, s, e, id=0, rid=0):
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=s, end=e),
                           id=id, device_resource_id=rid)


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def spans_of_a_step():
    return [
        span(1, "fit.step", MAIN, 0, 100, step=5),
        span(2, "fit.batch_wait", MAIN, 0, 10, 1, seq=5),
        span(3, "fit.train_step", MAIN, 10, 90, 1),
        span(4, "step.forward", MAIN, 10, 40, 3),
        span(5, "step.backward", MAIN, 40, 70, 3),
        span(6, "step.update", MAIN, 70, 90, 3),
        span(7, "prefetch.sample", WORKER, 5, 60, seq=7),
    ]


def events_of_a_step():
    return [
        # in fit.batch_wait, on the main thread
        ev("cudaStreamIsCapturing", CPU, 6, 7, id=10, rid=MAIN),
        # in step.forward, linked to an op: the native thread id
        ev("cudaLaunchKernel", CPU, 12, 13, id=11, rid=MAIN),
        ev("k_fwd", CUDA, 14, 30, id=11),
        # autograd's device thread: the main thread's innermost span
        ev("cudaLaunchKernel", CPU, 45, 46, id=12, rid=AUTOGRAD),
        ev("k_bwd", CUDA, 50, 60, id=12),
        # the prefetch thread, with no operator: the ident's low 32 bits
        # as a signed int
        ev("cudaMemcpyAsync", CPU, 20, 21, id=13, rid=-1761618240),
        ev("Memcpy HtoD", CUDA, 30, 34, id=13),
        # a sync inside .item() in step.update
        ev("aten::item", CPU, 74, 79, rid=MAIN),
        ev("aten::_local_scalar_dense", CPU, 75, 78, rid=MAIN),
        ev("cudaStreamSynchronize", CPU, 76, 77, id=16, rid=MAIN),
        # a sync in step.update, on the main thread with no operator
        ev("cudaStreamSynchronize", CPU, 80, 85, id=14,
           rid=IDENT[MAIN] & 0xFFFFFFFF),
        ev("cudaLaunchKernel", CPU, 86, 87, id=15, rid=MAIN),
        ev("k_upd", CUDA, 88, 95, id=15),
        # a device op with no runtime call in the trace
        ev("k_orphan", CUDA, 96, 97, id=99),
    ]


def join(spans=None, events=None):
    return sp.SpanJoin(events_of_a_step() if events is None else events, T0,
                       spans_of_a_step() if spans is None else spans, ANCHOR,
                       MAIN, IDENT)


def test_launches_go_to_the_innermost_span_open_on_their_thread():
    j = join()
    by_op = {n: j.name(sid) for n, _, _, sid in j.ops}
    assert by_op == {"k_fwd": "step.forward", "k_bwd": "step.backward",
                     "Memcpy HtoD": "prefetch.sample",
                     "k_upd": "step.update", "k_orphan": sp.NO_SPAN}
    rows = j.by_span()
    assert rows["step.forward"][1:] == [1, pytest.approx(16e-6)]
    assert rows["prefetch.sample"][1] == 1
    # self time: fit.train_step (80 us) less its three children (80 us)
    assert rows["fit.train_step"][0] == pytest.approx(0.0, abs=1e-12)
    # the stretch runs from the first event (6 us) to the last (97 us)
    assert rows["fit.batch_wait"] == [pytest.approx(4e-6), 0, 0.0]


def test_idle_gaps_go_to_the_main_threads_span():
    """The gap 34-50 us has its middle (42) in step.backward on the main
    thread; prefetch.sample is open on the worker then, and gets none."""
    j = join()
    idle = j.idle_by_span()
    assert idle["step.backward"] == pytest.approx(16e-6)  # 34-50
    assert idle["step.update"] == pytest.approx(28e-6)  # 60-88
    assert idle["fit.step"] == pytest.approx(1e-6)  # 95-96, after step 3
    assert "prefetch.sample" not in idle
    assert j.busy_s == pytest.approx((20 + 10 + 7 + 1) * 1e-6)


def test_blocking_calls_within_whole_train_steps():
    j = join()
    steps = j.of_name("fit.train_step", complete=True)
    assert steps == {3}
    assert j.calls_within(steps) == 2
    assert sp.step_host_syncs(dict(span_join=j)) == 2.0
    assert sorted(j.blocking) == [(6, "(no operator)"), (6, "aten::item")]
    # autograd's device thread opened no span: its call went to the main
    # thread's
    assert j.unmapped == {AUTOGRAD: 1}
    assert "step.update / aten::item 1.00" in j.table()
    # a train step that the stretch cuts is not counted: none left
    cut = join(events=[e for e in events_of_a_step() if e.time_range.start
                       < 70])
    assert sp.step_host_syncs(dict(span_join=cut)) is None
    assert sp.step_host_syncs({}) is None


def test_contacts_device_share():
    spans = [span(1, "composite.frame", MAIN, 0, 100, frame=0),
             span(2, "composite.contacts", MAIN, 10, 30, 1),
             span(3, "composite.png", MAIN, 60, 90, 1)]
    events = [ev("cudaLaunchKernel", CPU, 11, 12, id=1, rid=MAIN),
              ev("search", CUDA, 12, 42, id=1),
              ev("cudaLaunchKernel", CPU, 31, 32, id=2, rid=MAIN),
              ev("panel", CUDA, 42, 52, id=2)]
    j = join(spans, events)
    assert sp.contacts_device_share(dict(span_join=j)) == pytest.approx(75.0)
    no_contacts = join(spans[:1] + spans[2:], events)
    assert sp.contacts_device_share(dict(span_join=no_contacts)) is None
    assert sp.contacts_device_share(dict(span_join=None)) is None


def window_layer(spans, t0=0.0, t1=1.0):
    return dict(spans=spans, window_t0=t0, window_t_end=t1)


def s(id, name, a, b, parent=None, tid=MAIN):
    """A span from a to b seconds on the host's clock."""
    return sp_span(id, name, tid, int(a * 1e9), int(b * 1e9), parent, {})


def test_window_readings():
    spans = [
        s(1, "fit.batch_wait", -0.05, -0.01),  # before the window
        s(2, "fit.batch_wait", 0.10, 0.12),
        s(3, "fit.batch_wait", 0.95, 1.05),  # cut at the window's end
        s(4, "fit.train_step", 0.2, 0.3),
        s(5, "fit.train_step", 0.5, 0.7),
        s(6, "fit.train_step", 0.9, 1.1),  # not wholly in it
        s(7, "prefetch.sample", -0.1, 0.05, tid=WORKER),  # ended in it
        s(8, "prefetch.sample", 0.99, 1.02, tid=WORKER),  # ended after it
        s(9, "fit.densify", 0.4, 0.43),
        s(10, "fit.opacity_reset", 0.8, 0.81),
        s(11, "composite.png", 0.6, 0.7),
    ]
    layer = window_layer(spans)
    assert sp.batch_wait_share(layer) == pytest.approx(7.0)
    assert sp.step_host_ms(layer) == pytest.approx(150.0)
    assert sp.prefetch_batch_ms(layer) == pytest.approx(150.0)
    assert sp.event_share(layer) == pytest.approx(4.0)
    assert sp.png_share(layer) == pytest.approx(10.0)


def test_readings_are_none_without_their_spans():
    empty = window_layer([s(1, "fit.step", 0.1, 0.2)])
    for name, (_, _, _, _, read) in sp.READINGS.items():
        assert read(empty) is None, name
        assert read({}) is None, name
        # spans, but no window
        assert read(dict(spans=empty["spans"])) is None, name
    # an event outside the window is none in it
    assert sp.event_share(window_layer([s(1, "fit.densify", 1.5, 1.6)])) \
        is None


def test_step_spread():
    spans = [s(1, "fit.step", 0.0, 0.1), s(2, "fit.batch_wait", 0.0, 0.01, 1),
             s(3, "fit.train_step", 0.01, 0.09, 1),
             s(4, "fit.step", 0.1, 0.3), s(5, "fit.train_step", 0.1, 0.28, 4),
             s(6, "fit.log", 0.28, 0.29, 4)]
    spans += [s(7, "step.forward", 0.01, 0.05, 3),
              s(8, "step.forward", 0.1, 0.2, 5)]
    got = sp.step_spread(window_layer(spans))
    assert set(got) == {"fit.batch_wait", "fit.train_step", "fit.log",
                        "step.forward", "self"}
    assert got["fit.train_step"][1] == pytest.approx(130.0)
    assert got["step.forward"][1] == pytest.approx(70.0)
    assert got["self"][1] == pytest.approx(10.0)
    assert sp.step_spread({}) == {}


def test_the_profile_keeps_its_anchor():
    p = sp.AnchoredProfile(lambda: (1, 2))
    p.start()
    p.stop()
    assert p.anchor == (1, 2)


@pytest.mark.parametrize("workload,names", [
    ("hand_lpips", {"fit.batch_wait_share", "prefetch.batch_ms",
                    "step.host_ms"}),
    ("composite_gt_eval", {"frame.png_share"})])
def test_spans_run_reads_the_host_spans(workload, names):
    """On the CPU the stretch holds no device operations, so only the
    readings of host spans in the window read a number."""
    from portbench import spans_run
    from manus_tpu_torch.utils import trace

    line = spans_run.run(workload, 2**31 + 5, 0.5, device="cpu",
                         scale=tiny(workload))
    assert line["correct"]
    assert names <= set(line["spans"]) <= set(sp.READINGS)
    assert line["window_ms"] > 0 and line["spans_dropped"] == 0
    assert not trace.enabled() and trace.records() == []
