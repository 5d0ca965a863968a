"""The port's span recorder (manus_tpu_torch/utils/trace.py) on the CPU:
off it records nothing and costs no clock reading or allocation; on it
nests spans per thread, records the prefetch thread's batches, the fit
loop's and the composite frame's spans, and puts them on the profiler's
clock. Every test leaves the recorder off and empty."""
import json
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from manus_tpu_torch import main as tmain
from manus_tpu_torch.data.prefetch import PrefetchLoader
from manus_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(trace, "perf_counter_ns", no_clock)
    a = trace.span("a")
    b = trace.span("b", step=3)
    assert a is b is trace.NOOP
    with trace.span("fit.step", step=1):
        pass
    assert trace.records() == [] and trace.dropped() == 0
    # on, the same call reads the clock
    trace.enable()
    with pytest.raises(AssertionError, match="clock"):
        with trace.span("a"):
            pass


def test_off_allocates_nothing():
    def spans(n):
        for i in range(n):
            with trace.span("fit.step", step=i):
                pass

    spans(10)  # warm the code path
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        spans(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # nothing kept, and no more than one call's keyword dict at a time
    assert after - before <= 0
    assert peak - before < 512


def test_spans_nest_per_thread():
    trace.enable()
    ids = {}

    def work(tag):
        with trace.span("outer", tag=tag):
            with trace.span("inner", tag=tag):
                time.sleep(0.002)
        ids[tag] = threading.get_native_id()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    with trace.span("main"):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    trace.disable()
    recs = trace.records()
    by_id = {s.id: s for s in recs}
    (main,) = [s for s in recs if s.name == "main"]
    assert main.parent is None and main.tid == threading.get_native_id()
    for tag in "ab":
        (outer,) = [s for s in recs if s.name == "outer"
                    and s.attrs == {"tag": tag}]
        (inner,) = [s for s in recs if s.name == "inner"
                    and s.attrs == {"tag": tag}]
        # a thread's first span is a root: the main thread's open span is
        # not its parent
        assert outer.parent is None
        assert by_id[inner.parent] is outer
        assert outer.tid == inner.tid == ids[tag] != main.tid
        assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    assert set(trace.threads()) == {main.tid, ids["a"], ids["b"]}


def test_a_span_closes_on_an_exception():
    trace.enable()
    with pytest.raises(KeyError):
        with trace.span("outer"):
            with trace.span("inner"):
                raise KeyError("x")
    with trace.span("after"):
        pass
    by_name = {s.name: s for s in trace.records()}
    assert by_name["inner"].parent == by_name["outer"].id
    assert by_name["after"].parent is None


def test_prefetch_sample_spans_on_the_producer_thread():
    trace.enable()
    made = []

    def sample():
        made.append(threading.get_native_id())
        return len(made) - 1

    loader = PrefetchLoader(sample, depth=2)
    try:
        got = []
        for _ in range(5):
            with trace.span("fit.batch_wait", seq=loader.n_got):
                got.append(next(loader))
        assert loader.n_got == 5
    finally:
        loader.close()
    trace.disable()
    assert got == list(range(5))
    samples = [s for s in trace.records() if s.name == "prefetch.sample"]
    waits = [s for s in trace.records() if s.name == "fit.batch_wait"]
    assert {s.tid for s in samples} == {made[0]} != {threading.get_native_id()}
    assert [s.attrs["seq"] for s in samples] == list(range(len(samples)))
    assert [s.attrs["seq"] for s in waits] == list(range(5))
    assert loader.n_put >= 5
    # batch n is the one the n-th sample span made
    for w in waits:
        (made_it,) = [s for s in samples if s.attrs["seq"] == w.attrs["seq"]]
        assert made_it.end_ns <= w.end_ns


def test_the_cap_drops_spans_and_counts_them():
    rec = trace.Recorder(cap=3)
    rec.on = True
    for i in range(5):
        with rec.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in rec.records()] == [0, 1, 2]
    assert rec.dropped() == 2
    rec.clear()
    assert rec.records() == [] and rec.dropped() == 0


def test_write_chrome_trace(tmp_path):
    trace.enable()
    with trace.span("fit.step", step=0):
        with trace.span("fit.train_step"):
            pass
    trace.disable()
    path = tmp_path / "t.json"
    anchor = trace.clock_anchor()
    trace.write_chrome_trace(str(path), anchor=anchor)
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    assert [e["name"] for e in events] == ["fit.train_step", "fit.step"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert {e["tid"] for e in events} == {threading.get_native_id()}
    step = events[1]
    assert step["args"]["step"] == 0 and step["args"]["parent"] is None
    assert events[0]["args"]["parent"] == step["args"]["id"]
    # microseconds since the epoch, through the anchor
    rec = trace.records()[1]
    want = (rec.start_ns + anchor[1] - anchor[0]) / 1e3
    assert step["ts"] == pytest.approx(want, abs=1.0)
    assert doc["otherData"]["dropped"] == 0


def test_spans_land_on_the_profilers_clock():
    """A span around a CPU aten::mm, put on the profiler's clock through
    clock_anchor(), covers the op's interval (within 100 us) on the same
    thread id: kineto stamps CPU ops in Unix-epoch nanoseconds and gives a
    host op's thread as its device_resource_id."""
    x = torch.randn(128, 128)
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        anchor = trace.clock_anchor()
        with trace.span("mm"):
            torch.mm(x, x)
    trace.disable()
    (span,) = trace.records()
    start0 = prof.profiler.kineto_results.trace_start_ns()
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    off = anchor[1] - anchor[0]
    s0 = (span.start_ns + off - start0) * 1e-3
    s1 = (span.end_ns + off - start0) * 1e-3
    assert s0 - 100 <= mm.time_range.start <= mm.time_range.end <= s1 + 100
    assert mm.device_resource_id == span.tid


RASTER_SPANS = {"raster.project", "raster.bin", "raster.composite"}
SPAN_NAMES = {"fit.step", "fit.batch_wait", "fit.train_step",
              "step.forward", "step.backward", "step.update", "fit.densify",
              "fit.opacity_reset", "fit.log", "prefetch.sample",
              "composite.frame", "composite.contacts", "composite.png",
              *RASTER_SPANS}


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return request.param


def test_spans_stay_out_of_the_profilers_trace(device, tmp_path):
    """A hand train step under torch.profiler holds the same events, by
    name and count, with the recorder on as off (on the card: the same
    device operations), and none of them is a span."""
    from manus_tpu_torch import config as tcfg
    from manus_tpu_torch.data import synthetic as tsyn
    from manus_tpu_torch.train.trainer import Trainer

    cfg = tcfg.apply_overrides(tcfg.CONFIGS["HAND_GAUSSIAN"](), [
        "dataset.width=32", "dataset.height=32", "dataset.num_cameras=2",
        "capacity=256", "raster.max_pairs_per_tile=256",
        "dataset.grid_res=16", "dataset.sample_size=10",
        "trainer.val_every=0", "trainer.checkpoint_every=0",
        "raster.backend=auto", "loss.losses=[rgb_loss,ssim_loss]",
        "loss.loss_weight=[0.8,0.2]"])
    ds = tsyn.build_synthetic_dynamic(width=32, height=32, num_cameras=2,
                                      num_frames=2, device=device)
    model, grid = tmain.build_hand_pieces(cfg, ds, device=device)
    tr = Trainer(cfg, ds, model, True, grid, out_dir=str(tmp_path),
                 log=lambda *a: None)
    batch = tr.sample_batch()
    state = tr.state
    tr.train_step(state, batch)  # warm
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()

    def events(on: bool):
        if on:
            trace.enable()
        with torch.profiler.profile(activities=acts) as prof:
            with trace.span("fit.train_step"):
                tr.train_step(state, batch)
            if device == "cuda":
                torch.cuda.synchronize()
        trace.disable()
        return prof.events()

    off, on = events(False), events(True)
    assert {s.name for s in trace.records()} == {
        "fit.train_step", "step.forward", "step.backward", "step.update",
        *RASTER_SPANS}

    def names(evs, kind=None):
        return sorted(e.name for e in evs
                      if kind is None or e.device_type == kind)

    assert names(on) == names(off)
    assert not SPAN_NAMES & set(names(on))
    assert not any(e.is_user_annotation for e in on)
    if device == "cuda":
        cuda = torch.autograd.DeviceType.CUDA
        assert len(names(on, cuda)) == len(names(off, cuda)) > 0


COMMON = [
    "dataset.width=48", "dataset.height=48", "dataset.num_cameras=3",
    "capacity=512", "raster.backend=xla", "raster.max_pairs_per_tile=512",
    "model.remove_seg_end=0", "trainer.val_every=0",
]
HAND = ["dataset.num_frames=2", "dataset.sample_size=20",
        "dataset.grid_res=16", "trainer.max_steps=3",
        "trainer.checkpoint_every=0", "trainer.log_every=2",
        "loss.losses=[rgb_loss,ssim_loss,isotropic_reg]",
        "loss.loss_weight=[0.8,0.2,0.1]"]
STEP_PARTS = {"step.forward", "step.backward", "step.update"}


def _read(path, ph="X"):
    """The trace file's events of phase `ph` (spans; "C": counters)."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e["ph"] == ph]


@pytest.fixture(scope="module")
def hand_run(tmp_path_factory):
    """A short hand fit through the CLI with --trace-out: the run
    directory and the written trace's events."""
    out = str(tmp_path_factory.mktemp("trace_cli"))
    path = os.path.join(out, "hand.trace.json")
    tmain.main(["--device", "cpu", "--trace-out", path, "--config-name",
                "HAND_GAUSSIAN", *COMMON, *HAND, "trainer.exp_name=hand",
                f"trainer.output_dir={out}"])
    assert not trace.enabled() and trace.records() == []
    return out, _read(path)


def test_fit_records_its_spans(hand_run):
    _, events = hand_run
    by_id = {e["args"]["id"]: e for e in events}

    def parent(e):
        return by_id.get(e["args"]["parent"])

    steps = [e for e in events if e["name"] == "fit.step"]
    assert sorted(e["args"]["step"] for e in steps) == [0, 1, 2]
    assert all(parent(e) is None for e in steps)
    for name in ("fit.batch_wait", "fit.train_step"):
        got = [e for e in events if e["name"] == name]
        assert len(got) == 3
        assert sorted(parent(e)["args"]["step"] for e in got) == [0, 1, 2]
    waits = sorted(e["args"]["seq"] for e in events
                   if e["name"] == "fit.batch_wait")
    assert waits == [0, 1, 2]
    train = {e["args"]["id"] for e in events if e["name"] == "fit.train_step"}
    for name in STEP_PARTS:
        got = [e for e in events if e["name"] == name]
        assert len(got) == 3 and {e["args"]["parent"] for e in got} == train
    # the log block at steps 0 and 2 (log_every 2, and the last step)
    logs = [parent(e)["args"]["step"] for e in events if e["name"] == "fit.log"]
    assert sorted(logs) == [0, 2]
    samples = [e for e in events if e["name"] == "prefetch.sample"]
    assert len(samples) >= 3
    assert {e["tid"] for e in samples}.isdisjoint(e["tid"] for e in steps)


def test_composite_records_its_spans(hand_run, tmp_path):
    """Two gt_eval frames of the hand against itself: a composite.frame a
    frame, each with its composite.contacts and composite.png."""
    out, _ = hand_run
    ckpts = os.path.join(out, "manus_tpu", "synthetic", "hand",
                         "checkpoints")
    path = str(tmp_path / "comp.trace.json")
    run = tmain.main(["--device", "cpu", "--trace-out", path,
                      "--config-name", "COMPOSITE", *COMMON,
                      "dataset.num_frames=2", "trainer.exp_name=comp",
                      f"trainer.output_dir={out}",
                      f"hand_ckpt_dir={ckpts}", f"object_ckpt_dir={ckpts}",
                      "contact_render_type=gt_eval"])
    assert len(run.frames) == 2
    events = _read(path)
    frames = {e["args"]["id"]: e["args"]["frame"] for e in events
              if e["name"] == "composite.frame"}
    assert sorted(frames.values()) == sorted(run.frames)
    for name in ("composite.contacts", "composite.png"):
        got = [e for e in events if e["name"] == name]
        assert sorted(frames[e["args"]["parent"]] for e in got) == sorted(
            run.frames)


def test_a_rank_of_several_writes_its_own_trace(monkeypatch):
    assert tmain._rank_path("out/run.trace.json") == "out/run.trace.json"
    monkeypatch.setattr(tmain.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmain.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(tmain.dist, "get_rank", lambda: 2)
    assert tmain._rank_path("out/run.trace.json") == "out/run.trace.rank2.json"


class _Untouchable:
    """A value that fails on any use: a counter that is off must not read
    it (no conversion, no sum, no host sync)."""

    def __getattr__(self, name):
        raise AssertionError(f"the value was used ({name})")

    def __int__(self):
        raise AssertionError("the value was read")

    __float__ = __index__ = __bool__ = __int__


def test_count_off_costs_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(trace, "perf_counter_ns", no_clock)
    trace.count("gaussians.live", _Untouchable())
    trace.count("raster.pairs_emitted", _Untouchable(), _Untouchable())
    assert trace.counters() == [] and trace.dropped() == 0

    def counts(n):
        x = torch.ones(())
        for _ in range(n):
            trace.count("gaussians.live", x)

    counts(10)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        counts(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before <= 0 and peak - before < 512


def test_count_launches_nothing_and_syncs_not(device):
    """On as off, a count keeps its tensors as they are: no operation on
    them, and on the card no host sync (the sync debug mode raises on
    one); counters() reads them back, summed."""
    x = torch.arange(6, dtype=torch.int32, device=device)
    y = torch.tensor(4, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for on in (False, True):
                if on:
                    trace.enable()
                trace.count("raster.pairs_emitted", x, y, 3)
                trace.count("raster.pairs_dropped", y)
    finally:
        if device == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    assert not [e.name for e in prof.events() if e.name.startswith("aten::")]
    trace.disable()
    got = trace.counters()
    assert [(c.name, c.value) for c in got] == [
        ("raster.pairs_emitted", 15 + 4 + 3), ("raster.pairs_dropped", 4)]
    assert all(c.tid == threading.get_native_id() for c in got)
    assert got[0].t_ns <= got[1].t_ns


def test_the_cap_drops_counts_and_counts_them():
    rec = trace.Recorder(cap=2)
    rec.on = True
    for i in range(5):
        rec.count("gaussians.live", i)
    assert [c.value for c in rec.counters()] == [0, 1]
    assert rec.dropped() == 3
    rec.clear()
    assert rec.counters() == [] and rec.dropped() == 0


def test_chrome_trace_carries_the_counters(tmp_path):
    trace.enable()
    with trace.span("fit.step", step=0):
        trace.count("gaussians.live", torch.tensor(7))
    trace.count("raster.pairs_kept", torch.tensor([2, 3]))
    trace.disable()
    path = tmp_path / "t.json"
    anchor = trace.clock_anchor()
    trace.write_chrome_trace(str(path), anchor=anchor)
    events = json.loads(path.read_text())["traceEvents"]
    counts = [e for e in events if e["ph"] == "C"]
    assert [(e["name"], e["args"]) for e in counts] == [
        ("gaussians.live", {"gaussians.live": 7.0}),
        ("raster.pairs_kept", {"raster.pairs_kept": 5.0})]
    (step,) = [e for e in events if e["ph"] == "X"]
    first = trace.counters()[0]
    assert counts[0]["ts"] == pytest.approx(
        (first.t_ns + anchor[1] - anchor[0]) / 1e3, abs=1.0)
    assert step["ts"] <= counts[0]["ts"] <= step["ts"] + step["dur"]
    assert counts[0]["tid"] == step["tid"]


def _render_counts(tg_max, budget, cap):
    """A render of a small scene with the recorder on: its bins (binned
    again, as the render bins them) and its pair counters."""
    from manus_tpu_torch.ops.rasterizer.api import RasterConfig, \
        render_gaussians
    from manus_tpu_torch.ops.rasterizer.binning import bin_gaussians
    from manus_tpu_torch.ops.rasterizer.projection import project_gaussians
    from manus_tpu_torch.utils.camera import make_camera

    from tests.utils import random_scene

    s = random_scene(300, seed=5, scale_range=(0.08, 0.25))
    K = torch.tensor([[60.0, 0, 31.5], [0, 60.0, 31.5], [0, 0, 1]])
    extr = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 3.0]])
    cam = make_camera(K.numpy(), extr.numpy(), 64, 64, device="cpu")
    means = torch.tensor(np.asarray(s["means"]))
    cov = torch.tensor(np.asarray(s["cov6"]))
    cfg = RasterConfig(tg_max=tg_max, pair_budget_factor=budget,
                       max_pairs_per_tile=cap, backend="torch")
    trace.enable()
    render_gaussians(means, cov, means, torch.zeros(300, 1, 3),
                     torch.as_tensor(s["opacity"]), cam, torch.zeros(3),
                     colors_precomp=torch.as_tensor(s["colors"]),
                     config=cfg)
    trace.disable()
    bins = bin_gaussians(project_gaussians(means, cov, cam), 4, 4, tg_max,
                         pair_budget_factor=budget, max_pairs_per_tile=cap)
    return bins, {c.name: c.value for c in trace.counters()}


@pytest.mark.parametrize("tg_max,budget,cap", [(0, 0, 0), (3, 1, 12)],
                         ids=["uncapped", "tuned_drops"])
def test_pair_counters_agree_with_the_bins(tg_max, budget, cap):
    bins, got = _render_counts(tg_max, budget, cap)
    kept, dropped = int(bins.tile_counts.sum()), int(bins.overflow_count)
    assert got == {"raster.pairs_emitted": kept + dropped,
                   "raster.pairs_kept": kept,
                   "raster.pairs_dropped": dropped}
    assert (dropped > 0) == (tg_max > 0) and kept > 0
    # the rules drop pairs, never make them: the uncapped binning's pairs
    # are what the capped one emits
    if tg_max:
        full, _ = _render_counts(0, 0, 0)
        assert int(full.tile_counts.sum()) == kept + dropped


def test_densify_counters_agree_with_the_event():
    """Eight live slots over the threshold in 14: two clones and six
    splits ask for 14 children; the 6 free slots take both clones and two
    splits, and the other four splits drop 8 children."""
    from manus_tpu_torch.models import densify as tdensify
    from manus_tpu_torch.models.gaussians import (GaussianModel,
                                                  GaussianOpts,
                                                  GaussianParams)
    from manus_tpu_torch.train import optim as toptim

    cap, live = 14, 8
    gen = torch.Generator().manual_seed(0)
    scaling = torch.full((cap, 3), -2.0)
    scaling[:2] = -9.0  # small: clones
    params = GaussianParams(
        xyz=torch.randn(cap, 3, generator=gen),
        features_dc=torch.zeros(cap, 1, 3),
        features_rest=torch.zeros(cap, 15, 3), scaling=scaling,
        rotation=torch.tensor([[1.0, 0, 0, 0]]).repeat(cap, 1),
        opacity=torch.full((cap, 1), 2.0))
    model = GaussianModel(params=params,
                          active=torch.arange(cap) < live)
    stats = tdensify.DensifyStats(grad_accum=torch.ones(cap),
                                  denom=torch.ones(cap),
                                  max_radii2d=torch.zeros(cap))
    opts = GaussianOpts(densify_grad_threshold=0.5, percent_dense=0.01)
    noise = torch.randn(2, cap, 3, generator=gen)
    trace.enable()
    _, _, _, info = tdensify.densify_and_prune(
        model, toptim.init_adam(params), stats, opts, 1.0, noise, False)
    trace.disable()
    got = {c.name: c.value for c in trace.counters()}
    assert int(info["clones"]) == 2 and int(info["splits"]) == 2
    assert got == {"densify.children_written": 2 + 2 * 2,
                   "densify.children_dropped": 2 * 4}


def test_a_hand_fit_opens_its_spans_and_the_raster_spans(hand_run):
    """The hand fit's span names are those it opened before the raster
    spans came, and the three raster spans, once a view under each
    step.forward (the final validation's renders have no step)."""
    out, spans = hand_run
    assert {e["name"] for e in spans} == {
        "fit.step", "fit.batch_wait", "fit.train_step", "fit.log",
        "prefetch.sample", *STEP_PARTS, *RASTER_SPANS}
    by_id = {e["args"]["id"]: e for e in spans}
    forward = {e["args"]["id"] for e in spans if e["name"] == "step.forward"}
    for name in RASTER_SPANS:
        under = [by_id[e["args"]["parent"]]["args"]["id"] for e in spans
                 if e["name"] == name and e["args"]["parent"] in by_id]
        assert sorted(under) == sorted(forward)
    live = [e["args"]["gaussians.live"] for e in _read(
        os.path.join(out, "hand.trace.json"), "C")
        if e["name"] == "gaussians.live"]
    assert len(live) == 3 and all(v > 0 for v in live)
