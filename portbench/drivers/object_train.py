"""Object training (OBJ_GAUSSIAN) through the port's own fit loop,
`Trainer.fit`, at its published size.

Set-up makes the object, the rig, the gt images and the initial points
from the seed (portbench/object_scene.py), builds the initial model with
the port's `init_gaussian_model` and the Trainer on it, and drives `fit`
through its first steps: the three the reference follows
(portbench/reference/object_step.py), then a few to warm every shape.
Then it runs one densify event on the state those steps left, which the
reference follows too (portbench/reference/densify.py). After the run,
the initial cloud that `init_gaussian_model` made is held to the
published rule (the reference's `init_cloud`, in float64) before the
reference's steps start from it. The window is a new `fit` call that
runs until `--seconds` have passed; its metric is the window over the
steps finished in it, its densify events included, which write
children into free slots (51 s grow the cloud from about 300,000 live
to 550,000-830,000: the slots do not fill in the window). With a trace, the same `fit` call goes on for a stretch of steps under
torch.profiler once the window has closed, with the port's span recorder
on from the window's start (its spans and counters feed the raster and
densify readings).

The views come from the Trainer's on-card image cache, so the harness
learns each step's view from the Trainer's own draw (a wrapper of its
random state that keeps the last draw). Otherwise it steers `fit` as
hand_train.py does, with whose pieces it is built. Standard error gets
the live slots at the window's ends, after each of its densify events,
and the children its events wrote.
"""
from __future__ import annotations

import gc
import os
import statistics
from types import SimpleNamespace

import numpy as np
import torch

from portbench import object_scene
from portbench import spans as sp
from portbench import trace as tr
from portbench.counts import object as ocount
from portbench.drivers.common import (
    LEAVES,
    compare,
    compare_densify,
    config_as_run,
    decode,
    port_config,
    sync,
)
from portbench.drivers.hand_train import (
    VIEW_KEY,
    Steps,
    StretchDone,
    densify_event,
    densify_reference,
)
from portbench.reference import frozen as fz
from portbench.reference import object_step as ref


class Dataset:
    """The object's gt images behind the dataset interface the Trainer
    reads: one frame, `get_batch` decoding uint8 RGBA to float32 rgb and
    mask."""

    num_frames = 1

    def __init__(self, images, cameras, extent):
        self.images = images  # [1, V, H, W, 4] uint8
        self.cameras = cameras
        self.extent = extent

    @property
    def num_views(self):
        return self.images.shape[1]

    def get_batch(self, frame: int, views):
        rgb, mask = decode(self.images[frame, views])
        return dict(rgb=rgb, mask=mask)


class Draws:
    """The Trainer's random state, keeping the last `randint` draw (the
    object's sampler draws a step's views and nothing else)."""

    def __init__(self, rng):
        self.rng, self.last = rng, None

    def randint(self, *args, **kwargs):
        self.last = self.rng.randint(*args, **kwargs)
        return self.last

    def __getattr__(self, name):
        return getattr(self.rng, name)


def _require_counters():
    """The cell reads the port's trace counters: a program without them
    cannot run it, and the run ends here, at once."""
    from manus_tpu_torch.utils import trace

    if not hasattr(trace, "count"):
        raise RuntimeError("object_growth needs the trace counters of "
                           "manus_tpu_torch/utils/trace.py (count, "
                           "counters), which this program lacks")
    return trace


def run(ctx):
    """One run of the cell; see the module docstring. `ctx` is the
    harness's RunContext."""
    rec = _require_counters()
    from manus_tpu_torch.models.gaussians import init_gaussian_model
    from manus_tpu_torch.train.trainer import Trainer
    from manus_tpu_torch.utils.camera import make_camera, stack_cameras

    dev = ctx.device
    cfg_dict = config_as_run(ctx.config, ctx.traffic, ctx.scale)
    d = cfg_dict["dataset"]
    inputs = object_scene.build(cfg_dict, ctx.config["scene"], ctx.seed, dev)
    cfg = port_config(ctx.config["preset"], cfg_dict, ctx.seed)
    cfg.trainer.output_dir = os.path.join(ctx.tmpdir, "run")
    cfg.trainer.exp_name = "portbench"
    model = init_gaussian_model(inputs["points"], inputs["colors"],
                                cfg.capacity, opts=cfg.model, device=dev)
    inputs["init"] = dict(zip(LEAVES, (p.clone() for p in model.params)),
                          active=model.active.clone())
    cams = stack_cameras([make_camera(k, e, d["width"], d["height"],
                                      device=dev)
                          for k, e in zip(inputs["K"], inputs["extr"])])
    ds = Dataset(inputs["images"], cams, inputs["extent"])
    trainer = Trainer(cfg, ds, model, False, None, val_dataset=None,
                      log=ctx.log)
    draws = Draws(trainer._rng)
    trainer._rng = draws
    steps = Steps(trainer.train_step, lambda: sync(dev))
    trainer.train_step = steps
    sample_batch = trainer.sample_batch

    def tagged_batch():
        # the draw happens inside sample_batch, in the one producer thread
        batch = sample_batch()
        batch[VIEW_KEY] = (0, np.asarray(draws.last).copy())
        return batch

    trainer.sample_batch = tagged_batch
    spans = tr.Spans()
    densify_step = trainer.densify_step
    event_info = []

    def densify(state):
        state, info = densify_step(state)
        event_info.append(info)
        return state, info

    trainer.densify_step = spans.wrap("densify", densify)
    trainer.opacity_reset = spans.wrap("opacity_reset", trainer.opacity_reset)

    def fit(**stretch):
        steps.start(**stretch)
        try:
            trainer.fit(max_steps=1 << 40)
        except StretchDone:
            pass

    # the first steps: the reference follows them; then the warm-up
    n_check = ctx.traffic["check_steps"]
    prog = dict(losses=[])
    live = []

    def record(n, state, metrics):
        if n <= n_check:
            prog["losses"].append(metrics["loss"].detach().clone())
        if n == 1:
            prog["grad1"] = {k: m / (1.0 - fz.BETA1)
                             for k, m in zip(LEAVES, state.opt.m)}
        if n == n_check:
            prog["params"] = {k: p.clone() for k, p in
                              zip(LEAVES, state.model.params)}

    fit(limit=n_check + ctx.traffic["warmup_steps"], on_step=record)
    check_views = steps.views[:n_check]
    # a densify event on the state the warm-up left, with free slots for
    # its children; the reference follows it
    noise_seed = ctx.seed % (2**63 - 1)
    event = densify_event(trainer, densify_step, noise_seed)
    live_start = int(trainer.state.model.active.sum())
    sync(dev)

    # the window; with a trace, the recorder on from its start and the
    # same fit call going on under the profiler once it has closed
    n_trace = ctx.traffic["trace_steps"]
    n_before = len(trainer.timings["step_s"])
    profile = sp.AnchoredProfile(rec.clock_anchor) if ctx.trace else None
    live.clear()
    event_info.clear()
    if ctx.trace:
        rec.clear()
        rec.enable()
    t0 = ctx.window_started()
    try:
        fit(deadline=t0 + ctx.seconds, on_step=lambda n, s, m: live.append(
            m["num_active"]), after=profile, after_steps=n_trace)
    finally:
        rec.disable()
    window_s, n_window = steps.t_end - t0, steps.n_window
    events_s = spans.total("densify", t0, steps.t_end) + spans.total(
        "opacity_reset", t0, steps.t_end)
    n_events = sum(1 for s, _ in spans.items["densify"] + spans.items[
        "opacity_reset"] if t0 <= s < steps.t_end)
    result = dict(attempted=n_window, failed=0,
                  end_to_end=dict(train_step_ms=1e3 * window_s / n_window))
    layer = dict(step_ms=1e3 * window_s / n_window, window_s=window_s,
                 steps=n_window, event_s=events_s, events=n_events)
    _note_window(ctx, trainer, n_before, n_window, live, live_start,
                 spans, event_info, t0, steps.t_end)

    if ctx.trace:
        layer["trace"] = steps.trace
        layer["trace_steps"] = steps.n - n_window
        records = rec.records()
        counts = rec.counters()
        layer.update(
            spans=records, window_t0=t0, window_t_end=steps.t_end,
            span_join=sp.join_profile(profile, records, rec.threads()),
            stretch_counts=_sums(c for c in counts
                                 if c.t_ns >= profile.t0 * 1e9))
        rec.clear()
        ctx.note(layer["span_join"].table(layer["trace_steps"], "step"))
        traced_views = [int(v[0]) for _, v in steps.views[n_window:]]
    ctx.read_memory_peak()
    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.state.model.params)
    if not finite:
        result["failed"] = n_window
    if ctx.trace:
        # the work that the shares divide by: the traced steps' views, on
        # the state the stretch left
        state = trainer.state
        layer["work_s"] = ocount.step_work(
            cfg_dict, inputs, dict(zip(LEAVES, state.model.params)),
            state.model.active, traced_views, dev)

    # correctness: the reference follows the first steps and the densify
    # event, after the program's state is freed
    batches = []
    for f, views in check_views:
        rgb, mask = decode(inputs["images"][f, int(views[0])])
        batches.append((int(views[0]), rgb, mask))
    prog["losses"] = [float(x) for x in prog["losses"]]
    capacity = trainer.state.model.capacity
    del trainer, steps, model, sample_batch, densify_step, live, event_info
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    opts = SimpleNamespace(**cfg_dict["model"])
    compared = dict(init=init_gap(inputs["init"], ref.init_cloud(
        inputs["points"], inputs["colors"], capacity, opts, dev)))
    reference = ref.run_steps(cfg_dict, inputs, batches, device=dev)
    compared.update(compare(prog, reference, inputs["init"]))
    want = densify_reference(event, opts, inputs["extent"], noise_seed,
                             capacity, dev)
    compared.update(compare_densify(event["after"], want, event["before"]))
    result["compared"] = compared
    result["layer"] = layer
    return result


def init_gap(program: dict, rule: dict) -> float:
    """The number `correct` compares for the initial cloud: the largest
    gap between the program's leaves and the published rule's
    (reference/object_step.py init_cloud) over the rule's live slots, the
    log-scales as the leaves hold them (so a relative gap of the scale),
    plus the number of slots whose liveness differs."""
    live = rule["active"]
    gap = max(float((program[k][live] - rule[k][live]).abs().max())
              for k in LEAVES)
    return gap + int((program["active"] != live).sum())


def _sums(counts) -> dict:
    out = {}
    for c in counts:
        out[c.name] = out.get(c.name, 0.0) + c.value
    return out


def _note_window(ctx, trainer, n_before, n_window, live, live_start, spans,
                 event_info, t0, t_end):
    """The window's host times a step, its live slots and its densify
    events' children, on standard error."""
    host_ms = sorted(1e3 * x for x in trainer.timings["step_s"][
        n_before:n_before + n_window])
    if host_ms:
        ctx.note("host ms a fit iteration in the window: p10 %.2f median "
                 "%.2f p90 %.2f max %.2f over %d" % (
                     host_ms[len(host_ms) // 10], statistics.median(host_ms),
                     host_ms[9 * len(host_ms) // 10], host_ms[-1],
                     len(host_ms)))
    # the wrapped events are the fit calls' own, in order: the window's,
    # then the traced stretch's
    infos = [{k: int(v) for k, v in info.items()} for info, (s, _) in zip(
        event_info, spans.items["densify"]) if t0 <= s < t_end]
    written = sum(e["clones"] + 2 * e["splits"] for e in infos)
    ctx.note("live slots: %d at the window's start, %d at its end (step "
             "%d); after each of its %d densify events: %s; children "
             "written %d, candidates without a free slot %d" % (
                 live_start, int(live[n_window - 1]) if live else -1,
                 n_window, len(infos),
                 [e["num_active"] for e in infos], written,
                 sum(e["alloc_dropped"] for e in infos)))
