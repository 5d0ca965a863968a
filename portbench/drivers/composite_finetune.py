"""The contact stage's hand fine-tune through the port's own loop,
`main.run_composite` with optimize_hand, against an object at
OBJ_GAUSSIAN's published size.

Set-up makes the scene from the seed (portbench/composite_scene.py):
hand_720p's hand and its voxel grid, the object's `object_slots`
gaussians, all live, and the joint gt images. `run_composite` reads them
through `build_dataset` and `_load_model`, which the harness points at
the benchmark's dataset (8 poses x 50 cameras, each batch decoded from
uint8 by get_batch) and models in memory, as composite_frames.py does.
The harness also wraps the step that `make_composite_finetune_step`
returns: it counts the steps, keeps what the first `check_steps` left
(their losses, the first gradient as Adam's first moment holds it, the
hand after them) and each step's (frame, view) as get_batch was asked
for it; after `warmup_steps` more it starts the window, and at the
first step past `--seconds` it synchronises and closes it. The window's
metric is its time over the steps run_composite finished in it: their
batches (the draw, get_batch on the main thread, the copies to the
card), the steps, and the loop's log line every 50 steps. With a trace,
the port's span recorder is on from the window's start and the same loop
goes on for `trace_steps` under torch.profiler; then the harness ends
run_composite by raising out of the step, so that its gt_eval frames
never run (a render call raises, should the loop ever end first).

`correct` compares the first steps with the plain reference
(portbench/reference/composite_finetune.py) from the same state and
batches, as hand_lpips does (loss, grad, change), and the object's
leaves and liveness after the window with what set-up gave it (`frozen`:
the largest difference, exactly 0 when nothing touched it).
"""
from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from portbench import composite_scene
from portbench import spans as sp
from portbench.counts import finetune as fcount
from portbench.drivers.common import (
    LEAVES,
    compare,
    config_as_run,
    decode,
    port_config,
    port_model,
    port_scene,
    sync,
)
from portbench.drivers.object_train import _sums
from portbench.reference import composite_finetune as ref
from portbench.reference import frozen as fz


class StretchDone(Exception):
    """Raised out of run_composite to end its fine-tune."""


class Dataset:
    """What run_composite reads of its dataset: the cameras, the rest and
    posed bones, the numbers of frames and views, and get_batch, which
    decodes the uint8 RGBA gt as the other training cells' datasets do
    (common.decode) and records each (frame, view) asked for."""

    def __init__(self, images, cameras, bones_rest, bones_posed):
        self.images = images  # [F, V, H, W, 4] uint8
        self.cameras = cameras
        self.bones_rest, self.bones_posed = bones_rest, bones_posed
        self.num_frames, self.num_views = images.shape[:2]
        self.asked = []

    def get_batch(self, frame: int, views):
        self.asked.append((int(frame), int(np.asarray(views)[0])))
        rgb, mask = decode(self.images[frame, views])
        return dict(rgb=rgb, mask=mask)


class Steps:
    """The harness's view of run_composite's fine-tune: wraps the step
    that make_composite_finetune_step returns (module docstring)."""

    def __init__(self, ctx, dataset, rec, sync):
        self.ctx, self.ds, self.rec, self.sync = ctx, dataset, rec, sync
        t = ctx.traffic
        self.n_check = t["check_steps"]
        self.n_warm = t["check_steps"] + t["warmup_steps"]
        self.n_trace = t["trace_steps"] if ctx.trace else 0
        self.n, self.views, self.t_calls = 0, [], []
        self.prog = dict(losses=[])
        self.t0 = self.t_end = self.n_window = None
        self.profile = self.trace = None

    def wrap_factory(self, factory):
        def make_step(*args, **kwargs):
            step_fn = factory(*args, **kwargs)

            def step(state, frozen, batch):
                return self.step(step_fn, state, frozen, batch)
            return step
        return make_step

    def step(self, step_fn, state, frozen, batch):
        self.t_calls.append(time.perf_counter())
        if self.t0 is None and self.n == self.n_warm:
            self.sync()
            if self.ctx.trace:
                self.rec.clear()
                self.rec.enable()
            self.t0 = self.ctx.window_started()
        elif (self.t_end is None and self.t0 is not None
              and time.perf_counter() >= self.t0 + self.ctx.seconds):
            self.sync()
            self.t_end = time.perf_counter()
            self.n_window = self.n - self.n_warm
            if not self.n_trace:
                raise StretchDone
            self.profile = sp.AnchoredProfile(self.rec.clock_anchor)
            self.profile.start()
        elif (self.t_end is not None
              and self.n - self.n_warm - self.n_window >= self.n_trace):
            self.trace = self.profile.stop()
            self.rec.disable()
            raise StretchDone
        state, metrics = step_fn(state, frozen, batch)
        self.views.append(self.ds.asked[-1])
        self.n += 1
        self.record(state, metrics)
        return state, metrics

    def record(self, state, metrics):
        n, prog = self.n, self.prog
        if n <= self.n_check:
            prog["losses"].append(metrics["loss"].detach().clone())
        if n == 1:
            prog["grad1"] = {k: m / (1.0 - fz.BETA1)
                             for k, m in zip(LEAVES, state.opt.m)}
        if n == self.n_check:
            prog["params"] = {k: p.clone() for k, p in
                              zip(LEAVES, state.model.params)}
        self.state = state


def never_rendered(factory):
    """make_composite_render whose renderer raises: the fine-tune ends by
    the harness's StretchDone, before any gt_eval frame."""
    def make_render(*args, **kwargs):
        factory(*args, **kwargs)  # it checks the mode

        def render(*a, **k):
            raise RuntimeError("run_composite's fine-tune ended before the "
                               "harness closed its stretch")
        return render
    return make_render


def _require_counters():
    """The cell reads the port's trace counters: a program without them
    cannot run it, and the run ends here, at once."""
    from manus_tpu_torch.utils import trace

    if not hasattr(trace, "count"):
        raise RuntimeError("composite_finetune needs the trace counters of "
                           "manus_tpu_torch/utils/trace.py (count, "
                           "counters), which this program lacks")
    return trace


def frozen_gap(before: dict, model) -> float:
    """The largest absolute difference of the object's leaves from what
    set-up gave it, plus the slots whose liveness differs."""
    gap = max(float((p - before[k]).abs().max())
              for k, p in zip(LEAVES, model.params))
    return gap + int((model.active != before["active"]).sum())


def _note_host_ms(ctx, t_calls):
    """The host's time from one step call to the next in the window (the
    batch, the step, the loop's log line), on standard error."""
    ms = sorted(1e3 * (b - a) for a, b in zip(t_calls, t_calls[1:]))
    if ms:
        ctx.note("host ms a fine-tune iteration in the window: p10 %.2f "
                 "median %.2f p90 %.2f max %.2f over %d" % (
                     ms[len(ms) // 10], ms[len(ms) // 2],
                     ms[9 * len(ms) // 10], ms[-1], len(ms)))


def split_scale(scene: dict, scale: dict) -> tuple:
    """(the scene's numbers, the configuration's scale): a harness's
    `scale` shrinks the scene's numbers too, named "scene.<key>"."""
    scene, rest = dict(scene), {}
    for k, v in scale.items():
        if k.startswith("scene."):
            scene[k[len("scene."):]] = v
        else:
            rest[k] = v
    return scene, rest


def run(ctx):
    """One run of the cell; see the module docstring. `ctx` is the
    harness's RunContext."""
    rec = _require_counters()
    from manus_tpu_torch import main as port_main

    dev = ctx.device
    scene, scale = split_scale(ctx.config["scene"], ctx.scale)
    cfg_dict = config_as_run(ctx.config, ctx.traffic, scale)
    inputs = composite_scene.build(cfg_dict, scene, ctx.seed, dev)
    cfg = port_config(ctx.config["preset"], cfg_dict, ctx.seed)
    cfg.hand_ckpt_dir, cfg.object_ckpt_dir = "hand", "object"
    cams, rest, posed, grid = port_scene(cfg, inputs, dev)
    ds = Dataset(inputs["images"], cams, rest, posed)
    obj = port_model(inputs["obj"])
    before = dict(zip(LEAVES, (p.clone() for p in obj.params)),
                  active=obj.active.clone())
    loaded = dict(hand=(port_model(inputs["init"]), grid),
                  object=(obj, None))
    steps = Steps(ctx, ds, rec, lambda: sync(dev))
    patches = dict(
        build_dataset=lambda cfg, split, device=None: ds,
        _load_model=lambda ckpt_dir, device: loaded[ckpt_dir],
        make_composite_finetune_step=steps.wrap_factory(
            port_main.make_composite_finetune_step),
        make_composite_render=never_rendered(port_main.make_composite_render))
    saved = {k: getattr(port_main, k) for k in patches}
    for k, v in patches.items():
        setattr(port_main, k, v)
    try:
        port_main.run_composite(cfg, os.path.join(ctx.tmpdir, "composite"),
                                device=dev)
    except StretchDone:
        pass
    finally:
        for k, v in saved.items():
            setattr(port_main, k, v)
        rec.disable()

    n_window = steps.n_window
    window_s = steps.t_end - steps.t0
    result = dict(attempted=n_window, failed=0,
                  end_to_end=dict(train_step_ms=1e3 * window_s / n_window))
    layer = dict(step_ms=1e3 * window_s / n_window, window_s=window_s,
                 steps=n_window)
    if ctx.trace:
        profile = steps.profile
        records = rec.records()
        layer.update(
            trace=steps.trace, trace_steps=steps.n_trace, spans=records,
            window_t0=steps.t0, window_t_end=steps.t_end,
            span_join=sp.join_profile(profile, records, rec.threads()),
            stretch_counts=_sums(c for c in rec.counters()
                                 if c.t_ns >= profile.t0 * 1e9))
        rec.clear()
        ctx.note(layer["span_join"].table(steps.n_trace, "step"))
    ctx.read_memory_peak()
    state = steps.state
    if not all(bool(torch.isfinite(p).all()) for p in state.model.params):
        result["failed"] = n_window
    frozen = frozen_gap(before, obj)
    if ctx.trace:
        # the work that the shares divide by: the traced steps' views, on
        # the state the stretch left
        traced = steps.views[steps.n_warm + n_window:]
        layer["work_s"] = fcount.step_work(
            cfg_dict, inputs, dict(zip(LEAVES, state.model.params)),
            state.model.active, traced, dev)
    ctx.note("the window: %d steps of %.3f ms; the object's %d slots, "
             "frozen gap %r" % (n_window, layer["step_ms"],
                                before["active"].shape[0], frozen))
    _note_host_ms(ctx, steps.t_calls[steps.n_warm:steps.n_warm + n_window + 1])

    # correctness: the reference follows the first steps from the same
    # state and batches, after the program's state is freed
    batches = [(f, v, *decode(inputs["images"][f, v]))
               for f, v in steps.views[:steps.n_check]]
    prog = steps.prog
    prog["losses"] = [float(x) for x in prog["losses"]]
    del steps, loaded, obj, state, patches, saved
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    reference = ref.run_steps(cfg_dict, inputs, batches, device=dev)
    compared = compare(prog, reference, inputs["init"])
    compared["frozen"] = frozen
    result["compared"] = compared
    result["layer"] = layer
    return result
