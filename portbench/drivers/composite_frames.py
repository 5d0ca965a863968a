"""The contact stage's frames, through the port's own loop,
`main.run_composite`: a frame is `train/composite.make_composite_render`,
the image copied to the host, and written as a PNG.

Set-up makes the hand (hand_720p's initial cloud, its voxel grid) and an
object shell touching it from the seed. `run_composite` reads them
through `build_dataset` and `_load_model`, which the harness points at
the benchmark's own dataset (the poses cycled over gt_eval's 250 frames,
the cameras over the rig) and models in memory, in place of a capture
and checkpoints on disk. The harness also wraps the renderer that
`make_composite_render` returns, to keep each frame's contacts and the
running sum, and `dump_image`, which closes each frame: after the
traffic's warm-up frames it starts the window, and at the first frame
past `--seconds` it synchronises and closes it. The window's metric is
its time over the frames finished in it. With a trace, the same loop
goes on for a stretch of frames under torch.profiler, with host spans
(each synchronised at both ends) around the renderer's calls into
ops/contacts. Should the loop run out of frames before the window
closes, run_composite is called again, as a second pass over the
sequence.

`correct` compares every frame of the window: its contacts against the
float64 search of its pose, the running sum of the last pass against
the float64 sum over that pass's frames, and the panels of a few frames
drawn from the seed against the frozen plain render
(portbench/reference/composite_frames.py).
"""
from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from portbench import trace as tr
from portbench.counts import composite as ccount
from portbench.counts import gaussians as gcount
from portbench.counts import peaks
from portbench.drivers.common import (
    build_inputs,
    config_as_run,
    port_config,
    port_model,
    port_scene,
    sync,
)
from portbench.reference import composite_frames as ref


class StretchDone(Exception):
    """Raised out of run_composite to end the run's frames."""


class Poses:
    """The posed bones of frame f: pose f mod the number of poses."""

    def __init__(self, posed):
        self.posed = posed

    def __getitem__(self, f: int):
        return self.posed[f % len(self.posed)]


class Dataset:
    """What run_composite reads of its test dataset: the cameras, the rest
    and posed bones, and the number of frames and views."""

    def __init__(self, cameras, num_views: int, bones_rest, posed,
                 num_frames: int):
        self.cameras, self.num_views = cameras, num_views
        self.bones_rest = bones_rest
        self.bones_posed = Poses(posed)
        self.num_frames = num_frames


class Frames:
    """The harness's view of run_composite's frames: the window's start
    and close, and what each frame produced."""

    def __init__(self, ctx, n_poses: int, sync):
        self.ctx, self.n_poses, self.sync = ctx, n_poses, sync
        self.n_warm = ctx.traffic["warmup_frames"]
        self.n_trace = ctx.traffic["trace_frames"] if ctx.trace else 0
        self.passes = []  # [[pose of each frame in order]] a pass
        # the window's frames: (pose, contacts, uint8 image, pass, place)
        self.window = []
        self.pending = None  # the frame being rendered, as in `window`
        self.t0 = self.t_end = None
        self.n_done, self.n_window, self.acc = 0, None, None
        self.profile, self.trace = None, None
        self.spans = tr.Spans()

    def wrap_factory(self, factory):
        def make_render(*args, **kwargs):
            render_fn = factory(*args, **kwargs)
            self.passes.append([])

            def render(models, bone_tf, camera, cano_camera, bg, acc,
                       aux_colors, stats=None):
                out = render_fn(models, bone_tf, camera, cano_camera, bg,
                                acc, aux_colors, stats=stats)
                # frame f of a pass (run_composite renders them in
                # order) shows pose f mod the number of poses
                poses = self.passes[-1]
                self.pending = (len(poses) % self.n_poses, out[2],
                                len(self.passes) - 1, len(poses))
                poses.append(self.pending[0])
                self.acc = out[1]
                return out
            return render
        return make_render

    def wrap_dump(self, dump_image):
        def dump(img, path):
            dump_image(img, path)
            self.frame_done(img)
        return dump

    def frame_done(self, img):
        self.n_done += 1
        if self.t0 is None:
            if self.n_done == self.n_warm:
                self.sync()
                self.t0 = self.ctx.window_started()
            return
        if self.t_end is None:
            pose, contacts, n_pass, place = self.pending
            self.window.append((pose, contacts, img, n_pass, place))
            if time.perf_counter() >= self.t0 + self.ctx.seconds:
                self.sync()
                self.t_end = time.perf_counter()
                self.n_window = len(self.window)
                if not self.n_trace:
                    raise StretchDone
                self.begin_trace()
            return
        if self.n_done - self.n_warm - self.n_window >= self.n_trace:
            self.trace = self.profile.stop()
            self.end_trace()
            raise StretchDone

    def begin_trace(self):
        from manus_tpu_torch.ops import contacts as contacts_mod

        search = self.search = contacts_mod.contact_map

        def timed_search(*args, **kwargs):
            self.sync()
            with self.spans.span("contacts"):
                out = search(*args, **kwargs)
                self.sync()
            return out

        contacts_mod.contact_map = timed_search
        self.profile = tr.Profile()
        self.profile.start()

    def end_trace(self):
        from manus_tpu_torch.ops import contacts as contacts_mod

        contacts_mod.contact_map = self.search


def run(ctx):
    from manus_tpu_torch import main as port_main

    dev = ctx.device
    cfg_dict = config_as_run(ctx.config, ctx.traffic, ctx.scale)
    inputs = build_inputs(cfg_dict, ctx.config["scene"], ctx.seed, dev,
                          obj=True)
    cfg = port_config(ctx.config["preset"], cfg_dict, ctx.seed)
    cfg.contact_render_type = ctx.traffic["mode"]
    cfg.hand_ckpt_dir, cfg.object_ckpt_dir = "hand", "object"
    cams, rest, posed, grid = port_scene(cfg, inputs, dev)
    ds = Dataset(cams, len(inputs["K"]), rest, posed, ctx.traffic["frames"])
    loaded = dict(hand=(port_model(inputs["init"]), grid),
                  object=(port_model(inputs["obj"]), None))
    frames = Frames(ctx, len(posed), lambda: sync(dev))
    patches = dict(
        build_dataset=lambda cfg, split, device=None: ds,
        _load_model=lambda ckpt_dir, device: loaded[ckpt_dir],
        make_composite_render=frames.wrap_factory(
            port_main.make_composite_render),
        dump_image=frames.wrap_dump(port_main.dump_image))
    saved = {k: getattr(port_main, k) for k in patches}
    for k, v in patches.items():
        setattr(port_main, k, v)
    out_dir = os.path.join(ctx.tmpdir, "composite")
    try:
        while True:
            port_main.run_composite(cfg, out_dir, device=dev)
    except StretchDone:
        pass
    finally:
        for k, v in saved.items():
            setattr(port_main, k, v)
        if frames.profile is not None and frames.trace is None:
            frames.end_trace()

    k = frames.n_window
    window_s = frames.t_end - frames.t0
    result = dict(attempted=k, failed=0,
                  end_to_end=dict(composite_frame_ms=1e3 * window_s / k))
    layer = dict(frame_ms=1e3 * window_s / k, window_s=window_s, frames=k)
    if ctx.trace:
        layer["trace"] = frames.trace
        layer["trace_frames"] = frames.n_trace
        layer["search_s"] = frames.spans.total("contacts")
    ctx.read_memory_peak()

    acc_prog, passes = frames.acc, frames.passes
    window = frames.window
    cano_cam = port_main.index_camera(cams, 0)
    del loaded, frames, patches
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    compared, work = check(cfg_dict, inputs, window, acc_prog, passes,
                           cano_cam, dev, ctx)
    layer["work_s"] = work
    result["compared"] = compared
    result["layer"] = layer
    return result


def check(cfg: dict, inputs: dict, window: list, acc_prog, passes: list,
          cano_cam, dev, ctx):
    """The compared numbers, and the least time of a frame's work.

    contact: the largest gap of a hand point's contact signal, over every
    frame of the window, against the float64 search of its pose;
    acc: the largest gap of the running sum at the run's end against the
    float64 sum over the frames of its pass, over their number;
    panels: the mean gap of a window frame's 8-bit image against the
    frozen plain render from the float64 contacts and running sum, cast
    to 8 bits the same way (over 255), the largest over `check_frames`
    frames drawn from the seed.
    """
    grid = ref.voxel_grid(cfg, inputs, dev)
    h_act = inputs["init"]["active"].to(dev)
    o_act = inputs["obj"]["active"].to(dev)
    o_xyz = inputs["obj"]["xyz"].to(dev)
    d01, tfs = {}, {}
    for f in sorted({f for poses in passes for f in poses}):
        xyz, tfs[f] = ref.posed_hand(inputs, grid, f, dev)
        d01[f] = ref.contacts(xyz, o_xyz, h_act, o_act)

    def running_sum(poses):
        total = torch.zeros_like(next(iter(d01.values())))
        for f in poses:
            total = total + d01[f]
        return total

    contact = max(float((h.double() - d01[f]).abs().max())
                  for f, h, _, _, _ in window)
    acc = float((acc_prog.double() - running_sum(passes[-1])).abs().max()
                ) / len(passes[-1])
    rng = np.random.RandomState(ctx.seed % 2**32)
    picks = rng.choice(len(window), min(ctx.traffic["check_frames"],
                                        len(window)), replace=False)
    panels = 0.0
    for i in picks:
        f, _, u8, n_pass, place = window[int(i)]
        want = ref.gt_eval_panels(
            cfg, inputs, tfs[f], d01[f].float(),
            running_sum(passes[n_pass][:place + 1]).float(), cano_cam, dev)
        panels = max(panels, ref.image_gap(u8, want))
    work = frame_work(cfg, inputs, cano_cam, dev)
    return dict(contact=contact, acc=acc, panels=panels), work


@torch.no_grad()
def frame_work(cfg: dict, inputs: dict, cano_cam, dev) -> dict:
    """Least seconds of a gt_eval frame's parts on the card: the two
    contact searches at the bytes they must read and write (a search
    that is not brute force needs far fewer operations than one that
    is), the two panels' composite forward on the canonical hand, the
    hand's per-gaussian stages forward."""
    n_h = inputs["init"]["xyz"].shape[0]
    n_o = inputs["obj"]["xyz"].shape[0]
    search_bytes = 2 * (4 * 4 * (n_h + n_o) + 8 * (n_h + n_o))
    p = ref.params_of(inputs["init"], dev)
    active = inputs["init"]["active"].to(dev)
    colors = torch.full_like(p.xyz, 0.5)
    _, pay, bins = ref.render_precomp(cfg, p, active, colors, cano_cam)
    w = cfg["dataset"]["width"]
    n_eval = ccount.walk_counts(pay, bins.tile_offsets, bins.tile_counts,
                                (w + 15) // 16)
    fwd, _ = ccount.least_times(n_eval)
    return dict(search=peaks.least_s(nbytes=search_bytes),
                panels=2 * fwd,
                gaussians=gcount.forward_least_s(n_h),
                evaluations=2 * float(n_eval.sum()))
