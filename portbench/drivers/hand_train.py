"""Hand training through the port's own fit loop, `Trainer.fit`.

Set-up makes the scene from the seed (portbench/scene.py), builds the
Trainer on it, and drives `fit` through its first steps: the three the
reference follows, then a few to warm every shape. Then it runs one
densify event on the state those steps left, which the reference
follows too, and keeps its result. The window is a new `fit` call that
runs until `--seconds` have passed; it ends in torch.cuda.synchronize(),
and its metric is the window over the steps finished in it, so the fit
loop's batches, logging syncs and densify events that fall in it are all
in it. With a trace, the same `fit` call goes on for a stretch of steps
under torch.profiler after the window has closed.

The harness steers `fit` only through the Trainer's attributes: its
`train_step` is wrapped to count steps and to end a stretch (by raising
out of `fit`, so that `fit` writes no final checkpoint), `sample_batch`
to tag each batch with the (frame, view) it was read for, and
`densify_step` and `opacity_reset` are wrapped in host spans.
"""
from __future__ import annotations

import gc
import os
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import trace as tr
from portbench.counts import composite as ccount
from portbench.counts import gaussians as gcount
from portbench.counts import peaks, vgg16
from portbench.drivers.common import (
    LEAVES,
    build_inputs,
    compare,
    compare_densify,
    config_as_run,
    decode,
    port_config,
    port_model,
    port_scene,
    sync,
)
from portbench.reference import densify as ref_densify
from portbench.reference import frozen as fz
from portbench.reference import hand_step as ref

# the key under which a batch carries the (frame, views) it was read for
VIEW_KEY = "portbench_view"
STATS = ("grad_accum", "denom", "max_radii2d")


class StretchDone(Exception):
    """Raised out of Trainer.fit to end a stretch of steps."""


class Dataset:
    """The gt images of the scene behind the dataset interface the
    Trainer reads: get_batch decodes the uint8 RGBA frames to float32 rgb
    and mask, and records each (frame, views) asked for, in order."""

    def __init__(self, images, cameras, bones_rest, bones_posed, extent):
        self.images = images  # [F, V, H, W, 4] uint8
        self.cameras = cameras
        self.bones_rest = bones_rest
        self.bones_posed = bones_posed
        self.extent = extent
        self.asked = []

    @property
    def num_frames(self):
        return self.images.shape[0]

    @property
    def num_views(self):
        return self.images.shape[1]

    def get_batch(self, frame: int, views):
        self.asked.append((int(frame), np.asarray(views).copy()))
        rgb, mask = decode(self.images[frame, views])
        return dict(rgb=rgb, mask=mask)


class Steps:
    """Wraps the Trainer's train_step: counts the calls and keeps each
    step's (frame, views). A stretch ends, by raising StretchDone, at the
    call after `limit` steps, or at the first call past `deadline` after
    a synchronize (`t_end`, so that the stretch's time covers all its
    work). With `after` (a trace.Profile) a stretch that reaches its
    deadline goes on in the same `fit` call for `after_steps` steps
    under it, whose summary is `trace`. `on_step(n, state, metrics)`
    sees every finished step."""

    def __init__(self, step_fn, sync):
        self.step_fn = step_fn
        self.sync = sync
        self.start(limit=0)

    def start(self, limit=None, deadline=None, on_step=None, after=None,
              after_steps=0):
        self.n, self.limit, self.deadline = 0, limit, deadline
        self.on_step, self.after, self.after_steps = on_step, after, after_steps
        self.views, self.t_end, self.n_window, self.trace = [], None, None, None

    def __call__(self, state, batch):
        view = batch.pop(VIEW_KEY, None)
        if (self.deadline is not None and self.n
                and time.perf_counter() >= self.deadline):
            self.sync()
            self.t_end = time.perf_counter()
            self.deadline, self.n_window = None, self.n
            if self.after is None:
                raise StretchDone
            self.limit = self.n + self.after_steps
            self.after.start()
        if self.limit is not None and self.n >= self.limit:
            if self.n_window is not None and self.after is not None:
                self.trace = self.after.stop()
            else:
                self.sync()
                self.t_end = time.perf_counter()
            raise StretchDone
        state, metrics = self.step_fn(state, batch)
        self.views.append(view)
        self.n += 1
        if self.on_step is not None:
            self.on_step(self.n, state, metrics)
        return state, metrics


def _host(state) -> dict:
    """The parts of a TrainState that a densify event reads and writes,
    copied to the host."""
    def cpu(x):
        return x.detach().to("cpu", copy=True)

    return dict(params={k: cpu(p) for k, p in zip(LEAVES, state.model.params)},
                m={k: cpu(x) for k, x in zip(LEAVES, state.opt.m)},
                v={k: cpu(x) for k, x in zip(LEAVES, state.opt.v)},
                stats={k: cpu(getattr(state.stats, k)) for k in STATS},
                active=cpu(state.model.active), step=int(state.step))


def densify_event(trainer, densify_step, noise_seed: int) -> dict:
    """One densify event on the trainer's state, kept, with its split
    noise drawn from `noise_seed` (the state's generator is seeded with
    it): the state before and after it on the host, and its counts."""
    before = _host(trainer.state)
    trainer.state.gen.manual_seed(noise_seed)
    with torch.no_grad():
        trainer.state, info = densify_step(trainer.state)
    after = _host(trainer.state)
    after["counts"] = {k: int(v) for k, v in info.items()}
    return dict(before=before, after=after)


def densify_reference(event: dict, opts, extent: float, noise_seed: int,
                      capacity: int, device, dtype=torch.float32) -> dict:
    """The plain event (portbench/reference/densify.py) on the program's
    state before it, with the same split noise."""
    b = event["before"]

    def dev(d):
        return {k: x.to(device) for k, x in d.items()}

    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed)
    noise = torch.randn((2, capacity, 3), generator=gen, device=device)
    return ref_densify.densify(
        dev(b["params"]), b["active"].to(device), dev(b["stats"]), dev(b["m"]),
        dev(b["v"]), opts, extent, noise,
        use_size_threshold=b["step"] > opts.opacity_reset_interval,
        dtype=dtype)


def run(ctx):
    """One run of the cell; see the module docstring. `ctx` is the
    harness's RunContext."""
    from manus_tpu_torch.train.trainer import Trainer

    dev = ctx.device
    cfg_dict = config_as_run(ctx.config, ctx.traffic, ctx.scale)
    lpips = "lpips_loss" in cfg_dict["loss"]["losses"]
    inputs = build_inputs(cfg_dict, ctx.config["scene"], ctx.seed, dev,
                          images=True, vgg=lpips)
    cfg = port_config(ctx.config["preset"], cfg_dict, ctx.seed)
    cfg.trainer.output_dir = os.path.join(ctx.tmpdir, "run")
    cfg.trainer.exp_name = "portbench"
    if lpips:
        # the seed's VGG16 reaches the Trainer as a weights file
        os.makedirs(cfg.trainer.output_dir, exist_ok=True)
        cfg.loss.lpips_weights = os.path.join(cfg.trainer.output_dir,
                                              "vgg16_lpips.npz")
        np.savez(cfg.loss.lpips_weights, **{
            k: v.cpu().numpy() for k, v in inputs["vgg"].items()})
    cams, rest, posed, grid = port_scene(cfg, inputs, dev)
    ds = Dataset(inputs["images"], cams, rest, posed, inputs["extent"])
    model = port_model(inputs["init"])
    trainer = Trainer(cfg, ds, model, True, grid, val_dataset=None,
                      log=ctx.log)
    if trainer._device_cache is not None:
        raise ValueError("the views must come through get_batch, which "
                         "records them for the reference: the cell's "
                         "images must exceed trainer.device_cache_mb")
    steps = Steps(trainer.train_step, lambda: sync(dev))
    trainer.train_step = steps
    sample_batch = trainer.sample_batch

    def tagged_batch():
        # get_batch runs inside sample_batch, in the one producer thread
        batch = sample_batch()
        batch[VIEW_KEY] = ds.asked[-1]
        return batch

    trainer.sample_batch = tagged_batch
    spans = tr.Spans()
    densify_step = trainer.densify_step
    trainer.densify_step = spans.wrap("densify", densify_step)
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
    # a densify event on the state the warm-up left (it also builds what
    # the window's events run); the reference follows it
    noise_seed = ctx.seed % (2**63 - 1)
    event = densify_event(trainer, densify_step, noise_seed)
    sync(dev)

    # the window; with a trace, the same fit call goes on under the
    # profiler once it has closed
    n_trace = ctx.traffic["trace_steps"]
    n_before = len(trainer.timings["step_s"])
    t0 = ctx.window_started()
    fit(deadline=t0 + ctx.seconds,
        after=tr.Profile() if ctx.trace else None, after_steps=n_trace)
    window_s, n_window = steps.t_end - t0, steps.n_window
    events_s = spans.total("densify", t0, steps.t_end) + spans.total(
        "opacity_reset", t0, steps.t_end)
    result = dict(attempted=n_window, failed=0,
                  end_to_end=dict(train_step_ms=1e3 * window_s / n_window))
    n_events = sum(1 for s, _ in spans.items["densify"] + spans.items[
        "opacity_reset"] if t0 <= s < steps.t_end)
    # the LPIPS term runs in the window's steps when the state's step has
    # reached start_lpips_iter by then
    lpips_runs = lpips and cfg_dict["model"]["start_lpips_iter"] <= (
        n_check + ctx.traffic["warmup_steps"])
    layer = dict(step_ms=1e3 * window_s / n_window, window_s=window_s,
                 steps=n_window, event_s=events_s, events=n_events,
                 lpips=lpips_runs)
    host_ms = sorted(1e3 * x for x in trainer.timings["step_s"][
        n_before:n_before + n_window])
    if host_ms:
        ctx.note("host ms a fit iteration in the window: p10 %.2f median "
                 "%.2f p90 %.2f max %.2f over %d" % (
                     host_ms[len(host_ms) // 10], statistics.median(host_ms),
                     host_ms[9 * len(host_ms) // 10], host_ms[-1],
                     len(host_ms)))

    if ctx.trace:
        layer["trace"] = steps.trace
        layer["trace_steps"] = steps.n - n_window
        traced_views = steps.views[n_window:]
    ctx.read_memory_peak()
    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.state.model.params)
    if not finite:
        result["failed"] = n_window

    if ctx.trace:
        # the work that the shares divide by: the traced steps' views, on
        # the state the stretch left
        d = cfg_dict["dataset"]
        views = [(f, int(v[0])) for f, v in traced_views]
        layer["work_s"] = step_work(cfg_dict, inputs, trainer.state.model,
                                    views, dev, lpips_runs)
        layer["conv_flops_per_chain"] = vgg16.chain_flops(d["height"],
                                                          d["width"])

    # correctness: the reference follows the first steps and the densify
    # event, after the program's state is freed
    batches = []
    for f, views in check_views:
        rgb, mask = decode(inputs["images"][f, int(views[0])])
        batches.append((f, int(views[0]), rgb, mask))
    prog["losses"] = [float(x) for x in prog["losses"]]
    capacity = trainer.state.model.capacity
    del trainer, steps, model, grid, sample_batch, densify_step
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    reference = ref.run_steps(cfg_dict, inputs, batches,
                              lpips_params=inputs["vgg"], device=dev)
    compared = compare(prog, reference, inputs["init"])
    want = densify_reference(event, SimpleNamespace(**cfg_dict["model"]),
                             inputs["extent"], noise_seed, capacity, dev)
    compared.update(compare_densify(event["after"], want, event["before"]))
    result["compared"] = compared
    result["layer"] = layer
    return result


@torch.no_grad()
def step_work(cfg: dict, inputs: dict, model, views, device,
              lpips: bool) -> dict:
    """Least seconds of a step's parts on the card, the mean over `views`
    ((frame, camera) a step): the composite's evaluations on this state
    and view (counted by the plain walk), the per-gaussian stages, the
    image losses and, with LPIPS, VGG16's forward on the render and its
    input gradient at the bf16 peak."""
    d, r = cfg["dataset"], cfg["raster"]
    opts = SimpleNamespace(**cfg["model"])
    p = fz.GaussianParams(*(getattr(model.params, k) for k in LEAVES))
    keypts = np.concatenate([inputs["rest_heads"][:1], inputs["rest_tails"]])
    rest = torch.as_tensor(inputs["rest"], device=device)
    grid = fz.build_voxel_grid(keypts, res=d["grid_res"], ratio=d["grid_size"],
                               offset=d["grid_offset"],
                               num_bones=rest.shape[0], device=device)
    skin_w = fz.skinning_weights_from_voxel_grid(p.xyz, grid.center,
                                                 grid.scale, grid.weights)
    ntx, nty = (d["width"] + 15) // 16, (d["height"] + 15) // 16
    fwd = bwd = evals = 0.0
    for f, v in views:
        bone_tf = fz.bone_deformation_transforms(
            torch.as_tensor(inputs["pose"][f], device=device), rest,
            append_identity=True)
        cam = fz.make_camera(inputs["K"][v], inputs["extr"][v], d["width"],
                             d["height"], device=device)
        sk = fz.skin_gaussians(p.xyz, fz.get_covariance(p), skin_w, bone_tf)
        colors = fz.calculate_colors_from_sh(sk.posed_xyz,
                                             fz.get_features(p), p.xyz, cam,
                                             opts.sh_degree, sk.tf)
        proj = fz.project_gaussians(sk.posed_xyz, sk.posed_cov, cam,
                                    active=model.active)
        bins = fz.bin_gaussians(proj, ntx, nty, r["tg_max"],
                                lane_align=r["lane_align"],
                                pair_budget_factor=r["pair_budget_factor"],
                                max_pairs_per_tile=r["max_pairs_per_tile"],
                                multi_frac=r["multi_frac"])
        pay = fz.build_payload(proj, colors, fz.get_opacity(p).reshape(-1),
                               bins)
        n_eval = ccount.walk_counts(pay, bins.tile_offsets, bins.tile_counts,
                                    ntx)
        t_f, t_b = ccount.least_times(n_eval)
        fwd, bwd = fwd + t_f, bwd + t_b
        evals += float(n_eval.sum())
    n = max(len(views), 1)
    work = dict(composite_fwd=fwd / n, composite_bwd=bwd / n,
                gaussians=gcount.step_least_s(cfg["capacity"]),
                image_losses=gcount.image_losses_least_s(d["height"],
                                                         d["width"]),
                evaluations=evals / n)
    if lpips:
        work["vgg16"] = peaks.least_s(
            flops=2 * vgg16.chain_flops(d["height"], d["width"]),
            flop_per_s=peaks.BF16_FLOP_PER_S)
    return work
