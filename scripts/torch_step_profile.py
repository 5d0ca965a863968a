"""Where the time of the port's hand training step goes, on one NVIDIA card.

    python3 scripts/torch_step_profile.py [--steps N] [--lpips] [--voxel]

Builds chip_smoke.py's bench scene (65,536 gaussians, 512x512, one view)
or, with --voxel, its flagship scene (131,072 gaussians, the skin weights
sampled every step from a 96-resolution voxel grid); with --lpips the
step with the VGG16-LPIPS term on (chip_smoke.py's lpips slice:
random-feature VGG16 seed 0, weight 0.1, the gt features cached), then
reports:

  * each forward stage of one render timed alone (CUDA events, mean of 10
    calls, no autograd): with --voxel the grid sample of the skin
    weights, then LBS, SH colours, projection, binning, payload, the
    composite kernel, image assembly with the losses (with --lpips, the
    LPIPS forward included);
  * the whole step (host clock around a synchronised step, median);
  * torch.profiler over N steps: device time by kernel name, the number
    of kernel launches per step, and the device's busy share (summed
    kernel time over wall time).

Prints the whole result as one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from manus_tpu_torch.models.gaussians import get_features, get_opacity, get_scaling  # noqa: E402
from manus_tpu_torch.ops.rasterizer import composite  # noqa: E402
from manus_tpu_torch.ops.rasterizer.api import calculate_colors_from_sh  # noqa: E402
from manus_tpu_torch.ops.rasterizer.binning import bin_gaussians  # noqa: E402
from manus_tpu_torch.ops.rasterizer.payload import build_payload  # noqa: E402
from manus_tpu_torch.ops.rasterizer.projection import TILE, project_gaussians  # noqa: E402
from manus_tpu_torch.train.lpips import (  # noqa: E402
    pack_lpips_params,
    random_lpips_params,
)
from manus_tpu_torch.train.workloads import (  # noqa: E402
    forward_gaussians,
    init_train_state,
    make_train_step,
    resolve_skin_weights,
)
from manus_tpu_torch.utils import losses as loss_mod  # noqa: E402
from manus_tpu_torch.utils.camera import index_camera  # noqa: E402


def stage_times(cfg, model, batch, lpips_params=None, grid=None):
    """ms of each forward stage of one view's render, timed alone."""
    cam = index_camera(batch["cameras"], 0)
    p, r, w, h = model.params, cfg.raster, cfg.dataset.width, cfg.dataset.height
    ntx, nty = w // TILE, h // TILE
    out = {}
    with torch.no_grad():
        def grid_sample():
            return resolve_skin_weights(model, grid)
        skin_w = grid_sample()

        def lbs():
            return forward_gaussians(p, model.active, skin_w,
                                     batch["bone_tf"], cfg.model)
        posed, cov, tf = lbs()
        opac = get_opacity(p).reshape(-1)

        def colours():
            return calculate_colors_from_sh(posed, get_features(p), p.xyz, cam, 3, tf)
        colors = colours()

        def project():
            return project_gaussians(posed, cov, cam, active=model.active)
        proj = project()

        def binning():
            return bin_gaussians(proj, ntx, nty, r.tg_max, r.lane_align,
                                 r.pair_budget_factor, r.max_pairs_per_tile,
                                 r.multi_frac)
        bins = binning()

        def payload():
            return build_payload(proj, colors, opac, bins)
        pay = payload()

        def kernel():
            return composite.composite_fwd_cuda(
                pay, bins.tile_offsets, bins.tile_counts, ntx, nty)
        rgb, tfin = kernel()[:2]

        def image_and_losses():
            img, _ = composite.tiles_to_image(rgb, tfin, batch["bg"], ntx, nty, w, h)
            feats = batch.get("lpips_gt_feats")
            return loss_mod.compute_losses(
                img, batch["rgb"][0], get_scaling(p), model.active,
                tuple(cfg.loss.losses), tuple(cfg.loss.loss_weight),
                lpips_params=lpips_params,
                lpips_gt_feats=None if feats is None else [f[0] for f in feats])

        stages = (("grid_sample", grid_sample),) if grid is not None else ()
        for name, fn in stages + (("lbs", lbs), ("sh_colours", colours),
                         ("projection", project), ("binning", binning),
                         ("payload", payload), ("composite_fwd_kernel", kernel),
                         ("image_and_losses", image_and_losses)):
            out[name] = chip_smoke.cuda_ms(fn, 10)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lpips", action="store_true",
                    help="profile the step with the LPIPS term on")
    ap.add_argument("--voxel", action="store_true",
                    help="profile chip_smoke.py's flagship scene (131,072 "
                         "gaussians, skin weights from a 96-resolution grid)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = chip_smoke.gpu_name_and_power()
    if args.voxel:
        cfg, model, batch, grid = chip_smoke.hand_scene(
            dev, chip_smoke.FLAGSHIP_CAPACITY, chip_smoke.VOXEL_RES)
    else:
        cfg, model, batch = chip_smoke.build_scene(dev)
        grid = None
    params = None
    if args.lpips:
        params = pack_lpips_params(
            random_lpips_params(chip_smoke.LPIPS_SEED, device=dev))
        cfg, batch = chip_smoke.lpips_batch(cfg, batch, params)
    stages = stage_times(cfg, model, batch, params, grid)

    step = make_train_step(cfg, extent=1.0, articulated=True,
                           voxel_grid=grid, lpips_params=params)
    state = init_train_state(model)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times[3:])

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events give the busy time; the host ops that launched
    # them carry the same time again, and name where it went.
    kernels, host_ops = [], []
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            row = (ev.key, ev.self_device_time_total / 1e3 / args.steps,
                   ev.count / args.steps)
            (kernels if ev.device_type == DeviceType.CUDA else host_ops).append(row)
    kernels.sort(key=lambda k: -k[1])
    host_ops.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    launches = sum(k[2] for k in kernels)
    per_step_wall = wall_ms / args.steps
    print(f"card: {card}")
    print("forward stages, ms: " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    print(f"step: median {step_ms:.3f} ms (of {times[3:]}); profiled wall "
          f"{per_step_wall:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / per_step_wall:.1f}%), {launches:.0f} device "
          f"ops per step")
    for title, rows in (("kernels", kernels), ("host ops by device time", host_ops)):
        print(f"{title}:")
        for name, ms, count in rows[:25]:
            print(f"  {ms:9.4f} ms/step  x{count:6.1f}  {name[:110]}")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"peak device memory over the steps {peak_mib:.1f} MiB")
    result = dict(card=card, lpips=args.lpips, voxel=args.voxel,
                  capacity=model.capacity, peak_mib=peak_mib,
                  stage_ms=stages, step_ms_median=step_ms,
                  profiled_wall_ms_per_step=per_step_wall,
                  device_busy_ms_per_step=busy_ms,
                  device_busy_share=busy_ms / per_step_wall,
                  device_ops_per_step=launches,
                  top_kernels=[dict(name=n, ms_per_step=m, per_step=c)
                               for n, m, c in kernels[:25]],
                  top_host_ops=[dict(name=n, device_ms_per_step=m, per_step=c)
                                for n, m, c in host_ops[:25]])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
