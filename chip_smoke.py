"""Run the PyTorch port of the HAND_GAUSSIAN training step on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. build: nvcc compiles manus_tpu_torch/csrc/*.cu for sm_90a into
     manus_tpu_torch/_build/ (one nvcc per source, in parallel);
  2. scene: bench.py's primary hand workload built with the port:
     65,536 gaussians at 512x512, one view, procedural_skeleton(8), point
     skin weights, random weights from fixed seeds. The ground truth is
     rendered from the clean model with the CUDA kernels, then the model
     is perturbed;
  3. oracle: a 64x64 render of a small cut of the scene through the CUDA
     kernels against the dense per-pixel oracle;
  4. kernels: on the scene's real payload, each CUDA kernel against its
     plain PyTorch version (the forward on rgb and T_final, the backward
     on d_payload under a random image cotangent and a non-zero
     background), and their times;
  5. slice: STEPS training steps through make_train_step under bench.py's
     raster configuration; the loss must be finite and fall, and each
     kernel's launch count over the run must equal the number of steps.

The last lines are a {"kernels": [...]} JSON line, the card's name and
power limit from nvidia-smi, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from manus_tpu_torch.config import hand_config
from manus_tpu_torch.data.synthetic import (
    hemisphere_cameras,
    perturb_model,
    procedural_skeleton,
    sample_gaussians_on_bones,
)
from manus_tpu_torch.models.gaussians import (
    get_features,
    get_opacity,
    init_gaussian_model,
)
from manus_tpu_torch.ops.rasterizer import composite
from manus_tpu_torch.ops.rasterizer.api import (
    RasterConfig,
    calculate_colors_from_sh,
    render_gaussians,
)
from manus_tpu_torch.ops.rasterizer.binning import bin_gaussians
from manus_tpu_torch.ops.rasterizer.payload import NUM_LIVE, build_payload
from manus_tpu_torch.ops.rasterizer.projection import TILE, project_gaussians
from manus_tpu_torch.ops.skinning import bone_deformation_transforms
from manus_tpu_torch.train.workloads import (
    forward_gaussians,
    init_train_state,
    make_raster_config,
    make_train_step,
)
from manus_tpu_torch.utils import cuda_build
from manus_tpu_torch.utils.camera import index_camera, stack_cameras

CAPACITY, WIDTH, HEIGHT, VIEWS = 65536, 512, 512, 1
STEPS, WARMUP = 20, 3
# The kernels against their plain version. Forward: the same float32 math
# summed in another order (a running sum against chunked cumsums), 1e-4 on
# rgb and T_final, except at pixels whose walk ends one pair apart because
# log T lands within rounding of log(1e-4): at most 0.1% of the pixels,
# each off by at most the T (<= 0.0101) of the pair in question. Backward:
# d_payload per field, max abs error over the field's max abs value 1e-3
# (each column is a sum over up to 256 pixels, with cancellation).
FWD_ATOL, FLIP_SHARE, FLIP_ATOL, BWD_NORM_TOL = 1e-4, 1e-3, 0.0101, 1e-3
ORACLE_ATOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12
# Float operations per walked pixel-pair, counted from csrc/composite.cu
# (transcendentals count one each): the forward's gates, alpha, log-T
# step and colour accumulation; the backward's recomputation, gradient
# terms and its share of the nine-value warp reduction.
FWD_FLOP_PER_PAIR, BWD_FLOP_PER_PAIR = 32, 61
REPLACES = {
    "composite_fwd": "manus_tpu/ops/rasterizer/pallas_backend.py:105",
    "composite_bwd": "manus_tpu/ops/rasterizer/pallas_backend.py:258",
}


class PhaseFailed(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise PhaseFailed(what)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches, by CUDA events, after a warmup."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_scene(dev):
    """bench.py build_workload's primary leg, with the port."""
    skel = procedural_skeleton(8)
    j = len(skel["bnames"])
    per_bone = CAPACITY // (j + j // 2)
    pts, cols = sample_gaussians_on_bones(
        skel["rest_heads"], skel["rest_tails"], skel["rest_transforms"],
        per_bone, seed=0)
    pts, cols = pts[:CAPACITY], cols[:CAPACITY]
    skin = np.random.RandomState(0).dirichlet(
        np.ones(j) * 0.1, size=pts.shape[0]).astype(np.float32)

    cfg = hand_config()
    cfg.capacity = CAPACITY
    cfg.dataset.width, cfg.dataset.height = WIDTH, HEIGHT
    cfg.loss = dataclasses.replace(
        cfg.loss, losses=("rgb_loss", "ssim_loss", "isotropic_reg"),
        loss_weight=(0.8, 0.2, 0.1))
    cfg.model = dataclasses.replace(cfg.model, remove_seg_end=0,
                                    start_lpips_iter=0)
    cfg.raster = dataclasses.replace(
        cfg.raster, backend="cuda", tg_max=64, max_pairs_per_tile=4096,
        chunk=64, pair_budget_factor=2, multi_frac=0.25)
    model = init_gaussian_model(pts, cols, CAPACITY, skin_weights=skin,
                                device=dev)

    center = skel["rest_heads"].mean(axis=0)
    span = np.linalg.norm(skel["rest_tails"] - skel["rest_heads"], axis=1).sum()
    cams = stack_cameras(hemisphere_cameras(
        max(VIEWS, 4), WIDTH, HEIGHT, dist=max(1.0, 2.0 * span / 4),
        center=center, device=dev))
    frame = 3 % skel["pose_transforms"].shape[0]
    bone_tf = bone_deformation_transforms(
        torch.tensor(skel["pose_transforms"][frame], device=dev),
        torch.tensor(skel["rest_transforms"], device=dev))
    kp = np.concatenate([skel["pose_heads"][frame][:1],
                         skel["pose_tails"][frame]]).astype(np.float32)

    raster = make_raster_config(cfg)
    with torch.no_grad():
        gts = []
        for i in range(VIEWS):
            posed, cov, tf = forward_gaussians(
                model.params, model.active, model.skin_weights, bone_tf,
                cfg.model)
            out = render_gaussians(
                posed, cov, model.params.xyz, get_features(model.params),
                get_opacity(model.params), index_camera(cams, i),
                torch.zeros(3, device=dev), sh_degree=3, tf=tf,
                active=model.active, config=raster)
            gts.append(out.render.clamp(0, 1))
    batch = {
        "rgb": torch.stack(gts),
        "mask": torch.ones(VIEWS, HEIGHT, WIDTH, 1, device=dev),
        "cameras": index_camera(cams, slice(0, VIEWS)),
        "bg": torch.zeros(3, device=dev),
        "bone_tf": bone_tf,
        "keypoints": torch.tensor(kp, device=dev),
    }
    return cfg, perturb_model(model), batch


def scene_payload(cfg, model, batch, dev):
    """The payload and tile segments the first view's render builds."""
    cam = index_camera(batch["cameras"], 0)
    p = model.params
    with torch.no_grad():
        posed, cov, tf = forward_gaussians(
            p, model.active, model.skin_weights, batch["bone_tf"], cfg.model)
        colors = calculate_colors_from_sh(posed, get_features(p), p.xyz, cam,
                                          3, tf)
        proj = project_gaussians(posed, cov, cam, active=model.active)
        r = cfg.raster
        bins = bin_gaussians(proj, WIDTH // TILE, HEIGHT // TILE, r.tg_max,
                             r.lane_align, r.pair_budget_factor,
                             r.max_pairs_per_tile, r.multi_frac)
        pay = build_payload(proj, colors, get_opacity(p).reshape(-1), bins)
    return pay, bins


def oracle_phase(model, batch, dev):
    """CUDA render of a small cut against the dense oracle at 64x64."""
    keep = torch.arange(model.capacity, device=dev) % (model.capacity // 2048) == 0
    cam = hemisphere_cameras(4, 64, 64, dist=1.0, center=(0.0, 0.05, 0.0),
                             device=dev)[1]
    p = model.params
    with torch.no_grad():
        posed, cov, tf = forward_gaussians(
            p, model.active, model.skin_weights, batch["bone_tf"],
            hand_config().model)
        outs = [render_gaussians(
            posed, cov, p.xyz, get_features(p), get_opacity(p), cam,
            torch.tensor([0.3, 0.2, 0.1], device=dev), tf=tf,
            active=model.active & keep,
            config=RasterConfig(backend=b, max_pairs_per_tile=4096))
            for b in ("cuda", "oracle")]
    err = (outs[0].render - outs[1].render).abs().max().item()
    covered = (outs[1].t_final < 0.5).float().mean().item()
    print(f"oracle: 64x64 cut of {int((model.active & keep).sum())} gaussians, "
          f"cuda vs oracle max abs err {err:.3e} (tolerance {ORACLE_ATOL}), "
          f"covered share {covered:.3f}")
    check(covered > 0.01, "oracle scene covers no pixel")
    check(err <= ORACLE_ATOL, f"cuda render differs from the oracle by {err}")


def kernel_phase(pay, bins, dev):
    """Each kernel against its plain version on the scene's payload."""
    ntx, nty = WIDTH // TILE, HEIGHT // TILE
    offs, cnts = bins.tile_offsets, bins.tile_counts
    n_tiles = ntx * nty
    rgb_k, tf_k, log_t, n_walk = composite.composite_fwd_cuda(
        pay, offs, cnts, ntx, nty)
    with torch.no_grad():
        rgb_p, tf_p = composite.composite_tiles_torch(pay, offs, cnts, ntx, nty)
    err_px = torch.maximum((rgb_k - rgb_p).abs().amax(1), (tf_k - tf_p).abs())
    fwd_err = err_px.max().item()
    flips = int((err_px > FWD_ATOL).sum())
    walked = int(n_walk.sum())
    print(f"composite_fwd: P={pay.shape[1]} pairs in segments="
          f"{int(cnts.sum())} walked pixel-pairs={walked} max abs err "
          f"{fwd_err:.3e}; pixels beyond {FWD_ATOL}: {flips}")
    check(flips <= FLIP_SHARE * n_tiles * 256 and fwd_err <= FLIP_ATOL,
          f"forward kernel disagrees: max err {fwd_err}, {flips} pixels")
    check((tf_k < 0.5).any().item(), "the scene covers no pixel")

    gen = torch.Generator(device=dev).manual_seed(0)
    r_img = torch.rand(HEIGHT, WIDTH, 3, device=dev, generator=gen) - 0.5
    bg = torch.tensor([0.3, 0.2, 0.1], device=dev)

    def d_payload(fn):
        x = pay.detach().requires_grad_(True)
        rgb, tfin = fn(x)
        img, _ = composite.tiles_to_image(rgb, tfin, bg, ntx, nty, WIDTH,
                                          HEIGHT)
        (g,) = torch.autograd.grad((img * r_img).sum(), [x])
        return g

    dk = d_payload(lambda x: composite.CompositeFn.apply(x, offs, cnts, ntx, nty))
    dp = d_payload(lambda x: composite.composite_tiles_torch(
        x, offs, cnts, ntx, nty))
    bwd_err = (dk - dp).abs().max().item()
    norm = ((dk - dp).abs().amax(1) / dp.abs().amax(1).clamp(min=1e-30))[:NUM_LIVE]
    print(f"composite_bwd: max abs err {bwd_err:.3e}; per-field normalised "
          f"{[float(f'{v:.2e}') for v in norm.tolist()]}")
    check(bool((norm <= BWD_NORM_TOL).all()),
          f"backward kernel disagrees: normalised errors {norm.tolist()}")

    # times at the bench shape
    walk_max = n_walk.amax(1).long()
    pairs = int(walk_max.sum())
    d_rgb = torch.rand(n_tiles, 3, 256, device=dev, generator=gen)
    d_tf = torch.rand(n_tiles, 256, device=dev, generator=gen)
    fwd_ms = cuda_ms(lambda: composite.composite_fwd_cuda(
        pay, offs, cnts, ntx, nty), 50)
    bwd_ms = cuda_ms(lambda: composite.composite_bwd_cuda(
        pay, offs, cnts, ntx, nty, d_rgb, d_tf, tf_k, log_t, n_walk), 50)
    with torch.no_grad():
        fwd_plain_ms = cuda_ms(lambda: composite.composite_tiles_torch(
            pay, offs, cnts, ntx, nty), 3)
    bwd_plain_ms = plain_backward_ms(pay, offs, cnts, ntx, nty, d_rgb, d_tf)

    px_out = n_tiles * 256
    fwd_bytes = 36 * pairs + 8 * n_tiles + 24 * px_out
    bwd_bytes = 72 * pairs + 4 * n_tiles + 28 * px_out

    def bound(nbytes, flops):
        t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
        return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"

    fwd_bound, fwd_by = bound(fwd_bytes, FWD_FLOP_PER_PAIR * walked)
    bwd_bound, bwd_by = bound(bwd_bytes, BWD_FLOP_PER_PAIR * walked)
    print(f"times (ms, bench shape): fwd kernel {fwd_ms:.4f} plain "
          f"{fwd_plain_ms:.3f} bound {fwd_bound:.4f} ({fwd_by}); bwd kernel "
          f"{bwd_ms:.4f} plain {bwd_plain_ms:.3f} bound {bwd_bound:.4f} "
          f"({bwd_by}); tiles walked {int((walk_max > 0).sum())}/{n_tiles}, "
          f"pairs walked {pairs}, deepest tile {int(walk_max.max())}")
    return {
        "composite_fwd": dict(max_abs_err=fwd_err, ms=fwd_ms,
                              plain_ms=fwd_plain_ms, bound_ms=fwd_bound,
                              bound_by=fwd_by),
        "composite_bwd": dict(max_abs_err=bwd_err, ms=bwd_ms,
                              plain_ms=bwd_plain_ms, bound_ms=bwd_bound,
                              bound_by=bwd_by),
    }


def plain_backward_ms(pay, offs, cnts, ntx, nty, d_rgb, d_tf, reps=3):
    """Mean ms of autograd's backward through the plain composite."""
    total = 0.0
    for _ in range(reps + 1):
        x = pay.detach().requires_grad_(True)
        rgb, tfin = composite.composite_tiles_torch(x, offs, cnts, ntx, nty)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad([rgb, tfin], [x], [d_rgb, d_tf])
        end.record()
        torch.cuda.synchronize()
        if _ > 0:  # the first is warmup
            total += start.elapsed_time(end)
    return total / reps


def slice_phase(cfg, state, batch):
    """STEPS train steps through the CUDA kernels."""
    train_step = make_train_step(cfg, extent=1.0, articulated=True)
    kernels = (composite.composite_fwd_cuda, composite.composite_bwd_cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    losses, times, metrics = [], [], {}
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = {"composite_fwd": kernels[0].launches,
                "composite_bwd": kernels[1].launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ms = statistics.median(times[WARMUP:])
    print(f"slice: {STEPS} steps, loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
          f"median {ms:.3f} ms/step after {WARMUP} warmup (min "
          f"{min(times[WARMUP:]):.3f}, max {max(times[WARMUP:]):.3f}), "
          f"pair_overflow {int(metrics['pair_overflow'])} far "
          f"{int(metrics['pair_overflow_far'])}, psnr "
          f"{metrics['psnr'].item():.3f}, active {int(metrics['num_active'])}, "
          f"peak {peak_mb:.1f} MiB, launches {launches}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(losses[-1] < losses[0], "the loss did not fall")
    for name, n in launches.items():
        check(n == STEPS * VIEWS, f"{name} launched {n} times in {STEPS} steps")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_name_and_power()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = cuda_build.build(["composite"])
    print(f"build: {time.perf_counter() - t0:.1f} s into {cuda_build.BUILD_DIR}")
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  " + line.strip())

    t0 = time.perf_counter()
    cfg, model, batch = build_scene(dev)
    torch.cuda.synchronize()
    print(f"scene: {CAPACITY} gaussians at {WIDTH}x{HEIGHT}, {VIEWS} view(s), "
          f"{time.perf_counter() - t0:.1f} s")

    oracle_phase(model, batch, dev)
    pay, bins = scene_payload(cfg, model, batch, dev)
    results = kernel_phase(pay, bins, dev)
    del pay, bins
    state = init_train_state(model)
    launches = slice_phase(cfg, state, batch)

    kernels = [
        dict(name=name, route="cuda", source="manus_tpu_torch/csrc/composite.cu",
             replaces=REPLACES[name], launches=launches[name],
             **results[name], library_ms=None)
        for name in ("composite_fwd", "composite_bwd")
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
