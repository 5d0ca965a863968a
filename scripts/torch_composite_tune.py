"""Time variants of the port's composite kernels on one NVIDIA card.

    python3 scripts/torch_composite_tune.py [--chunks 128,256] [--batches 64]

For every pair of (pairs per item, pairs per backward batch) it rewrites
those two constants in a copy of manus_tpu_torch/csrc/composite.cu under
the build directory, compiles the copy, and on chip_smoke.py's bench
payload and its spread payload reports: the forward's largest deviation
from the plain version, the device time per launch of the forward and
the backward wrapper from CUDA-graph replays, and the device time of each
kernel inside them (torch.profiler over 10 launches). First it prints
which share of the (pair, warp) visits the kernels' footprint cull leaves. The last line is
the whole result as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from manus_tpu_torch.ops.rasterizer import composite  # noqa: E402
from manus_tpu_torch.ops.rasterizer.projection import TILE  # noqa: E402
from manus_tpu_torch.utils import cuda_build  # noqa: E402


def build_variant(chunk: int, batch: int) -> ctypes.CDLL:
    src = (cuda_build.CSRC_DIR / "composite.cu").read_text()
    for name, value in (("kChunk", chunk), ("kBwdBatch", batch)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        assert n == 1, name
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / f"composite_c{chunk}_b{batch}.cu"
    cu.write_text(src)
    out = cu.with_suffix(".so")
    log = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(cu)],
        capture_output=True, text=True, check=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line and "0 bytes spill stores" not in line:
            print("  " + line.strip())
    return composite.LIBRARY.open(out)


def kernel_us(pay, bins, dev, reps=10):
    """Device microseconds per launch of each kernel under the forward and
    the backward wrapper."""
    ntx, nty = chip_smoke.WIDTH // TILE, chip_smoke.HEIGHT // TILE
    offs, cnts = bins.tile_offsets, bins.tile_counts
    d_rgb = torch.rand(ntx * nty, 3, 256, device=dev)
    d_tf = torch.rand(ntx * nty, 256, device=dev)
    fwd = composite.composite_fwd_cuda(pay, offs, cnts, ntx, nty)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            composite.composite_fwd_cuda(pay, offs, cnts, ntx, nty)
            composite.composite_bwd_cuda(pay, offs, cnts, ntx, nty, d_rgb, d_tf,
                                         *fwd[1:])
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.split("<")[0].split("::")[-1].split(" ")[-1]
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / reps
    return out


def warp_share(pay, bins):
    """The share of (pair, warp) visits left after the kernels' footprint
    cull: csrc/composite.cu's warp_mask in torch, over every pair in a
    segment."""
    ntx = chip_smoke.WIDTH // TILE
    cnts = bins.tile_counts.long()
    tiles = torch.repeat_interleave(torch.arange(cnts.shape[0], device=pay.device), cnts)
    within = torch.arange(tiles.shape[0], device=pay.device) - \
        torch.repeat_interleave(torch.cumsum(cnts, 0) - cnts, cnts)
    f = pay[:, bins.tile_offsets.long()[tiles] + within]
    mx, my, ca, cb, cc, op = f[:6]
    det = ca * cc - cb * cb
    h2 = 2.0 * torch.log(op * 255.0) + 0.05
    rx = torch.sqrt(h2 * cc / det) * 1.01 + 0.5
    ry = torch.sqrt(h2 * ca / det) * 1.01 + 0.5
    x0, y0 = (tiles % ntx) * TILE, (tiles // ntx) * TILE
    xa, xb, ya, yb = mx - rx - x0, mx + rx - x0, my - ry - y0, my + ry - y0
    cols = ((xb >= 0) & (xa <= 7)).int() + ((xb >= 8) & (xa <= 15)).int()
    rows = sum(((yb >= 4 * b) & (ya <= 4 * b + 3)).int() for b in range(4))
    warps = torch.where((det > 0) & (ca > 0) & (cc > 0) & (rx < 1e6) & (ry < 1e6),
                        cols * rows, 8)
    warps = torch.where(op >= 1.0 / 255.0, warps, 0)
    return warps.float().mean().item() / 8.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="128,256")
    ap.add_argument("--batches", default="64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_composite_tune: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = chip_smoke.gpu_name_and_power()
    cfg, model, batch = chip_smoke.build_scene(dev)
    payloads = {name: chip_smoke.scene_payload(cfg, model, batch, dev, spread)
                for name, spread in (("bench", False), ("spread", True))}
    # the same shapes with no pair in any tile: what a launch costs before
    # any pair is walked (the plan, the grid of idle CTAs, the outputs)
    pay, bins = payloads["bench"]
    empty_bins = bins._replace(tile_counts=torch.zeros_like(bins.tile_counts))
    ntx, nty = chip_smoke.WIDTH // TILE, chip_smoke.HEIGHT // TILE
    shares = {name: warp_share(*pb) for name, pb in payloads.items()}
    print(f"share of (pair, warp) visits left after the footprint cull: {shares}")
    results = []
    for chunk in map(int, args.chunks.split(",")):
        for bwd_batch in map(int, args.batches.split(",")):
            print(f"variant: {chunk} pairs an item, backward batches of {bwd_batch}")
            lib = build_variant(chunk, bwd_batch)
            composite.LIBRARY.lib = lib
            row = dict(chunk=chunk, bwd_batch=bwd_batch,
                       ctas_per_sm=composite.kernel_occupancy())
            for name, (pay, bins) in payloads.items():
                offs, cnts = bins.tile_offsets, bins.tile_counts
                rgb_k, tf_k, _, _, state = composite.composite_fwd_cuda(
                    pay, offs, cnts, ntx, nty)
                with torch.no_grad():
                    rgb_p, tf_p = composite.composite_tiles_torch(
                        pay, offs, cnts, ntx, nty)
                row[name] = dict(
                    chip_smoke.composite_graph_ms(pay, bins, dev),
                    items=int(state.item_start[-1]),
                    fwd_max_abs_err=max((rgb_k - rgb_p).abs().max().item(),
                                        (tf_k - tf_p).abs().max().item()),
                    kernel_us=kernel_us(pay, bins, dev))
                print(f"  {name}: {json.dumps(row[name])}")
            row["empty"] = dict(
                {k: v for k, v in chip_smoke.composite_graph_ms(
                    pay, empty_bins, dev).items() if k.endswith("_ms")},
                kernel_us=kernel_us(pay, empty_bins, dev))
            print(f"  empty: {json.dumps(row['empty'])}")
            results.append(row)
    print(json.dumps(dict(card=card, warp_share=shares, variants=results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
