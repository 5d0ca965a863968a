"""Check and time the layout conv kernel (csrc/conv3x3.cu) plan by plan.

    python3 scripts/torch_conv_tune.py            # the VGG16 layers at 512x512
    python3 scripts/torch_conv_tune.py --check    # small edge shapes only
    python3 scripts/torch_conv_tune.py --size 256 --reps 50

Needs an NVIDIA card. For every conv layer shape of the VGG16 at the given
image size, forward and dx form, it runs the kernel under conv_plan's
plan and under the alternatives (other channel tiles and splits of K),
holds each output against the plain version (max abs error, the share of
values that differ, the number beyond the bf16 rule), and prints device
times (launches replayed from a CUDA graph) and TFLOP/s, the host time of
one launch call and of the C entry point alone, and whether two launches
of the planned form give equal bits. --check runs the edge shapes
(16-channel paths, row counts that are no multiple of the tile, a K shorter
than the ring) and stops. The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from manus_tpu_torch.ops import conv  # noqa: E402
from manus_tpu_torch.train import lpips  # noqa: E402
from manus_tpu_torch.utils import cuda_build  # noqa: E402

BF16_REL, BF16_FLOOR = 2.0 ** -7, 1e-3
# (h, w, ci, co) edge shapes: the 16-channel paths, odd widths, one row
# block, a wide layer, the 32x32 split-K stage.
EDGE_SHAPES = [(13, 9, 16, 64), (16, 16, 64, 128), (45, 45, 16, 16),
               (7, 4, 16, 16), (16, 16, 16, 32), (24, 20, 64, 16),
               (40, 40, 128, 256), (64, 64, 256, 512), (32, 32, 512, 512)]


def cuda_ms(fn, reps):
    """Mean device ms of fn() over reps launches replayed from a CUDA
    graph, so that the host's launch cost (tens of microseconds a call,
    more than the small layers take) is not in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps=200):
    """Host time of one launch call (the queue is drained before and
    after, so the calls do not wait on the card's queue limit)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def c_entry_us(xl, mask_by, w, b, relu, L, plan):
    """Host time of the library's C entry point alone (tensor maps encoded,
    kernels enqueued), outputs and workspace allocated once."""
    lib = conv.CONV_LIBRARY.get()
    y = torch.empty(L.rows, w.shape[1], dtype=torch.bfloat16, device=xl.device)
    ws = torch.empty(max(plan.workspace, 1), dtype=torch.float32,
                     device=xl.device)
    args = (xl.data_ptr(), None if mask_by is None else mask_by.data_ptr(),
            w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            ws.data_ptr(), L.rows, xl.shape[1], w.shape[1], L.w, L.m_blk,
            L.n_valid, int(relu), plan.kc, plan.bn, plan.split_k,
            torch.cuda.current_stream().cuda_stream)
    return host_us(lambda: lib.conv3x3_layout(*args))


def compare(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = BF16_REL * torch.maximum(got.abs(), want.abs()) \
        + BF16_FLOOR * want.abs().max()
    return (err.max().item(), (err > 0).float().mean().item(),
            int((err > limit).sum()))


def alternatives(L, ci, co, base):
    """base and the plans that differ from it in the channel tile or the
    split of K."""
    plans = [base]
    for bn in (256, 128, 64, 16):
        if co % bn or (base.kc == 16 and bn > 64):
            continue
        tiles = base.m_tiles * (co // bn)
        for split in (1, 2, 3, 4, 6, 8, 12):
            if base.chunks % split or base.chunks // split < 2:
                continue
            if split > 1 and tiles * split > 6 * conv.SM_COUNT:
                continue
            plan = base._replace(
                bn=bn, n_tiles=co // bn, split_k=split, grid=tiles * split,
                workspace=split * base.m_tiles * base.bm * co
                if split > 1 else 0)
            if plan not in plans:
                plans.append(plan)
    return plans


def layer_inputs(L, ci, co, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(L.h, L.w, ci, generator=g)
    w = torch.randn(3, 3, ci, co, generator=g) * (2.0 / (9 * ci)) ** 0.5
    b = torch.randn(co, generator=g) * 0.1
    p = conv.pack_conv3x3(w.to(dev), b.to(dev))
    xl = conv.build_layout(x.to(dev), L)
    gl = torch.randn(L.rows, co, generator=g).to(dev, torch.bfloat16)
    return p, xl, gl


def run_layer(name, L, ci, co, dev, reps, all_plans):
    p, xl, gl = layer_inputs(L, ci, co, dev, L.h * 31 + ci)
    flop = 2.0 * L.h * L.w * 9 * ci * co
    y_ref = conv.conv3x3_layout_torch(xl, p.w, p.b, True, L)
    dx_ref = conv.conv3x3_layout_torch(gl, p.w_t, None, False, L,
                                       mask_by=y_ref)
    forms = (
        ("conv", ci, co,
         lambda plan: conv._launch_conv(xl, None, p.w, p.b, True, L, plan),
         y_ref, (xl, None, p.w, p.b, True)),
        ("dx", co, ci,
         lambda plan: conv._launch_conv(gl, y_ref, p.w_t, None, False, L,
                                        plan), dx_ref,
         (gl, y_ref, p.w_t, None, False)),
    )
    bad = 0
    for form, k_in, n_out, launch, ref, c_args in forms:
        base = conv.conv_plan(L, k_in, n_out)
        plans = alternatives(L, k_in, n_out, base) if all_plans else [base]
        for plan in plans:
            out = launch(plan)
            torch.cuda.synchronize()
            err, share, over = compare(out, ref)
            bad += over
            line = (f"{name} {form} {L.h}x{L.w} {k_in}->{n_out} kc {plan.kc} "
                    f"bn {plan.bn} split {plan.split_k} ctas {plan.grid} "
                    f"waves {plan.waves:.2f}: err {err:.3e} share "
                    f"{share:.2e} beyond {over}")
            if reps:
                ms = cuda_ms(lambda: launch(plan), reps)
                line += f" ms {ms:.4f} TFLOP/s {flop / ms / 1e9:.1f}"
            if plan is base:
                same = torch.equal(launch(plan), out)
                line += f" equal bits {same} PLANNED"
                bad += not same
                if reps:
                    line += (f" host us/launch {host_us(lambda: launch(plan)):.2f}"
                             f" C entry us {c_entry_us(*c_args, L, plan):.2f}")
            print(line, flush=True)
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--planned-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_conv_tune: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    log = cuda_build.build(["conv3x3"]).get("conv3x3", "")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line or "arning" in line or "error" in line:
            print("  " + line.strip())
    bad = 0
    if args.check:
        for h, w, ci, co in EDGE_SHAPES:
            L = conv.StageLayout(h, w, max(ci, co, 128))
            bad += run_layer("edge", L, ci, co, dev, 0, True)
    else:
        layouts = lpips._vgg_stage_layouts(args.size, args.size)
        c_in = 16
        for si, stage in enumerate(lpips.VGG_PLAN["stages"]):
            for li, (c_out, *_) in enumerate(stage):
                bad += run_layer(f"conv{si}_{li}", layouts[si], c_in, c_out,
                                 dev, args.reps, not args.planned_only)
                c_in = c_out
    print(f"values beyond the bf16 rule or unequal bits: {bad}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
