"""Time the port's LPIPS head kernels alone, on one NVIDIA card.

    python3 scripts/torch_head_bench.py [--package DIR] [--reps N]

Builds chip_smoke.py's LPIPS inputs (the bench scene's 512x512 gt image,
its seeded perturbed copy, the random-feature VGG16 of seed 0) and their
five stage features through the conv kernels, then times each stage's
head forward and backward wrapper as chip_smoke.py does: device ms per
launch from CUDA-graph replays that rotate over copies of the stage's
features whose pixel spans exceed chip_smoke.COLD_BYTES, so every launch
reads HBM. The backward is timed with both outputs and, where the
wrappers have it, with da alone (the train step's form). With --package
DIR the kernels and wrappers come from DIR/manus_tpu_torch (an unpacked
copy of another commit) while the inputs and the timing stay this
checkout's, so that two commits are timed the same way in one call;
wrappers without the layout argument are called over every row, as that
commit's step calls them.

Prints one JSON line per stage; the last line is the whole result, with
the sums over the 5-launch sweep.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke(package: str):
    """This checkout's chip_smoke.py over DIR/manus_tpu_torch."""
    sys.path.insert(0, os.path.abspath(package))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def stage_inputs(chip_smoke, dev) -> list:
    """[(a, b, L, lin_eff, ct)] of the 5 stages: the perturbed image's and
    the gt's features, the stage's layout, head and a seeded cotangent."""
    import torch

    lpips = chip_smoke.lpips_mod
    _, _, batch = chip_smoke.build_scene(dev)
    params, gt, pred, gen = chip_smoke.lpips_inputs(batch, dev)
    packed = lpips.pack_lpips_params(params)
    with torch.no_grad():
        f_pred = lpips.vgg16_features(packed, pred * 2.0 - 1.0)
        f_gt = lpips.vgg16_features(packed, gt * 2.0 - 1.0)
    return [(a, b, L, packed.lin_eff(si, L),
             torch.rand((), device=dev, generator=gen) + 0.5)
            for si, ((a, L), (b, _)) in enumerate(zip(f_pred, f_gt))]


def time_stage(chip_smoke, a, b, L, lin, ct, reps: int) -> dict:
    """ms per launch of the forward, the backward and (where the wrappers
    take a layout) the da-only backward on one stage."""
    conv = chip_smoke.conv_mod
    spans = "L" in inspect.signature(conv.head_fwd_cuda).parameters
    c = a.shape[1]
    copies = [(a, b)] + [(a.clone(), b.clone()) for _ in range(
        int(chip_smoke.COLD_BYTES // (4 * L.n_valid * c)))]
    kw = {"L": L} if spans else {}

    def graph_ms(launch):
        return chip_smoke.rotated_graph_ms(launch, copies, reps)

    row = dict(c=c, rows=L.rows, span_rows=L.n_valid, pixels=L.h * L.w,
               copies=len(copies))
    row["fwd_ms"] = graph_ms(lambda x, y: conv.head_fwd_cuda(x, y, lin, **kw))
    row["bwd_ms"] = graph_ms(
        lambda x, y: conv.head_bwd_cuda(x, y, lin, ct, **kw))
    row["bwd_da_ms"] = graph_ms(
        lambda x, y: conv.head_bwd_cuda(x, y, lin, ct, L, False)) \
        if spans else None
    return row


def sweep(stages: list) -> dict:
    """The per-stage times summed over the 5-launch sweep."""
    da = [r["bwd_da_ms"] for r in stages]
    return dict(fwd_ms=sum(r["fwd_ms"] for r in stages),
                bwd_ms=sum(r["bwd_ms"] for r in stages),
                bwd_da_ms=None if None in da else sum(da))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=ROOT,
                    help="directory that holds the manus_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    chip_smoke = load_chip_smoke(args.package)
    import torch

    if not torch.cuda.is_available():
        print("torch_head_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = chip_smoke.gpu_name_and_power()
    stages = []
    for si, inputs in enumerate(stage_inputs(chip_smoke, dev)):
        stages.append(dict(stage=si, **time_stage(chip_smoke, *inputs,
                                                  args.reps)))
        print(json.dumps(stages[-1]))
    print(json.dumps(dict(card=card, package=os.path.abspath(args.package),
                          stages=stages, **sweep(stages))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
