"""Time the port's composite kernels alone, on one NVIDIA card.

    python3 scripts/torch_composite_bench.py [--package DIR] [--reps N]

Builds chip_smoke.py's bench scene (65,536 gaussians, 512x512, one view)
and times the forward and the backward wrapper per launch from CUDA-graph
replays on two payloads: the scene's own (clustered: a few deep tiles)
and the spread one (the same gaussians scattered over the image). With
--package DIR the kernels and wrappers come from DIR/manus_tpu_torch (an
unpacked copy of another commit) while the scene and the timing stay
this checkout's, so that two commits are timed the same way in one call.

Prints one JSON line per payload; the last line is the whole result.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=ROOT,
                    help="directory that holds the manus_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.package))
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    if not torch.cuda.is_available():
        print("torch_composite_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = chip_smoke.gpu_name_and_power()
    cfg, model, batch = chip_smoke.build_scene(dev)
    result = dict(card=card, package=os.path.abspath(args.package))
    for name, spread in (("bench", False), ("spread", True)):
        pay, bins = chip_smoke.scene_payload(cfg, model, batch, dev, spread)
        result[name] = chip_smoke.composite_graph_ms(pay, bins, dev, args.reps)
        print(json.dumps({name: result[name]}))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
