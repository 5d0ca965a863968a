"""Readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/check_limits.py --workload <cell> --seeds 1,2,3 \
        [--control] [--faults half_batch,altered] [--program]

--program  the compared numbers of sound runs of the program (a short
           window each), the lower readings;
--control  the reference in the program's place at the next precision
           down (TF32 in its float32 matmuls and convolutions) against
           the reference, on the first steps a run's sampler draws;
--faults   runs of the program with each fault of portbench/faults.py
           planted underneath.
One JSON line per reading. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults as faults_mod  # noqa: E402
from portbench import run as run_mod  # noqa: E402
from portbench.registry import Registry  # noqa: E402


def control_reading(registry, workload: str, seed: int) -> dict:
    import numpy as np

    from portbench.drivers import common
    from portbench.reference import hand_step as ref

    w = registry.workload(workload)
    config, traffic = registry.config(w["config"]), registry.traffic(
        w["traffic"])
    cfg = common.config_as_run(config, traffic, {})
    lpips = "lpips_loss" in cfg["loss"]["losses"]
    inputs = common.build_inputs(cfg, config["scene"], seed, "cuda",
                                 images=True, vgg=lpips)
    # the trainer's own draw of a step's frame and view (trainer.py
    # sample_batch), from the seed the driver gives it
    rng = np.random.RandomState(seed % 2**32)
    batches = []
    for _ in range(traffic["check_steps"]):
        f = rng.randint(0, cfg["dataset"]["num_frames"])
        v = int(rng.randint(0, cfg["dataset"]["num_cameras"], size=1)[0])
        batches.append((f, v, *common.decode(inputs["images"][f, v])))
    t0 = time.perf_counter()
    reference = ref.run_steps(cfg, inputs, batches, inputs["vgg"], "cuda",
                              tf32=False)
    t_ref = time.perf_counter() - t0
    control = ref.run_steps(cfg, inputs, batches, inputs["vgg"], "cuda",
                            tf32=True)
    return dict(kind="control", seed=seed, reference_s=t_ref,
                **common.compare(control, reference, inputs["init"]))


def composite_control_reading(registry, workload: str, seed: int) -> dict:
    """The contact search at the next precision below the float32 the
    port states for it (bfloat16 operands, float32 sums; TF32 does not
    apply to a product of inner size 3) in the program's place, against
    float64, over one cycle of the poses: the compared numbers as a run
    reads them (the panels of its first three frames, 8-bit)."""
    import numpy as np
    import torch

    from portbench.drivers import common
    from portbench.reference import composite_frames as ref
    from portbench.reference import frozen as fz

    w = registry.workload(workload)
    config, traffic = registry.config(w["config"]), registry.traffic(
        w["traffic"])
    cfg = common.config_as_run(config, traffic, {})
    inputs = common.build_inputs(cfg, config["scene"], seed, "cuda",
                                 obj=True)
    grid = ref.voxel_grid(cfg, inputs, "cuda")
    d = cfg["dataset"]
    cano = fz.make_camera(inputs["K"][0], inputs["extr"][0], d["width"],
                          d["height"], device="cuda")
    h_act = inputs["init"]["active"]
    o_act, o_xyz = inputs["obj"]["active"], inputs["obj"]["xyz"]
    t0 = time.perf_counter()
    contact, panels = 0.0, 0.0
    acc_c = acc_r = 0.0
    for f in range(d["num_frames"]):
        xyz, tf = ref.posed_hand(inputs, grid, f, "cuda")
        want = ref.contacts(xyz, o_xyz, h_act, o_act)
        got = ref.contacts(xyz, o_xyz, h_act, o_act, dtype=torch.float32,
                           operands=torch.bfloat16)
        contact = max(contact, float((got.double() - want).abs().max()))
        acc_c, acc_r = acc_c + got, acc_r + want
        if f < 3:
            img_r = ref.gt_eval_panels(cfg, inputs, tf, want.float(),
                                       acc_r.float(), cano, "cuda")
            img_c = ref.gt_eval_panels(cfg, inputs, tf, got.float(),
                                       acc_c.float(), cano, "cuda")
            u8 = (img_c.cpu().numpy() * 255).astype(np.uint8)
            panels = max(panels, ref.image_gap(u8, img_r))
    acc = float((acc_c.double() - acc_r).abs().max()) / d["num_frames"]
    return dict(kind="control", seed=seed,
                reference_s=time.perf_counter() - t0, contact=contact,
                acc=acc, panels=panels)


CONTROLS = {"hand_train": control_reading,
            "composite_frames": composite_control_reading}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("check_limits: no CUDA card", file=sys.stderr)
        return 2
    registry = Registry()
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        if args.program:
            line = run_mod.run_cell(registry, args.workload, seed,
                                    args.seconds, False)
            print(json.dumps(dict(kind="program", seed=seed, **{
                k: c["value"] for k, c in line["compared"].items()})),
                flush=True)
        if args.control:
            w = registry.workload(args.workload)
            driver = registry.traffic(w["traffic"]).get(
                "driver", registry.config(w["config"])["driver"])
            print(json.dumps(CONTROLS[driver](registry, args.workload, seed)),
                  flush=True)
        for name in filter(None, args.faults.split(",")):
            with faults_mod.FAULTS[name]():
                line = run_mod.run_cell(registry, args.workload, seed,
                                        args.seconds, False)
            print(json.dumps(dict(kind=name, seed=seed, **{
                k: c["value"] for k, c in line["compared"].items()})),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
