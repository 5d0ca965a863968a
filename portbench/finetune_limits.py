"""Readings that the fine-tune cell's limits are set from, at its own size.

    python3 portbench/finetune_limits.py --seeds 1,2,3 [--program] \
        [--control] [--faults object_dropped,object_trained,half_batch,altered]

portbench/check_limits.py, with the fine-tune's control and faults:

--program  the compared numbers of sound runs of the program (a short
           window each), the lower readings;
--control  the reference in the program's place at the next precision
           down (TF32 in its float32 matmuls and convolutions) against
           the reference, on the first steps run_composite draws from the
           seed; its object is never touched (frozen 0);
--faults   runs of the program with each fault planted underneath:
           `object_dropped`, the hand rendered without the object (the
           frozen model's slots all dead in the step's scene);
           `object_trained`, the frozen model updated too (after each
           step of the hand, a step of the object's own, written into its
           leaves); and portbench/faults.py's `half_batch` and `altered`.
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

WORKLOAD = "composite_finetune"
SECONDS = 2.0  # a program run's window: the readings are of its first steps


def object_dropped():
    """The fine-tune step renders the hand without the object."""
    import torch

    from manus_tpu_torch import main as port_main

    def make(factory):
        def make_step(*args, **kwargs):
            step = factory(*args, **kwargs)

            def without_object(state, frozen, batch):
                gone = frozen._replace(active=torch.zeros_like(frozen.active))
                return step(state, gone, batch)
            return without_object
        return make_step

    return faults_mod._patched(port_main, "make_composite_finetune_step",
                               make)


def object_trained():
    """After each step of the hand, a step of the object's own on the same
    batch (masked Adam at the same learning rates), written into the
    frozen model's leaves."""
    import torch

    from manus_tpu_torch import main as port_main
    from manus_tpu_torch.train.workloads import init_train_state

    def make(factory):
        def make_step(cfg, raster_cfg, optimize, **kwargs):
            step = factory(cfg, raster_cfg, optimize, **kwargs)
            obj_step = factory(cfg, raster_cfg, "object", **kwargs)
            held = {}

            def both(state, frozen, batch):
                state, metrics = step(state, frozen, batch)
                if "obj" not in held:
                    held["obj"] = init_train_state(frozen)
                held["obj"], _ = obj_step(held["obj"], state.model, batch)
                with torch.no_grad():
                    for p, q in zip(frozen.params, held["obj"].model.params):
                        p.copy_(q)
                return state, metrics
            return both
        return make_step

    return faults_mod._patched(port_main, "make_composite_finetune_step",
                               make)


FAULTS = dict(object_dropped=object_dropped, object_trained=object_trained,
              half_batch=faults_mod.half_batch, altered=faults_mod.altered)


def control_reading(registry, seed: int) -> dict:
    """The reference with TF32 on against the reference, from the cell's
    initial state on the first `check_steps` batches that run_composite
    draws (RandomState(trainer.seed): a frame, then a view)."""
    import numpy as np

    from portbench import composite_scene
    from portbench.drivers import common
    from portbench.reference import composite_finetune as ref

    device = "cuda"
    w = registry.workload(WORKLOAD)
    config, traffic = registry.config(w["config"]), registry.traffic(
        w["traffic"])
    cfg = common.config_as_run(config, traffic, {})
    inputs = composite_scene.build(cfg, config["scene"], seed, device)
    d = cfg["dataset"]
    rng = np.random.RandomState(seed % 2**32)
    batches = []
    for _ in range(traffic["check_steps"]):
        f = rng.randint(d["num_frames"])
        v = rng.randint(d["num_cameras"])
        batches.append((f, v, *common.decode(inputs["images"][f, v])))
    t0 = time.perf_counter()
    reference = ref.run_steps(cfg, inputs, batches, device, tf32=False)
    t_ref = time.perf_counter() - t0
    control = ref.run_steps(cfg, inputs, batches, device, tf32=True)
    frozen = max(float((control["obj"][k] - inputs["obj"][k].to(device)
                        ).abs().max()) for k in common.LEAVES)
    return dict(kind="control", seed=seed, reference_s=t_ref,
                frozen=frozen,
                **common.compare(control, reference, inputs["init"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("finetune_limits: no CUDA card", file=sys.stderr)
        return 2
    registry = Registry()
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            line = run_mod.run_cell(registry, WORKLOAD, seed, SECONDS,
                                    False)
            print(json.dumps(dict(kind="program", seed=seed, **{
                k: c["value"] for k, c in line["compared"].items()})),
                flush=True)
        if args.control:
            print(json.dumps(control_reading(registry, seed)), flush=True)
        for name in filter(None, args.faults.split(",")):
            with FAULTS[name]():
                line = run_mod.run_cell(registry, WORKLOAD, seed, SECONDS,
                                        False)
            print(json.dumps(dict(kind=name, seed=seed, **{
                k: c["value"] for k, c in line["compared"].items()})),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
